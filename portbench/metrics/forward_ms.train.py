"""Device milliseconds a training step spends in its forward (the zeroing of
the gradients, both encodes and the loss): the mean, over the steps of the
traced window, of the time between the CUDA events of the program's
``train.forward`` span."""

from portbench import spans


def read(run):
    return spans.mean_device_ms(run, "train.forward")
