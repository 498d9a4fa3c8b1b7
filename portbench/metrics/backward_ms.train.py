"""Device milliseconds a training step spends in its backward: the mean,
over the steps of the traced window, of the time between the CUDA events of
the program's ``train.backward`` span."""

from portbench import spans


def read(run):
    return spans.mean_device_ms(run, "train.backward")
