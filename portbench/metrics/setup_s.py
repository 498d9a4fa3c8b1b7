"""Process start to the first timed call: imports, inputs, loading,
warm-up and, in a checkout's first run, the kernels' build."""


def read(run):
    return run.setup_s
