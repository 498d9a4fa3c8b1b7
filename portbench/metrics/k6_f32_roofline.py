"""K6-f32 (csrc/flash_attention.cu, inference) against its roofline: once a
layer for each embed call, over the real token pairs of each text."""

from portbench import readers

K6_F32 = r"flash_f32_kernel"


def read(run):
    if run.profile is None:
        return None
    least = readers.attention_least(run, "forward", run.facts["calls"])
    return readers.roofline(run, K6_F32, least)
