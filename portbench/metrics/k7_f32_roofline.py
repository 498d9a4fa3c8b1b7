"""K7-f32 (csrc/flash_attention_bwd.cu, dK and dV) against its roofline:
once a layer for each step's passages."""

from portbench import readers

K7_F32 = r"bwd_dkv_(tf32|f32)_kernel"


def read(run):
    if run.profile is None:
        return None
    least = readers.attention_least(run, "dkv", [p for _q, p in run.facts["steps"]])
    return readers.roofline(run, K7_F32, least)
