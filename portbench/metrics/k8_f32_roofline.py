"""K8-f32 (csrc/flash_attention_bwd.cu, dQ) against its roofline: once a
layer for each step's passages."""

from portbench import readers

K8_F32 = r"bwd_dq_(tf32|f32)_kernel"


def read(run):
    if run.profile is None:
        return None
    least = readers.attention_least(run, "dq", [p for _q, p in run.facts["steps"]])
    return readers.roofline(run, K8_F32, least)
