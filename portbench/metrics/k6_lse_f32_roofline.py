"""K6-f32 with the row log-sum-exp (the training forward) against its
roofline: once a layer for each step's passages (queries of under 256
tokens take the materialised attention)."""

from portbench import readers

K6_F32 = r"flash_f32_kernel"


def read(run):
    if run.profile is None:
        return None
    least = readers.attention_least(run, "forward_lse", [p for _q, p in run.facts["steps"]])
    return readers.roofline(run, K6_F32, least)
