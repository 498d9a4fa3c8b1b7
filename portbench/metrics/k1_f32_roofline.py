"""K1-f32 (csrc/phase1.cu, float32 phase 1) against its roofline: every
launch scores the live rows against the real queries of one search."""

from portbench import counts, readers

K1_F32 = r"phase1_(tf32|f32)_kernel"


def read(run):
    if run.profile is None:
        return None
    f = run.facts
    n = len(run.profile.kernels(K1_F32))
    least = n * counts.least_seconds(*counts.phase1_work(f["rows"], f["dim"], f["batch"]))
    return readers.roofline(run, K1_F32, least)
