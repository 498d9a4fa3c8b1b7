"""Device milliseconds per embed call of every kernel outside attention
(models/encoder.py: dense layers, norms, GELU, embedding, pooling)."""

from portbench import readers

K6 = r"flash_\w*kernel"


def read(run):
    took = readers.kernel_seconds(run)
    calls = len(run.facts.get("calls", ()))
    if took is None or not calls:
        return None
    return 1e3 * (took - (readers.kernel_seconds(run, K6) or 0.0)) / calls
