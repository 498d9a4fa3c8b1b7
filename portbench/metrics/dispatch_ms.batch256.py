"""Host milliseconds to enqueue one search: the mean of the benchmark's
spans around each find_most_similar_batch_async call of the traced run."""


def read(run):
    spans = [b - a for name, a, b in run.spans if name == "dispatch"]
    return 1e-6 * sum(spans) / len(spans) if spans and run.trace else None
