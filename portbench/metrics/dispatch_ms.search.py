"""Host milliseconds from the start of a search call to the start of the
wait for its results: the filter, the snapshot, routing, padding, the
upload and the launches. For each request of the traced window whose root
span ``search`` has a ``search.fetch``, the start of its first fetch less
the start of the root, averaged."""

from portbench import spans


def read(run):
    sp = spans.program_spans(run)
    if sp is None:
        return None
    roots = {s.request_id: s.start_ns for s in sp if s.name == "search" and s.parent_id is None}
    fetch: dict = {}
    for s in sp:
        if s.name == "search.fetch" and s.request_id in roots:
            fetch[s.request_id] = min(fetch.get(s.request_id, s.start_ns), s.start_ns)
    if not fetch:
        return None
    return 1e-6 * sum(t - roots[r] for r, t in fetch.items()) / len(fetch)
