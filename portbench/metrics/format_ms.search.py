"""Host milliseconds a call spends formatting its hits (ids, scores and
metadata of k rows): the program's ``search.format`` spans in the traced
window, summed by request and averaged over the requests."""

from portbench import spans


def read(run):
    return spans.mean_ms(run, "search.format", per_request=True)
