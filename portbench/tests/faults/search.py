"""Faults a search cell can have, planted under its timed path."""


def altered_answer(monkeypatch):
    """An answer altered where it is produced: the engine's formatting puts
    another row (with that row's metadata) in place of each query's last
    hit."""
    from minivectordb_tpu_torch.core.engine import SearchEngine
    batch, single = SearchEngine._format_hits_batch, SearchEngine._format_hits

    def alter(hits):
        ids, scores, metas = (list(x) for x in hits)
        ids[-1] = (int(ids[-1]) + 1) % 6000
        metas[-1] = {"id": ids[-1]}
        return ids, scores, metas

    monkeypatch.setattr(SearchEngine, "_format_hits_batch",
                        staticmethod(lambda *a: [alter(h) for h in batch(*a)]))
    monkeypatch.setattr(SearchEngine, "_format_hits",
                        staticmethod(lambda *a: alter(single(*a))))


FAULTS = {"altered-answer": altered_answer}
