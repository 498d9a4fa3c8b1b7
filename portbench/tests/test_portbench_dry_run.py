"""Each cell, cut to a size the CPU runs, driven end to end through the
port and held against the reference: correct on the sound program, and not
correct with the timed path broken underneath, once for each fault the
cell can have. The look for a card is skipped: these run on the CPU."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.tiny import dry_run

CELLS = ["cohere-1m-768.b256-k100", "cohere-1m-768.serial-k100",
         "me5-large.ingest-f32", "me5-large.train-f32"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(root, name):
    run = dry_run(root, name)
    line = harness.result_line(root, run, "cpu")
    assert line["correct"], line
    assert run.items_done > 0 and run.failed == 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in run.cell.end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_the_same_seed_gives_the_same_inputs(root, name):
    from portbench.tests.tiny import tiny_cell
    from portbench import traffic
    cell = tiny_cell(root, name)
    if cell.traffic["driver"] == "search":
        from portbench.drivers.search import inputs
        a = inputs(cell.config, 64, 2 ** 35 + 3, "cpu")
        b = inputs(cell.config, 64, 2 ** 35 + 3, "cpu")
        c = inputs(cell.config, 64, 2 ** 35 + 4, "cpu")
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert not torch.equal(a[0], c[0])
    else:
        a = traffic.make_weights(cell.config["model"], 7, "cpu")
        b = traffic.make_weights(cell.config["model"], 7, "cpu")
        assert all(torch.equal(a[k], b[k]) for k in a)
        spec = cell.traffic.get("chunk") or cell.traffic["passage"]
        t1, l1 = traffic.text_pool(spec, 40, 3, 5)
        t2, l2 = traffic.text_pool(spec, 40, 3, 5)
        t3, l3 = traffic.text_pool(spec, 40, 3, 6)
        assert t1 == t2 and l1 == l2
        # another seed: the same multiset of sizes in another order
        assert sorted(l1) == sorted(l3) and l1 != l3


def _alter_hits(monkeypatch):
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


def _alter_embeddings(monkeypatch):
    """An answer altered where it is produced: the embed program hands each
    text the next text's embedding."""
    import minivectordb_tpu_torch.embedding_model as em
    real = em.embed_program
    monkeypatch.setattr(em, "embed_program", lambda *a, **k: torch.roll(real(*a, **k), 1, 0))


def _state_unchanged(monkeypatch):
    """A step that returns its state unchanged: the optimizer's update is
    skipped."""
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from minivectordb_tpu_torch.models import train
    real = train.info_nce_loss

    def half(params, cfg, batch, temperature=0.05):
        n = batch["q_ids"].shape[0] // 2
        return real(params, cfg, {k: v[:n] for k, v in batch.items()}, temperature)

    monkeypatch.setattr(train, "info_nce_loss", half)


@pytest.mark.parametrize("name,fault", [
    ("cohere-1m-768.b256-k100", _alter_hits),
    ("cohere-1m-768.serial-k100", _alter_hits),
    ("me5-large.ingest-f32", _alter_embeddings),
    ("me5-large.train-f32", _state_unchanged),
    ("me5-large.train-f32", _half_batch),
], ids=["b256-altered-answer", "serial-altered-answer", "ingest-altered-answer",
        "train-state-unchanged", "train-half-batch"])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, name, fault):
    fault(monkeypatch)
    run = dry_run(root, name)
    line = harness.result_line(root, run, "cpu")
    assert not line["correct"], line["checks"]
    failed = [k for k, v in line["checks"].items() if v["value"] > v["limit"]]
    assert failed, line["checks"]


def test_a_failing_call_is_counted_and_not_correct(root, monkeypatch):
    from minivectordb_tpu_torch import VectorDatabase
    real, calls = VectorDatabase.find_most_similar, []

    def boom(self, *a, **k):
        calls.append(1)
        if len(calls) > 3:  # past the warm-up: every call of the window
            raise RuntimeError("planted")
        return real(self, *a, **k)

    monkeypatch.setattr(VectorDatabase, "find_most_similar", boom)
    run = dry_run(root, "cohere-1m-768.serial-k100", seconds=0.3)
    assert run.failed == run.attempted > 0
    assert not harness.is_correct(run)


def test_the_chunk_mix_keeps_its_shares():
    from portbench import traffic
    lengths = traffic.fixed_lengths(1536, {"full_share": 0.75, "tail_min": 64,
                                           "tail_max": 511, "max_tokens": 512})
    assert lengths.count(512) == 1152
    tails = [n for n in lengths if n != 512]
    assert min(tails) >= 64 and max(tails) <= 511
    assert np.mean(tails) == pytest.approx(287.5, abs=1.0)
