"""Faults an embed cell can have, planted under its timed path."""


def altered_answer(monkeypatch):
    """An answer altered where it is produced: the embed program hands each
    text the next text's embedding."""
    import torch

    import minivectordb_tpu_torch.embedding_model as em
    real = em.embed_program
    monkeypatch.setattr(em, "embed_program", lambda *a, **k: torch.roll(real(*a, **k), 1, 0))


FAULTS = {"altered-answer": altered_answer}
