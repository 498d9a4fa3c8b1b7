"""Faults a training cell can have, planted under its timed path."""


def state_unchanged(monkeypatch):
    """A step that returns its state unchanged: the optimizer's update is
    skipped."""
    import torch
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from minivectordb_tpu_torch.models import train
    real = train.info_nce_loss

    def half(params, cfg, batch, temperature=0.05):
        n = batch["q_ids"].shape[0] // 2
        return real(params, cfg, {k: v[:n] for k, v in batch.items()}, temperature)

    monkeypatch.setattr(train, "info_nce_loss", half)


FAULTS = {"state-unchanged": state_unchanged, "half-batch": half_batch}
