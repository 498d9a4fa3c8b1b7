"""Contrastive fine-tuning of the embedding encoder, on one card.

Counterpart of ``minivectordb_tpu/models/train.py``: in-batch InfoNCE over
(query, passage) pairs through the encoder, with the same functions,
arguments, history entries and checkpoint cadence. PyTorch's idiom where the
JAX module is functional:

- ``params`` is a ``models.encoder.Encoder`` (a numpy pytree is loaded into
  one by ``init_training``); gradients come from ``torch.autograd``. On the
  card, sequences of 256 and more (a multiple of 128, head width >= 32) take
  the flash-attention kernels: K6 forward with its row statistic, K7 and K8
  backward (ops/flash_attention.py:FlashAttention); the rest, and the CPU,
  take the materialised attention, which autograd differentiates.
- the optimizer is ``torch.optim.AdamW`` set to ``optax.adamw``'s defaults,
  which are not torch's: weight decay 1e-4 (torch's default is 1e-2) on every
  parameter, betas (0.9, 0.999), eps 1e-8. The two apply the same update,
  p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), with the roundings in
  another order (torch scales p by 1 - lr * wd first).
- ``opt_state`` is that optimizer's ``state`` (parameter -> step, exp_avg,
  exp_avg_sq), updated in place by each step; checkpoints carry it in the
  JAX layout (models/checkpoint.py, convert.adamw_state_to_numpy).

Float32 products are IEEE float32: TF32 stays off (ops/scan.py). ``mesh=``
(data and tensor parallelism) raises until the port has ``parallel/``
(ROADMAP queue 1, item 13).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch.nn import functional as F

from minivectordb_tpu_torch import convert
from minivectordb_tpu_torch.models.encoder import (
    Encoder,
    EncoderConfig,
    encode,
    mean_pool_normalize,
)
from minivectordb_tpu_torch.ops import scan as scan_ops

# optax.adamw's defaults
ADAMW = {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "training on a mesh waits for the port's parallel/ (queue 1, item 13: "
            "parallel/ -> torch.distributed; param_shardings comes with it)"
        )


def batch_to(batch: dict, device) -> dict:
    """The batch's arrays (numpy, or anything np.asarray takes) as tensors on
    ``device``."""
    out = {}
    for key, val in batch.items():
        t = val if isinstance(val, torch.Tensor) else torch.as_tensor(np.asarray(val))
        out[key] = t.to(device)
    return out


def info_nce_loss(params: Encoder, cfg: EncoderConfig, batch: dict,
                  temperature: float = 0.05):
    """In-batch InfoNCE: query i must match passage i against all others.
    Returns (loss, accuracy) as float32 scalar tensors.

    With a soft ``labels`` matrix (B, B) in the batch the loss is
    multi-positive cross-entropy (each row's target mass on its positives),
    and a row counts as a hit when its argmax lands on a positive; otherwise
    the targets are the diagonal. ``batch`` holds tensors on the encoder's
    device (``q_ids``, ``q_mask``, ``p_ids``, ``p_mask``, optional
    ``labels``)."""
    q_emb = mean_pool_normalize(
        encode(params, batch["q_ids"], batch["q_mask"]), batch["q_mask"],
        cfg.token_norm_pool,
    )
    p_emb = mean_pool_normalize(
        encode(params, batch["p_ids"], batch["p_mask"]), batch["p_mask"],
        cfg.token_norm_pool,
    )
    scan_ops._assert_ieee_f32(q_emb)
    logits = torch.matmul(q_emb, p_emb.T) / temperature
    pred = torch.argmax(logits, dim=-1)
    if "labels" in batch:
        labels = batch["labels"].to(torch.float32)
        loss = F.cross_entropy(logits, labels)
        hit = torch.gather(labels > 0, 1, pred[:, None])[:, 0]
    else:
        diag = torch.arange(logits.shape[0], device=logits.device)
        loss = F.cross_entropy(logits, diag)
        hit = pred == diag
    return loss, hit.to(torch.float32).mean()


def make_train_step(cfg: EncoderConfig, optimizer, mesh=None,
                    temperature: float = 0.05):
    """The training step ``step(params, opt_state, batch) -> (params,
    opt_state, {"loss", "accuracy"})``: forward, backward, one AdamW update of
    ``optimizer`` (whose ``state`` is ``opt_state``), in place. The metrics
    are scalar tensors on the card (read them when they are wanted: a read
    waits for the step)."""
    _no_mesh(mesh)

    def step(params, opt_state, batch):
        batch = batch_to(batch, params.device)
        optimizer.zero_grad(set_to_none=True)
        loss, acc = info_nce_loss(params, cfg, batch, temperature)
        loss.backward()
        optimizer.step()
        return params, opt_state, {"loss": loss.detach(), "accuracy": acc}

    return step


def init_training(cfg: EncoderConfig, params, mesh=None,
                  learning_rate: float = 1e-4, *, device=None):
    """Place params and build the optimizer: returns (encoder, opt_state,
    optimizer). ``params`` is an ``Encoder`` (moved to ``device`` in place if
    it lies elsewhere) or the JAX parameter pytree as numpy arrays (loaded by
    ``convert.encoder_from_numpy``). ``device=None`` means the CUDA card and
    raises without one."""
    _no_mesh(mesh)
    dev = scan_ops.resolve_device(device)
    if isinstance(params, Encoder):
        encoder = params if params.device == dev else params.to(dev)
    else:
        encoder = convert.encoder_from_numpy(params, cfg, dev)
    encoder.requires_grad_(True)
    optimizer = torch.optim.AdamW(encoder.parameters(), lr=learning_rate, **ADAMW)
    return encoder, optimizer.state, optimizer


def _resume(opt_state, encoder: Encoder, optimizer) -> None:
    """Loads ``opt_state`` into a fresh optimizer: a torch AdamW state over
    this encoder's parameters (an earlier ``train_loop``'s), or a checkpoint's
    numpy state of either package."""
    if isinstance(opt_state, Mapping) and all(isinstance(p, torch.Tensor) for p in opt_state):
        for param in encoder.parameters():
            if param in opt_state:
                optimizer.state[param] = opt_state[param]
        return
    convert.adamw_state_from_numpy(opt_state, encoder, optimizer)


def train_loop(
    cfg: EncoderConfig,
    params,
    batch_iter,
    steps: int,
    mesh=None,
    learning_rate: float = 1e-4,
    temperature: float = 0.05,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 100,
    start_step: int = 0,
    opt_state=None,
    log_every: int = 10,
    log_fn=print,
    *,
    device=None,
):
    """Simple training loop: step + periodic atomic checkpointing
    (models/checkpoint.py). ``batch_iter`` yields dicts with
    q_ids/q_mask/p_ids/p_mask (numpy arrays; optional soft ``labels``).
    ``opt_state`` resumes an optimizer: a checkpoint's (either package's) or
    an earlier call's. Returns (params, opt_state, history); params is the
    trained ``Encoder``. ``device=None`` means the CUDA card and raises
    without one."""
    from minivectordb_tpu_torch.models.checkpoint import save_checkpoint

    params, fresh_opt, optimizer = init_training(
        cfg, params, mesh=mesh, learning_rate=learning_rate, device=device
    )
    if opt_state is not None:
        _resume(opt_state, params, optimizer)
    opt_state = fresh_opt
    step_fn = make_train_step(cfg, optimizer, mesh=mesh, temperature=temperature)
    history = []
    for step in range(start_step, start_step + steps):
        batch = next(batch_iter)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if log_every and step % log_every == 0:
            loss = float(metrics["loss"])
            acc = float(metrics["accuracy"])
            history.append({"step": step, "loss": loss, "accuracy": acc})
            log_fn(f"step {step}: loss={loss:.4f} acc={acc:.3f}")
        if checkpoint_path and (step + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, params, opt_state, step + 1)
    if checkpoint_path:
        save_checkpoint(checkpoint_path, params, opt_state, start_step + steps)
    return params, opt_state, history
