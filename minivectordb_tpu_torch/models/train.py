"""Contrastive fine-tuning of the embedding encoder, on one card or on a
(dp, tp) mesh.

Counterpart of ``minivectordb_tpu/models/train.py``: in-batch InfoNCE over
(query, passage) pairs through the encoder, with the same functions,
arguments, history entries and checkpoint cadence. PyTorch's idiom where the
JAX module is functional:

- ``params`` is a ``models.encoder.Encoder`` (a numpy pytree is loaded into
  one by ``init_training``, each leaf in its own type: see bfloat16 below);
  gradients come from ``torch.autograd``. On the card, sequences of 256 and
  more (a multiple of 128, head width >= 32) take the flash-attention
  kernels: K6 forward with its row statistic, K7 and K8 backward
  (ops/flash_attention.py:FlashAttention), in float32 or bfloat16; the rest,
  and the CPU, take the materialised attention, which autograd
  differentiates.
- the optimizer is ``torch.optim.AdamW`` set to ``optax.adamw``'s defaults,
  which are not torch's: weight decay 1e-4 (torch's default is 1e-2) on every
  parameter, betas (0.9, 0.999), eps 1e-8. The two apply the same update,
  p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p), with the roundings in
  another order (torch scales p by 1 - lr * wd first).
- bfloat16: an encoder with bfloat16 parameters (``init_params(...,
  dtype=torch.bfloat16)``, or a JAX pytree from ``init_params(...,
  dtype=jnp.bfloat16)``) trains in bfloat16 as the JAX package's step does:
  activations and gradients in the parameters' type, AdamW's moments in each
  parameter's type (optax keeps ``mu`` and ``nu`` in the parameters' type,
  torch's AdamW in the parameter's). Each parameter keeps its type: JAX's
  bfloat16 ``init_params`` gives float32 dense weights, which both packages
  cast to the activations' bfloat16 at each product and update in float32.
  Every bfloat16 operation rounds in another order than XLA's, and AdamW's
  update too (torch's in-place sequence on bfloat16 moments against optax's
  expression), so the two packages agree to bfloat16 rounding, not bit for
  bit (tests/test_torch_train.py states the tolerances).
- ``opt_state`` is that optimizer's ``state`` (parameter -> step, exp_avg,
  exp_avg_sq), updated in place by each step; checkpoints carry it in the
  JAX layout (models/checkpoint.py, convert.adamw_state_to_numpy).

Float32 products of the dense layers, and of the backward kernels K7 and K8,
are IEEE float32: TF32 stays off (ops/scan.py). The attention forward (K6,
with the row log-sum-exp the backward reads) forms its two products on the
tensor cores in 3xTF32, three TF32 products each, within the same 2e-5 of
IEEE float32 (csrc/flash_attention.cu).

``mesh=`` (a (dp, tp) mesh from ``parallel.mesh.train_mesh``) trains with
data and tensor parallelism, as the JAX package's ``make_train_step(mesh=)``
does through GSPMD: ``param_shardings`` gives the Megatron layout in the JAX
package's terms, the batch rows split over dp, and
``parallel/tensor_parallel.py`` holds the placement, the sharded step and
its collectives. ``params`` is then a ``tensor_parallel.MeshEncoder`` (one
piece ``Encoder`` a position this process holds), ``opt_state`` maps each
position to its AdamW's state, and checkpoints hold the gathered JAX pytree.
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
from minivectordb_tpu_torch.parallel import tensor_parallel
from minivectordb_tpu_torch.parallel.mesh import NamedSharding, train_spec
from minivectordb_tpu_torch.utils.telemetry import span

# optax.adamw's defaults
ADAMW = {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}


def param_shardings(mesh, params) -> dict:
    """Megatron-style tensor-parallel layout of the encoder's parameter
    pytree, as the JAX package gives it: q/k/v and ffn_in shard the OUTPUT
    dim (column parallel), attn_out and ffn_out the INPUT dim (row
    parallel), embeddings and layer norms are replicated. A pytree of
    ``parallel.mesh.NamedSharding`` in the JAX layout (dense weights (in,
    out)), whatever ``params`` is: the numpy pytree, an ``Encoder`` or a
    ``MeshEncoder``."""
    if isinstance(params, tensor_parallel.MeshEncoder):
        params = next(iter(params.pieces.values()))
    if isinstance(params, Encoder):
        params = convert._tree_of(params, lambda _p, _t: None)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return NamedSharding(mesh, train_spec(path))

    return walk(params, ())


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
    waits for the step). With a mesh, the sharded step of
    ``parallel/tensor_parallel.py`` over ``init_training(mesh=)``'s
    placed params and optimizer.

    The single-card step is the span ``train.step`` with the spans
    ``train.upload``, ``train.forward``, ``train.backward`` and
    ``train.optimizer`` inside it (utils/telemetry.py; the last three time
    the device by CUDA events on the card)."""
    if mesh is not None:
        return tensor_parallel.make_step(cfg, optimizer, mesh, temperature)

    def step(params, opt_state, batch):
        on_card = params.device.type == "cuda"
        with span("train.step"):
            with span("train.upload"):
                batch = batch_to(batch, params.device)
            with span("train.forward", device=on_card):
                optimizer.zero_grad(set_to_none=True)
                loss, acc = info_nce_loss(params, cfg, batch, temperature)
            with span("train.backward", device=on_card):
                loss.backward()
            with span("train.optimizer", device=on_card):
                optimizer.step()
        return params, opt_state, {"loss": loss.detach(), "accuracy": acc}

    return step


def init_training(cfg: EncoderConfig, params, mesh=None,
                  learning_rate: float = 1e-4, *, device=None):
    """Place params and build the optimizer: returns (encoder, opt_state,
    optimizer). ``params`` is an ``Encoder`` (moved to ``device`` in place if
    it lies elsewhere) or the JAX parameter pytree as numpy arrays (loaded by
    ``convert.encoder_from_numpy``). ``device=None`` means the CUDA card and
    raises without one.

    With a mesh the mesh names the devices (``device``, when given, must be
    its own): ``params`` (a pytree, a placed checkpoint, an ``Encoder`` or a
    ``MeshEncoder``) is placed by ``param_shardings`` into a ``MeshEncoder``,
    and the optimizer is one AdamW a position (``MeshAdamW``)."""
    if mesh is not None:
        tensor_parallel.check_mesh(mesh)
        if device is not None and {scan_ops.resolve_device(device)} != {
                d for _pos, d in mesh.local_shards()}:
            raise ValueError(f"device {device!r} is not the mesh's")
        placed = tensor_parallel.place(params, cfg, mesh).requires_grad_(True)
        optimizer = tensor_parallel.MeshAdamW(placed, learning_rate, **ADAMW)
        return placed, optimizer.state, optimizer
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
    if isinstance(encoder, tensor_parallel.MeshEncoder):
        tensor_parallel.resume(opt_state, encoder, optimizer)
        return
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
    trained ``Encoder``, or with a mesh the trained ``MeshEncoder`` (its
    checkpoints hold the gathered JAX pytree). ``device=None`` means the
    CUDA card and raises without one."""
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
