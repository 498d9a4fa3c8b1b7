"""The plain reference that decides ``correct``: exact cosine top-k, the
encoder forward of a configuration's model family (``portbench/families``)
with autograd backward, in-batch InfoNCE and AdamW, in plain PyTorch.

It imports nothing of the program. It takes the benchmark's inputs (the
corpus, the queries, the token ids, the weights), never what the program
made of them, and works everything out again. Float32 products here are
IEEE float32: TF32 is switched off while a reference runs (``ieee``), and
exact search scores in float64. The controls run the same code with TF32
switched on (``tf32=True``): the nearest precision below the float32 the
configurations state.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.nn import functional as F

from portbench import families


@contextlib.contextmanager
def precision(tf32: bool = False):
    """IEEE float32 products (the reference), or TF32 ones (the control),
    restoring the caller's settings after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# -- exact search ------------------------------------------------------------


def cosine_topk(corpus: torch.Tensor, queries: torch.Tensor, k: int,
                dtype=torch.float64, block: int = 1 << 17,
                tf32: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best rows of ``corpus`` for each query by cosine similarity,
    in descending order: (scores (m, k) float64, rows (m, k) int64). Scored
    in ``dtype`` a block of rows at a time (float64 for the reference;
    float32 with ``tf32=True`` for the control)."""
    q = queries.to(dtype)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    best_v = torch.full((q.shape[0], k), -math.inf, dtype=torch.float64, device=q.device)
    best_i = torch.zeros((q.shape[0], k), dtype=torch.int64, device=q.device)
    with precision(tf32):
        for lo in range(0, corpus.shape[0], block):
            x = corpus[lo:lo + block].to(dtype)
            inv = 1.0 / torch.linalg.vector_norm(x, dim=1)
            s = (q @ x.T) * inv
            v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
            v = torch.cat([best_v, v.to(torch.float64)], dim=1)
            i = torch.cat([best_i, i + lo], dim=1)
            best_v, at = torch.topk(v, k, dim=1)
            best_i = torch.gather(i, 1, at)
    return best_v, best_i


def cosine_of(corpus: torch.Tensor, queries: torch.Tensor,
              rows: torch.Tensor) -> torch.Tensor:
    """Float64 cosine of each query with each of its ``rows`` (m, k)."""
    q = queries.to(torch.float64)
    x = corpus[rows.reshape(-1)].to(torch.float64).view(*rows.shape, -1)
    num = torch.einsum("md,mkd->mk", q, x)
    return num / (torch.linalg.vector_norm(q, dim=1, keepdim=True)
                  * torch.linalg.vector_norm(x, dim=2))


# -- encoder -----------------------------------------------------------------


def layer_norm(x, g, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def mean_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of the real tokens' states, scaled to unit length."""
    m = mask.to(hidden.dtype)[..., None]
    pooled = (hidden * m).sum(dim=1) / m.sum(dim=1)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)


def embed(w: dict, ids: torch.Tensor, mask: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Unit embeddings (B, H) of a batch of token ids, by the model family
    of ``cfg``."""
    return families.of(cfg).embed(w, ids, mask, cfg)


# -- training ----------------------------------------------------------------


def info_nce(q_emb: torch.Tensor, p_emb: torch.Tensor, temperature: float) -> torch.Tensor:
    """In-batch InfoNCE: query i against every passage, passage i its
    positive."""
    logits = (q_emb @ p_emb.T) / temperature
    return F.cross_entropy(logits, torch.arange(q_emb.shape[0], device=q_emb.device))


def loss_and_grads(w: dict, batch: dict, cfg: dict, temperature: float,
                   block: int = 8) -> float:
    """One InfoNCE loss and its gradient on every leaf of ``w`` (leaves that
    require grad; gradients accumulate into ``.grad``). The embeddings are
    formed without a graph first, the loss differentiated with respect to
    them, and then each block of ``block`` sequences is encoded again with a
    graph and back-propagated from its share: the same gradient as one
    backward over the whole batch, in a fraction of the memory."""
    sides = (("q_ids", "q_mask"), ("p_ids", "p_mask"))
    with torch.no_grad():
        embs = [torch.cat([embed(w, batch[i][lo:lo + block], batch[m][lo:lo + block], cfg)
                           for lo in range(0, batch[i].shape[0], block)])
                for i, m in sides]
    embs = [e.requires_grad_(True) for e in embs]
    loss = info_nce(embs[0], embs[1], temperature)
    loss.backward()
    for (i, m), e in zip(sides, embs):
        for lo in range(0, batch[i].shape[0], block):
            out = embed(w, batch[i][lo:lo + block], batch[m][lo:lo + block], cfg)
            out.backward(e.grad[lo:lo + block])
    return float(loss.detach())


class AdamW:
    """AdamW as ``torch.optim.AdamW`` applies it (decoupled decay first,
    then the bias-corrected Adam step), written out plainly."""

    def __init__(self, leaves: dict, lr: float, betas, eps: float, weight_decay: float):
        self.leaves, self.lr, self.eps, self.wd = leaves, lr, eps, weight_decay
        self.b1, self.b2 = betas
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, p in self.leaves.items():
            g = p.grad
            p.mul_(1.0 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)
            p.grad = None


def train(w: dict, batches: list[dict], cfg: dict, traffic: dict, steps: int,
          tf32: bool = False) -> dict:
    """``steps`` training steps from the leaves ``w`` (changed in place):
    {"loss": [per step], "grad_norm": {leaf: step 1's gradient norm},
    "change_norm": {leaf: norm of the leaf's change after ``steps``}}."""
    start = {k: v.detach().clone() for k, v in w.items()}
    for v in w.values():
        v.requires_grad_(True)
    opt = AdamW(w, float(traffic["learning_rate"]), tuple(traffic["betas"]),
                float(traffic["eps"]), float(traffic["weight_decay"]))
    out = {"loss": [], "grad_norm": {}, "change_norm": {}}
    with precision(tf32):
        for step in range(steps):
            out["loss"].append(loss_and_grads(w, batches[step], cfg,
                                              float(traffic["temperature"])))
            if step == 0:
                out["grad_norm"] = {k: float(torch.linalg.vector_norm(v.grad.double()))
                                    for k, v in w.items()}
            opt.step()
    for k, v in w.items():
        v.requires_grad_(False)
        out["change_norm"][k] = float(torch.linalg.vector_norm((v - start[k]).double()))
    return out
