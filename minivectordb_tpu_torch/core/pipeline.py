"""Embed -> search pipeline on one device.

Counterpart of ``minivectordb_tpu/core/pipeline.py``. A text query runs as
tokenize (host) -> encoder forward -> pool -> L2 normalize -> cosine floor ->
masked cosine scan -> top-k, with the embedding staying on the device between
the encoder and the scan (the JAX package makes this one jitted program;
PyTorch runs the same steps eagerly on one stream, so
``embed_search_program`` is a plain function).

The scan of that program is outside any hand kernel in the JAX package (an XLA
dot plus top-k), so here it is ``torch.matmul`` with IEEE float32 products
(bf16 buffers give float32 sums of exact products, int8 buffers the exact
integer route of ops/scan.py) plus the tie-breaking ``topk_last_axis``.
"""

from __future__ import annotations

import numpy as np
import torch

from minivectordb_tpu_torch.core.store import _HOST_ALWAYS_BYTES
from minivectordb_tpu_torch.models.encoder import embed_program, seq_bucket
from minivectordb_tpu_torch.ops import scan as scan_ops
from minivectordb_tpu_torch.ops.scan import fetch_results as scan_fetch_results


def embed_search_program(
    encoder, input_ids, attention_mask, buf, inv_norms, count, k,
    pooling="mean", mask=None, mode="exact",
):
    """Tokens -> embeddings -> top-k over the corpus, all on ``buf``'s device.
    Returns (q (B, d) float32 unit vectors, values (B, k) float32, indices
    (B, k) int32). The queries are unit vectors already and are not
    normalized again."""
    with torch.inference_mode():
        q = embed_program(encoder, input_ids, attention_mask, pooling)
        if buf.dtype == torch.int8:
            vals, idx = scan_ops.scan_topk_int8(buf, inv_norms, q, count, k, mask, mode)
            return q, vals, idx
        scores = scan_ops.dots_f32(q.to(buf.dtype), buf) * inv_norms[None, :]
        valid = scan_ops._valid_rows(buf.shape[0], count, mask, buf.device)
        scores = scores.masked_fill(~valid[None, :], float(scan_ops._MASKED_SCORE))
        vals, idx = scan_ops.topk_last_axis(scores, k, mode)
        return q, vals, idx.to(torch.int32)


class TextSearchPipeline:
    """Binds an EmbeddingModel and a database into text search.

    Usage:
        pipe = TextSearchPipeline(model, db)
        ids, scores, metas = pipe.search("query text", k=5)

    The model and the database must live on one device.
    """

    def __init__(self, model, db):
        if model.device != db._engine.device:
            raise ValueError(
                f"the model lives on {model.device}, the database on "
                f"{db._engine.device}: the pipeline needs one device"
            )
        self.model = model
        self.db = db

    def search(self, texts, k: int = 5, metadata_filter=None,
               exclude_filter=None, or_filters=None):
        """texts: str or list[str]. Returns one (ids, scores, metadatas)
        triple for a single text, or a list of triples for a batch."""
        single = isinstance(texts, str)
        if single:
            texts = [texts]
        eng = self.db._engine
        if eng.store is None or eng.count == 0:
            out = [([], [], [])] * len(texts)
            return out[0] if single else out

        enc = self.model.model  # _TorchEncoder

        # IVF databases route through the engine's own search core: the
        # coarse probe beats the exact scan at corpus scale, and the
        # embedding hand-off is a (B, d) host array — trivial next to the
        # scan it avoids. The engine handles filters (broad filters ride the
        # probe, selective go exact), the overflow merge and the
        # count-guarantee fallback.
        if eng.ivf_active():
            q = enc.embed(texts)
            res = eng.search_batch(
                q, metadata_filter, exclude_filter, or_filters, k
            )
            return res[0] if single else res

        # Under the lock: filter + device-cache sync + row-aligned snapshots.
        # The tokenize->embed->scan run itself happens OUTSIDE the lock (the
        # snapshot's tensors are only ever replaced, never written), so
        # concurrent writers are never blocked behind an encoder forward pass.
        with eng.lock:
            mask, n_candidates = eng._candidate_mask(
                metadata_filter, exclude_filter, or_filters
            )
            if n_candidates == 0:
                out = [([], [], [])] * len(texts)
                return out[0] if single else out
            search_k = min(k, n_candidates)
            snap = eng.store.snapshot()
            uids, metadata = eng.uids, eng.metadata
            mask_thunk = (
                None if mask is None
                else eng._device_mask_thunk(
                    metadata_filter, exclude_filter, or_filters, mask
                )
            )
        row_mask = None
        if mask is None and snap.host_alive is not None:
            # unfiltered search over a tombstoned corpus: the alive mask IS
            # the candidate mask, as in StoreSnapshot.search (the JAX pipeline
            # scans dead rows here until the next compaction)
            mask, row_mask = snap.host_alive, snap.alive_dev

        # Tiny-corpus shortcut: below the store's always-host byte bound a
        # host scan beats any device dispatch — embed through the encoder's
        # own adaptive host/device router, scan on the host. 'mixed' is
        # f32-authoritative after rescore, so host-exact is identical there.
        if (
            eng.search_mode in ("exact", "mixed")
            and snap._host_eligible("exact", len(texts))
            and snap.count * snap.dim_bytes <= _HOST_ALWAYS_BYTES
        ):
            # embed() tokenizes internally — tokenization is deliberately
            # deferred until after this routing decision so neither branch
            # pays it twice
            q = enc.embed(texts)
            vals, idx = snap._host_search(q, search_k, mask)
        else:
            batch = enc.tokenizer(
                [enc.prefix + t for t in texts], max_length=512
            )
            ids_arr = np.asarray(batch["input_ids"], dtype=np.int32)
            mask_arr = np.asarray(batch["attention_mask"], dtype=np.int32)
            s = seq_bucket(ids_arr.shape[1], 512)
            if ids_arr.shape[1] < s:
                pad = s - ids_arr.shape[1]
                ids_arr = np.pad(ids_arr, ((0, 0), (0, pad)),
                                 constant_values=enc.cfg.pad_id)
                mask_arr = np.pad(mask_arr, ((0, 0), (0, pad)))
            device = snap.device
            if mask is not None:
                if mask_thunk is not None:
                    row_mask = mask_thunk(snap.buf.shape[0])
                if row_mask is None or row_mask.shape[0] != snap.buf.shape[0]:
                    padded = np.zeros(snap.buf.shape[0], dtype=bool)
                    padded[: mask.shape[0]] = mask
                    row_mask = scan_ops.to_device(padded, device)
            kb = scan_ops.k_bucket(search_k, snap.buf.shape[0])
            _, vals, idx = embed_search_program(
                enc.encoder,
                scan_ops.to_device(ids_arr, device),
                scan_ops.to_device(mask_arr, device),
                snap.buf, snap.inv_norms, snap.count, kb,
                enc.pooling, row_mask, eng.search_mode,
            )
            vals, idx = scan_fetch_results(
                vals[:, :search_k], idx[:, :search_k]
            )
        vals = vals[:, :search_k]
        idx = idx[:, :search_k]

        results = []
        for b in range(len(texts)):
            found = [
                (uids[row], np.float32(score), metadata[row])
                for score, row in zip(vals[b], idx[b])
                if score >= -1.0e38
            ]
            results.append(tuple(zip(*found)) if found else ([], [], []))
        return results[0] if single else results
