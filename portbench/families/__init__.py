"""Model families: what the benchmark knows of one architecture, found by
name. A configuration's ``model["model_type"]``, with ``-`` changed to
``_``, names the module ``portbench/families/<name>.py``, which gives:

- ``weight_shapes(model)``: (path, shape, kind) of every leaf, in the order
  ``traffic.make_weights`` draws them; kind is "emb", "dense", "bias",
  "gain" or "shift";
- ``to_pytree(flat)`` / ``from_pytree(tree)``: the leaves in the program's
  converted-artifact layout, and back;
- ``embed(w, ids, mask, model)``: the plain reference's forward and
  pooling, unit embeddings of a batch of token ids;
- ``forward_flops(model, lengths)``: model operations of one forward pass
  over sequences of ``lengths`` real tokens;
- ``attention(model)``: for each attention kernel the forward launches, the
  layers that launch it, its heads and head width, and the real (query,
  key) pairs a sequence of n real tokens needs there;
- ``tiny(model)``: the widths cut, in place, to a size the CPU runs in
  seconds (the benchmark's own tests).

A family imports nothing of the program: the reference is built from it.
"""

from __future__ import annotations

import importlib


def of(model: dict):
    """The family module of a configuration's ``model``."""
    return importlib.import_module(
        "portbench.families." + str(model["model_type"]).replace("-", "_"))
