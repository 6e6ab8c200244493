"""Attention constants shared by the decode and serving paths."""

from __future__ import annotations

__all__ = ["_NEG_INF"]

# Mask value for hidden attention scores and filtered sampling logits.  A
# large finite value, not -inf: a fully masked row still softmaxes to
# finite numbers, and exp(-1e30 - max) is exactly 0.0 for a masked entry,
# the same as the JAX package (ray_lightning_tpu/ops/attention.py).
_NEG_INF = -1e30
