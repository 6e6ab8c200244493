"""Causal multi-head attention: the plain reference and the dispatcher.

All implementations share the JAX package's contract
(``ray_lightning_tpu/ops/attention.py``)::

    causal_attention(q, k, v) -> out      # shapes (batch, seq, heads, dim)

* ``impl="xla"`` — :func:`xla_causal_attention`: einsum + masked softmax
  in plain PyTorch, differentiated by autograd, any shape, any device.
  The name keeps the JAX package's.
* ``impl="flash"`` — ``ops/flash_attention.py``: the CUDA kernels on CUDA
  tensors (a shape they reject raises and names ``impl="xla"``), their
  plain versions on CPU tensors.
* ``impl="auto"`` — the JAX package's default name, kept so callers of
  either package pass the same value; here it is an alias of ``"flash"``
  (:func:`resolve_impl`), there being one kernel to choose.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["_NEG_INF", "causal_attention", "resolve_impl",
           "xla_causal_attention"]

# Mask value for hidden attention scores and filtered sampling logits.  A
# large finite value, not -inf: a fully masked row still softmaxes to
# finite numbers, and exp(-1e30 - max) is exactly 0.0 for a masked entry,
# the same as the JAX package (ray_lightning_tpu/ops/attention.py).
_NEG_INF = -1e30

ATTN_IMPLS = ("auto", "xla", "flash")


def xla_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Reference causal attention, (B, S, H, D) -> (B, S, H, D): f32
    scores and softmax whatever the input dtype, the probabilities cast to
    v's dtype before the product, the output cast back to q's dtype."""
    s = q.shape[1]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    pos = torch.arange(s, device=q.device)
    logits = torch.where(pos[:, None] >= pos[None, :], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def resolve_impl(impl: str) -> str:
    """``"xla"`` or ``"flash"`` for an ``impl`` name; raises on others."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"Unknown attention impl {impl!r} (auto|xla|flash)")
    return "flash" if impl == "auto" else impl


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: Optional[float] = None,
                     impl: str = "auto") -> torch.Tensor:
    """Dispatching causal attention (see the module docstring)."""
    if resolve_impl(impl) == "xla":
        return xla_causal_attention(q, k, v, scale)
    from ray_lightning_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(q, k, v, scale)
