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
* ``impl="auto"`` — the JAX package's default: ``"flash"`` where
  :func:`flash_supported` admits the shape, ``"xla"`` elsewhere
  (:func:`resolve_impl`).  The gate is the JAX package's shape rule
  (``_flash_supported``: some 128-multiple block divides S, head_dim in
  64/128/256) and nothing else, so ``"auto"`` never gives way to the plain
  attention where the JAX package runs its kernel: a shape the rule admits
  but the port's kernels do not take (f16, mixed dtypes, B·H > 65535)
  raises on the card, as ``"flash"`` does.  It is a rule about shape, so it
  routes alike on the CPU and on the card; the JAX gate's platform clause
  (TPU only) has no counterpart, since the plain versions compute the
  kernels' numbers on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["_NEG_INF", "causal_attention", "flash_supported", "pick_block",
           "resolve_impl", "xla_causal_attention"]

# Mask value for hidden attention scores and filtered sampling logits.  A
# large finite value, not -inf: a fully masked row still softmaxes to
# finite numbers, and exp(-1e30 - max) is exactly 0.0 for a masked entry,
# the same as the JAX package (ray_lightning_tpu/ops/attention.py).
_NEG_INF = -1e30

ATTN_IMPLS = ("auto", "xla", "flash")

# The JAX package's flash block preference and head dims
# (ray_lightning_tpu/ops/flash_attention.py, ops/attention.py).
DEFAULT_BLOCK_Q = 512
FLASH_HEAD_DIMS = (64, 128, 256)


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


def pick_block(seq_len: int, prefer: int = DEFAULT_BLOCK_Q) -> Optional[int]:
    """Largest lane-aligned block (<= prefer) that divides ``seq_len``, or
    None when no 128-multiple block fits — the JAX package's rule, as
    written there."""
    block = min(prefer, seq_len)
    while block >= 128:
        if seq_len % block == 0 and block % 128 == 0:
            return block
        block //= 2
    return None


def flash_supported(q: torch.Tensor) -> bool:
    """Whether ``impl="auto"`` takes flash for ``q`` (B, S, H, D): the JAX
    package's shape rule, as written there."""
    S, D = q.shape[1], q.shape[-1]
    return pick_block(S) is not None and D in FLASH_HEAD_DIMS


def resolve_impl(impl: str, q: torch.Tensor) -> str:
    """``"xla"`` or ``"flash"`` for an ``impl`` name at ``q``'s shape;
    raises on other names."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"Unknown attention impl {impl!r} (auto|xla|flash)")
    if impl == "auto":
        return "flash" if flash_supported(q) else "xla"
    return impl


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: Optional[float] = None,
                     impl: str = "auto") -> torch.Tensor:
    """Dispatching causal attention (see the module docstring)."""
    if resolve_impl(impl, q) == "xla":
        return xla_causal_attention(q, k, v, scale)
    from ray_lightning_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(q, k, v, scale)
