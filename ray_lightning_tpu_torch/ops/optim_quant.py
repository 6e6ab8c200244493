"""Block-scaled int8 storage for optimizer moments
(``ray_lightning_tpu/ops/optim_quant.py`` and the block codec of
``ray_lightning_tpu/ops/collective_quant.py``).

A moment tensor is stored as int8 payloads with one f32 absmax scale per
block of ``block_size`` elements, so the persistent AdamW state costs
~2.06 bytes a parameter instead of 8; the update runs on a transient f32
view (``models/optim.py::quantize_opt_state``).  The first moment
quantizes linearly; the second in the sqrt domain (``sqrt(nu)`` is
stored), which halves its dynamic range in log space, so an element must
sit ~8 orders below its block's max before it rounds to zero.

The JAX package computes this codec in XLA, outside any Pallas kernel; it
is plain PyTorch here, op for op: ``scale = amax / 127`` where amax > 0
else 1.0, ``round(v / scale)`` (a division, halves to even) clipped to
±127.  The all-reduce half of ``collective_quant.py`` is multi-GPU work
and not ported.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import torch

__all__ = ["BlockQuantized", "quantize_block_scaled",
           "dequantize_block_scaled", "quantize_moment", "dequantize_moment",
           "is_block_quantized", "DEFAULT_BLOCK_SIZE", "MIN_QUANT_SIZE"]

# The gradient wire's block granularity: 4 bytes of scale over 128 payload
# bytes (3.1%), and one outlier poisons at most 127 neighbours.
DEFAULT_BLOCK_SIZE = 128

# Leaves below this many elements keep a float moment: biases and
# LayerNorm gains are O(d) where the matmul moments are O(d²).
MIN_QUANT_SIZE = 4096


class BlockQuantized:
    """One quantized moment tensor.  ``q``: int8, 1-D, padded to a
    multiple of ``block_size``; ``scale``: f32, one per block.  Static:
    ``shape`` (the logical shape), ``block_size`` and ``sqrt_domain``
    (the payload encodes ``sqrt(value)``).  ``models/optim.py``'s
    ``tree_map``/``tree_leaves`` walk into it (its leaves are ``q`` then
    ``scale``), so the megastep write-back and the checkpoint see two
    tensors.  ``aux`` keeps the static fields as a JAX checkpoint held
    them, so a tree read and written back pickles the same objects."""

    __slots__ = ("q", "scale", "shape", "block_size", "sqrt_domain", "aux")

    def __init__(self, q: Any, scale: Any, shape: Tuple[int, ...],
                 block_size: int, sqrt_domain: bool, aux: Any = None):
        self.q = q
        self.scale = scale
        self.shape = tuple(shape)
        self.block_size = int(block_size)
        self.sqrt_domain = bool(sqrt_domain)
        self.aux = aux

    def static(self) -> Tuple[Tuple[int, ...], int, bool]:
        return self.shape, self.block_size, self.sqrt_domain

    def replace(self, q: Any, scale: Any) -> "BlockQuantized":
        """The same static fields over new leaves."""
        return BlockQuantized(q, scale, self.shape, self.block_size,
                              self.sqrt_domain, self.aux)

    def __repr__(self) -> str:
        return (f"BlockQuantized(shape={self.shape}, "
                f"block_size={self.block_size}, sqrt={self.sqrt_domain})")


def is_block_quantized(x: Any) -> bool:
    return isinstance(x, BlockQuantized)


def quantize_block_scaled(v: torch.Tensor, block_size: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat f32 vector (a multiple of ``block_size`` long) → (int8
    payload, f32 per-block absmax scales).  An all-zero block gets scale
    1.0."""
    vb = v.reshape(-1, block_size)
    amax = vb.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(vb / scale), -127, 127).to(torch.int8)
    return q.reshape(-1), scale.reshape(-1)


def dequantize_block_scaled(q: torch.Tensor, scales: torch.Tensor,
                            block_size: int) -> torch.Tensor:
    """Inverse of :func:`quantize_block_scaled` (up to rounding)."""
    vb = q.float().reshape(-1, block_size)
    return (vb * scales[:, None]).reshape(-1)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root.  CUDA's ``sqrtf`` is; the
    CPU's vectorized f32 kernel is not (1 ulp off at ~0.7% of the
    elements of a large tensor), so on the CPU the root is taken in f64
    and rounded once to f32, which is exact for a square root."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def quantize_moment(v: torch.Tensor, block_size: int = DEFAULT_BLOCK_SIZE,
                    sqrt_domain: bool = False) -> BlockQuantized:
    """Float tensor → :class:`BlockQuantized` (flatten, optional sqrt of
    the absolute value, zero-pad to a block multiple, absmax block
    quantization)."""
    shape = tuple(v.shape)
    flat = v.reshape(-1).float()
    if sqrt_domain:
        # nu >= 0; abs() guards values dequantization noise nudged below 0.
        flat = _sqrt(flat.abs())
    pad = (-flat.numel()) % block_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, scale = quantize_block_scaled(flat, block_size)
    return BlockQuantized(q, scale, shape, block_size, sqrt_domain)


def dequantize_moment(bq: BlockQuantized,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_moment` (up to rounding)."""
    flat = dequantize_block_scaled(bq.q, bq.scale, bq.block_size)
    if bq.sqrt_domain:
        flat = flat * flat
    return flat[:math.prod(bq.shape)].reshape(bq.shape).to(dtype)
