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
±127.  The all-reduce half is ``ops/collective_quant.py``.

Under ZeRO a moment's ``q`` and ``scale`` are sharded as the JAX
package shards them (``parallel/sharding.py``): a rank holds a
contiguous run of the flat padded payload (``BlockQuantized.shard``, a
:class:`MomentShard`), and with it either its own blocks' scales or every
block's.  The run's ends may cut a block in two (a straddling block):
:func:`quantize_moment_run` takes that block's absmax over every rank's
part (one MAX all-reduce of the leaf's block maxima) before it divides,
so each element rounds as the whole tensor's quantization rounds it.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

__all__ = ["BlockQuantized", "MomentShard", "quantize_block_scaled",
           "dequantize_block_scaled", "quantize_moment", "dequantize_moment",
           "quantize_moment_run", "is_block_quantized",
           "DEFAULT_BLOCK_SIZE", "MIN_QUANT_SIZE"]

# The gradient wire's block granularity: 4 bytes of scale over 128 payload
# bytes (3.1%), and one outlier poisons at most 127 neighbours.
DEFAULT_BLOCK_SIZE = 128

# Leaves below this many elements keep a float moment: biases and
# LayerNorm gains are O(d) where the matmul moments are O(d²).
MIN_QUANT_SIZE = 4096


class MomentShard(NamedTuple):
    """This rank's run of a ZeRO-sharded :class:`BlockQuantized` moment:
    ``start``, the run's first element in the flat padded payload (its
    ``q`` is the next ``q.numel()`` elements); ``scale_sharded``, whether
    its ``scale`` holds only the run's blocks (the run then starts and
    ends on block boundaries) or every block of the tensor; and
    ``sync_amax``, where the scale is every block's, the in-place MAX
    all-reduce over the ranks of a vector of one value a block (a
    collective: every rank calls it at the same point)."""

    start: int
    scale_sharded: bool
    sync_amax: Optional[Callable[[torch.Tensor], None]]


class BlockQuantized:
    """One quantized moment tensor.  ``q``: int8, 1-D, padded to a
    multiple of ``block_size``; ``scale``: f32, one per block.  Static:
    ``shape`` (the logical shape), ``block_size`` and ``sqrt_domain``
    (the payload encodes ``sqrt(value)``).  ``models/optim.py``'s
    ``tree_map``/``tree_leaves`` walk into it (its leaves are ``q`` then
    ``scale``), so the megastep write-back and the checkpoint see two
    tensors.  ``aux`` keeps the static fields as a JAX checkpoint held
    them, so a tree read and written back pickles the same objects.
    ``shard``: None for the whole tensor, else the :class:`MomentShard`
    this rank's ``q`` and ``scale`` are (a ZeRO state's)."""

    __slots__ = ("q", "scale", "shape", "block_size", "sqrt_domain", "aux",
                 "shard")

    def __init__(self, q: Any, scale: Any, shape: Tuple[int, ...],
                 block_size: int, sqrt_domain: bool, aux: Any = None,
                 shard: Optional[MomentShard] = None):
        self.q = q
        self.scale = scale
        self.shape = tuple(shape)
        self.block_size = int(block_size)
        self.sqrt_domain = bool(sqrt_domain)
        self.aux = aux
        self.shard = shard

    def static(self) -> Tuple[Tuple[int, ...], int, bool]:
        return self.shape, self.block_size, self.sqrt_domain

    @property
    def padded(self) -> int:
        """The flat payload's length: the elements, padded to a block
        multiple."""
        n = math.prod(self.shape)
        return n + (-n) % self.block_size

    def replace(self, q: Any, scale: Any) -> "BlockQuantized":
        """The same static fields (and run) over new leaves."""
        return BlockQuantized(q, scale, self.shape, self.block_size,
                              self.sqrt_domain, self.aux, self.shard)

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
    """Inverse of :func:`quantize_moment` (up to rounding).  A sharded
    moment (``bq.shard``) gives its run of the flat padded tensor, 1-D."""
    if bq.shard is not None:
        flat = _dequantize_run(bq)
        return (flat * flat if bq.sqrt_domain else flat).to(dtype)
    flat = dequantize_block_scaled(bq.q, bq.scale, bq.block_size)
    if bq.sqrt_domain:
        flat = flat * flat
    return flat[:math.prod(bq.shape)].reshape(bq.shape).to(dtype)


def _run_blocks(start: int, n: int, block_size: int) -> Tuple[int, int, int]:
    """``(first block, lead, tail)`` of a run of ``n`` elements from
    ``start``: the run padded by ``lead`` zeros in front and ``tail``
    behind covers its blocks exactly."""
    lead = start % block_size
    return start // block_size, lead, (-(lead + n)) % block_size


def _dequantize_run(bq: BlockQuantized) -> torch.Tensor:
    """A sharded payload's run, each element times its block's scale (the
    product :func:`dequantize_block_scaled` takes)."""
    B, n = bq.block_size, bq.q.numel()
    first, lead, tail = _run_blocks(bq.shard.start, n, B)
    vb = torch.nn.functional.pad(bq.q.float(), (lead, tail)).view(-1, B)
    s0 = 0 if bq.shard.scale_sharded else first
    scales = bq.scale[s0:s0 + vb.shape[0]]
    return (vb * scales[:, None]).reshape(-1)[lead:lead + n]


def quantize_moment_run(v: torch.Tensor, like: BlockQuantized
                        ) -> BlockQuantized:
    """The run ``v`` (f32, 1-D, ``like``'s run of the flat padded moment)
    quantized as :func:`quantize_moment` quantizes the whole tensor:
    each block's absmax is the whole block's (a block the run's ends cut
    takes its maximum over the ranks through ``like.shard.sync_amax``,
    which also hands every rank every block's scale where the scale is
    replicated), the scale ``amax / 127`` where amax > 0, else 1.0, and
    ``round(v / scale)`` clipped to ±127."""
    sh, B = like.shard, like.block_size
    flat = v.reshape(-1).float()
    if like.sqrt_domain:
        flat = _sqrt(flat.abs())
    n = flat.numel()
    first, lead, tail = _run_blocks(sh.start, n, B)
    vb = torch.nn.functional.pad(flat, (lead, tail)).view(-1, B)
    amax = vb.abs().amax(dim=1)
    full = None
    if not sh.scale_sharded:
        full = amax.new_zeros(like.padded // B)
        full[first:first + amax.numel()] = amax
        sh.sync_amax(full)
        amax = full[first:first + amax.numel()]
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(vb / scale[:, None]), -127, 127).to(
        torch.int8).reshape(-1)[lead:lead + n].contiguous()
    if full is not None:
        scale = torch.where(full > 0, full / 127.0,
                            torch.ones_like(full)).float()
    return BlockQuantized(q, scale, like.shape, B, like.sqrt_domain,
                          like.aux, sh)
