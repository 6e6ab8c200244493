"""Block-scaled int8 codec and the compressed all-reduce of the gradient
wire (``ray_lightning_tpu/ops/collective_quant.py``).

A flat f32 vector is cut into blocks of ``block_size`` elements; a block
travels as int8 payloads and one f32 absmax scale: 1 byte an element plus
``4 / block_size`` bytes of scale instead of 4 bytes.

The all-reduce is the JAX package's two-phase compressed ring over a
``torch.distributed`` process group of ``n`` ranks:

1. reduce-scatter (``all_to_all_single``): each rank sends the quantized
   chunk ``d`` of its partial, payload and scales, to rank ``d``, which
   dequantizes the ``n`` versions and sums them in rank order; it then
   owns the reduced chunk ``d``;
2. all-gather (``all_gather_into_tensor``): the owner requantizes its
   chunk and every rank gathers the int8 chunks and their scales, and
   dequantizes the whole reduced vector.

A rank's chunk index is its rank in the group (the JAX
``composite_axis_index``).  The JAX package computes all of it in XLA
around ``lax`` collectives, with no Pallas kernel, so the port is plain
PyTorch on tensors, in the arithmetic of the compiled JAX program (the
island always runs under ``jit``): XLA rewrites ``amax / 127.0`` as a
product with the f32 reciprocal of 127, and contracts each dequantized
add (``acc + q·s``) and each error term (``v - q·s``) into one fused
multiply-add.  The port takes the reciprocal, and does the fused ops in
f64 rounded once to f32 (an int8 code times an f32 scale is exact in
f64), so it equals the compiled island bit for bit on the same partials
(the optimizer's moment codec, ``ops/optim_quant.py``, divides, as
eager JAX does).  :func:`int8_all_reduce_reference` computes what every
rank of such a group returns, from all the ranks' partials, with no
process group: the tests and ``chip_smoke.py`` hold the collective to it.

Both collectives take the tensors where they are: NCCL the card's, and
gloo the CPU's and, for ranks sharing a card, the card's (the card's
PyTorch 2.11 gloo takes int8 and f32 CUDA tensors in both).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["quantize_block_scaled", "dequantize_block_scaled",
           "int8_all_reduce", "int8_all_reduce_reference"]


# f32(1 / 127): what the compiled JAX codec multiplies amax by.
_INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def quantize_block_scaled(v: torch.Tensor, block_size: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat f32 vector (a multiple of ``block_size`` long) → (int8
    payload, f32 per-block absmax scales): ``scale = amax · f32(1/127)``
    (1.0 for an all-zero block), ``round(v / scale)`` halves to even,
    clipped to ±127."""
    vb = v.reshape(-1, block_size)
    amax = vb.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax * _INV_127,
                        torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(vb / scale), -127, 127).to(torch.int8)
    return q.reshape(-1), scale.reshape(-1)


def dequantize_block_scaled(q: torch.Tensor, scales: torch.Tensor,
                            block_size: int) -> torch.Tensor:
    """Inverse of :func:`quantize_block_scaled` (up to rounding)."""
    vb = q.float().reshape(-1, block_size)
    return (vb * scales[:, None]).reshape(-1)


def _collective(new: str, old: str):
    """``torch.distributed``'s function under its current name (PyTorch
    2.13 renamed ``all_gather_into_tensor``; older releases have only the
    old name)."""
    import torch.distributed as dist

    return getattr(dist, new, None) or getattr(dist, old)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``out[d] = rank d's x[me]`` over the leading split of ``x``."""
    import torch.distributed as dist

    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _all_gather(x: torch.Tensor, n: int, group) -> torch.Tensor:
    out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
    _collective("all_gather_single", "all_gather_into_tensor")(
        out, x, group=group)
    return out


def _dequantize_f64(q: torch.Tensor, scales: torch.Tensor,
                    block_size: int) -> torch.Tensor:
    """``q · scale`` in f64: exact, the product a fused multiply-add
    keeps unrounded."""
    vb = q.double().reshape(-1, block_size)
    return (vb * scales.double()[:, None]).reshape(-1)


def _fused_sub(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
               block_size: int) -> torch.Tensor:
    """``x - q·s`` rounded once (a fused multiply-add)."""
    return (x.double() - _dequantize_f64(q, s, block_size)).float()


def _reduce_chunk(q_peer: torch.Tensor, s_peer: torch.Tensor, n: int,
                  block_size: int) -> torch.Tensor:
    """The dequantized ``n`` versions of one chunk summed in rank order
    (the JAX ``deq.sum(axis=0)`` over the peers, compiled: the first
    product rounded, each later one added by a fused multiply-add)."""
    deq = _dequantize_f64(q_peer.reshape(-1), s_peer.reshape(-1),
                          block_size).reshape(n, -1)
    acc = deq[0].float()
    for p in range(1, n):
        acc = (acc.double() + deq[p]).float()
    return acc


def int8_all_reduce(v: torch.Tensor, group, n: int, block_size: int,
                    want_error: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sum ``v`` over the ``n`` ranks of ``group`` through the int8
    block-scaled wire.  ``v``: this rank's flat f32 partial, a multiple of
    ``n · block_size`` long.  Returns ``(reduced, error)``: ``error``
    (with ``want_error``) is this rank's share of the compression error,
    its phase-1 error over the whole vector plus, on the chunk it owns,
    the phase-2 error; summed over the ranks it is ``sum(partials) -
    reduced``, so a rank that adds its ``error`` to its next partial
    (error feedback) lets the error telescope.  Every rank calls it at the
    same point with the same length."""
    import torch.distributed as dist

    idx = dist.get_rank(group)
    chunk = v.numel() // n
    # Phase 1: quantize the partial, chunk d to rank d.
    q, s = quantize_block_scaled(v, block_size)
    q_peer = _all_to_all(q, group)
    s_peer = _all_to_all(s, group)
    reduced_chunk = _reduce_chunk(q_peer, s_peer, n, block_size)
    # Phase 2: requantize the owned chunk, gather every chunk.
    q2, s2 = quantize_block_scaled(reduced_chunk, block_size)
    q_all = _all_gather(q2, n, group)
    s_all = _all_gather(s2, n, group)
    reduced = dequantize_block_scaled(q_all, s_all, block_size)
    if not want_error:
        return reduced, None
    err = _fused_sub(v, q, s, block_size)
    err[idx * chunk:(idx + 1) * chunk] += _fused_sub(reduced_chunk, q2, s2,
                                                     block_size)
    return reduced, err


def int8_all_reduce_reference(partials: Sequence[torch.Tensor],
                              block_size: int, want_error: bool = True
                              ) -> List[Tuple[torch.Tensor,
                                              Optional[torch.Tensor]]]:
    """The plain version of :func:`int8_all_reduce`: from every rank's
    partial (``partials[r]``, rank order, equal lengths, on one device),
    what each rank returns, ``[(reduced, error), ...]``, computed with no
    process group: the blocks of all the ranks at once, the peers' sum
    over a stacked axis, the errors written out in full."""
    n = len(partials)
    v = torch.stack([p.reshape(-1) for p in partials])    # (rank, L)
    L = v.shape[1]
    blocks = v.reshape(n, -1, block_size)                  # (rank, blk, B)
    amax = blocks.abs().amax(dim=2, keepdim=True)
    s1 = torch.where(amax > 0, amax * _INV_127, torch.ones_like(amax))
    q1 = torch.clamp(torch.round(blocks / s1), -127, 127)
    d1 = q1.double() * s1.double()                         # exact
    # Chunk d of the sum is owned by rank d: the same sum, rank order.
    acc = d1[0].float()
    for r in range(1, n):
        acc = (acc.double() + d1[r]).float()               # (blk, B)
    amax2 = acc.abs().amax(dim=1, keepdim=True)
    s2 = torch.where(amax2 > 0, amax2 * _INV_127, torch.ones_like(amax2))
    q2 = torch.clamp(torch.round(acc / s2), -127, 127)
    reduced = (q2 * s2).reshape(-1)
    e2 = (acc.double() - q2.double() * s2.double()).float().reshape(-1)
    chunk = L // n
    out = []
    for r in range(n):
        err = None
        if want_error:
            err = (v[r].double() - d1[r].reshape(-1)).float()
            err[r * chunk:(r + 1) * chunk] += e2[r * chunk:(r + 1) * chunk]
        out.append((reduced.clone(), err))
    return out
