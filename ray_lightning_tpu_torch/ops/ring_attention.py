"""Ring attention: causal attention over a sequence cut across the ranks
of an ``sp`` group (``ray_lightning_tpu/ops/ring_attention.py``).

Each rank keeps its query rows; the key/value rows travel round the ring,
one hop a step, while an online softmax in f32 (running max, denominator
and accumulator) folds in each block that arrives: the JAX package's
``ring_causal_attention``, with its masking by global positions, its
local block folded first and then n - 1 hops.  The JAX package runs the
body under ``shard_map`` and moves the blocks with ``lax.ppermute``,
whose transpose carries the gradients back round the ring; here the hop
is a ``torch.autograd.Function`` (:class:`_Hop`) whose forward sends to
the next rank and receives from the previous one, and whose backward
does the reverse.

The hop has one route a backend, chosen by the group's backend, never by
trying one:

* NCCL: ``batch_isend_irecv`` of the send and the receive, on the card;
* gloo with CPU tensors: ``isend``/``irecv``;
* gloo with card tensors (ranks sharing one card, where NCCL refuses two
  ranks on a device): gloo's ``isend``/``irecv`` accept a card tensor
  and then fail in the TCP transport (``writev``: Bad address, on an
  H100; ``chip_smoke.py`` phase 19 (a)), so the block is staged through
  the host (a device-to-host copy, the send and receive, a host-to-device
  copy).  This departs from the JAX package's on-device hop and costs
  two copies of the block a hop.

With ``layout="zigzag"`` a rank ``j`` of ``n`` holds the global chunks
``j`` and ``2n-1-j`` of ``2n`` (:func:`zigzag_indices`), which balances
the causal work over the ring.  The fit permutes tokens and targets once
at the data layer (``models/gpt.py::GPT.shard_sequence``), as the JAX
docstring recommends, so nothing is permuted here.

:func:`ring_attention_local` runs the same fold over ``n`` shards in one
process: the plain version the tests and the card's checks hold the
distributed ring against.  No rank of a fit calls it.

The fold keeps each hop's (B, H, s, s) f32 logits for the backward, as
the JAX scan does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.parallel.model_parallel import AxisGroup

__all__ = ["zigzag_indices", "shard_positions", "ring_causal_attention",
           "ring_attention_local", "hop_route", "RING_LAYOUTS"]

_NEG_INF = -1e30
RING_LAYOUTS = ("contiguous", "zigzag")


def zigzag_indices(seq_len: int, n_shards: int) -> np.ndarray:
    """Permutation taking a normally ordered sequence to zig-zag shard
    order: shard ``j``'s rows are chunks ``j`` and ``2n-1-j`` of ``2n``
    equal chunks."""
    if seq_len % (2 * n_shards):
        raise ValueError(
            f"zigzag layout needs seq_len ({seq_len}) divisible by "
            f"2*n_shards ({2 * n_shards})")
    c = seq_len // (2 * n_shards)
    order = []
    for j in range(n_shards):
        order.extend(range(j * c, (j + 1) * c))
        lo = (2 * n_shards - 1 - j) * c
        order.extend(range(lo, lo + c))
    return np.asarray(order, np.int32)


def shard_positions(index: int, n_shards: int, s_loc: int, layout: str,
                    device=None) -> torch.Tensor:
    """Global sequence positions of shard ``index``'s ``s_loc`` rows."""
    if layout == "zigzag":
        c = s_loc // 2
        lo, hi = index * c, (2 * n_shards - 1 - index) * c
        return torch.cat([lo + torch.arange(c, device=device),
                          hi + torch.arange(c, device=device)])
    return index * s_loc + torch.arange(s_loc, device=device)


def _check_layout(layout: str) -> None:
    if layout not in RING_LAYOUTS:
        raise ValueError(
            f"layout={layout!r}: expected 'contiguous' or 'zigzag'")


def _fold(acc, m, l, qf, k, v, q_pos, k_pos):
    """One block of the online softmax (the JAX ``fold``): logits of the
    block masked by global positions, the running max, denominator and
    accumulator advanced."""
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
    logits = torch.where(mask, logits, _NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
    p = torch.exp(logits - m_new)
    # A fully masked block has logits == m_new == NEG_INF and exp(0) = 1:
    # the mask again, so a dead block adds exactly zero.
    p = torch.where(mask, p, 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    acc_new = acc * corr + torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return acc_new, m_new, l_new


def _init(q: torch.Tensor):
    b, s, h, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.zeros((b, h, s, d), **f32),
            torch.full((b, h, s, 1), _NEG_INF, **f32),
            torch.zeros((b, h, s, 1), **f32))


def hop_route(group: AxisGroup, t: torch.Tensor) -> str:
    """The hop's route for ``t`` over ``group``: ``"nccl"``, ``"gloo"``
    (CPU tensors) or ``"gloo-host"`` (card tensors staged through the
    host), by the group's backend."""
    import torch.distributed as dist

    backend = str(dist.get_backend(group.group)).lower()
    if backend == "nccl":
        return "nccl"
    if backend != "gloo":
        raise NotImplementedError(
            f"ring attention's hop has no route over backend {backend!r}")
    return "gloo-host" if t.is_cuda else "gloo"


def _exchange(t: torch.Tensor, group: AxisGroup, to: int,
              frm: int) -> torch.Tensor:
    """``t`` sent to global rank ``to``; what global rank ``frm`` sent
    this rank, returned."""
    import torch.distributed as dist

    t = t.contiguous()
    route = hop_route(group, t)
    if route == "nccl":
        out = torch.empty_like(t)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, to, group.group),
            dist.P2POp(dist.irecv, out, frm, group.group)])
        for r in reqs:
            r.wait()
        return out
    src = t.cpu() if route == "gloo-host" else t
    buf = torch.empty_like(src)
    reqs = [dist.isend(src, to, group=group.group),
            dist.irecv(buf, frm, group=group.group)]
    for r in reqs:
        r.wait()
    return buf.to(t.device) if route == "gloo-host" else buf


class _Hop(torch.autograd.Function):
    """One hop of the ring: forward to the next rank, from the previous;
    the gradient goes the other way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group, group.rank_at(group.index + 1),
                         group.rank_at(group.index - 1))

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group
        return _exchange(grad, g, g.rank_at(g.index - 1),
                         g.rank_at(g.index + 1)), None


def ring_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          group: AxisGroup, layout: str = "contiguous",
                          scale: Optional[float] = None) -> torch.Tensor:
    """The per-rank body: ``q``/``k``/``v`` are this rank's (B, S/n, H, D)
    rows of the sequence over the ``sp`` group ``group``; returns its rows
    of the causal attention output, in ``q``'s dtype.  Differentiable:
    the gradients of ``k`` and ``v`` come back round the ring."""
    _check_layout(layout)
    n, me = group.size, group.index
    s_loc, d = q.shape[1], q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    qf = q.float() * scale
    q_pos = shard_positions(me, n, s_loc, layout, q.device)
    acc, m, l = _fold(*_init(q), qf, k, v, q_pos, q_pos)
    kv = torch.stack([k, v])
    for i in range(1, n):
        # After i hops this rank holds the rows of shard (me - i) mod n.
        kv = _Hop.apply(kv, group)
        k_pos = shard_positions((me - i) % n, n, s_loc, layout, q.device)
        acc, m, l = _fold(acc, m, l, qf, kv[0], kv[1], q_pos, k_pos)
    return (acc / l).transpose(1, 2).to(q.dtype)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n_shards: int, layout: str = "contiguous",
                         scale: Optional[float] = None) -> torch.Tensor:
    """The ring's fold over ``n_shards`` shards in one process, on
    normally ordered (B, S, H, D) inputs (permuted into the zig-zag
    order and back where ``layout="zigzag"``): shard ``j`` folds its own
    block, then the blocks of shards ``j-1``, ``j-2``, ... as the ring
    delivers them."""
    _check_layout(layout)
    S, d = q.shape[1], q.shape[-1]
    if S % n_shards:
        raise ValueError(f"seq_len {S} does not divide into {n_shards} "
                         f"shards")
    scale = d ** -0.5 if scale is None else scale
    order = inv = None
    if layout == "zigzag":
        order = torch.as_tensor(zigzag_indices(S, n_shards).astype(np.int64),
                                device=q.device)
        inv = torch.argsort(order)
        q, k, v = (x.index_select(1, order) for x in (q, k, v))
    s = S // n_shards
    qs, ks, vs = (x.split(s, dim=1) for x in (q, k, v))
    outs = []
    for j in range(n_shards):
        qf = qs[j].float() * scale
        q_pos = shard_positions(j, n_shards, s, layout, q.device)
        acc, m, l = _init(qs[j])
        for i in range(n_shards):
            src = (j - i) % n_shards
            acc, m, l = _fold(acc, m, l, qf, ks[src], vs[src], q_pos,
                              shard_positions(src, n_shards, s, layout,
                                              q.device))
        outs.append((acc / l).transpose(1, 2).to(q.dtype))
    out = torch.cat(outs, dim=1)
    return out if inv is None else out.index_select(1, inv)

