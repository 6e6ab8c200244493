"""Mixture-of-Experts routing and the expert MLP (``ray_lightning_tpu/ops/
moe.py``), in plain PyTorch: no Pallas kernel lies behind it.

Routing is the JAX package's GShard formulation: dense one-hot dispatch
and combine tensors ``[G, s, E, C]`` against which the tokens are
contracted, greedy top-k with a per-expert capacity ``C`` counted within
each of ``groups`` routing groups, and the Switch-Transformer load-balance
loss over the statistics of every group.  The router runs in f32 whatever
the compute dtype.

Expert parallelism (``expert`` and ``tensor`` groups, :func:`moe_mlp`):
the JAX package shards ``moe_*`` over ``expert`` (and each expert's hidden
dim over ``tensor``) and lets GSPMD partition the einsums.  Its batch is
sharded over the batch axes only, so the ranks along ``expert`` route the
same tokens, and the combine einsum sums over the experts: the cross-rank
step is one all-reduce of the partial output over the ``expert`` x
``tensor`` group, not an all-to-all.  Here a rank computes its ``E/e``
experts (each at ``h/t`` of the hidden dim) and sums the partial output
with one ``reduce_out`` over that group; the replicated tensors that
enter the sharded region (the dispatch's input, ``combine``) go through
``copy_in``, and the expert-output bias, replicated over ``tensor``, is
added by the group's tensor rank 0 alone (its gradient summed over the
tensor group by a ``copy_in``, so every tensor rank holds the whole
one).

Under data parallelism a rank routes its own data shard as its one
routing group (the JAX group of the same rows: ``GPT._moe_groups`` is the
data-shard count there), and the load-balance loss is taken over the
statistics of every shard, as the JAX package takes it over every group:
the per-expert dispatch counts, router probability sums and token count
are summed over the ``data`` group with :func:`~ray_lightning_tpu_torch.
parallel.model_parallel.global_sum` (``moe_mlp(data=...)``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ray_lightning_tpu_torch.parallel.model_parallel import (
    AxisGroup, copy_in, global_sum, reduce_out,
)

__all__ = ["topk_capacity_routing", "load_balance_loss", "moe_mlp",
           "moe_capacity"]


def topk_capacity_routing(probs: torch.Tensor, top_k: int, capacity: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy top-k assignment with a per-expert capacity, one group:
    ``probs [s, E]`` f32 → ``(combine, dispatch)``, both ``[s, E, C]``:
    ``dispatch`` the 0/1 token → (expert, slot) assignment, ``combine``
    the same weighted by the renormalized gate."""
    s, E = probs.shape
    top_k = min(top_k, E)
    remaining = probs
    slots_used = probs.new_zeros((1, E))
    dispatch = probs.new_zeros((s, E, capacity))
    combine = probs.new_zeros((s, E, capacity))
    for _ in range(top_k):
        choice = torch.argmax(remaining, dim=-1)
        onehot = F.one_hot(choice, E).to(probs.dtype)
        position = torch.cumsum(onehot, dim=0) - onehot + slots_used
        fits = (position < capacity).to(probs.dtype) * onehot
        # one_hot of a position past the capacity is all zeros (as
        # jax.nn.one_hot's): clamp the index, then zero those rows.
        pos = position.long()
        slot = F.one_hot(pos.clamp(max=capacity - 1), capacity).to(
            probs.dtype) * (pos < capacity).to(probs.dtype)[..., None]
        d = slot * fits[..., None]
        gate = (probs * onehot).sum(-1)
        dispatch = dispatch + d
        combine = combine + d * gate[:, None, None]
        slots_used = slots_used + fits.sum(0, keepdim=True)
        remaining = remaining * (1.0 - onehot)
    denom = combine.sum(dim=(1, 2), keepdim=True)
    return combine / torch.clamp(denom, min=1e-9), dispatch


def load_balance_loss(probs: torch.Tensor,
                      dispatch: torch.Tensor) -> torch.Tensor:
    """Switch-Transformer aux loss ``E · Σ_e f_e · p̄_e``, 1.0 for a uniform
    assignment at any ``top_k``."""
    E = probs.shape[-1]
    per_expert = dispatch.sum(dim=(0, 2))
    frac = per_expert / torch.clamp(per_expert.sum(), min=1.0)
    return E * torch.sum(frac * probs.mean(dim=0))


def moe_capacity(tokens: int, groups: int, n_experts: int,
                 capacity_factor: float) -> Tuple[int, int, int]:
    """``(G, s, C)``: the routing groups (``groups`` where it divides the
    tokens, else 1), the tokens a group and the per-expert capacity."""
    G = groups if groups > 0 and tokens % groups == 0 else 1
    s = tokens // G
    return G, s, max(1, int(math.ceil(s / n_experts * capacity_factor)))


def moe_mlp(x: torch.Tensor, gate_w: torch.Tensor, w_in: torch.Tensor,
            b_in: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
            top_k: int = 2, capacity_factor: float = 1.25, groups: int = 1,
            expert: Optional[AxisGroup] = None,
            tensor: Optional[AxisGroup] = None,
            expert_tensor: Optional[AxisGroup] = None,
            data: Optional[AxisGroup] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route → dispatch → expert FFN → combine: ``(y [B, T, d], aux)``.

    ``x [B, T, d]``, ``gate_w [d, E]`` (all experts, replicated); ``w_in
    [E_loc, d, h_loc]``, ``b_in [E_loc, h_loc]``, ``w_out [E_loc, h_loc,
    d]``, ``b_out [E_loc, d]``: the rank's experts, ``E_loc = E / e`` at
    its index in ``expert`` (None: every expert), each at ``h_loc = h / t``
    of the hidden dim at its index in ``tensor``; ``expert_tensor`` the
    group over both, which the partial output is summed over; ``data``
    the group of data shards the load-balance statistics are summed
    over."""
    B, T, d = x.shape
    E = gate_w.shape[-1]
    G, s, capacity = moe_capacity(B * T, groups, E, capacity_factor)
    xg = x.reshape(G, s, d)
    logits = torch.einsum("gsd,de->gse", xg.float(), gate_w.float())
    probs = torch.softmax(logits, dim=-1)
    routed = [topk_capacity_routing(p, top_k, capacity) for p in probs]
    combine = torch.stack([r[0] for r in routed])
    dispatch = torch.stack([r[1] for r in routed])
    # Over every group's statistics at once (a per-group mean would
    # depend on the mesh).
    if data is None or data.size == 1:
        aux = load_balance_loss(probs.reshape(G * s, E),
                                dispatch.reshape(G * s, E, capacity))
    else:
        stats = global_sum(torch.cat([
            dispatch.sum(dim=(0, 1, 3)), probs.sum(dim=(0, 1)),
            probs.new_full((1,), float(G * s))]), data)
        per_expert, prob_sum, n_tok = stats[:E], stats[E:2 * E], stats[-1]
        frac = per_expert / torch.clamp(per_expert.sum(), min=1.0)
        aux = E * torch.sum(frac * (prob_sum / n_tok))
    c = x.dtype
    e_loc = w_in.shape[0]
    e0 = 0 if expert is None else expert.index * e_loc
    mine = slice(e0, e0 + e_loc)
    xg = copy_in(xg, expert_tensor)
    combine = copy_in(combine, expert_tensor)
    xd = torch.einsum("gsec,gsd->gecd", dispatch[:, :, mine].to(c).float(),
                      xg.float()).to(c)
    h = F.gelu(torch.einsum("gecd,edh->gech", xd.float(), w_in.float()
                            ).to(c) + b_in[None, :, None, :].to(c),
               approximate="tanh")
    yo = torch.einsum("gech,ehd->gecd", h.float(), w_out.float())
    if tensor is not None and tensor.size > 1:
        # The tensor ranks' partials sum in f32 (GSPMD's reduction of the
        # contraction); the bias once, by tensor rank 0.
        bias = copy_in(b_out, tensor) * float(tensor.index == 0)
        yo = yo + bias[None, :, None, :].to(c).float()
    else:
        yo = yo.to(c) + b_out[None, :, None, :].to(c)
    y = torch.einsum("gsec,gecd->gsd", combine[:, :, mine].to(c).float(),
                     yo.float())
    y = reduce_out(y, expert_tensor)
    return y.reshape(B, T, d).to(c), aux
