"""Megatron's collectives for the model axes, placed by hand.

The JAX package leaves the collectives of tensor and expert parallelism to
GSPMD, which inserts them from the weights' ``PartitionSpec``\\ s.  The
port runs one process a rank and places them itself, as Megatron-LM does,
with a pair of ``torch.autograd.Function``\\ s over a group:

* :func:`copy_in` (Megatron's *f*): forward the identity, backward an
  all-reduce.  Every replicated tensor that enters a tensor- or
  expert-sharded region goes through it (the LayerNorm output before the
  QKV or MLP-in product, MoE's dispatched input and its ``combine``), so
  the gradient that leaves the region is the sum of every rank's partial
  and the replicated leaves upstream (``ln*``, ``gate_w``) get their whole
  gradient on every rank;
* :func:`reduce_out` (Megatron's *g*): forward an all-reduce of the
  rank's partial result (after the row-parallel product, after MoE's
  combine), backward the identity;
* :func:`gather_dim`: forward an all-gather of the ranks' slices along a
  dim, backward the rank's own slice of the gradient (everything
  downstream of the gather is replicated over the group, so each rank's
  gradient is already the whole one);
* :func:`global_sum`: forward an all-reduce, backward an all-reduce: a
  sum over the group's data that every rank's loss takes whole (MoE's
  load-balance statistics over the data shards), so that once the
  gradients are averaged over the group each rank's share counts once.

A reduction runs in f32 whatever the tensor's dtype (the partial sums of
a bf16 product are added in f32, then rounded once).

A group is an :class:`AxisGroup`: the ``torch.distributed`` subgroup of
the ranks along one mesh axis (or several), this rank's index in it and
its size.  With a group of one rank every function is the identity.
:class:`ModelParallel` holds a rank's groups (``parallel.mesh.
model_groups``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

__all__ = ["AxisGroup", "ModelParallel", "copy_in", "reduce_out",
           "gather_dim", "global_sum", "model_parallel_of",
           "data_group_of"]


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The ranks along a set of mesh axes: ``group`` (a
    ``torch.distributed`` subgroup, None for one rank), this rank's
    ``index`` in it, its ``size`` and the members' global ``ranks`` in
    index order."""

    group: Any
    index: int
    size: int
    ranks: Tuple[int, ...]

    def rank_at(self, index: int) -> int:
        """The global rank at ``index`` (modulo the size)."""
        return self.ranks[index % self.size]


@dataclasses.dataclass(frozen=True)
class ModelParallel:
    """One rank's model-parallel context: its group along ``sp``,
    ``tensor``, ``expert`` and ``expert`` x ``tensor``, its ``replica``
    group (the ranks holding the same weight slices: the batch axes and
    ``sp``) and its data coordinate (``data_index`` of ``data_count``
    batch shards)."""

    sp: AxisGroup
    tensor: AxisGroup
    expert: AxisGroup
    expert_tensor: AxisGroup
    replica: AxisGroup
    data_index: int
    data_count: int

    def axis(self, name: str) -> AxisGroup:
        return getattr(self, name)


def model_parallel_of(module: Any) -> Optional[ModelParallel]:
    """The :class:`ModelParallel` of the fit ``module`` runs in (its loop
    context's process group), or None: one device, or no model axis."""
    dist = getattr(getattr(module, "trainer", None), "dist", None)
    return getattr(dist, "mp", None)


def data_group_of(module: Any) -> Optional[AxisGroup]:
    """The group of ranks holding the other data shards of the fit
    ``module`` runs in: the replica group under model axes, every rank
    (the default group) on a batch-only mesh, None on one device."""
    dist = getattr(getattr(module, "trainer", None), "dist", None)
    if dist is None:
        return None
    if dist.mp is not None:
        return dist.mp.replica
    n = dist.world_size
    return AxisGroup(None, dist.rank, n, tuple(range(n))) if n > 1 else None


def _all_reduce(t: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    import torch.distributed as dist

    out = t.to(torch.float32, memory_format=torch.contiguous_format,
               copy=True)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g.group)
    return out.to(t.dtype)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.g), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return _all_reduce(x, g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _all_reduce(x, g)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.g), None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, g):
        import torch.distributed as dist

        ctx.dim, ctx.g, ctx.n = dim, g, x.shape[dim]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(g.size)]
        dist.all_gather(parts, x.contiguous(), group=g.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.g.index * ctx.n, ctx.n),
                None, None)


def copy_in(x: torch.Tensor, g: Optional[AxisGroup]) -> torch.Tensor:
    """Megatron's *f*: ``x`` as it is; its gradient summed over ``g``."""
    if g is None or g.size == 1:
        return x
    return _CopyIn.apply(x, g)


def reduce_out(x: torch.Tensor, g: Optional[AxisGroup]) -> torch.Tensor:
    """Megatron's *g*: ``x`` summed over ``g``; its gradient as it is."""
    if g is None or g.size == 1:
        return x
    return _ReduceOut.apply(x, g)


def global_sum(x: torch.Tensor, g: Optional[AxisGroup]) -> torch.Tensor:
    """``x`` summed over ``g``, its gradient summed over ``g`` as well."""
    if g is None or g.size == 1:
        return x
    return _GlobalSum.apply(x, g)


def gather_dim(x: torch.Tensor, dim: int,
               g: Optional[AxisGroup]) -> torch.Tensor:
    """The ranks' slices of ``x`` along ``dim`` concatenated in index
    order; the gradient's slice of this rank goes back."""
    if g is None or g.size == 1:
        return x
    return _GatherDim.apply(x, dim, g)
