"""Gradient synchronisation of the data-parallel flavors, full width
(``ray_lightning_tpu/parallel/grad_sync.py``, its bucket plan and
full-width path).

Each rank's gradients are of the mean loss over its own rows; averaging
them over the ranks gives the gradients of the mean over the global batch,
which the JAX step computes as one program.  Two syncs:

* :class:`BucketSync` (``RayStrategy``): the synced leaves, in the JAX
  package's tree order (dict keys sorted), packed into buckets by
  :func:`build_bucket_plan` (``bucket_bytes`` of f32 footprint, 4 MiB by
  default; a larger leaf gets its own bucket), one ``all_reduce`` a bucket
  over its flat f32 vector, then divided by the world size;
* :class:`LeafSync` (``HorovodRayStrategy``): one ``all_reduce`` a leaf,
  no buckets (the JAX ``shard_map`` flavor's per-leaf ``pmean``).

Only the leaves ``module.trainable`` marks are synced: a frozen leaf's
gradient is ``models.optim.known_zeros`` and stays so.  The JAX package's
int8 wire modes with error feedback (``GradCommConfig``) are a later
slice: :func:`resolve_grad_comm` raises for them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.models.optim import (
    is_known_zeros, tree_leaves, tree_unflatten,
)

__all__ = ["Bucket", "BucketPlan", "build_bucket_plan", "jax_order",
           "sync_leaf_buckets", "BucketSync", "LeafSync",
           "resolve_grad_comm", "DEFAULT_BUCKET_BYTES"]

DEFAULT_BUCKET_BYTES = 4 * 2 ** 20


def resolve_grad_comm(value: Any) -> None:
    """The port's strategies sync gradients at full width only: ``None``,
    ``"full"`` or ``{"mode": "full"}``; anything else raises."""
    mode = value.get("mode") if isinstance(value, dict) else value
    if value is None or mode == "full":
        return None
    raise NotImplementedError(
        f"grad_comm={value!r}: the int8 gradient wire with error feedback "
        f"(comm hooks over parallel/grad_sync.py's modes and "
        f"ops/collective_quant.py) is not ported yet (ROADMAP Queue 1 item "
        f"2); gradients sync at full width (grad_comm=None or 'full')")


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One sync unit: a contiguous (tree-order) run of grad leaves."""

    indices: Tuple[int, ...]   # positions in the plan's leaf list
    sizes: Tuple[int, ...]     # elements per leaf
    size: int                  # total payload elements
    padded: int                # padded to n_shards * block_size
    offset: int                # start within the flat padded vector


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    buckets: Tuple[Bucket, ...]
    n_shards: int
    block_size: int
    total_elems: int
    total_padded: int
    full_width_bytes: int

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)


def build_bucket_plan(shapes: Sequence[Sequence[int]], n_shards: int,
                      bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                      block_size: int = 256) -> BucketPlan:
    """The JAX ``build_bucket_plan`` over leaf ``shapes`` in tree order:
    leaves packed in order into buckets bounded by ``bucket_bytes`` of f32
    footprint (a larger leaf alone, never split; an empty leaf skipped),
    each padded to a multiple of ``n_shards · block_size`` (the int8
    wire's alignment; the full-width sync sends only ``size``)."""
    align = n_shards * block_size
    max_elems = max(bucket_bytes // 4, 1)
    buckets: List[Bucket] = []
    cur_idx: List[int] = []
    cur_sizes: List[int] = []
    cur_total = 0
    offset = 0
    full_width_bytes = 0

    def flush():
        nonlocal cur_idx, cur_sizes, cur_total, offset
        if not cur_idx:
            return
        padded = -(-cur_total // align) * align
        buckets.append(Bucket(indices=tuple(cur_idx),
                              sizes=tuple(cur_sizes), size=cur_total,
                              padded=padded, offset=offset))
        offset += padded
        cur_idx, cur_sizes, cur_total = [], [], 0

    for i, shape in enumerate(shapes):
        shape = tuple(shape)
        size = int(np.prod(shape)) if shape else 1
        if size == 0:
            continue
        full_width_bytes += size * 4
        if cur_total and cur_total + size > max_elems:
            flush()
        cur_idx.append(i)
        cur_sizes.append(size)
        cur_total += size
        if cur_total >= max_elems:
            flush()
    flush()
    return BucketPlan(buckets=tuple(buckets), n_shards=n_shards,
                      block_size=block_size,
                      total_elems=sum(b.size for b in buckets),
                      total_padded=offset,
                      full_width_bytes=full_width_bytes)


def jax_order(tree: Any) -> List[int]:
    """Positions of ``tree``'s leaves (``models.optim.tree_leaves`` order)
    in the order ``jax.tree_util`` flattens the same tree: dict keys
    sorted at every level."""
    from ray_lightning_tpu_torch.parallel.sharding import leaves_with_paths

    paths = [tuple(str(k) for k in p) for p, _ in leaves_with_paths(tree)]
    return sorted(range(len(paths)), key=lambda i: paths[i])


def sync_leaf_buckets(leaves: List[torch.Tensor], buckets: Sequence[Bucket],
                      world_size: int) -> List[torch.Tensor]:
    """The full-width path of the JAX ``sync_leaf_buckets``: each bucket's
    leaves flattened into one f32 vector, all-reduced (sum) and divided by
    ``world_size``, then cut back into the leaves' shapes and dtypes."""
    import torch.distributed as dist

    out = list(leaves)
    for b in buckets:
        parts = [leaves[i].reshape(-1).float() for i in b.indices]
        flat = torch.cat(parts) if len(parts) > 1 else parts[0].clone()
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(world_size)
        pos = 0
        for i, sz in zip(b.indices, b.sizes):
            out[i] = flat[pos:pos + sz].view(leaves[i].shape).to(
                leaves[i].dtype)
            pos += sz
    return out


class BucketSync:
    """``RayStrategy``'s gradient sync: the synced leaves in JAX tree
    order, bucketed by :func:`build_bucket_plan` (built at the first call,
    from that tree's shapes), one ``all_reduce`` a bucket."""

    def __init__(self, world_size: int,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES):
        self.world = world_size
        self.bucket_bytes = bucket_bytes
        self.plan: Optional[BucketPlan] = None
        self._synced: Optional[List[int]] = None

    def __call__(self, grads: Any) -> Any:
        leaves = tree_leaves(grads)
        if self._synced is None:
            self._synced = [i for i in jax_order(grads)
                            if not is_known_zeros(leaves[i])]
            self.plan = build_bucket_plan(
                [tuple(leaves[i].shape) for i in self._synced], self.world,
                self.bucket_bytes)
        synced = sync_leaf_buckets([leaves[i] for i in self._synced],
                                   self.plan.buckets, self.world)
        out = list(leaves)
        for i, g in zip(self._synced, synced):
            out[i] = g
        return tree_unflatten(grads, out)


class LeafSync:
    """``HorovodRayStrategy``'s gradient sync: one ``all_reduce`` a synced
    leaf, in JAX tree order, then divided by the world size."""

    def __init__(self, world_size: int):
        self.world = world_size

    def __call__(self, grads: Any) -> Any:
        import torch.distributed as dist

        leaves = tree_leaves(grads)
        out = list(leaves)
        for i in jax_order(grads):
            g = leaves[i]
            if is_known_zeros(g):
                continue
            dist.all_reduce(g, op=dist.ReduceOp.SUM)
            out[i] = g.div_(self.world)
        return tree_unflatten(grads, out)
