"""ZeRO state sharding over a process group (``ray_lightning_tpu/parallel/
sharding.py``).

The JAX package annotates each state leaf with a ``NamedSharding`` and
lets XLA insert the reduce-scatters and all-gathers.  The port applies
the same leaf rule (:func:`shard_leaf_spec`: the biggest dim divisible by
the world size, ties to the last such dim, for leaves of at least 2^12
elements; the rest replicated) as a per-leaf plan (:class:`ZeroPlan`)
that both stages use:

* stage 1: every rank holds the full params and its slice of each
  sharded moment leaf; a step reduce-scatters the gradients onto the
  slices (the replicated leaves' are all-reduced), updates the slices of
  the params and all-gathers them;
* stage 3: every rank holds only its slices of the params as well; a
  step all-gathers the full params, runs, reduce-scatters the gradients
  and updates the slices;
* the sharded weight update (``update_sharding``) is stage 1's step;
* gradients already synced in full (the int8 wire under ZeRO-1 or the
  sharded update): each rank takes its slices of them
  (:meth:`ZeroPlan.slice_grads`, no collective), then as stage 1.  The
  JAX package's ZeRO-1 step likewise shards the int8 island's replicated
  output for the update.

The step's collectives go a bucket at a time, not a leaf at a time: the
sharded leaves, in the JAX package's tree order, are packed into the
gradient wire's buckets (``grad_sync.build_bucket_plan``, 4 MiB of f32 a
bucket), one plan a dtype.  A bucket is laid out rank-major (rank r's
slices of every leaf in the bucket, in order, then rank r+1's), so one
``reduce_scatter_tensor`` hands each rank its slices of every leaf in
it and one ``all_gather_into_tensor`` returns them; the replicated
leaves' gradients go through ``grad_sync.sync_leaf_buckets``, one
``all_reduce`` a bucket.  Every element is summed over the same ranks as
a collective a leaf would sum it, so at two ranks (where a sum of two
addends has one order) the bucketed step is bitwise the per-leaf one.

A rank's slice of a leaf sharded along dim ``d`` is the contiguous run
``[rank·c, (rank+1)·c)`` of ``d`` (``c = shape[d] / world``), stored as a
contiguous tensor; a collective along ``d`` moves ``d`` to the front
first.  Optimizer-state leaves take their parameter's rule by key-path
suffix, as the JAX ``state_shardings_for_module`` matches them (the
moments ``mu``/``nu`` and ``multi_steps``' ``acc_grads`` of a param).
The JAX ``make_global_batch`` has no counterpart: each rank's loader
yields its own rows (``core.data.NumpyLoader.set_shard``).
"""

from __future__ import annotations

import math
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.models.optim import (
    MaskedNode, is_known_zeros, known_zeros, tree_leaves, tree_unflatten,
)
from ray_lightning_tpu_torch.ops.optim_quant import BlockQuantized

__all__ = ["MIN_LEAF_SIZE", "shard_leaf_spec", "leaves_with_paths",
           "ZeroPlan"]

MIN_LEAF_SIZE = 2 ** 12


def shard_leaf_spec(shape: Sequence[int], axis_size: int,
                    min_leaf_size: int = MIN_LEAF_SIZE) -> Optional[int]:
    """The dim a leaf of ``shape`` shards along over ``axis_size`` ranks,
    or None (replicated): JAX ``shard_leaf_spec`` (``_merge_zero_axis``
    with no other spec), whose PartitionSpec names the axis at this
    dim."""
    shape = tuple(int(s) for s in shape)
    if not shape or int(np.prod(shape)) < min_leaf_size:
        return None
    candidates = [(dim, i) for i, dim in enumerate(shape)
                  if dim % axis_size == 0]
    if not candidates:
        return None
    return max(candidates)[1]


def leaves_with_paths(tree: Any, path: Tuple = ()
                      ) -> Iterator[Tuple[Tuple, Any]]:
    """``(key path, leaf)`` in ``models.optim.tree_leaves`` order: dict
    keys and sequence indices; a :class:`MaskedNode` has none."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_paths(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (i,))
    elif isinstance(tree, MaskedNode):
        return
    elif isinstance(tree, BlockQuantized):
        yield path + ("q",), tree.q
        yield path + ("scale",), tree.scale
    else:
        yield path, tree


def _collective(new: str, old: str):
    """``torch.distributed``'s function under its current name (PyTorch
    2.13 renamed the single-tensor collectives and deprecated the old
    names; older releases have only those)."""
    import torch.distributed as dist

    return getattr(dist, new, None) or getattr(dist, old)


def _has_quantized(tree: Any) -> bool:
    if isinstance(tree, BlockQuantized):
        return True
    if isinstance(tree, dict):
        return any(_has_quantized(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(_has_quantized(v) for v in tree)
    return False


class ZeroPlan:
    """The per-leaf ZeRO plan of one params tree over a process group:
    ``dims[i]``, the dim leaf ``i`` (in ``tree_leaves`` order) shards
    along, or None.  ``stage`` 1 or 3.  Every collective method is run by
    every rank at the same point."""

    def __init__(self, params: Any, stage: int, rank: int, world_size: int,
                 min_leaf_size: int = MIN_LEAF_SIZE):
        if stage not in (1, 3):
            raise ValueError(f"zero stage must be 1 or 3, got {stage}")
        self.stage = stage
        self.rank = rank
        self.world = world_size
        pairs = list(leaves_with_paths(params))
        self.paths = [p for p, _ in pairs]
        self.full_shapes = [tuple(t.shape) for _, t in pairs]
        self.dims = [shard_leaf_spec(s, world_size, min_leaf_size)
                     for s in self.full_shapes]
        self.min_leaf_size = min_leaf_size
        self._by_path = {p: i for i, p in enumerate(self.paths)}
        self._order = sorted(range(len(self.paths)), key=lambda i: tuple(
            str(k) for k in self.paths[i]))
        # (the frozen leaves' mask, the leaves' dtypes) -> the step's
        # bucket plans: the sharded leaves' reduce-scatter buckets and the
        # replicated leaves' all-reduce buckets.  (The leaves' dtypes) ->
        # the all-gather's buckets.  A bucket never mixes dtypes.
        self._grad_plans: dict = {}
        self._gather_plans: dict = {}

    # -- shapes -------------------------------------------------------------
    def shard_shape(self, i: int) -> Tuple[int, ...]:
        shape, d = list(self.full_shapes[i]), self.dims[i]
        if d is not None:
            shape[d] //= self.world
        return tuple(shape)

    # -- local slices -------------------------------------------------------
    def _slice(self, t: torch.Tensor, d: Optional[int],
               own: bool = False) -> torch.Tensor:
        """This rank's run of ``t`` along ``d``, contiguous.  ``own``: in
        memory of its own, never a view (a dim-0 run is contiguous as a
        view, and a view would keep the whole leaf's storage alive)."""
        if d is None:
            return t
        c = t.shape[d] // self.world
        part = t.narrow(d, self.rank * c, c)
        return (part.clone(memory_format=torch.contiguous_format) if own
                else part.contiguous())

    def shard_tree(self, tree: Any, own: bool = False) -> Any:
        """This rank's slices of a params-shaped tree (replicated leaves as
        they are); ``own`` as :meth:`_slice`'s, for a state that keeps
        them."""
        leaves = tree_leaves(tree)
        self._check_len(leaves, "tree")
        return tree_unflatten(tree, [self._slice(t, d, own)
                                     for t, d in zip(leaves, self.dims)])

    # -- collectives on params-shaped trees ---------------------------------
    def _gather(self, s: torch.Tensor, d: int) -> torch.Tensor:
        x = (s if d == 0 else s.movedim(d, 0)).contiguous()
        out = torch.empty((x.shape[0] * self.world, *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _collective("all_gather_single", "all_gather_into_tensor")(
            out, x)
        return out if d == 0 else out.movedim(0, d).contiguous()

    def _buckets(self, indices: List[int], shapes, dtypes
                 ) -> List[List[int]]:
        """``indices`` (in JAX tree order) packed into buckets of one
        dtype each by the gradient wire's plan over ``shapes``."""
        from ray_lightning_tpu_torch.parallel.grad_sync import (
            DEFAULT_BUCKET_BYTES, build_bucket_plan,
        )

        out: List[List[int]] = []
        for dt in dict.fromkeys(dtypes[i] for i in indices):
            group = [i for i in indices if dtypes[i] == dt]
            plan = build_bucket_plan([shapes[i] for i in group], self.world,
                                     DEFAULT_BUCKET_BYTES)
            out += [[group[j] for j in b.indices] for b in plan.buckets]
        return out

    def _rank_major(self, ts: List[torch.Tensor], dims: List[int]
                    ) -> torch.Tensor:
        """A bucket's leaves laid out rank-major: rank r's run of every
        leaf (along its dim), in order, then rank r+1's."""
        parts = [(t if d == 0 else t.movedim(d, 0)).reshape(self.world, -1)
                 for t, d in zip(ts, dims)]
        return torch.cat(parts, dim=1).reshape(-1)

    def _unpack_slices(self, flat: torch.Tensor, idx: List[int]
                       ) -> List[torch.Tensor]:
        """This rank's slices of a bucket's leaves out of its flat run."""
        out, pos = [], 0
        for i in idx:
            d = self.dims[i]
            shape = list(self.full_shapes[i])
            shape[d] //= self.world
            moved = [shape[d]] + shape[:d] + shape[d + 1:]
            n = math.prod(moved)
            part = flat[pos:pos + n].view(moved)
            out.append(part if d == 0 else part.movedim(0, d).contiguous())
            pos += n
        return out

    def all_gather(self, shards: Any) -> Any:
        """Full leaves from every rank's slices (a params-shaped tree): one
        ``all_gather_into_tensor`` a bucket of the sharded leaves."""
        leaves = tree_leaves(shards)
        self._check_len(leaves, "tree")
        dtypes = tuple(t.dtype for t in leaves)
        plan = self._gather_plans.get(dtypes)
        if plan is None:
            sharded = [i for i in self._order if self.dims[i] is not None]
            plan = self._gather_plans[dtypes] = self._buckets(
                sharded, self.full_shapes, dtypes)
        out = list(leaves)
        gather = _collective("all_gather_single", "all_gather_into_tensor")
        for idx in plan:
            parts = [leaves[i] for i in idx]
            dims = [self.dims[i] for i in idx]
            mine = torch.cat([(t if d == 0 else t.movedim(d, 0)).reshape(-1)
                              for t, d in zip(parts, dims)])
            full = torch.empty(mine.numel() * self.world, dtype=mine.dtype,
                               device=mine.device)
            gather(full, mine)
            rows = full.view(self.world, -1)
            pos = 0
            for i, t, d in zip(idx, parts, dims):
                n = t.numel()
                shape = list(self.full_shapes[i])
                moved = [shape[d]] + shape[:d] + shape[d + 1:]
                leaf = rows[:, pos:pos + n].reshape(moved)
                out[i] = leaf if d == 0 else leaf.movedim(0, d).contiguous()
                pos += n
        return tree_unflatten(shards, out)

    def reduce_scatter_grads(self, grads: Any) -> Any:
        """Gradients averaged over the ranks: the sharded leaves reduced
        onto this rank's slices, one ``reduce_scatter_tensor`` a bucket;
        the replicated ones all-reduced in full, one ``all_reduce`` a
        bucket (``grad_sync.sync_leaf_buckets``); a frozen leaf's
        ``known_zeros`` becomes a slice-shaped one, no collective."""
        import torch.distributed as dist

        from ray_lightning_tpu_torch.parallel.grad_sync import (
            DEFAULT_BUCKET_BYTES, build_bucket_plan, sync_leaf_buckets,
        )

        leaves = tree_leaves(grads)
        self._check_len(leaves, "gradient tree")
        frozen = tuple(is_known_zeros(g) for g in leaves)
        dtypes = tuple(g.dtype for g in leaves)
        plans = self._grad_plans.get((frozen, dtypes))
        if plans is None:
            live = [i for i in self._order if not frozen[i]]
            sharded = [i for i in live if self.dims[i] is not None]
            repl = [i for i in live if self.dims[i] is None]
            plans = self._grad_plans[frozen, dtypes] = (
                self._buckets(sharded, self.full_shapes, dtypes),
                repl, build_bucket_plan(
                    [self.full_shapes[i] for i in repl], self.world,
                    DEFAULT_BUCKET_BYTES).buckets)
        rs_buckets, repl, repl_buckets = plans
        out = list(leaves)
        for i, (g, d) in enumerate(zip(leaves, self.dims)):
            if frozen[i] and d is not None:
                out[i] = known_zeros(g.narrow(d, 0, g.shape[d] // self.world))
        scatter = _collective("reduce_scatter_single",
                              "reduce_scatter_tensor")
        for idx in rs_buckets:
            flat = self._rank_major([leaves[i] for i in idx],
                                    [self.dims[i] for i in idx])
            part = torch.empty(flat.numel() // self.world, dtype=flat.dtype,
                               device=flat.device)
            scatter(part, flat, op=dist.ReduceOp.SUM)
            part.div_(self.world)
            for i, s in zip(idx, self._unpack_slices(part, idx)):
                out[i] = s
        if repl:
            synced = sync_leaf_buckets([leaves[i] for i in repl],
                                       repl_buckets, self.world)
            for i, g in zip(repl, synced):
                out[i] = g
        return tree_unflatten(grads, out)

    def slice_grads(self, grads: Any) -> Any:
        """This rank's slices of gradients every rank holds in full,
        synced already: no collective (a frozen leaf's ``known_zeros``
        becomes a slice-shaped one)."""
        leaves = tree_leaves(grads)
        self._check_len(leaves, "gradient tree")
        return tree_unflatten(grads, [
            g if d is None else (
                known_zeros(g.narrow(d, 0, g.shape[d] // self.world))
                if is_known_zeros(g) else self._slice(g, d))
            for g, d in zip(leaves, self.dims)])

    def norm_sq(self, leaves: List[torch.Tensor]) -> torch.Tensor:
        """The clip's squared global norm over an update tree of slices
        (the ``norm_sq`` a ZeRO step hands ``models.optim``'s
        transformations): each leaf's sum of
        squares in order, the sharded leaves' summed over the ranks by one
        all-reduce, then added up in leaf order as the one-device clip
        adds them."""
        import torch.distributed as dist

        self._check_len(leaves, "update tree")
        sums = [None if is_known_zeros(t) else torch.sum(t * t)
                for t in leaves]
        shard_idx = [i for i, (s, d) in enumerate(zip(sums, self.dims))
                     if s is not None and d is not None]
        if shard_idx:
            stacked = torch.stack([sums[i] for i in shard_idx])
            dist.all_reduce(stacked, op=dist.ReduceOp.SUM)
            for i, v in zip(shard_idx, stacked.unbind()):
                sums[i] = v
        return sum(s for s in sums if s is not None)

    # -- optimizer state ----------------------------------------------------
    def opt_dims(self, opt_state: Any, sharded: bool) -> List[Optional[int]]:
        """The dim each optimizer-state leaf shards along: its param's, by
        key-path suffix and shape (``sharded``: the state holds slices, so
        the slice shape must match; else the full shape), else None."""
        if _has_quantized(opt_state):
            raise NotImplementedError(
                "int8 optimizer moments under ZeRO are not ported: a rank's "
                "slice of a param does not hold whole codec blocks of the "
                "flat moment (ROADMAP Queue 1 item 2.3); use opt_state_dtype "
                "None, 'float32' or 'bfloat16' with RayShardedStrategy")
        dims = []
        for path, leaf in leaves_with_paths(opt_state):
            shape = tuple(getattr(leaf, "shape", ()))
            dim = None
            for k in range(len(path)):
                i = self._by_path.get(path[k:])
                if i is None:
                    continue
                want = self.shard_shape(i) if sharded else self.full_shapes[i]
                if want == shape:
                    dim = self.dims[i]
                    break
            else:
                if (shape and math.prod(shape) >= self.min_leaf_size
                        and shard_leaf_spec(shape, self.world,
                                            self.min_leaf_size) is not None):
                    raise NotImplementedError(
                        f"optimizer-state leaf {path} of shape {shape} has "
                        f"no parameter twin; ZeRO shards only moments that "
                        f"mirror a parameter (ROADMAP Queue 1 item 2.3)")
            dims.append(dim)
        return dims

    def shard_opt_state(self, opt_state: Any) -> Any:
        """This rank's slices of a full optimizer state (a resumed one)."""
        dims = self.opt_dims(opt_state, sharded=False)
        leaves = tree_leaves(opt_state)
        return tree_unflatten(opt_state, [self._slice(t, d, own=True)
                                          for t, d in zip(leaves, dims)])

    def gather_opt_state(self, opt_state: Any) -> Any:
        """The full optimizer state from every rank's slices."""
        dims = self.opt_dims(opt_state, sharded=True)
        leaves = tree_leaves(opt_state)
        return tree_unflatten(opt_state, [
            t if d is None else self._gather(t, d)
            for t, d in zip(leaves, dims)])

    def _check_len(self, leaves: Sequence, what: str) -> None:
        if len(leaves) != len(self.dims):
            raise ValueError(
                f"ZeRO plan: the {what} has {len(leaves)} leaves where the "
                f"params have {len(self.dims)}; a transformation that "
                f"reshapes the tree before the clip is not supported under "
                f"RayShardedStrategy")
