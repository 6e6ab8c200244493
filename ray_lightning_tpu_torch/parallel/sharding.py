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
moments ``mu``/``nu`` and ``multi_steps``' ``acc_grads`` of a param); an
int8 moment's payload ``q`` and ``scale`` have no twin and take the leaf
rule themselves, so a rank holds a contiguous run of the flat payload.
Such a param is updated as its flat padded vector (the plan's update
layout, :meth:`ZeroPlan.set_moment_layout`): the rank's run of its
gradient, param and moments is one range.  On a ``data`` x ``fsdp`` mesh
the plan shards over the rank's ``fsdp`` group (``mesh.zero_groups``).
The JAX ``make_global_batch`` has no counterpart: each rank's loader
yields its own rows (``core.data.NumpyLoader.set_shard``).

Under model axes (``tensor``, ``expert``) a rank's leaves are already its
slices of the global arrays (:class:`ModelPlan`, by the module's
``param_partition_specs``), and ZeRO shards those local leaves over the
ZeRO axis among the ranks with the same model coordinates
(``mesh.zero_groups``).  The clip's global norm then sums each sharded
leaf's squares over the group it is sharded over and counts each
replicated leaf once (:meth:`ModelPlan.reduce_sums`, which the ZeRO
plan's :meth:`ZeroPlan.norm_sq` applies too).
"""

from __future__ import annotations

import math
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.models.optim import (
    MaskedNode, is_known_zeros, known_zeros, tree_leaves, tree_unflatten,
)
from ray_lightning_tpu_torch.ops.optim_quant import (
    BlockQuantized, MomentShard,
)

__all__ = ["MIN_LEAF_SIZE", "shard_leaf_spec", "leaves_with_paths",
           "has_quantized", "ZeroPlan", "ModelPlan"]

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


def _quantized_nodes(tree: Any, path: Tuple = ()
                     ) -> Iterator[Tuple[Tuple, BlockQuantized]]:
    """``(key path, node)`` of each ``BlockQuantized`` node of ``tree``."""
    if isinstance(tree, BlockQuantized):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _quantized_nodes(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _quantized_nodes(v, path + (i,))


def has_quantized(tree: Any) -> bool:
    """Whether ``tree`` holds an int8 ``BlockQuantized`` moment."""
    return next(_quantized_nodes(tree), None) is not None


def _opt_leaves(tree: Any, path: Tuple = ()
                ) -> Iterator[Tuple[Tuple, Any, Optional[BlockQuantized]]]:
    """``(key path, leaf, its BlockQuantized node or None)`` in
    :func:`leaves_with_paths` order."""
    if isinstance(tree, BlockQuantized):
        yield path + ("q",), tree.q, tree
        yield path + ("scale",), tree.scale, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _opt_leaves(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _opt_leaves(v, path + (i,))
    elif not isinstance(tree, MaskedNode):
        yield path, tree, None


class ZeroPlan:
    """The per-leaf ZeRO plan of one params tree over a process group:
    ``dims[i]``, the dim leaf ``i`` (in ``tree_leaves`` order) shards
    along, or None.  ``stage`` 1 or 3.  Every collective method is run by
    every rank at the same point.

    ``rank`` and ``world_size`` are this rank's place in, and the size
    of, the group the state is sharded over: ``group`` (None, the
    default group: every rank), or on a ``data`` × ``fsdp`` mesh the
    rank's ``fsdp`` group, each slice then held alike by the
    ``replicas`` ranks of its ``data_group`` (the JAX
    ``default_zero_axis``: ZeRO shards over ``fsdp``, replicated along
    ``data``).  A gradient is the mean over every rank: reduce-scattered
    within the ``fsdp`` group, its slices all-reduced across the ``data``
    group, then divided by ``world_size · replicas``.

    The update layout (:meth:`set_moment_layout`): a param whose AdamW
    moments are int8 (``ops.optim_quant.BlockQuantized``) and whose
    payload shards (``flat[i]``) is updated as its flat padded vector,
    ``ushapes[i] = (padded,)`` along ``udims[i] = 0``, so a rank's run of
    the gradient, the param and the moments is one range; one whose
    payload does not shard is updated whole (``udims[i]`` None).  Every
    other leaf is updated in its stored layout (``udims == dims``)."""

    def __init__(self, params: Any, stage: int, rank: int, world_size: int,
                 min_leaf_size: int = MIN_LEAF_SIZE, group: Any = None,
                 replicas: int = 1, data_group: Any = None,
                 model: Optional["ModelPlan"] = None,
                 replica_group: Any = None):
        if stage not in (1, 3):
            raise ValueError(f"zero stage must be 1 or 3, got {stage}")
        self.stage = stage
        self.rank = rank
        self.world = world_size
        self.group = group
        self.replicas = replicas
        self.data_group = data_group
        self.model = model
        # The group the unsharded leaves' gradients are averaged over: the
        # ZeRO group with its replicas (None: every rank; under model axes
        # the rank's replica group).
        self.replica_group = replica_group
        pairs = list(leaves_with_paths(params))
        self.paths = [p for p, _ in pairs]
        self.full_shapes = [tuple(t.shape) for _, t in pairs]
        self.dims = [shard_leaf_spec(s, world_size, min_leaf_size)
                     for s in self.full_shapes]
        self.udims = list(self.dims)
        self.ushapes = list(self.full_shapes)
        self.flat = [False] * len(self.dims)
        self.min_leaf_size = min_leaf_size
        self._by_path = {p: i for i, p in enumerate(self.paths)}
        self._order = sorted(range(len(self.paths)), key=lambda i: tuple(
            str(k) for k in self.paths[i]))
        # (the frozen leaves' mask, the leaves' dtypes) -> the step's
        # bucket plans: the sharded leaves' reduce-scatter buckets and the
        # replicated leaves' all-reduce buckets.  (The layout, the leaves'
        # dtypes) -> the all-gather's buckets.  A bucket never mixes
        # dtypes.
        self._grad_plans: dict = {}
        self._gather_plans: dict = {}

    @property
    def relayout(self) -> bool:
        """Whether some leaf is updated in another layout than stored."""
        return self.udims != self.dims or any(self.flat)

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

    def _as_update(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """A whole leaf in its update layout (a flat leaf: flattened and
        zero-padded to its payload's length)."""
        if not self.flat[i]:
            return t
        flat = t.reshape(-1)
        pad = self.ushapes[i][0] - flat.numel()
        return torch.nn.functional.pad(flat, (0, pad)) if pad else flat

    def _from_update(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """A whole leaf in its update layout back in its own shape."""
        if not self.flat[i]:
            return t
        return t[:math.prod(self.full_shapes[i])].view(self.full_shapes[i])

    def update_view(self, tree: Any) -> Any:
        """This rank's runs, in the update layout, of a tree of whole
        leaves."""
        leaves = tree_leaves(tree)
        self._check_len(leaves, "tree")
        return tree_unflatten(tree, [
            self._slice(self._as_update(t, i), self.udims[i])
            for i, t in enumerate(leaves)])

    def set_moment_layout(self, opt_state: Any) -> None:
        """The update layout of the params whose AdamW moments
        ``opt_state`` (whole or this rank's) holds as int8
        ``BlockQuantized`` nodes."""
        for path, bq in _quantized_nodes(opt_state):
            i = self._param_of(path, bq.shape)
            if i is None:
                continue
            if shard_leaf_spec((bq.padded,), self.world,
                               self.min_leaf_size) == 0:
                self.flat[i] = True
                self.ushapes[i] = (bq.padded,)
                self.udims[i] = 0
            else:
                self.udims[i] = None
        self._grad_plans.clear()
        self._gather_plans.clear()

    def _param_of(self, path: Tuple, shape: Tuple[int, ...]
                  ) -> Optional[int]:
        """The param whose key path ``path`` ends with, of ``shape``."""
        for k in range(len(path)):
            i = self._by_path.get(path[k:])
            if i is not None and self.full_shapes[i] == tuple(shape):
                return i
        return None

    # -- collectives on params-shaped trees ---------------------------------
    def _gather(self, s: torch.Tensor, d: int) -> torch.Tensor:
        x = (s if d == 0 else s.movedim(d, 0)).contiguous()
        out = torch.empty((x.shape[0] * self.world, *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _collective("all_gather_single", "all_gather_into_tensor")(
            out, x, group=self.group)
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
        """This rank's slices (update layout) of a bucket's leaves out of
        its flat run."""
        out, pos = [], 0
        for i in idx:
            d = self.udims[i]
            shape = list(self.ushapes[i])
            shape[d] //= self.world
            moved = [shape[d]] + shape[:d] + shape[d + 1:]
            n = math.prod(moved)
            part = flat[pos:pos + n].view(moved)
            out.append(part if d == 0 else part.movedim(0, d).contiguous())
            pos += n
        return out

    def all_gather(self, shards: Any, update: bool = False) -> Any:
        """Full leaves from every rank's slices (a params-shaped tree): one
        ``all_gather_into_tensor`` a bucket of the sharded leaves, over the
        group.  ``update``: the slices are in the update layout (the
        update's new params), else in the stored one."""
        leaves = tree_leaves(shards)
        self._check_len(leaves, "tree")
        dims, shapes = ((self.udims, self.ushapes) if update
                        else (self.dims, self.full_shapes))
        dtypes = tuple(t.dtype for t in leaves)
        plan = self._gather_plans.get((update, dtypes))
        if plan is None:
            sharded = [i for i in self._order if dims[i] is not None]
            plan = self._gather_plans[update, dtypes] = self._buckets(
                sharded, shapes, dtypes)
        out = list(leaves)
        gather = _collective("all_gather_single", "all_gather_into_tensor")
        for idx in plan:
            parts = [leaves[i] for i in idx]
            bdims = [dims[i] for i in idx]
            mine = torch.cat([(t if d == 0 else t.movedim(d, 0)).reshape(-1)
                              for t, d in zip(parts, bdims)])
            full = torch.empty(mine.numel() * self.world, dtype=mine.dtype,
                               device=mine.device)
            gather(full, mine, group=self.group)
            rows = full.view(self.world, -1)
            pos = 0
            for i, t, d in zip(idx, parts, bdims):
                n = t.numel()
                shape = list(shapes[i])
                moved = [shape[d]] + shape[:d] + shape[d + 1:]
                leaf = rows[:, pos:pos + n].reshape(moved)
                out[i] = leaf if d == 0 else leaf.movedim(0, d).contiguous()
                pos += n
        if update:
            out = [self._from_update(t, i) for i, t in enumerate(out)]
        return tree_unflatten(shards, out)

    def to_storage(self, tree: Any) -> Any:
        """A params-shaped tree in the update layout (a stage-3 update's
        new params, the accumulators) in the stored layout: a flat leaf's
        runs gathered over the group (one ``all_gather_into_tensor`` a
        leaf), a whole leaf sliced; the rest as they are."""
        leaves = tree_leaves(tree)
        self._check_len(leaves, "tree")
        out = list(leaves)
        for i, t in enumerate(leaves):
            if self.flat[i]:
                t = self._from_update(self._gather(t, 0), i)
            elif self.udims[i] == self.dims[i]:
                continue
            out[i] = self._slice(t, self.dims[i], own=True)
        return tree_unflatten(tree, out)

    def to_update(self, tree: Any) -> Any:
        """A params-shaped tree of this rank's stored slices in the update
        layout: a leaf laid out otherwise gathered whole over the group
        (one ``all_gather_into_tensor`` a leaf), then cut into its run."""
        leaves = tree_leaves(tree)
        self._check_len(leaves, "tree")
        out = list(leaves)
        for i, t in enumerate(leaves):
            if not self.flat[i] and self.udims[i] == self.dims[i]:
                continue
            if self.dims[i] is not None:
                t = self._gather(t, self.dims[i])
            out[i] = self._slice(self._as_update(t, i), self.udims[i],
                                 own=True)
        return tree_unflatten(tree, out)

    def opt_to_update(self, opt_state: Any) -> Any:
        """An optimizer state with ``multi_steps``' accumulators (kept in
        the params' stored layout, as the JAX package keeps them) in the
        update layout, for the update; :meth:`opt_to_storage` puts them
        back."""
        if (not self.relayout or not isinstance(opt_state, dict)
                or "acc_grads" not in opt_state):
            return opt_state
        return {**opt_state, "acc_grads": self.to_update(
            opt_state["acc_grads"])}

    def opt_to_storage(self, opt_state: Any) -> Any:
        if (not self.relayout or not isinstance(opt_state, dict)
                or "acc_grads" not in opt_state):
            return opt_state
        return {**opt_state, "acc_grads": self.to_storage(
            opt_state["acc_grads"])}

    def reduce_scatter_grads(self, grads: Any) -> Any:
        """Gradients averaged over every rank, in the update layout: the
        sharded leaves reduced onto this rank's slices, one
        ``reduce_scatter_tensor`` a bucket over the group (and, with
        replicas along ``data``, one ``all_reduce`` of the slices across
        the data group); the replicated ones all-reduced in full over
        every rank, one ``all_reduce`` a bucket
        (``grad_sync.sync_leaf_buckets``); a frozen leaf's
        ``known_zeros`` becomes a slice-shaped one, no collective."""
        import torch.distributed as dist

        from ray_lightning_tpu_torch.parallel.grad_sync import (
            DEFAULT_BUCKET_BYTES, build_bucket_plan, sync_leaf_buckets,
        )

        leaves = tree_leaves(grads)
        self._check_len(leaves, "gradient tree")
        total = self.world * self.replicas
        frozen = tuple(is_known_zeros(g) for g in leaves)
        dtypes = tuple(g.dtype for g in leaves)
        plans = self._grad_plans.get((frozen, dtypes))
        if plans is None:
            live = [i for i in self._order if not frozen[i]]
            sharded = [i for i in live if self.udims[i] is not None]
            repl = [i for i in live if self.udims[i] is None]
            plans = self._grad_plans[frozen, dtypes] = (
                self._buckets(sharded, self.ushapes, dtypes),
                repl, build_bucket_plan(
                    [self.ushapes[i] for i in repl], total,
                    DEFAULT_BUCKET_BYTES).buckets)
        rs_buckets, repl, repl_buckets = plans
        out = list(leaves)
        for i, (g, d) in enumerate(zip(leaves, self.udims)):
            if frozen[i] and d is not None:
                out[i] = known_zeros(g.narrow(d, 0, g.shape[d] // self.world))
        scatter = _collective("reduce_scatter_single",
                              "reduce_scatter_tensor")
        for idx in rs_buckets:
            flat = self._rank_major([self._as_update(leaves[i], i)
                                     for i in idx],
                                    [self.udims[i] for i in idx])
            part = torch.empty(flat.numel() // self.world, dtype=flat.dtype,
                               device=flat.device)
            scatter(part, flat, op=dist.ReduceOp.SUM, group=self.group)
            if self.data_group is not None:
                dist.all_reduce(part, op=dist.ReduceOp.SUM,
                                group=self.data_group)
            part.div_(total)
            for i, s in zip(idx, self._unpack_slices(part, idx)):
                out[i] = s
        if repl:
            synced = sync_leaf_buckets([leaves[i] for i in repl],
                                       repl_buckets, total,
                                       self.replica_group)
            for i, g in zip(repl, synced):
                out[i] = g
        return tree_unflatten(grads, out)

    def slice_grads(self, grads: Any) -> Any:
        """This rank's slices (update layout) of gradients every rank
        holds in full, synced already: no collective (a frozen leaf's
        ``known_zeros`` becomes a slice-shaped one)."""
        leaves = tree_leaves(grads)
        self._check_len(leaves, "gradient tree")
        return tree_unflatten(grads, [
            g if d is None else (
                known_zeros(g.narrow(d, 0, g.shape[d] // self.world))
                if is_known_zeros(g) else self._slice(self._as_update(g, i),
                                                      d))
            for i, (g, d) in enumerate(zip(leaves, self.udims))])

    def norm_sq(self, leaves: List[torch.Tensor]) -> torch.Tensor:
        """The clip's squared global norm over an update tree of slices
        (the ``norm_sq`` a ZeRO step hands ``models.optim``'s
        transformations): each leaf's sum of squares in order, the
        sharded leaves' summed over the group by one all-reduce (and under
        model axes over the leaf's model group, :meth:`ModelPlan.
        reduce_sums`), then added up in leaf order as the one-device clip
        adds them."""
        import torch.distributed as dist

        self._check_len(leaves, "update tree")
        sums = [None if is_known_zeros(t) else torch.sum(t * t)
                for t in leaves]
        shard_idx = [i for i, (s, d) in enumerate(zip(sums, self.udims))
                     if s is not None and d is not None]
        if shard_idx:
            stacked = torch.stack([sums[i] for i in shard_idx])
            dist.all_reduce(stacked, op=dist.ReduceOp.SUM, group=self.group)
            for i, v in zip(shard_idx, stacked.unbind()):
                sums[i] = v
        if self.model is not None:
            sums = self.model.reduce_sums(sums)
        return sum(s for s in sums if s is not None)

    # -- optimizer state ----------------------------------------------------
    def _codec_dim(self, bq: BlockQuantized, payload: bool) -> Optional[int]:
        """The dim a ``BlockQuantized`` moment's ``q`` (``payload``) or
        ``scale`` shards along: the JAX rule for a leaf with no param twin
        (``shard_leaf_spec`` of its 1-D global shape)."""
        n = bq.padded if payload else bq.padded // bq.block_size
        return shard_leaf_spec((n,), self.world, self.min_leaf_size)

    def opt_dims(self, opt_state: Any, sharded: bool) -> List[Optional[int]]:
        """The dim each optimizer-state leaf shards along: its param's, by
        key-path suffix and shape (``sharded``: the state holds slices, so
        the slice shape must match; else the full shape); an int8
        moment's payload and scale as :meth:`_codec_dim`; else None."""
        dims = []
        for path, leaf, bq in _opt_leaves(opt_state):
            if bq is not None:
                dims.append(self._codec_dim(bq, leaf is bq.q))
                continue
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
                        f"mirror a parameter and int8 moments' payloads "
                        f"and scales")
            dims.append(dim)
        return dims

    def _sync_amax(self, t: torch.Tensor) -> None:
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)

    def attach_moment_shards(self, opt_state: Any) -> Any:
        """Mark each int8 moment of a state of this rank's slices with its
        run (``BlockQuantized.shard``), where its payload shards."""
        for _, bq in _quantized_nodes(opt_state):
            bq.shard = None
            if self._codec_dim(bq, True) == 0:
                scale_sharded = self._codec_dim(bq, False) == 0
                bq.shard = MomentShard(
                    self.rank * bq.q.numel(), scale_sharded,
                    None if scale_sharded else self._sync_amax)
        return opt_state

    def shard_opt_state(self, opt_state: Any) -> Any:
        """This rank's slices of a full optimizer state (a resumed one)."""
        dims = self.opt_dims(opt_state, sharded=False)
        leaves = tree_leaves(opt_state)
        return self.attach_moment_shards(tree_unflatten(opt_state, [
            self._slice(t, d, own=True) for t, d in zip(leaves, dims)]))

    def gather_opt_state(self, opt_state: Any) -> Any:
        """The full optimizer state from every rank's slices."""
        dims = self.opt_dims(opt_state, sharded=True)
        leaves = tree_leaves(opt_state)
        full = tree_unflatten(opt_state, [
            t if d is None else self._gather(t, d)
            for t, d in zip(leaves, dims)])
        for _, bq in _quantized_nodes(full):
            bq.shard = None
        return full

    def _check_len(self, leaves: Sequence, what: str) -> None:
        if len(leaves) != len(self.dims):
            raise ValueError(
                f"ZeRO plan: the {what} has {len(leaves)} leaves where the "
                f"params have {len(self.dims)}; a transformation that "
                f"reshapes the tree before the clip is not supported under "
                f"RayShardedStrategy")


class ModelPlan:
    """The model-parallel layout of a params tree on one rank: each leaf's
    partition spec (``GPT.param_partition_specs``, a tuple of axis names
    or None), its global and local shapes, and the group its squares are
    summed over in the clip's norm (the rank's group over the ``tensor``
    and ``expert`` axes its spec names; None for a replicated leaf).
    ``mp`` is the rank's ``parallel.model_parallel.ModelParallel``.

    :meth:`shard` and :meth:`gather` cut a params-shaped tree to the
    rank's slices and put it back (``models/convert.py::shard_leaf``,
    ``gather_leaf``); :meth:`gather_opt_state` does the same for the
    optimizer moments, matched to their param by key-path suffix and
    shape, as ``ZeroPlan`` matches them."""

    def __init__(self, params: Any, specs: Any, mp: Any):
        from ray_lightning_tpu_torch.models.convert import (
            HEAD_ALIGNED, shard_leaf, spec_of,
        )

        self.mp = mp
        pairs = list(leaves_with_paths(params))
        self.paths = [p for p, _ in pairs]
        self.specs = [spec_of(specs, p) for p in self.paths]
        self.head = [p[-1] in HEAD_ALIGNED for p in self.paths]
        self.full_shapes = [tuple(t.shape) for _, t in pairs]
        self.local_shapes = [tuple(shard_leaf(
            torch.empty(shape, device="meta"), spec, mp, ha).shape)
            for shape, spec, ha in zip(self.full_shapes, self.specs,
                                       self.head)]
        self.norm_groups = [self._norm_group(spec) for spec in self.specs]
        self._by_path = {p: i for i, p in enumerate(self.paths)}

    def _norm_group(self, spec: Tuple) -> Any:
        axes = {a for a in spec if a in ("tensor", "expert")
                and self.mp.axis(a).size > 1}
        if axes == {"tensor", "expert"}:
            return self.mp.expert_tensor
        return self.mp.axis(axes.pop()) if axes else None

    def shard(self, tree: Any) -> Any:
        """This rank's slices of a full params-shaped tree."""
        from ray_lightning_tpu_torch.models.convert import shard_leaf

        leaves = tree_leaves(tree)
        return tree_unflatten(tree, [
            shard_leaf(t, spec, self.mp, ha)
            for t, spec, ha in zip(leaves, self.specs, self.head)])

    def gather(self, tree: Any) -> Any:
        """The full tree from every rank's slices (a collective)."""
        from ray_lightning_tpu_torch.models.convert import gather_leaf

        leaves = tree_leaves(tree)
        return tree_unflatten(tree, [
            gather_leaf(t, spec, self.mp, ha)
            for t, spec, ha in zip(leaves, self.specs, self.head)])

    def _param_of(self, path: Tuple, shape: Tuple,
                  shapes: List[Tuple]) -> Optional[int]:
        """The param whose key path ``path`` ends with, of ``shape`` in
        ``shapes`` (the local or the global shapes)."""
        for k in range(len(path)):
            i = self._by_path.get(path[k:])
            if i is not None and shapes[i] == tuple(shape):
                return i
        return None

    def gather_opt_state(self, opt_state: Any) -> Any:
        """The optimizer state with each moment of a sharded param
        gathered to its global shape (a collective)."""
        from ray_lightning_tpu_torch.models.convert import gather_leaf

        if has_quantized(opt_state):
            raise NotImplementedError(
                "int8 optimizer moments under model axes are not ported "
                "(ROADMAP Queue 1 item 3)")
        out = []
        for path, leaf in leaves_with_paths(opt_state):
            i = self._param_of(path, tuple(getattr(leaf, "shape", ())),
                               self.local_shapes)
            out.append(leaf if i is None or self.local_shapes[i]
                       == self.full_shapes[i] else gather_leaf(
                           leaf, self.specs[i], self.mp, self.head[i]))
        return tree_unflatten(opt_state, out)

    def shard_opt_state(self, opt_state: Any) -> Any:
        """This rank's slices of a global optimizer state (a resumed
        one): each moment of a sharded param cut as its param."""
        from ray_lightning_tpu_torch.models.convert import shard_leaf

        if has_quantized(opt_state):
            raise NotImplementedError(
                "int8 optimizer moments under model axes are not ported "
                "(ROADMAP Queue 1 item 3)")
        out = []
        for path, leaf in leaves_with_paths(opt_state):
            i = self._param_of(path, tuple(getattr(leaf, "shape", ())),
                               self.full_shapes)
            out.append(leaf if i is None else shard_leaf(
                leaf, self.specs[i], self.mp, self.head[i]))
        return tree_unflatten(opt_state, out)

    def reduce_sums(self, sums: List[Optional[torch.Tensor]]
                    ) -> List[Optional[torch.Tensor]]:
        """Each leaf's sum of squares summed over its model group (one
        all-reduce a group, of the stacked sums of its leaves); the
        replicated leaves' left as they are, counted once."""
        import torch.distributed as dist

        out = list(sums)
        groups: dict = {}
        for i, g in enumerate(self.norm_groups):
            if g is not None and out[i] is not None:
                groups.setdefault(g.ranks, (g, []))[1].append(i)
        for g, idx in groups.values():
            stacked = torch.stack([out[i] for i in idx])
            dist.all_reduce(stacked, op=dist.ReduceOp.SUM, group=g.group)
            for i, v in zip(idx, stacked.unbind()):
                out[i] = v
        return out

    def norm_sq(self, leaves: List[torch.Tensor]) -> torch.Tensor:
        """The clip's squared global norm over a tree of this rank's
        slices (every leaf a whole slice: no ZeRO)."""
        if len(leaves) != len(self.specs):
            raise ValueError(
                f"model plan: the update tree has {len(leaves)} leaves "
                f"where the params have {len(self.specs)}")
        sums = [None if is_known_zeros(t) else torch.sum(t * t)
                for t in leaves]
        return sum(s for s in self.reduce_sums(sums) if s is not None)
