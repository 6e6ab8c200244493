"""Gradient synchronisation of the data-parallel flavors
(``ray_lightning_tpu/parallel/grad_sync.py``).

Each rank's gradients are of the mean loss over its own rows; averaged
over the ranks they are the gradients of the mean over the global batch,
which the JAX step computes as one program.  Full width (``grad_comm``
None or ``"full"``, the default):

* :class:`BucketSync` (``RayStrategy``): the synced leaves, in the JAX
  package's tree order (dict keys sorted), packed into buckets by
  :func:`build_bucket_plan` (``bucket_bytes`` of f32 footprint, 4 MiB by
  default; a larger leaf gets its own bucket), one ``all_reduce`` a bucket
  over its flat f32 vector, then divided by the world size;
* :class:`LeafSync` (``HorovodRayStrategy``): one ``all_reduce`` a leaf,
  no buckets (the JAX ``shard_map`` flavor's per-leaf ``pmean``).

The int8 wire (``grad_comm="int8"`` or ``"int8_ef"``, a
:class:`GradCommConfig`): :class:`GradSync`, built by
:func:`maybe_build_grad_sync` against the real world size, flavor and
ZeRO stage, with the JAX package's downgrades and their words.  As in the
JAX island, each rank differentiates ``loss / n`` and the partials are
*summed* over the wire (``ops/collective_quant.py``), bucket by bucket
(:func:`sync_leaf_buckets_int8`): the codec quantizes the ``g / n``
partial, and the error-feedback residual (``int8_ef``,
``TrainState.grad_residual``: this rank's own f32 row of
``plan.total_padded``) is carried in those units and added to the next
step's partial before it is quantized.  With ``grad_overlap_segments=G``
the sync runs inside the backward, a group of params at a time
(``parallel/overlap.py``).

Only the leaves ``module.trainable`` marks are synced at full width: a
frozen leaf's gradient is ``models.optim.known_zeros`` and stays so.  The
int8 plan covers every leaf, as JAX's does; a frozen leaf rides its
buckets as zeros (which quantize exactly) and comes back
``known_zeros``.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.models.optim import (
    is_known_zeros, tree_leaves, tree_unflatten,
)

__all__ = ["GradCommConfig", "Bucket", "BucketPlan", "build_bucket_plan",
           "jax_order", "sync_leaf_buckets", "sync_leaf_buckets_int8",
           "BucketSync", "LeafSync", "GradSync", "maybe_build_grad_sync",
           "warn_residual_dropped",
           "DEFAULT_BUCKET_BYTES"]

DEFAULT_BUCKET_BYTES = 4 * 2 ** 20
_MODES = ("full", "int8", "int8_ef")


@dataclasses.dataclass(frozen=True)
class GradCommConfig:
    """The gradient wire's knobs (the JAX ``GradCommConfig``): ``mode``
    ``"full"`` (the default), ``"int8"`` (block-scaled int8) or
    ``"int8_ef"`` (int8 with the error-feedback residual);
    ``bucket_bytes`` bounds a bucket by its f32 footprint; ``block_size``
    is the elements a scale covers; ``dcn_only`` keeps a world of one
    process at full width (a rank is one process, so that world is the
    one-rank world, which syncs nothing anyway)."""

    mode: str = "full"
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    block_size: int = 256
    dcn_only: bool = True

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(
                f"grad_comm mode {self.mode!r}: expected one of {_MODES}"
            )
        if self.bucket_bytes < 4:
            raise ValueError("bucket_bytes must be >= 4 (one f32)")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")

    @classmethod
    def coerce(cls, value: Any) -> "GradCommConfig":
        """None | str | dict | GradCommConfig → GradCommConfig.  ``None``
        reads ``RLT_GRAD_COMM`` (forwarded to the workers), else full
        width; ``RLT_GRAD_BUCKET_MB``, ``RLT_GRAD_BLOCK`` and
        ``RLT_GRAD_DCN_ONLY`` fill the fields the value leaves unset."""
        if isinstance(value, cls):
            return value
        if value is None:
            value = os.environ.get("RLT_GRAD_COMM") or "full"
        if isinstance(value, str):
            kw: dict = {"mode": value}
        elif isinstance(value, dict):
            kw = dict(value)
            if "mode" not in kw:
                # A dict without a mode would silently coerce to full
                # width where the user meant to choose compression.
                raise ValueError(
                    "grad_comm dict must name a 'mode' "
                    f"(one of {_MODES}); got keys {sorted(kw)}"
                )
        else:
            raise TypeError(
                f"grad_comm must be a mode string, dict or GradCommConfig; "
                f"got {type(value).__name__}"
            )
        env_mb = os.environ.get("RLT_GRAD_BUCKET_MB")
        if env_mb and "bucket_bytes" not in kw:
            kw["bucket_bytes"] = int(float(env_mb) * 2**20)
        env_block = os.environ.get("RLT_GRAD_BLOCK")
        if env_block and "block_size" not in kw:
            kw["block_size"] = int(env_block)
        env_dcn = os.environ.get("RLT_GRAD_DCN_ONLY")
        if env_dcn is not None and "dcn_only" not in kw:
            kw["dcn_only"] = env_dcn not in ("0", "false", "False", "")
        return cls(**kw)


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

    def wire_bytes_per_step(self, mode: str) -> int:
        """The JAX package's analytic bytes a rank puts on the wire a
        step: ring accounting, ``2(n-1)/n`` traversals of the payload
        (reduce-scatter + all-gather), for the int8 wire (payload and
        scales) and the full-width counterfactual alike."""
        n = self.n_shards
        if n <= 1:
            return 0
        ring = 2.0 * (n - 1) / n
        if mode == "full":
            return int(ring * self.full_width_bytes)
        payload = sum(b.padded for b in self.buckets)
        scales = sum(b.padded // self.block_size for b in self.buckets) * 4
        return int(ring * (payload + scales))

    def collectives_per_step(self, mode: str) -> int:
        if mode == "full":
            return max(self.num_buckets, 1)
        return 4 * self.num_buckets  # (all_to_all + all_gather) x (q, s)


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
                      world_size: int, group: Any = None
                      ) -> List[torch.Tensor]:
    """The full-width path of the JAX ``sync_leaf_buckets``: each bucket's
    leaves flattened into one f32 vector, all-reduced (sum) over ``group``
    (None: every rank) and divided by ``world_size`` (its size), then cut
    back into the leaves' shapes and dtypes."""
    import torch.distributed as dist

    out = list(leaves)
    for b in buckets:
        parts = [leaves[i].reshape(-1).float() for i in b.indices]
        flat = torch.cat(parts) if len(parts) > 1 else parts[0].clone()
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
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
    from that tree's shapes), one ``all_reduce`` a bucket over ``group``
    of ``world_size`` ranks (None: every rank; under model axes the
    rank's replica group, the ranks holding the same slices: each leaf
    is synced over the ranks that hold the same slice of it)."""

    def __init__(self, world_size: int,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES, group: Any = None):
        self.world = world_size
        self.group = group
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
                                   self.plan.buckets, self.world, self.group)
        out = list(leaves)
        for i, g in zip(self._synced, synced):
            out[i] = g
        return tree_unflatten(grads, out)


class LeafSync:
    """``HorovodRayStrategy``'s gradient sync: one ``all_reduce`` a synced
    leaf over ``group`` (as :class:`BucketSync`'s), in JAX tree order,
    then divided by its size."""

    def __init__(self, world_size: int, group: Any = None):
        self.world = world_size
        self.group = group

    def __call__(self, grads: Any) -> Any:
        import torch.distributed as dist

        leaves = tree_leaves(grads)
        out = list(leaves)
        for i in jax_order(grads):
            g = leaves[i]
            if is_known_zeros(g):
                continue
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=self.group)
            out[i] = g.div_(self.world)
        return tree_unflatten(grads, out)


def sync_leaf_buckets_int8(leaves: List[torch.Tensor],
                           buckets: Sequence[Bucket], n: int,
                           block_size: int,
                           resid: Optional[torch.Tensor] = None,
                           out: Optional[torch.Tensor] = None,
                           resid_out: Optional[torch.Tensor] = None
                           ) -> Tuple[List[Optional[torch.Tensor]],
                                      Optional[torch.Tensor]]:
    """The int8 path of the JAX ``sync_leaf_buckets``, the one sync both
    schedules share (the step end, and each tap group mid-backward):
    each bucket's leaves (``leaves``: this rank's partials in plan order)
    flattened into one f32 vector, zero-padded to ``b.padded``, the
    residual's slice added (``resid``: error feedback; bucket offsets are
    local to it), summed over the ``n`` ranks of the default group through
    ``ops.collective_quant.int8_all_reduce``.  The reduced vectors land in
    ``out`` (a flat f32 buffer of the plan's padded length, made when
    None) and the new residual in ``resid_out`` likewise.  Returns the
    synced leaves (views of ``out``, in the leaves' dtypes; None where a
    leaf is empty) and the new residual (None without EF)."""
    from ray_lightning_tpu_torch.ops.collective_quant import int8_all_reduce

    total = buckets[-1].offset + buckets[-1].padded if buckets else 0
    device = leaves[buckets[0].indices[0]].device if buckets else None
    if out is None:
        out = torch.empty(total, dtype=torch.float32, device=device)
    if resid is not None and resid_out is None:
        resid_out = torch.empty(total, dtype=torch.float32, device=device)
    synced: List[Optional[torch.Tensor]] = [None] * len(leaves)
    for b in buckets:
        parts = [leaves[i].reshape(-1).float() for i in b.indices]
        flat = torch.cat(parts) if len(parts) > 1 else parts[0]
        if b.padded > b.size:
            flat = torch.nn.functional.pad(flat, (0, b.padded - b.size))
        if resid is not None:
            flat = flat + resid[b.offset:b.offset + b.padded]
        reduced, err = int8_all_reduce(flat, None, n, block_size,
                                       want_error=resid is not None)
        out[b.offset:b.offset + b.padded].copy_(reduced)
        if resid is not None:
            resid_out[b.offset:b.offset + b.padded].copy_(err)
        pos = b.offset
        for i, sz in zip(b.indices, b.sizes):
            synced[i] = out[pos:pos + sz].view(leaves[i].shape).to(
                leaves[i].dtype)
            pos += sz
    return synced, (resid_out if resid is not None else None)


def warn_residual_dropped(got: Tuple[int, ...], n_shards: int,
                          want: Optional[Tuple[int, ...]],
                          telemetry: Any = None) -> None:
    """A checkpoint's error-feedback residual dropped at a world-size
    change, loudly: the JAX package's warning (``want`` in its layout,
    one row a device; None where this run keeps no residual) and the
    ``grad_residual_dropped`` counter."""
    warnings.warn(
        f"checkpoint error-feedback residual has shape {got} "
        f"but this run syncs over {n_shards} devices "
        f"(want {want}) — the per-device residual does not "
        "survive an elastic world-size change; resetting to "
        "zero (at most one step of compression error is lost)"
    )
    if telemetry is not None:
        telemetry.add_counter("grad_residual_dropped", 1)


class GradSync:
    """A resolved int8 gradient wire for one (module, world): built by
    :func:`maybe_build_grad_sync`, run by ``step_fns.DistributedStep``
    (:meth:`step`) and the fit loop (the residual, the accounting).

    ``plan`` is the step-end :class:`BucketPlan` over every param leaf in
    JAX tree order (``order``: their ``tree_leaves`` positions), or the
    ``overlap.OverlapPlan`` when the sync runs in the backward
    (``overlap``); stats, the residual and its reconciliation read either
    alike.  Every collective runs on the default process group."""

    def __init__(self, module: Any, cfg: GradCommConfig, n_shards: int,
                 plan: BucketPlan, order: List[int], overlap: Any = None):
        self.module = module
        self.cfg = cfg
        self.n_shards = n_shards
        self.order = order
        self.overlap = overlap
        self.plan = overlap if overlap is not None else plan
        self.use_ef = cfg.mode == "int8_ef"
        self._telemetry = None
        # The overlapped sync's side stream (NCCL on a card), made at its
        # first use and kept for the fit.
        self.side_stream = None

    # -- accounting -----------------------------------------------------
    @property
    def bytes_per_step(self) -> int:
        return self.plan.wire_bytes_per_step(self.cfg.mode)

    def stats(self) -> dict:
        full = self.plan.wire_bytes_per_step("full")
        mine = self.bytes_per_step
        return {
            "grad_sync_mode": self.cfg.mode,
            "grad_sync_bytes": mine,
            "grad_sync_bytes_full_width": full,
            "grad_sync_compression_ratio": (
                round(full / mine, 3) if mine else None),
            "grad_sync_buckets": self.plan.num_buckets,
            "grad_sync_collectives": self.plan.collectives_per_step(
                self.cfg.mode),
            "grad_sync_block_size": self.plan.block_size,
            "grad_sync_devices": self.n_shards,
            # 0 = step-end sync; G >= 1 = taps over G trunk segments.
            "grad_sync_overlap_segments": (
                self.overlap.trunk_segments if self.overlap is not None
                else 0),
        }

    def register_telemetry(self, telemetry) -> None:
        """The accounting as telemetry counters (numbers) and meta (the
        mode), so ``grad_sync_bytes`` stands in the fleet report beside
        the step times.  (The JAX package also marks the plan with a
        trace instant; the port's telemetry has no spans tier yet.)"""
        self._telemetry = telemetry
        for key, value in self.stats().items():
            if isinstance(value, bool) or value is None:
                telemetry.set_meta(key, value)
            elif isinstance(value, (int, float)):
                telemetry.set_counter(key, value)
            else:
                telemetry.set_meta(key, value)

    # -- error-feedback residual ------------------------------------------
    def init_residual(self, device) -> Optional[torch.Tensor]:
        """This rank's zero residual row (EF), else None."""
        if not self.use_ef:
            return None
        return torch.zeros(self.plan.total_padded, dtype=torch.float32,
                           device=device)

    def attach_residual(self, state):
        """``state`` carrying a zero residual row (EF); others unchanged."""
        from ray_lightning_tpu_torch.core.module import TrainState

        if not self.use_ef:
            return state
        device = tree_leaves(state.params)[0].device
        return TrainState(state.params, state.opt_state, state.step,
                          self.init_residual(device))

    def reconcile_resumed_state(self, state):
        """A resumed state against this run's residual layout: a state
        without a residual (an ``RLTCKPT1`` file never holds one) gets
        zeros under EF; one with a residual sheds it without EF; this
        rank's row of a restart checkpoint of the same world and layout
        resumes as it was; a residual of another shape (another world
        size or overlap layout) is dropped, loudly
        (:func:`warn_residual_dropped`), and reset to zeros, never
        applied as another rank's error history."""
        from ray_lightning_tpu_torch.core.module import TrainState

        resid = getattr(state, "grad_residual", None)
        if not self.use_ef:
            if resid is None:
                return state
            return TrainState(state.params, state.opt_state, state.step)
        got = tuple(getattr(resid, "shape", ()))
        if resid is not None and got == (self.plan.total_padded,):
            return state
        if resid is not None:
            warn_residual_dropped(got, self.n_shards,
                                  (self.n_shards, self.plan.total_padded),
                                  self._telemetry)
        device = tree_leaves(state.params)[0].device
        return TrainState(state.params, state.opt_state, state.step,
                          self.init_residual(device))

    # -- the sync ----------------------------------------------------------
    def step(self, params: Any, residual: Optional[torch.Tensor], batch,
             rng) -> Tuple[Any, dict, Optional[torch.Tensor]]:
        """``(grads, logs, new_residual)`` of one micro-step: the
        gradients of ``loss / n`` on this rank's rows, summed over the
        ranks through the int8 wire (the dequantized world sum: the
        gradients of the global mean loss), at the step end or, with an
        overlap plan, inside the backward (``overlap.tapped_step``);
        ``logs`` this rank's (the caller averages them)."""
        if self.overlap is not None:
            from ray_lightning_tpu_torch.parallel.overlap import tapped_step

            return tapped_step(self, params, residual, batch, rng)
        from ray_lightning_tpu_torch.parallel.step_fns import loss_and_grads

        grads, logs = loss_and_grads(self.module, params, batch, rng,
                                     loss_div=self.n_shards)
        grads, new_resid = self.sync_tree(grads, residual)
        return grads, logs, new_resid

    def sync_tree(self, grads: Any, residual: Optional[torch.Tensor]
                  ) -> Tuple[Any, Optional[torch.Tensor]]:
        """The step-end sync of a tree of partials over the bucket plan
        (the whole tree in JAX order, or, with an overlap plan, group by
        group in the plan's order: ``overlap.sync_groups``)."""
        resid = residual if self.use_ef else None
        if self.overlap is not None:
            from ray_lightning_tpu_torch.parallel.overlap import sync_groups

            return sync_groups(self, grads, resid)
        leaves = tree_leaves(grads)
        ordered = [leaves[i] for i in self.order]
        synced, new_resid = sync_leaf_buckets_int8(
            ordered, self.plan.buckets, self.n_shards, self.plan.block_size,
            resid=resid)
        out = list(leaves)
        for j, i in enumerate(self.order):
            if synced[j] is not None and not is_known_zeros(leaves[i]):
                out[i] = synced[j]
        return tree_unflatten(grads, out), new_resid


def maybe_build_grad_sync(module: Any, cfg: Any, world_size: Optional[int],
                          mode: str = "gspmd", zero_stage: int = 0,
                          params: Any = None, overlap_segments: int = 0
                          ) -> Optional[GradSync]:
    """Resolve a ``grad_comm`` request against the real world (the JAX
    ``maybe_build_grad_sync``): an active :class:`GradSync`, or None (full
    width), every downgrade warned with its reason.  ``world_size`` None
    is no process group (``LocalStrategy``, the JAX mesh None).  The
    layout is batch-only by construction (``mesh.build_mesh``), and a
    world of one process is the one-rank world, which returns None before
    ``dcn_only`` is read.  ``overlap_segments >= 1`` asks for the
    backward-overlapped sync: the module must partition its params
    (``grad_overlap_groups``), else the step-end sync runs, with a
    warning.  ``params``: the params tree (tensors; their shapes make the
    plan)."""
    cfg = GradCommConfig.coerce(cfg)
    if cfg.mode == "full" or world_size is None:
        return None

    def _downgrade(reason: str) -> None:
        warnings.warn(
            f"grad_comm={cfg.mode!r} requested but {reason}; "
            "gradients sync at full width."
        )

    if mode != "gspmd":
        _downgrade(f"step mode {mode!r} is not 'gspmd'")
        return None
    if zero_stage >= 3:
        _downgrade(
            "zero_stage=3 shards params (quantized ZeRO-3 all-gather is "
            "the follow-on, not this path)"
        )
        return None
    n_shards = int(world_size)
    if n_shards <= 1:
        return None  # nothing to sync — not worth a warning
    if params is None:
        params = module.init_params(torch.Generator().manual_seed(0))
    leaves = tree_leaves(params)
    order = jax_order(params)
    plan = build_bucket_plan([tuple(leaves[i].shape) for i in order],
                             n_shards, cfg.bucket_bytes, cfg.block_size)
    if plan.num_buckets == 0:
        _downgrade("the module has no parameters to sync")
        return None
    overlap = None
    if overlap_segments and overlap_segments >= 1:
        from ray_lightning_tpu_torch.parallel import overlap as ovl

        groups_fn = getattr(module, "grad_overlap_groups", None)
        spec = (groups_fn(params, overlap_segments)
                if groups_fn is not None else None)
        if spec is None:
            warnings.warn(
                f"grad_overlap_segments={overlap_segments} requested but "
                f"{type(module).__name__} does not partition its params "
                "(grad_overlap_groups is missing or returned None); "
                "gradients sync at step end."
            )
        else:
            overlap = ovl.build_overlap_plan(spec, n_shards,
                                             cfg.bucket_bytes,
                                             cfg.block_size)
            if overlap.total_elems != plan.total_elems:
                # A partition that misses (or double-counts) params would
                # silently skip their sync: a module bug, refused here.
                raise ValueError(
                    f"grad_overlap_groups covers {overlap.total_elems} "
                    f"elements but the module has {plan.total_elems} — "
                    "the groups must partition the whole param tree"
                )
    return GradSync(module, cfg, n_shards, plan, order, overlap=overlap)
