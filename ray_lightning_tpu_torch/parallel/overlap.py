"""Backward-overlapped gradient sync (``ray_lightning_tpu/parallel/
overlap.py``): the int8 wire of ``parallel/grad_sync.py`` run inside the
backward, a group of params at a time, so a group's collectives go out
while the backward of the groups below it still runs.

* The module partitions its params into groups ordered by when their
  gradients complete in the backward (``module.grad_overlap_groups``;
  the GPT: ``head`` (the final LN), ``seg{G-1}`` ... ``seg0`` (the trunk
  cut into ``G`` segments at ``pipeline.layer_splits`` bounds), ``embed``
  (``wte``, ``wpe``)), and :func:`build_overlap_plan` buckets each group
  with the step-end packer: an :class:`OverlapPlan`, field for field the
  JAX package's, whose accounting reads as a ``BucketPlan``'s.
* A :class:`TapPlane` lives for one differentiation.  Each group's
  params pass through a tap (:class:`_Tap`, a ``torch.autograd.Function``
  whose forward is the identity): the entry groups (top-level keys) by
  :meth:`TapPlane.apply_entry_taps` before ``training_step``, so every
  read of ``wte`` (the tied head's too) sees the tapped tensor; each
  trunk segment's stacked ``blocks`` rows by the module's forward
  (``trainer.grad_tap_plane``), outside any remat wrapper.  A tap's
  backward receives the group's whole local cotangent (the gradients of
  ``loss / n``) and runs the group's bucketed int8 sync.

Where the synced gradients go.  The JAX tap returns them as the
cotangent; here a tap hands autograd nothing (``None``) and writes them
into buffers the plane owns (``synced``, and ``new_resid`` under EF), so
autograd never waits on the wire.  Over NCCL on a card the chain after
the cotangent (pack, quantize, phase 1, dequantized sum, requantize,
phase 2, dequantize) runs on a side ``torch.cuda.Stream`` that waits on
an event recorded after the cotangent; the cotangents and the plane's
buffers are marked used there (``record_stream``), and :meth:`TapPlane.
finish` makes the compute stream wait on the side stream once, before
the optimizer reads the buffers.  Over gloo (whose collectives on CUDA
tensors go through the host and wait for the device) and on the CPU the
chain runs where the tap fires; the values are the same either way.  The full-size gradient leaves are put together
from the groups' pieces (:func:`join_groups`: an entry group's leaves are
views of the buffer; a trunk leaf is its segments' rows concatenated).

Layout rule of the groups (the JAX GPT's, which this module relies on
to put the gradient tree back together): an entry group names top-level
keys; the other groups are consecutive row ranges of the stacked
``blocks`` leaves, in the plan's order.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.models.optim import (
    known_zeros, tree_leaves, tree_map, tree_unflatten,
)

__all__ = ["normalize_grad_overlap", "resolve_grad_overlap", "GroupPlan",
           "OverlapPlan", "build_overlap_plan", "TapPlane", "tapped_step",
           "sync_groups", "split_groups", "join_groups"]


def normalize_grad_overlap(value: Any) -> Optional[int]:
    """Validate a ``grad_overlap_segments`` value and return its normal
    form: None (defer to the environment) or an int >= 0 (0 = off;
    "off"/"" are 0, numeric strings become ints)."""
    if value is None:
        return None
    if isinstance(value, str):
        s = value.strip().lower()
        if s in ("", "off", "none"):
            return 0
        try:
            value = int(s)
        except ValueError:
            raise ValueError(
                f"grad_overlap_segments={value!r}: expected 'off', '' or "
                "an integer G >= 0"
            ) from None
    if isinstance(value, bool) or not isinstance(value, int):
        raise TypeError(
            f"grad_overlap_segments must be None, 'off' or an int >= 0; "
            f"got {type(value).__name__}"
        )
    if value < 0:
        raise ValueError(
            f"grad_overlap_segments must be >= 0, got {value}"
        )
    return value


def resolve_grad_overlap(value: Any) -> int:
    """The trunk segment count G of a fit (0 = step-end sync): the knob,
    else ``RLT_GRAD_OVERLAP`` (forwarded to the workers; empty = off),
    else off."""
    value = normalize_grad_overlap(value)
    if value is None:
        value = normalize_grad_overlap(os.environ.get("RLT_GRAD_OVERLAP"))
    return 0 if value is None else int(value)


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """One tap group: a param subtree synced at its backward boundary."""

    name: str
    #: Tapped at loss entry (a dict of top-level param keys, applied by
    #: dict replacement) vs inside the module's own forward.
    entry: bool
    keys: Tuple[str, ...]          # top-level param keys (entry groups)
    plan: Any                      # the group's grad_sync.BucketPlan
    resid_offset: int              # the group's start in the residual row
    leaf_sizes: Tuple[int, ...]    # JAX-order element counts (validation)


@dataclasses.dataclass(frozen=True)
class OverlapPlan:
    """The groups' bucket layout, backward-completion ordered; reads as a
    ``grad_sync.BucketPlan`` for the accounting and the residual."""

    groups: Tuple[GroupPlan, ...]
    trunk_segments: int
    n_shards: int
    block_size: int
    total_elems: int
    total_padded: int
    full_width_bytes: int

    @property
    def num_buckets(self) -> int:
        return sum(g.plan.num_buckets for g in self.groups)

    def wire_bytes_per_step(self, mode: str) -> int:
        return sum(g.plan.wire_bytes_per_step(mode) for g in self.groups)

    def collectives_per_step(self, mode: str) -> int:
        return sum(g.plan.collectives_per_step(mode) for g in self.groups)


def _jax_leaves(subtree: Any) -> List[Any]:
    """``subtree``'s leaves in JAX tree order (dict keys sorted)."""
    from ray_lightning_tpu_torch.parallel.grad_sync import jax_order

    flat = tree_leaves(subtree)
    return [flat[i] for i in jax_order(subtree)]


def _leaf_sizes(subtree: Any) -> Tuple[int, ...]:
    return tuple(int(np.prod(tuple(t.shape))) if len(t.shape) else 1
                 for t in _jax_leaves(subtree))


def build_overlap_plan(group_specs: Sequence[Tuple[str, Any, bool]],
                       n_shards: int, bucket_bytes: int = 4 * 2**20,
                       block_size: int = 256) -> OverlapPlan:
    """Per-group bucket plans from a module's ``grad_overlap_groups``
    spec, ``(name, subtree, entry)`` in backward-completion order (the
    subtrees' leaves: tensors, meta tensors will do): each group bucketed
    by ``grad_sync.build_bucket_plan`` over its leaves in JAX order, at
    the ``n_shards · block_size`` alignment, and given the next
    contiguous slice of the residual row."""
    from ray_lightning_tpu_torch.parallel.grad_sync import build_bucket_plan

    groups: List[GroupPlan] = []
    offset = total_elems = full_width_bytes = trunk_segments = 0
    seen: set = set()
    for name, subtree, entry in group_specs:
        if name in seen:
            raise ValueError(f"duplicate grad-overlap group name {name!r}")
        seen.add(name)
        plan = build_bucket_plan([tuple(t.shape)
                                  for t in _jax_leaves(subtree)],
                                 n_shards, bucket_bytes, block_size)
        keys: Tuple[str, ...] = ()
        if entry:
            if not isinstance(subtree, dict):
                raise ValueError(
                    f"entry grad-overlap group {name!r} must be a dict of "
                    "top-level param keys (applied by dict replacement); "
                    f"got {type(subtree).__name__}"
                )
            keys = tuple(subtree.keys())
        else:
            trunk_segments += 1
        groups.append(GroupPlan(name=name, entry=entry, keys=keys,
                                plan=plan, resid_offset=offset,
                                leaf_sizes=_leaf_sizes(subtree)))
        offset += plan.total_padded
        total_elems += plan.total_elems
        full_width_bytes += plan.full_width_bytes
    if not groups:
        raise ValueError("grad_overlap_groups produced no groups")
    return OverlapPlan(groups=tuple(groups), trunk_segments=trunk_segments,
                       n_shards=n_shards, block_size=block_size,
                       total_elems=total_elems, total_padded=offset,
                       full_width_bytes=full_width_bytes)


# -- a tree <-> its groups' leaves ---------------------------------------------

def _trunk_bounds(oplan: OverlapPlan, blocks: Dict[str, Any]
                  ) -> Dict[str, Tuple[int, int]]:
    """Each trunk group's row range of the stacked ``blocks`` leaves."""
    first = _jax_leaves(blocks)[0]
    row = max(int(np.prod(tuple(first.shape[1:]))), 1)
    bounds, start = {}, 0
    for g in oplan.groups:
        if not g.entry:
            rows = g.leaf_sizes[0] // row
            bounds[g.name] = (start, start + rows)
            start += rows
    return bounds


def split_groups(tree: Dict[str, Any], oplan: OverlapPlan
                 ) -> Dict[str, List[torch.Tensor]]:
    """``tree``'s leaves cut into the plan's groups: name -> the group's
    leaves in JAX order (a trunk group's as row slices of ``blocks``)."""
    out = {}
    bounds = _trunk_bounds(oplan, tree.get("blocks", {})) \
        if oplan.trunk_segments else {}
    for g in oplan.groups:
        if g.entry:
            out[g.name] = _jax_leaves({k: tree[k] for k in g.keys})
        else:
            b, e = bounds[g.name]
            out[g.name] = _jax_leaves({k: v[b:e] for k, v in
                                       tree["blocks"].items()})
    return out


def join_groups(tree: Dict[str, Any], oplan: OverlapPlan,
                parts: Dict[str, List[torch.Tensor]]) -> Dict[str, Any]:
    """The inverse of :func:`split_groups`: a tree shaped as ``tree``
    whose leaves are put together from the groups' ``parts`` (an entry
    group's taken as they are; a trunk leaf its segments' rows
    concatenated in plan order)."""
    from ray_lightning_tpu_torch.parallel.grad_sync import jax_order

    out = dict(tree)
    rows: Dict[str, List[torch.Tensor]] = {}
    for g in oplan.groups:
        vals = parts[g.name]
        if g.entry:
            sub = {k: tree[k] for k in g.keys}
            flat = list(tree_leaves(sub))
            for v, i in zip(vals, jax_order(sub)):
                flat[i] = v
            out.update(tree_unflatten(sub, flat))
        else:
            for k, v in zip(sorted(tree["blocks"], key=str), vals):
                rows.setdefault(k, []).append(v)
    if rows:
        out["blocks"] = {k: (torch.cat(rows[k]) if len(rows[k]) > 1
                             else rows[k][0])
                         for k in tree["blocks"]}
    return out


def _leaf_views(out: torch.Tensor, plan, shapes, dtypes
                ) -> List[Optional[torch.Tensor]]:
    """The leaves of a group's buffer ``out`` (plan order), as
    ``sync_leaf_buckets_int8`` returns them."""
    views: List[Optional[torch.Tensor]] = [None] * len(shapes)
    for b in plan.buckets:
        pos = b.offset
        for i, sz in zip(b.indices, b.sizes):
            views[i] = out[pos:pos + sz].view(shapes[i]).to(dtypes[i])
            pos += sz
    return views


# -- the taps ------------------------------------------------------------------

class _Tap(torch.autograd.Function):
    """The identity on a group's leaves whose backward syncs the group's
    cotangent into the plane's buffers and hands autograd nothing."""

    @staticmethod
    def forward(ctx, plane, grp, *leaves):
        ctx.plane, ctx.grp = plane, grp
        return tuple(t.view_as(t) for t in leaves)

    @staticmethod
    def backward(ctx, *cts):
        ctx.plane._sync(ctx.grp, list(cts))
        return (None, None) + (None,) * len(cts)


class TapPlane:
    """The taps of one differentiation of the loss (JAX ``TapPlane``).
    ``resid_row``: this rank's residual row (EF); ``side_stream``: the
    stream the chain after each cotangent runs on (None: synchronous);
    ``device``: where the plane's buffers live.  :meth:`check_consumed`
    raises if the forward skipped a group, :meth:`tap` if it tapped one
    twice, an unknown one or another subtree than declared: a silently
    missed tap would drop that group's sync."""

    def __init__(self, oplan: OverlapPlan, n_shards: int, use_ef: bool,
                 device, resid_row=None, side_stream=None):
        self._oplan = oplan
        self._groups = {g.name: g for g in oplan.groups}
        self._n = n_shards
        self._use_ef = use_ef
        self._resid_row = resid_row
        self._side = side_stream
        self.consumed: set = set()
        self.fired: set = set()
        self.synced = torch.empty(oplan.total_padded, dtype=torch.float32,
                                  device=device)
        self.new_resid = (torch.empty_like(self.synced) if use_ef
                          else None)
        self._parts: Dict[str, List[Optional[torch.Tensor]]] = {}
        self._shapes: Dict[str, Tuple[list, list]] = {}

    @property
    def trunk_segments(self) -> int:
        return self._oplan.trunk_segments

    def apply_entry_taps(self, params: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(params)
        for grp in self._oplan.groups:
            if grp.entry:
                out.update(self.tap(grp.name, {k: out[k] for k in grp.keys}))
        return out

    def tap(self, name: str, subtree: Any) -> Any:
        from ray_lightning_tpu_torch.parallel.grad_sync import jax_order

        grp = self._groups.get(name)
        if grp is None:
            raise ValueError(
                f"grad tap {name!r} is not in the overlap plan "
                f"(groups: {sorted(self._groups)})"
            )
        if name in self.consumed:
            raise ValueError(
                f"grad tap {name!r} consumed twice in one trace — each "
                "group must be tapped exactly once per differentiation"
            )
        sizes = _leaf_sizes(subtree)
        if sizes != grp.leaf_sizes:
            raise ValueError(
                f"grad tap {name!r}: subtree leaf layout {sizes} does "
                f"not match the plan's {grp.leaf_sizes} — the forward "
                "must tap the same subtree grad_overlap_groups declared"
            )
        self.consumed.add(name)
        flat = tree_leaves(subtree)
        order = jax_order(subtree)
        ordered = [flat[i] for i in order]
        self._shapes[name] = ([t.shape for t in ordered],
                              [t.dtype for t in ordered])
        tapped = _Tap.apply(self, grp, *ordered)
        out = list(flat)
        for i, t in zip(order, tapped):
            out[i] = t
        return tree_unflatten(subtree, out)

    def check_consumed(self) -> None:
        missing = [g.name for g in self._oplan.groups
                   if g.name not in self.consumed]
        if missing:
            raise ValueError(
                f"grad overlap groups never tapped this trace: {missing} "
                "— the module's forward must route every declared "
                "subtree through trainer.grad_tap_plane.tap()"
            )

    def _slice(self, grp: GroupPlan, buf: Optional[torch.Tensor]):
        if buf is None:
            return None
        return buf[grp.resid_offset:grp.resid_offset + grp.plan.total_padded]

    def _sync(self, grp: GroupPlan, cts: List[torch.Tensor]) -> None:
        """A tap's backward: the group's bucketed int8 sync of ``cts``
        into the plane's buffers."""
        from ray_lightning_tpu_torch.parallel.grad_sync import (
            sync_leaf_buckets_int8,
        )

        self.fired.add(grp.name)

        def run():
            self._parts[grp.name], _ = sync_leaf_buckets_int8(
                cts, grp.plan.buckets, self._n, self._oplan.block_size,
                resid=self._slice(grp, self._resid_row),
                out=self._slice(grp, self.synced),
                resid_out=self._slice(grp, self.new_resid))

        if self._side is None:
            run()
            return
        # The cotangents are ready on the compute stream: the side stream
        # waits for them there, and the allocator learns that the side
        # stream reads them (and writes the plane's buffers).
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.synced.device))
        self._side.wait_event(ready)
        with torch.cuda.stream(self._side):
            for t in cts:
                t.record_stream(self._side)
            for buf in (self.synced, self.new_resid, self._resid_row):
                if buf is not None:
                    buf.record_stream(self._side)
            run()

    def finish(self) -> Tuple[Dict[str, List[torch.Tensor]],
                              Optional[torch.Tensor]]:
        """After the backward: the compute stream waits once for the side
        stream, then the groups' synced leaves (name -> JAX-order views of
        ``synced``) and the new residual row.  A group whose backward
        never ran (no leaf of it needed a gradient) reads zeros and keeps
        its residual."""
        if self._side is not None:
            torch.cuda.current_stream(self.synced.device).wait_stream(
                self._side)
        for grp in self._oplan.groups:
            if grp.name in self.fired:
                continue
            out = self._slice(grp, self.synced)
            out.zero_()
            if self.new_resid is not None:
                self._slice(grp, self.new_resid).copy_(
                    self._slice(grp, self._resid_row))
            self._parts[grp.name] = _leaf_views(out, grp.plan,
                                                *self._shapes[grp.name])
        return self._parts, self.new_resid


def _side_stream(gs, device: torch.device):
    """The overlapped sync's side stream: over NCCL on a card, else None
    (gloo's collectives on the card wait for it anyway)."""
    import torch.distributed as dist

    if device.type != "cuda" or dist.get_backend() != "nccl":
        return None
    if gs.side_stream is None:
        gs.side_stream = torch.cuda.Stream(device)
    return gs.side_stream


def tapped_step(gs, params: Any, residual: Optional[torch.Tensor], batch,
                rng) -> Tuple[Any, Dict[str, torch.Tensor],
                              Optional[torch.Tensor]]:
    """``GradSync.step`` with an overlap plan: the forward through a
    :class:`TapPlane` (entry taps here, trunk taps by the module through
    ``trainer.grad_tap_plane``), the backward of ``loss / n``, whose taps
    sync each group as its cotangent completes; then the gradient tree
    from the plane's buffers (frozen leaves ``known_zeros``)."""
    module = gs.module
    train = module.trainable(params)
    if train is None:
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    else:
        leaves = tree_map(lambda t, on: t.detach().requires_grad_(bool(on)),
                          params, train)
    device = tree_leaves(params)[0].device
    plane = TapPlane(gs.overlap, gs.n_shards, gs.use_ef, device,
                     resid_row=residual if gs.use_ef else None,
                     side_stream=_side_stream(gs, device))
    trainer = getattr(module, "trainer", None)
    with torch.enable_grad():
        tapped = plane.apply_entry_taps(leaves)
        if trainer is not None:
            trainer.grad_tap_plane = plane
        try:
            loss, logs = module.training_step(tapped, batch, rng)
        finally:
            if trainer is not None:
                trainer.grad_tap_plane = None
        plane.check_consumed()
        wanted = [t for t in tree_leaves(leaves) if t.requires_grad]
        torch.autograd.grad(loss / gs.n_shards, wanted, allow_unused=True)
    parts, new_resid = plane.finish()
    grads = join_groups(leaves, gs.overlap, parts)
    grads = tree_map(lambda g, t: g if t.requires_grad else known_zeros(t),
                     grads, leaves)
    logs = {k: v.detach() for k, v in dict(logs).items()}
    logs.setdefault("loss", loss.detach())
    return grads, logs, new_resid


def sync_groups(gs, grads: Dict[str, Any],
                resid: Optional[torch.Tensor]
                ) -> Tuple[Dict[str, Any], Optional[torch.Tensor]]:
    """The step-end sync over an overlap plan: the groups of a tree of
    partials synced in the plan's order, each over its own buckets and
    residual slice, as the taps sync them mid-backward."""
    from ray_lightning_tpu_torch.models.optim import is_known_zeros
    from ray_lightning_tpu_torch.parallel.grad_sync import (
        sync_leaf_buckets_int8,
    )

    oplan = gs.overlap
    device = tree_leaves(grads)[0].device
    synced = torch.empty(oplan.total_padded, dtype=torch.float32,
                         device=device)
    new_resid = torch.empty_like(synced) if resid is not None else None
    parts = {}
    for grp, leaves in zip(oplan.groups, split_groups(grads,
                                                      oplan).values()):
        sl = slice(grp.resid_offset,
                   grp.resid_offset + grp.plan.total_padded)
        parts[grp.name], _ = sync_leaf_buckets_int8(
            leaves, grp.plan.buckets, gs.n_shards, oplan.block_size,
            resid=None if resid is None else resid[sl],
            out=synced[sl],
            resid_out=None if new_resid is None else new_resid[sl])
    out = join_groups(grads, oplan, parts)
    out = tree_map(lambda g, t: t if is_known_zeros(t) else g, out, grads)
    return out, new_resid
