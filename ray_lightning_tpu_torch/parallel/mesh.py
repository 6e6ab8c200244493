"""Rank layout and process-group bootstrap (``ray_lightning_tpu/parallel/
mesh.py``).

The JAX package joins every host to one multi-controller runtime
(``jax.distributed.initialize``) and builds a device mesh over all chips;
collectives are compiled into the step.  The port runs one process per
rank and one card per process, joined by one ``torch.distributed``
process group (:func:`bootstrap_distributed`, an explicit backend and
timeout), and keeps the mesh as a record of the rank layout
(:class:`RankLayout`: rank r at device r's place in the JAX mesh).  The
batch shards over the batch-parallel axes that the JAX
``sharding.data_axes`` reads (``data``, ``fsdp``): a rank's rows are given
by its data coordinate (:meth:`RankLayout.data_coord`).  The model axes
(``sp``, ``tensor``, ``expert``) see the same rows, as under the JAX
package's GSPMD: ``sp`` cuts the sequence, ``tensor`` and ``expert`` the
weights (``parallel/model_parallel.py``, one ``torch.distributed``
subgroup an axis, :func:`model_groups`).  ``pipe`` raises, naming the
port's pipelines (``pipeline_apply`` over a process group and
``MpmdStrategy``).  ZeRO shards over the ZeRO axis's group
among the ranks with the same model coordinates and replicates along the
other batch axes and ``sp`` (:func:`zero_groups`).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Dict, Optional, Tuple

__all__ = ["bootstrap_distributed", "MeshSpec",
           "RankLayout", "build_mesh", "BATCH_AXES", "MODEL_AXES",
           "REPLICA_AXES", "DistContext", "zero_groups", "model_groups"]

# The mesh axes a batch shards over (JAX ``sharding.data_axes``).
BATCH_AXES = ("data", "fsdp")
# The model-parallel axes: the sequence (ring attention), the Megatron
# weight split and the experts.
MODEL_AXES = ("sp", "tensor", "expert")
# The axes whose ranks hold the same slice of every weight (a gradient is
# a partial over each's rows): the batch axes and the sequence axis.
REPLICA_AXES = BATCH_AXES + ("sp",)


def bootstrap_distributed(coordinator: str, world_size: int, rank: int,
                          backend: str, timeout_s: float) -> None:
    """Join the process group (worker side): ``backend`` ("nccl" or
    "gloo") over a TCP rendezvous at ``coordinator`` ("host:port", a free
    port of worker 0's host brokered by the driver).  ``timeout_s`` bounds
    the rendezvous and every collective, so a rank whose peer died fails
    instead of waiting forever.  One rank joins a group too: its
    collectives run (and cost what they cost)."""
    import torch.distributed as dist

    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


class MeshSpec:
    """Declarative mesh request: axis names and sizes, -1 = infer (the JAX
    package's ``MeshSpec``)."""

    def __init__(self, axes: Optional[Dict[str, int]] = None):
        self.axes = dict(axes or {"data": -1})
        inferred = [k for k, v in self.axes.items() if v == -1]
        if len(inferred) > 1:
            raise ValueError(f"Only one axis may be -1 (got {inferred})")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.axes.keys())

    def resolve(self, num_devices: int) -> Dict[str, int]:
        sizes = dict(self.axes)
        known = 1
        infer_key = None
        for k, v in sizes.items():
            if v == -1:
                infer_key = k
            else:
                known *= v
        if infer_key is not None:
            if num_devices % known != 0:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes "
                    f"product {known} ({sizes})")
            sizes[infer_key] = num_devices // known
        else:
            total = 1
            for v in sizes.values():
                total *= v
            if total != num_devices:
                raise ValueError(
                    f"Mesh {sizes} wants {total} devices, have {num_devices}")
        return sizes


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """The mesh as the port keeps it: each axis's size over the ranks
    (one device a rank)."""

    sizes: Dict[str, int]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.sizes)

    @property
    def world_size(self) -> int:
        n = 1
        for v in self.sizes.values():
            n *= v
        return n

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s index along each axis: the JAX mesh's device
        order (the devices reshaped to the axes' sizes, row-major), so
        rank r sits where device r does and holds its batch rows."""
        out = {}
        for name in reversed(self.axis_names):
            out[name] = rank % self.sizes[name]
            rank //= self.sizes[name]
        return {name: out[name] for name in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        rank = 0
        for name in self.axis_names:
            rank = rank * self.sizes[name] + coords[name]
        return rank

    def data_coord(self, rank: int) -> Tuple[int, int]:
        """``(index, count)`` of rank ``rank``'s batch rows: its place
        row-major over the batch axes in their order (the JAX
        ``P(data_axes)`` batch sharding), so the ranks along the model
        axes share their rows."""
        c = self.coords(rank)
        index, count = 0, 1
        for name in self.axis_names:
            if name in BATCH_AXES:
                index = index * self.sizes[name] + c[name]
                count *= self.sizes[name]
        return index, count

    @property
    def model_axes(self) -> Tuple[str, ...]:
        """The model axes of the mesh with more than one rank."""
        return tuple(a for a in self.axis_names
                     if a in MODEL_AXES and self.sizes[a] > 1)

    @property
    def zero_axis(self) -> str:
        """The axis ZeRO shards the state over (the JAX
        ``default_zero_axis``): ``fsdp`` where the mesh has one, else
        ``data``."""
        return "fsdp" if "fsdp" in self.sizes else "data"

    def groups_along(self, axes: Tuple[str, ...]) -> list:
        """Every group of ranks that differ only along ``axes``, each a
        sorted rank list, in the order of their first rank."""
        seen, out = set(), []
        for r in range(self.world_size):
            if r in seen:
                continue
            c = self.coords(r)
            members = sorted({self.rank_of({**c, **dict(zip(axes, idx))})
                              for idx in _product(
                                  [range(self.sizes[a]) for a in axes])})
            seen.update(members)
            out.append(members)
        return out


def _product(ranges) -> list:
    out = [()]
    for rng in ranges:
        out = [p + (i,) for p in out for i in rng]
    return out


def build_mesh(spec: Optional[MeshSpec], world_size: int) -> RankLayout:
    """The rank layout of ``spec`` over ``world_size`` ranks: the batch
    axes and the model axes.  ``pipe`` raises (the JAX fit has no ``pipe``
    path either; the port's pipelines are named), as does an unknown
    axis."""
    spec = spec or MeshSpec()
    if "pipe" in spec.axis_names:
        raise NotImplementedError(
            "mesh axis 'pipe' is not a strategy's mesh axis: pipeline "
            "parallelism runs as parallel.pipeline.pipeline_apply(stage_fn, "
            "stacked, x, group=...) over a process group (one rank a "
            "stage) or as MpmdStrategy (the MPMD plane)")
    other = [a for a in spec.axis_names
             if a not in BATCH_AXES + MODEL_AXES]
    if other:
        raise ValueError(
            f"unknown mesh axes {other}: the port takes {BATCH_AXES} "
            f"(batch) and {MODEL_AXES} (model)")
    return RankLayout(spec.resolve(world_size))


def zero_groups(dist: Any) -> Dict[str, Any]:
    """The ZeRO plan's group keywords for the rank of ``dist`` (a
    :class:`DistContext`; ``sharding.ZeroPlan``): the state sharded over
    the ranks along the ZeRO axis (``RankLayout.zero_axis``).  Where that
    axis spans every rank (or ``dist`` carries no layout: one ``data``
    axis), over the default group; else over the rank's group along the
    ZeRO axis, replicated across its group along the other batch axes and
    ``sp`` (on a ``data`` x ``fsdp`` mesh its ``data`` group).  The ranks
    along ``tensor`` and ``expert`` hold other slices of the weights and
    sit in neither.  The subgroups are made here by every rank, every one
    in the same order (``torch.distributed.new_group`` is a collective of
    the default group): a collective."""
    layout = getattr(dist, "layout", None)
    if layout is None or layout.sizes[layout.zero_axis] == layout.world_size:
        return {"rank": dist.rank, "world_size": dist.world_size}
    import torch.distributed as tdist

    axis = layout.zero_axis
    size = layout.sizes[axis]
    others = tuple(a for a in layout.axis_names
                   if a != axis and a in REPLICA_AXES)
    mine = {}
    for key, axes in (("group", (axis,)), ("data_group", others)):
        for members in layout.groups_along(axes):
            g = tdist.new_group(members)
            if dist.rank in members:
                mine[key] = g
    replicas = 1
    for a in others:
        replicas *= layout.sizes[a]
    return {"rank": layout.coords(dist.rank)[axis], "world_size": size,
            "group": mine["group"], "replicas": replicas,
            "data_group": mine["data_group"] if replicas > 1 else None}


def model_groups(layout: RankLayout, rank: int) -> Any:
    """Rank ``rank``'s :class:`model_parallel.ModelParallel`: its data
    coordinate and one subgroup for each of ``sp``, ``tensor``,
    ``expert``, ``expert`` x ``tensor`` (MoE's reduction) and the
    replica axes (:data:`REPLICA_AXES`: the gradient sync and the logs'
    mean).  Every rank makes every group, in this order (a collective of
    the default group); an axis the mesh lacks gives a group of one."""
    import torch.distributed as tdist

    from ray_lightning_tpu_torch.parallel.model_parallel import (
        AxisGroup, ModelParallel,
    )

    def make(axes):
        axes = tuple(a for a in axes if a in layout.sizes)
        mine = None
        for members in layout.groups_along(axes):
            g = tdist.new_group(members) if len(members) > 1 else None
            if rank in members:
                mine = AxisGroup(g, members.index(rank), len(members),
                                 tuple(members))
        return mine

    index, count = layout.data_coord(rank)
    return ModelParallel(
        sp=make(("sp",)), tensor=make(("tensor",)), expert=make(("expert",)),
        expert_tensor=make(("expert", "tensor")), replica=make(REPLICA_AXES),
        data_index=index, data_count=count)


class DistContext:
    """One rank's view of its process group: ``rank``, ``world_size``,
    its ``device`` and the group's ``backend``, with the few collectives
    the loop itself runs (the strategies' gradient and state collectives
    live in ``grad_sync.py`` and ``sharding.py``).  Every method is a
    collective: every rank calls it at the same point."""

    def __init__(self, rank: int, world_size: int, device: Any,
                 backend: str, layout: Optional[RankLayout] = None):
        self.rank = rank
        self.world_size = world_size
        self.device = device
        self.backend = backend
        self.layout = layout or RankLayout({"data": world_size})
        # The model-parallel groups (``model_groups``), made by
        # :meth:`setup_model_groups` where the layout has a model axis.
        self.mp: Any = None

    def setup_model_groups(self) -> None:
        """Make the rank's model-parallel groups where the layout has a
        model axis (a collective: every rank calls it at the same
        point)."""
        if self.layout.model_axes and self.mp is None:
            self.mp = model_groups(self.layout, self.rank)

    def mean_logs(self, logs: Dict[str, Any]) -> Dict[str, Any]:
        """Each log's mean over the ranks (one all-reduce of the logs
        stacked in f32), in its own dtype and shape: the value a JAX step
        over the global batch logs where the log is a mean over the rows,
        each rank's being the mean of its equal share of them.  A log that
        is not (``val_ppl``) is derived again from the means by the
        caller (``TrainModule.derive_logs``).  With model axes the mean
        runs over the rank's replica group (the batch axes and ``sp``:
        the ranks along ``tensor`` and ``expert`` log the same values)."""
        import torch
        import torch.distributed as dist

        if not logs:
            return logs
        keys = list(logs)
        vals = [torch.as_tensor(logs[k]) for k in keys]
        flat = torch.cat([v.detach().float().reshape(-1).to(self.device)
                          for v in vals])
        if self.mp is None:
            n = self.world_size
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        else:
            n = self.mp.replica.size
            if n > 1:
                dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                                group=self.mp.replica.group)
        flat = flat / n
        out, pos = {}, 0
        for k, v in zip(keys, vals):
            n = v.numel()
            out[k] = flat[pos:pos + n].reshape(v.shape).to(v.dtype)
            pos += n
        return out

    def barrier(self) -> None:
        """Every rank reaches this point before any leaves it."""
        import torch.distributed as dist

        dist.barrier()

    def broadcast_(self, tensors, src: int = 0) -> None:
        """Rank ``src``'s values written into every rank's ``tensors``."""
        import torch.distributed as dist

        for t in tensors:
            dist.broadcast(t, src)

    def broadcast_value(self, value: Optional[float], src: int = 0
                        ) -> Optional[float]:
        """Rank ``src``'s float (or None) on every rank."""
        import torch

        buf = torch.tensor([0.0 if value is None else 1.0,
                            0.0 if value is None else float(value)],
                           dtype=torch.float64, device=self.device)
        self.broadcast_([buf], src)
        return None if float(buf[0]) == 0.0 else float(buf[1])
