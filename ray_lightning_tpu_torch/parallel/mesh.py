"""Rank layout and process-group bootstrap (``ray_lightning_tpu/parallel/
mesh.py``).

The JAX package joins every host to one multi-controller runtime
(``jax.distributed.initialize``) and builds a device mesh over all chips;
collectives are compiled into the step.  The port runs one process per
rank and one card per process, joined by one ``torch.distributed``
process group (:func:`bootstrap_distributed`, an explicit backend and
timeout), and keeps the mesh as a record of the rank layout
(:class:`RankLayout`: rank r at device r's place in the JAX mesh).  Only
the batch-parallel axes that the JAX ``sharding.data_axes`` reads
(``data``, ``fsdp``) are taken; any other axis (``tensor``, ``sp``, ...)
raises, naming ROADMAP Queue 1 item 3.  ZeRO over a ``data`` x ``fsdp``
mesh shards over each ``fsdp`` group and replicates along ``data``
(:func:`zero_groups`, ``torch.distributed`` subgroups).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Dict, Optional, Tuple

__all__ = ["bootstrap_distributed", "MeshSpec",
           "RankLayout", "build_mesh", "BATCH_AXES", "DistContext",
           "zero_groups"]

# The mesh axes a batch shards over (JAX ``sharding.data_axes``).
BATCH_AXES = ("data", "fsdp")


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
    """The rank layout of ``spec`` over ``world_size`` ranks.  Axes other
    than ``data`` and ``fsdp`` raise (model parallelism is ROADMAP Queue 1
    item 3)."""
    spec = spec or MeshSpec()
    other = [a for a in spec.axis_names if a not in BATCH_AXES]
    if other:
        raise NotImplementedError(
            f"mesh axes {other} are not ported: the port's strategies "
            f"shard the batch over {BATCH_AXES} only (tensor, sequence and "
            f"pipeline parallelism are ROADMAP Queue 1 item 3)")
    return RankLayout(spec.resolve(world_size))


def zero_groups(dist: Any) -> Dict[str, Any]:
    """The ZeRO plan's group keywords for the rank of ``dist`` (a
    :class:`DistContext`; ``sharding.ZeroPlan``): the state sharded over
    the ranks along the ZeRO axis (``RankLayout.zero_axis``).  Where that
    axis spans every rank (or ``dist`` carries no layout: one ``data``
    axis), over the default group; on a ``data`` x ``fsdp`` mesh over the
    rank's ``fsdp`` group, replicated across its ``data`` group.  The
    subgroups are made here by every rank, every one in the same order
    (``torch.distributed.new_group`` is a collective of the default
    group): a collective."""
    layout = getattr(dist, "layout", None)
    if layout is None or layout.sizes[layout.zero_axis] == layout.world_size:
        return {"rank": dist.rank, "world_size": dist.world_size}
    import torch.distributed as tdist

    axis = layout.zero_axis
    size = layout.sizes[axis]
    others = tuple(a for a in layout.axis_names if a != axis)
    mine = {}
    for key, axes in (("group", (axis,)), ("data_group", others)):
        for members in layout.groups_along(axes):
            g = tdist.new_group(members)
            if dist.rank in members:
                mine[key] = g
    return {"rank": layout.coords(dist.rank)[axis], "world_size": size,
            "group": mine["group"], "replicas": layout.world_size // size,
            "data_group": mine["data_group"]}


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

    def mean_logs(self, logs: Dict[str, Any]) -> Dict[str, Any]:
        """Each log's mean over the ranks (one all-reduce of the logs
        stacked in f32), in its own dtype and shape: the value a JAX step
        over the global batch logs where the log is a mean over the rows,
        each rank's being the mean of its equal share of them.  A log that
        is not (``val_ppl``) is derived again from the means by the
        caller (``TrainModule.derive_logs``)."""
        import torch
        import torch.distributed as dist

        if not logs:
            return logs
        keys = list(logs)
        vals = [torch.as_tensor(logs[k]) for k in keys]
        flat = torch.cat([v.detach().float().reshape(-1).to(self.device)
                          for v in vals])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat = flat / self.world_size
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
