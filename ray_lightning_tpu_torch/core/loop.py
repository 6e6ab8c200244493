"""The fit loop on one device, or on one rank of a strategy: the spine of
``run_fit`` (``ray_lightning_tpu/core/loop.py``).

Kept: epochs, ``max_steps``, ``limit_train_batches``/``limit_val_batches``,
``log_every_n_steps`` (step logs land in ``callback_metrics`` one log
interval late, as the JAX package's asynchronous fetch lands them; a
megastep stride rounds the boundary to its end), ``check_val_every_n_epoch``,
the epoch means of the step logs with non-finite values left out
(``_RunningMeanLogs``), validation, the module and callback hooks,
``initial_params`` warm starts, ``module.precision = config.precision``,
gradient accumulation (``accumulate_grad_batches``: ``models.optim.
multi_steps``, the partial window flushed at epoch end), megastep (K
micro-steps a dispatch: ``parallel.step_fns.MultiStep``, one CUDA graph
per stride on the card) and the cheap telemetry tier (``telemetry/``:
``step_time_ms``, ``dispatch_ms``, ``mfu``... in ``callback_metrics``).
Checkpoints (``LoopContext.save_checkpoint``: the JAX package's payload
``{"state", "epoch", "global_step", "micro_step", "callback_metrics"}``
in an ``RLTCKPT1`` file, ``utils/state_stream.py``), resume
(``resume_from_checkpoint``: the state, counters, epoch and metrics of a
file either package wrote; across an ``opt_state_dtype`` change the
moments are converted, ``_reconcile_opt_state_format``) and the eval
loops (:func:`run_eval` for validation and test, :func:`run_predict`)
are kept.  Restart checkpoints too (``restart_dir``,
``restart_every_n_epochs``: at each such epoch end every rank writes its
pieces of the live state into one ``RLTSHRD2`` directory,
``utils/sharded_ckpt.py``, no gather, then rank 0 its META after a
barrier: :func:`_write_restart`), and resuming from them at the same or
another world (the index-selective reader onto this rank's slices; the
accumulation factor re-derived, :func:`_elastic_resume_info`).  Drain
checkpoints in the middle of an epoch, prefetch threads and the full
telemetry tier are later slices (ROADMAP Queue 1 item 6).

Under a strategy's process group (``dist``, a ``parallel.mesh.
DistContext``; ``parallel/strategies.py``) the loops run on each rank:
the datamodule is sharded by rank (``set_shard(rank, world_size)``),
every rank starts from rank 0's params (one broadcast), the step is a
``parallel.step_fns.DistributedStep`` of the strategy's flavor, logs and
validation metrics are averaged over the ranks, a ``ModelCheckpoint``
file gathers the state on every rank (under ZeRO) and rank 0 writes it
(a restart checkpoint gathers nothing), and the fit returns the JAX
package's per-rank result package: rank 0's carries the state stream
(the ``RLTCKPT1`` bytes of the gathered state), the metrics, the best
path and the callback states; every rank's carries its telemetry
snapshot.  Megastep is off there: ``"auto"`` resolves to 1, and an
explicit K > 1 raises (a CUDA graph of steps with collectives in it is
ROADMAP Queue 1 item 2.2).

The gradient wire is resolved against the real world size, flavor and
ZeRO stage, as the JAX ``run_fit`` resolves it against its mesh
(:func:`_resolve_comm`): ``grad_comm`` (``parallel/grad_sync.py``;
``LocalStrategy``'s one device keeps full width), ``grad_overlap_segments``
(``parallel/overlap.py``) and
``update_sharding`` (:func:`_resolve_update_sharding`); ``comm_stats``
and the telemetry meta say what was taken.  The EF residual is attached
to the state after it is built and reconciled on resume; each rank's row
enters its restart checkpoint (as the JAX restart state carries it),
never an ``RLTCKPT1`` file or the rank-0 package.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import queue
import shutil
import threading
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.core.callbacks import Callback, ModelCheckpoint
from ray_lightning_tpu_torch.core.data import TpuDataModule
from ray_lightning_tpu_torch.core.module import TrainModule, TrainState
from ray_lightning_tpu_torch.models.convert import (
    jax_train_state_fields, params_from_jax, train_state_from_jax,
    train_state_to_jax,
)
from ray_lightning_tpu_torch.models.optim import (
    MaskedNode, multi_steps, tree_leaves, tree_map,
)
from ray_lightning_tpu_torch.ops.optim_quant import (
    BlockQuantized, dequantize_moment, quantize_moment,
)
from ray_lightning_tpu_torch.parallel import step_fns
from ray_lightning_tpu_torch.parallel.overlap import (
    normalize_grad_overlap, resolve_grad_overlap,
)
from ray_lightning_tpu_torch.telemetry.runtime import Telemetry
from ray_lightning_tpu_torch.utils.state_stream import (
    load_state_stream, state_stream_from_file, state_stream_to_file,
    to_state_stream,
)

__all__ = ["FitConfig", "LoopContext", "init_train_state", "run_fit",
           "run_eval", "run_predict"]

_PRECISION_ALIASES = {"32": "f32", "32-true": "f32", "float32": "f32",
                      "bf16-mixed": "bf16", "bfloat16": "bf16"}


@dataclasses.dataclass
class FitConfig:
    """The loop's configuration (the JAX package's ``FitConfig`` fields
    that the single-device loop reads)."""

    max_epochs: int = 1
    max_steps: int = -1
    check_val_every_n_epoch: int = 1
    limit_train_batches: int = -1
    limit_val_batches: int = -1
    log_every_n_steps: int = 50
    seed: int = 0
    precision: str = "f32"
    accumulate_grad_batches: int = 1
    megastep: Optional[Any] = None
    # The sharded weight update (arXiv:2004.13336): None (the
    # RLT_UPDATE_SHARDING variable, else "auto"), "auto" (on for eligible
    # ranks on the card, off on the CPU), "on", "off" or a bool.
    update_sharding: Optional[Any] = None
    # The backward-overlapped gradient sync: None (RLT_GRAD_OVERLAP, else
    # off), "off"/""/0, or G >= 1 trunk segments.
    grad_overlap_segments: Optional[Any] = None
    default_root_dir: str = "."
    resume_from_checkpoint: Optional[str] = None
    # One epoch of one train batch and one val batch (a smoke run).
    fast_dev_run: bool = False
    # Restart checkpoints: every restart_every_n_epochs (None: 1) epochs
    # each rank writes its pieces of the state under restart_dir
    # (utils/sharded_ckpt.py); a strategy with max_restarts > 0 sets a
    # scratch directory of its own when this is None.
    restart_dir: Optional[str] = None
    restart_every_n_epochs: Optional[int] = None

    def __post_init__(self):
        if self.limit_train_batches is None:
            self.limit_train_batches = -1
        if self.limit_val_batches is None:
            self.limit_val_batches = -1
        if self.max_steps is None:
            self.max_steps = -1
        if self.max_epochs is None:
            self.max_epochs = 1000
        self.precision = _PRECISION_ALIASES.get(str(self.precision),
                                                self.precision)
        if self.precision not in ("f32", "bf16"):
            raise ValueError(
                f"precision {self.precision!r} unsupported: use 'f32' or "
                f"'bf16' (accepted aliases: {sorted(_PRECISION_ALIASES)})")
        # A typo'd knob fails at construction; "auto" resolves at fit
        # time, against the fit's device and world.
        _normalize_megastep(self.megastep)
        _normalize_update_sharding(self.update_sharding)
        normalize_grad_overlap(self.grad_overlap_segments)
        if (self.restart_every_n_epochs is not None
                and self.restart_every_n_epochs < 1):
            raise ValueError("restart_every_n_epochs must be >= 1")
        if self.fast_dev_run:
            self.max_epochs = 1
            self.limit_train_batches = 1
            self.limit_val_batches = 1


def _normalize_megastep(value: Any) -> Optional[Any]:
    """Validate a megastep knob value and return its normal form:
    None, "auto", "off" or an int >= 1 (numeric strings become ints;
    resolution to a concrete K happens at fit time)."""
    if value is None:
        return None
    if isinstance(value, str):
        s = value.strip().lower()
        if s in ("auto", "off", ""):
            return "off" if s == "" else s
        try:
            value = int(s)
        except ValueError:
            raise ValueError(
                f"megastep={value!r}: expected 'auto', 'off' or an "
                "integer K >= 1"
            ) from None
    if isinstance(value, bool) or not isinstance(value, int):
        raise TypeError(
            f"megastep must be None, 'auto', 'off' or an int >= 1; got "
            f"{type(value).__name__}"
        )
    if value < 1:
        raise ValueError(f"megastep must be >= 1, got {value}")
    return value


def _normalize_update_sharding(value: Any) -> Optional[str]:
    """Validate an ``update_sharding`` value: None, "auto", "on" or "off"
    (bools as on/off); resolution happens at fit time
    (:func:`_resolve_update_sharding`)."""
    if value is None:
        return None
    if isinstance(value, bool):
        return "on" if value else "off"
    if isinstance(value, str):
        s = value.strip().lower()
        if s == "":
            return "off"
        if s in ("auto", "on", "off"):
            return s
    raise ValueError(
        f"update_sharding={value!r}: expected 'auto', 'on', 'off' or a "
        "bool"
    )


def _resolve_update_sharding(config: FitConfig, world: Optional[int],
                             mode: str, zero_stage: int,
                             device: torch.device,
                             axes: Optional[tuple] = None) -> bool:
    """Whether this fit shards the weight update over the ranks (the JAX
    ``_resolve_update_sharding``): the knob, else ``RLT_UPDATE_SHARDING``,
    else ``"auto"``.  Eligible: more than one rank (``world``; None is
    ``LocalStrategy``'s one device), the gspmd flavor and
    ``zero_stage == 0`` (the port's ranks are batch-parallel only).  "on"
    outside that warns with the JAX words and stays off; "auto" is on
    where eligible and on the card (the JAX rule's TPU backend), off on
    the CPU.  On, the step is ZeRO-1's (``step_fns.build_dist_step``):
    the gradients reduce-scattered onto each rank's slices (or the int8
    wire's synced ones sliced), its slices of the moments and params
    updated, then the params all-gathered."""
    value = _normalize_update_sharding(config.update_sharding)
    if value is None:
        value = _normalize_update_sharding(
            os.environ.get("RLT_UPDATE_SHARDING", "auto"))
    if value == "off":
        return False
    eligible = (world is not None and world > 1 and mode == "gspmd"
                and zero_stage == 0)
    if value == "on":
        if not eligible:
            warnings.warn(
                "update_sharding='on' needs a multi-device batch-only "
                "(data/fsdp) gspmd mesh with zero_stage=0 (ZeRO already "
                f"shards the update); got mesh={axes}, "
                f"mode={mode!r}, zero_stage={zero_stage} — running with "
                "a replicated update instead"
            )
            return False
        return True
    return eligible and device.type == "cuda"


def _resolve_megastep(config: FitConfig, device: torch.device,
                      distributed: bool = False) -> int:
    """The concrete stride length K for this fit.

    Strongest first: an explicit ``megastep=`` on the Trainer/strategy →
    the ``RLT_MEGASTEP`` environment variable (set but empty means "off")
    → ``"auto"``.  Auto is K = 8 on the card, where the host's per-step
    issue cost can hold the card back (the JAX package's accelerator
    rule), and 1 on the CPU, where execution is synchronous and fusing
    strides buys nothing.  Under a strategy's process group
    (``distributed``) auto is 1 and K > 1 raises: the steps' collectives
    are not captured into a graph (ROADMAP Queue 1 item 2.2)."""
    value = config.megastep
    if value is None:
        value = os.environ.get("RLT_MEGASTEP")
        value = "auto" if value is None else value
    value = _normalize_megastep(value)
    if value == "off":
        return 1
    if value == "auto":
        return 8 if device.type == "cuda" and not distributed else 1
    if distributed and int(value) > 1:
        raise NotImplementedError(
            f"megastep={value} under a multi-process strategy: a CUDA graph "
            f"of steps with their collectives captured is not ported yet "
            f"(ROADMAP Queue 1 item 2.2, megastep under NCCL capture); use "
            f"megastep='auto' or 'off' there")
    return int(value)


class LoopContext:
    """The ``trainer`` argument of every hook (the JAX package's
    ``LoopContext``; one process, one device, and under a strategy one
    rank of its process group)."""

    def __init__(self, config: FitConfig, device: torch.device,
                 dist: Any = None):
        self.config = config
        self.device = device
        # The strategy's process group (None: one process) and, under
        # RayShardedStrategy, the ZeRO plan of the state's leaves.
        self.dist = dist
        self.zero_plan = None
        # The gradient wire of the fit (``_resolve_comm``): its
        # accounting and the tap plane of the differentiation in flight
        # (which the module's forward reads).
        self.comm_stats: Dict[str, Any] = {}
        self.grad_tap_plane = None
        self.current_epoch = 0
        # global_step counts optimizer steps, micro_step micro-batches
        # (equal without accumulation).
        self.global_step = 0
        self.micro_step = 0
        self.should_stop = False
        self.callback_metrics: Dict[str, float] = {}
        self.logged_metrics: Dict[str, float] = {}
        self.state: Optional[TrainState] = None
        self.telemetry: Optional[Telemetry] = None
        # Recovery events of this fit (an elastic resume's ``resize``),
        # carried back in the result package.
        self.events: List[Dict[str, Any]] = []
        self.default_root_dir = config.default_root_dir
        # The async checkpoint writer (one thread a fit, made on first
        # use): its queue, failures, paths in flight and their lock.
        self._ckpt_queue: Optional[queue.Queue] = None
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_errors: List[BaseException] = []
        self._ckpt_pending: set = set()
        self._ckpt_lock = threading.Lock()

    @property
    def global_rank(self) -> int:
        return 0 if self.dist is None else self.dist.rank

    @property
    def world_size(self) -> int:
        return 1 if self.dist is None else self.dist.world_size

    @property
    def is_global_zero(self) -> bool:
        return self.global_rank == 0

    def broadcast_value(self, value: Optional[float]) -> Optional[float]:
        """Rank 0's ``value`` (a float or None) on every rank: a decision
        every rank must take alike (``EarlyStopping``).  A collective."""
        return value if self.dist is None else self.dist.broadcast_value(
            value)

    def full_state(self) -> TrainState:
        """The whole state: under ZeRO gathered from every rank's slices
        (a collective, on every rank), else the state itself."""
        plan = self.zero_plan
        if plan is None:
            return self.state
        st = self.state
        params = plan.all_gather(st.params) if plan.stage == 3 else st.params
        return TrainState(params, plan.gather_opt_state(st.opt_state),
                          st.step)

    def log_metrics(self, metrics: Dict[str, Any]) -> None:
        for k, v in metrics.items():
            self.logged_metrics[k] = float(v)
            self.callback_metrics[k] = float(v)

    # -- checkpoints ---------------------------------------------------------
    def checkpoint_payload(self) -> Dict[str, Any]:
        """The JAX package's checkpoint payload; the state as the JAX
        ``TrainState`` tree (its tensors still where they live; gathered
        under ZeRO, on every rank)."""
        return {"state": train_state_to_jax(self.full_state()),
                "epoch": self.current_epoch,
                "global_step": self.global_step,
                "micro_step": self.micro_step,
                "callback_metrics": dict(self.callback_metrics)}

    def save_checkpoint(self, path: str, async_write: bool = False) -> None:
        """Write the state to ``path``.  The stream is built here, each
        tensor copied from the card straight into it: the copy waits for
        the steps queued before it (a captured stride's write-back
        included) and ends before the next step is issued, so the file
        holds this step's state whatever runs next.  ``async_write``
        leaves the crc and the file write to a writer thread (at most one
        stream waits for it); :meth:`flush_checkpoints` joins it and
        raises its failures.  Under a process group every rank calls it
        (the gather is a collective) and rank 0 writes."""
        payload = self.checkpoint_payload()
        if not self.is_global_zero:
            return
        stream = to_state_stream(payload)
        del payload
        if self.telemetry is not None:
            self.telemetry.add_counter("checkpoint_writes", 1)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not async_write:
            state_stream_to_file(stream, path)
            return
        if self._ckpt_queue is None:
            self._start_writer()
        with self._ckpt_lock:
            self._ckpt_pending.add(path)
        self._ckpt_queue.put((path, stream))

    def _start_writer(self) -> None:
        # maxsize 1: one stream (a host copy of the whole state) waits at
        # most; a slow disk holds the loop back instead of piling copies.
        q: queue.Queue = queue.Queue(maxsize=1)
        errors, pending, lock = (self._ckpt_errors, self._ckpt_pending,
                                 self._ckpt_lock)

        def writer():  # holds the queue, not the context or its state
            while True:
                item = q.get()
                try:
                    if item is None:
                        return
                    state_stream_to_file(item[1], item[0])
                except BaseException as e:  # noqa: BLE001 - raised at flush
                    errors.append(e)
                finally:
                    if item is not None:
                        with lock:
                            pending.discard(item[0])
                    q.task_done()

        self._ckpt_queue = q
        self._ckpt_thread = threading.Thread(target=writer, daemon=True,
                                             name="rlt-ckpt-writer")
        self._ckpt_thread.start()

    def checkpoint_write_pending(self, path: str) -> bool:
        """True while an async write of ``path`` is queued or running."""
        with self._ckpt_lock:
            return path in self._ckpt_pending

    def flush_checkpoints(self) -> None:
        """Wait for pending async writes; raise the first that failed."""
        if self._ckpt_queue is None:
            return
        self._ckpt_queue.join()
        if self._ckpt_errors:
            err = self._ckpt_errors[0]
            self._ckpt_errors.clear()
            raise RuntimeError(
                f"async checkpoint write failed: {err!r}") from err

    def close_checkpoint_writer(self) -> None:
        """Flush, then retire the writer thread."""
        try:
            self.flush_checkpoints()
        finally:
            self._retire_writer()

    def _retire_writer(self) -> None:
        if self._ckpt_queue is None:
            return
        self._ckpt_queue.put(None)
        self._ckpt_thread.join(timeout=30)
        self._ckpt_queue = self._ckpt_thread = None


def _call_hooks(callbacks: List[Callback], hook: str, *args) -> None:
    for cb in callbacks:
        getattr(cb, hook)(*args)


class _RunningMeanLogs:
    """Epoch means of device-scalar step logs: one f32 running sum and
    finite count per metric on the device (no host sync per step);
    non-finite values are left out of the mean, and a metric whose every
    value was non-finite reads NaN.  ``nonfinite_count`` (after
    :meth:`result`) is how many values were left out."""

    def __init__(self) -> None:
        self._sum: Optional[Dict[str, torch.Tensor]] = None
        self._cnt: Optional[Dict[str, torch.Tensor]] = None
        self._n = 0
        self.nonfinite_count = 0

    def update(self, logs: Dict[str, Any]) -> None:
        if self._sum is None:
            self._sum, self._cnt = {}, {}
            for k, v in logs.items():
                v32 = torch.as_tensor(v).float()
                finite = torch.isfinite(v32)
                self._sum[k] = torch.where(finite, v32, 0.0)
                self._cnt[k] = finite.float()
        else:
            for k in self._sum:
                v32 = torch.as_tensor(logs[k]).float()
                finite = torch.isfinite(v32)
                self._sum[k] = self._sum[k] + torch.where(finite, v32, 0.0)
                self._cnt[k] = self._cnt[k] + finite.float()
        self._n += 1

    def update_stride(self, sums: Dict[str, torch.Tensor],
                      cnts: Dict[str, torch.Tensor], n: int) -> None:
        """Fold a megastep stride's device sums and finite counts over its
        ``n`` inner steps into the epoch mean."""
        if self._sum is None:
            self._sum, self._cnt = dict(sums), dict(cnts)
        else:
            for k in self._sum:
                self._sum[k] = self._sum[k] + sums[k]
                self._cnt[k] = self._cnt[k] + cnts[k]
        self._n += n

    def result(self) -> Dict[str, float]:
        if self._sum is None:
            return {}
        out: Dict[str, float] = {}
        nonfinite = 0
        for k, s in self._sum.items():
            c = float(self._cnt[k])
            nonfinite += self._n - int(round(c))
            out[k] = float(s) / c if c else float("nan")
        self.nonfinite_count = nonfinite
        return out


def init_train_state(module: TrainModule, tx, device: torch.device,
                     seed: int) -> TrainState:
    """The initial state on ``device``: ``module.initial_params`` when set
    (copied, in f32), else ``module.init_params`` from a generator seeded
    ``seed``."""
    return TrainState.create(_initial_params(module, device, seed), tx)


def _initial_params(module: TrainModule, device: torch.device,
                    seed: int) -> Any:
    preset = getattr(module, "initial_params", None)
    if preset is not None:
        from ray_lightning_tpu_torch.models.quant import is_quantized

        if isinstance(preset, dict) and is_quantized(preset):
            # int8 decode storage is inference-only: the optimizer cannot
            # step int8 weights, and dequantizing here would train an
            # already-rounded model.
            raise ValueError(
                "initial_params are int8-quantized (decode storage); "
                "training needs the original float tree — keep it, or "
                "dequantize explicitly before warm-starting"
            )
        return tree_map(
            lambda t: torch.as_tensor(t).to(device=device,
                                            dtype=torch.float32).clone(),
            dict(preset))
    gen = torch.Generator(device=device).manual_seed(seed)
    return tree_map(lambda t: t.to(device), module.init_params(gen))


def _resolve_comm(ctx: LoopContext, module: TrainModule, tel: Telemetry,
                  params: Any, mode: str, zero_stage: int, grad_comm: Any):
    """The fit's gradient wire against its real world (``dist``'s size;
    ``LocalStrategy`` resolves as one device), flavor and ZeRO stage, as
    the JAX ``run_fit`` does: the int8 sync or None
    (``grad_sync.maybe_build_grad_sync``, its downgrades warned), the
    trunk segments, and the sharded weight update; recorded in
    ``ctx.comm_stats`` and the telemetry.  Returns ``(grad_sync,
    shard_update)``."""
    from ray_lightning_tpu_torch.parallel import grad_sync as gsync

    dist = ctx.dist
    world = 1 if dist is None else dist.world_size
    overlap_segments = resolve_grad_overlap(ctx.config.grad_overlap_segments)
    grad_sync = gsync.maybe_build_grad_sync(
        module, grad_comm, world, mode=mode, zero_stage=zero_stage,
        params=params, overlap_segments=overlap_segments)
    tel.set_meta("grad_overlap_segments", overlap_segments)
    if grad_sync is not None:
        grad_sync.register_telemetry(tel)
        ctx.comm_stats = grad_sync.stats()
    else:
        tel.set_meta("grad_sync_mode", "full")
        ctx.comm_stats = {"grad_sync_mode": "full"}
    shard_update = _resolve_update_sharding(
        ctx.config, None if dist is None else dist.world_size, mode,
        zero_stage, ctx.device,
        None if dist is None else dist.layout.axis_names)
    tel.set_meta("update_sharding", "on" if shard_update else "off")
    return grad_sync, shard_update


def _init_dist_state(ctx: LoopContext, module: TrainModule, tx, tel,
                     callbacks: List[Callback], accum: int, mode: str,
                     zero_stage: int, grad_comm: Any,
                     resize_info: Optional[Dict[str, Any]] = None):
    """A rank's step and initial state under a strategy: every rank
    builds the params from the same seed, then takes rank 0's (one
    broadcast, so a module whose init is not deterministic still starts
    equal).  Under ZeRO or the sharded update the state keeps this rank's
    slices (``ctx.zero_plan``); under EF it carries a zero residual row.
    A resume writes the checkpoint into that state (:func:`_resume`).
    Returns ``(step, (start_epoch, skip_batches))``."""
    config, dist = ctx.config, ctx.dist
    params = _initial_params(module, ctx.device, config.seed)
    with torch.no_grad():
        dist.broadcast_(tree_leaves(params))
    grad_sync, shard_update = _resolve_comm(ctx, module, tel, params, mode,
                                            zero_stage, grad_comm)
    step = step_fns.build_dist_step(module, tx, dist, params, mode,
                                    zero_stage, grad_sync, shard_update)
    plan = step.plan
    if plan is None:
        ctx.state = TrainState.create(params, tx)
    else:
        shards = plan.shard_tree(params, own=plan.stage == 3)
        opt_state = tx.init(shards)
        plan.opt_dims(opt_state, sharded=True)  # refuses int8 moments
        ctx.state = TrainState(shards if plan.stage == 3 else params,
                               opt_state, 0)
        ctx.zero_plan = plan
    del params
    if grad_sync is not None:
        ctx.state = grad_sync.attach_residual(ctx.state)
    start = (0, 0)
    if config.resume_from_checkpoint:
        start = _resume(ctx, callbacks, accum, grad_sync, resize_info)
    return step, start


def _restore_state(template: TrainState, loaded: TrainState,
                   plan: Any = None) -> TrainState:
    """``loaded``'s values written into ``template``'s tensors, each cast
    to the template's dtype (a dtype policy changed between runs must not
    leak into this one, as the JAX loop casts) on its device; the trees
    must agree, and the shapes too, but that under a ZeRO ``plan`` a full
    leaf where the template holds this rank's slice (a whole ``RLTCKPT1``
    state, a moment converted from int8) gives its slice."""
    cuts = set() if plan is None else {
        (s, d) for s, d in zip(plan.full_shapes, plan.dims) if d is not None}

    def fit(src, dst):
        if src.dim() != dst.dim():
            return None
        diff = [k for k in range(src.dim()) if src.shape[k] != dst.shape[k]]
        if len(diff) != 1 or (tuple(src.shape), diff[0]) not in cuts:
            return None
        d, c = diff[0], dst.shape[diff[0]]
        return (src.narrow(d, plan.rank * c, c)
                if src.shape[d] == c * plan.world else None)

    def put(dst, src, path):
        if isinstance(dst, MaskedNode):
            if not isinstance(src, MaskedNode):
                raise ValueError(f"resume: {path}: the checkpoint holds "
                                 f"{type(src).__name__} where this fit "
                                 f"masks the leaf (lora_rank changed?)")
        elif isinstance(dst, BlockQuantized):
            if (not isinstance(src, BlockQuantized)
                    or src.static() != dst.static()):
                raise ValueError(f"resume: {path}: the checkpoint holds "
                                 f"{src!r} where this fit holds {dst!r}")
            put(dst.q, src.q, f"{path}.q")
            put(dst.scale, src.scale, f"{path}.scale")
            # The checkpoint's own static objects: a state written back
            # pickles as the file did.
            dst.aux = src.aux
        elif isinstance(dst, dict):
            if not isinstance(src, dict) or set(src) != set(dst):
                got = sorted(src) if isinstance(src, dict) else type(
                    src).__name__
                raise ValueError(
                    f"resume: {path}: the checkpoint holds {got} where this "
                    f"fit holds {sorted(dst)}")
            for k in dst:
                put(dst[k], src[k], f"{path}['{k}']")
        elif isinstance(dst, tuple):
            if not isinstance(src, tuple) or len(src) != len(dst):
                raise ValueError(
                    f"resume: {path}: the checkpoint holds "
                    f"{type(src).__name__} where this fit holds a tuple of "
                    f"{len(dst)} (accumulate_grad_batches changed?)")
            for i, (d, x) in enumerate(zip(dst, src)):
                put(d, x, f"{path}[{i}]")
        elif tuple(src.shape) != tuple(dst.shape):
            part = fit(src, dst)
            if part is None:
                raise ValueError(
                    f"resume: {path}: shape {tuple(src.shape)} in the "
                    f"checkpoint, {tuple(dst.shape)} in this fit")
            dst.copy_(part)
        else:
            dst.copy_(src)

    with torch.no_grad():
        put(template.params, loaded.params, "state.params")
        put(template.opt_state, loaded.opt_state, "state.opt_state")
        if (template.grad_residual is not None
                and loaded.grad_residual is not None):
            put(template.grad_residual, loaded.grad_residual,
                "state.grad_residual")
    template.step = loaded.step
    return template


class _Foreign(Exception):
    """The trees differ beyond the moments' storage format."""


def _structure(tree: Any) -> Any:
    """A tree's structure with each quantized node's static fields (what
    a JAX treedef compares)."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    if isinstance(tree, MaskedNode):
        return "masked"
    if isinstance(tree, BlockQuantized):
        return ("quantized", tree.static())
    return "leaf"


def _reconcile_opt_state_format(loaded: TrainState,
                                template: TrainState) -> TrainState:
    """The JAX loop's ``_reconcile_opt_state_format``: a checkpoint's
    optimizer moments in this fit's storage format across an
    ``opt_state_dtype`` change.  Float → int8 requantizes (the codec's
    rounding, once), int8 → float dequantizes, int8 of another block size
    or sqrt mode goes through float; a same-format state passes through
    untouched, so an int8 state round-trips bitwise.  Trees that differ
    otherwise are returned as they are, for :func:`_restore_state` to
    refuse."""
    if _structure(loaded.opt_state) == _structure(template.opt_state):
        return loaded
    converted = 0

    def coerce(tmpl, ckpt):
        nonlocal converted
        t_q = isinstance(tmpl, BlockQuantized)
        c_q = isinstance(ckpt, BlockQuantized)
        if t_q and c_q:
            if tmpl.static() == ckpt.static():
                return ckpt
            converted += 1
            return quantize_moment(dequantize_moment(ckpt),
                                   block_size=tmpl.block_size,
                                   sqrt_domain=tmpl.sqrt_domain)
        if t_q:
            if not isinstance(ckpt, torch.Tensor):
                raise _Foreign
            converted += 1
            return quantize_moment(ckpt.float(), block_size=tmpl.block_size,
                                   sqrt_domain=tmpl.sqrt_domain)
        if c_q:
            if not isinstance(tmpl, torch.Tensor):
                raise _Foreign
            converted += 1
            return dequantize_moment(ckpt).to(tmpl.dtype)
        if isinstance(tmpl, dict):
            if not isinstance(ckpt, dict) or set(ckpt) != set(tmpl):
                raise _Foreign
            return {k: coerce(tmpl[k], ckpt[k]) for k in ckpt}
        if isinstance(tmpl, (tuple, list)):
            if type(ckpt) is not type(tmpl) or len(ckpt) != len(tmpl):
                raise _Foreign
            return type(tmpl)(coerce(t, c) for t, c in zip(tmpl, ckpt))
        return ckpt

    try:
        opt_state = coerce(template.opt_state, loaded.opt_state)
    except _Foreign:
        return loaded
    if converted:
        warnings.warn(
            f"resume across an opt_state_dtype change: {converted} "
            "optimizer moment leaves converted to this run's storage format "
            "(float ↔ block-scaled int8; requantization applies the codec's "
            "rounding once)")
    return TrainState(loaded.params, opt_state, loaded.step,
                      loaded.grad_residual)


def _prune_restart_dir(restart_dir: str, keep: int = 2) -> None:
    """Keep the ``keep`` newest complete restart checkpoints (two: a
    corrupt newest one falls back to its predecessor), by the enumeration
    restart discovery uses (``sharded_ckpt.list_restart_candidates``)."""
    from ray_lightning_tpu_torch.utils.sharded_ckpt import (
        list_restart_candidates,
    )

    for _, _, _, stale in list_restart_candidates(restart_dir)[keep:]:
        shutil.rmtree(stale, ignore_errors=True)
        if os.path.isfile(stale):
            try:
                os.unlink(stale)
            except OSError:
                pass


def _write_restart(ctx: LoopContext, callbacks: List[Callback], accum: int,
                   epoch: int) -> None:
    """The epoch's restart checkpoint (the JAX loop's, per rank, no
    gather): every rank writes its pieces of the live state
    (``sharded_ckpt.save_shard``: its ZeRO slices, the replicated leaves,
    its residual row), a barrier, then rank 0 writes META with the loop's
    counters and the callbacks' states and prunes the directory."""
    from ray_lightning_tpu_torch.utils import sharded_ckpt

    t0 = time.perf_counter()
    config, tel = ctx.config, ctx.telemetry
    rank, world = ctx.global_rank, ctx.world_size
    tag = os.path.join(config.restart_dir, f"restart-epoch-{epoch:06d}.ckpt")
    tree = sharded_ckpt.state_tree(ctx.state, ctx.zero_plan, rank, world,
                                   residual=ctx.state.grad_residual)
    sharded_ckpt.save_shard(tree, tag, rank, world)
    if ctx.dist is not None:
        ctx.dist.barrier()
    if ctx.is_global_zero:
        sharded_ckpt.save_meta(tree, tag, world, extra={
            "epoch": ctx.current_epoch,
            "global_step": ctx.global_step,
            "micro_step": ctx.micro_step,
            "world_size": world,
            "accum": accum,
            "callback_metrics": dict(ctx.callback_metrics),
            "callback_states": [cb.state_dict() for cb in callbacks],
        })
        _prune_restart_dir(config.restart_dir, keep=2)
    tel.add_counter("restart_checkpoint_writes", 1)
    tel.add_counter("restart_checkpoint_write_s", time.perf_counter() - t0)


def _rederive_accum(old_world: int, old_accum: int,
                    new_world: int) -> Optional[int]:
    """The accumulation factor that keeps the global batch of an optimizer
    step, ``world × accum × rows``, across a world-size change (the JAX
    ``_rederive_accum``); None where it does not divide."""
    rows = int(old_world) * int(old_accum)
    if new_world <= 0 or rows % int(new_world):
        return None
    return rows // int(new_world)


def _elastic_resume_info(path: str, world_size: int,
                         cfg_accum: int) -> Optional[Dict[str, Any]]:
    """The JAX ``_elastic_resume_info``: a sharded checkpoint's recorded
    world and accum against this fit's, from META alone; None when it
    records no world or nothing changed.  At the same world a recorded
    accum that differs from the config's wins (a previous resize set
    it)."""
    from ray_lightning_tpu_torch.utils import sharded_ckpt

    try:
        extra = sharded_ckpt.load_meta(path).get("extra", {})
    except Exception:  # noqa: BLE001 - a corrupt META fails in the load
        return None
    old_world = extra.get("world_size")
    if not old_world:
        return None
    old_world = int(old_world)
    recorded_accum = extra.get("accum")
    old_accum = int(recorded_accum or cfg_accum)
    if old_world == int(world_size):
        if recorded_accum is None or int(recorded_accum) == int(cfg_accum):
            return None
        return {"old_world": old_world, "new_world": int(world_size),
                "old_accum": int(recorded_accum),
                "accum": int(recorded_accum), "exact": True, "ckpt": path}
    new_accum = _rederive_accum(old_world, old_accum, world_size)
    return {"old_world": old_world, "new_world": int(world_size),
            "old_accum": old_accum,
            "accum": new_accum if new_accum is not None else old_accum,
            "exact": new_accum is not None, "ckpt": path}


def _announce_resize(info: Dict[str, Any], ctx: LoopContext,
                     tel: Telemetry) -> None:
    """An elastic resume, loudly (the JAX ``_announce_resize``): a warning
    on every rank, the ``elastic_resizes`` counter, and on rank 0 a
    ``resize`` event in the fit's recovery events.  At the same world (a
    recorded accum kept) only the warning."""
    from ray_lightning_tpu_torch.telemetry.monitor import make_event

    if info["old_world"] == info["new_world"]:
        warnings.warn(
            f"elastic resume: honoring the checkpoint's recorded accum "
            f"{info['accum']} over the configured value — the state's "
            f"optimizer trajectory (and the global batch per optimizer "
            f"step) continues what a previous elastic resize established")
        return
    msg = (f"elastic resume: checkpoint from world size {info['old_world']}"
           f" (accum {info['old_accum']}) resuming on {info['new_world']}"
           f" with accum {info['accum']}")
    if not info["exact"]:
        msg += (" — old_world*accum does not divide the new world size; the"
                " GLOBAL batch per optimizer step changes and the LR"
                " schedule is no longer step-equivalent")
    warnings.warn(msg)
    tel.add_counter("elastic_resizes", 1)
    if ctx.is_global_zero:
        ctx.events.append(make_event(
            "resize", ctx.global_rank, old_world=info["old_world"],
            new_world=info["new_world"], message=msg, ckpt=info["ckpt"]))


def _reconcile_multisteps(loaded: TrainState,
                          template: TrainState) -> TrainState:
    """The JAX ``_reconcile_multisteps``: a re-derived accum that crosses 1
    wraps or unwraps the optimizer state.  Bare → ``multi_steps``: a fresh
    window (``mini_step`` 0, zero ``acc_grads``, ``gradient_step`` the
    step count); ``multi_steps`` → bare: the inner state, a partial
    window dropped with a warning."""
    have = isinstance(loaded.opt_state, dict)
    want = isinstance(template.opt_state, dict)
    if have == want:
        return loaded
    if want:
        step32 = torch.tensor(int(loaded.step), dtype=torch.int32)
        opt = {"mini_step": torch.zeros((), dtype=torch.int32),
               "gradient_step": step32,
               "inner_opt_state": loaded.opt_state,
               "acc_grads": tree_map(torch.zeros_like, loaded.params)}
        return TrainState(loaded.params, opt, loaded.step,
                          loaded.grad_residual)
    mini = int(loaded.opt_state["mini_step"])
    if mini:
        warnings.warn(
            f"elastic resume collapsed accum to 1: the checkpoint's partial "
            f"accumulation window ({mini} micro-grad(s)) is dropped")
    return TrainState(loaded.params, loaded.opt_state["inner_opt_state"],
                      loaded.step, loaded.grad_residual)


def _as_multisteps(state: TrainState, wrapped: bool,
                   plan: Any = None) -> TrainState:
    """``state`` with its optimizer state in ``multi_steps`` (``wrapped``)
    or bare, as a checkpoint of another accum holds it: the selective
    reader's targets, whose leaves give only shapes and places (the
    accumulators are this rank's slices of meta tensors, as ``tx.init``
    of the slices makes them)."""
    if isinstance(state.opt_state, dict) == wrapped:
        return state
    if not wrapped:
        return TrainState(state.params, state.opt_state["inner_opt_state"],
                          state.step, state.grad_residual)
    acc = tree_map(lambda t: torch.empty_like(t, device="meta"),
                   state.params)
    if plan is not None and plan.stage == 1:
        acc = plan.shard_tree(acc)
    count = torch.zeros((), dtype=torch.int32)
    return TrainState(state.params, {
        "mini_step": count, "gradient_step": count,
        "inner_opt_state": state.opt_state, "acc_grads": acc},
        state.step, state.grad_residual)


def _loaded_state(tree: Any, ctx: LoopContext,
                  recorded_world: Optional[int]) -> TrainState:
    """A checkpoint's JAX ``TrainState`` tree as the port's, with its
    error-feedback residual as this rank's row where the checkpoint's
    world is this one's (its row read alone, or row ``rank`` of the
    whole leaf); else the whole leaf, for the reconciliation to drop."""
    loaded = train_state_from_jax(tree)
    resid = tree.children[3]
    if isinstance(resid, torch.Tensor):
        world = ctx.world_size
        if recorded_world == world and resid.shape[0] == 1:
            resid = resid.reshape(-1)
        elif resid.dim() == 2 and tuple(resid.shape[:1]) == (world,) \
                and recorded_world == world:
            resid = resid[ctx.global_rank].clone()
        loaded.grad_residual = resid
    return loaded


def _resume(ctx: LoopContext, callbacks: List[Callback], accum: int,
            grad_sync: Any = None,
            resize_info: Optional[Dict[str, Any]] = None):
    """Load ``config.resume_from_checkpoint`` into the context's state
    (state, counters, metrics, callback states); returns
    ``(start_epoch, skip_batches)``.

    An ``RLTCKPT1`` file is read whole.  A sharded restart directory is
    read by the index-selective reader onto this rank's state
    (``sharded_ckpt.state_tree`` over this world's ``ZeroPlan``), its
    optimizer state in the checkpoint's accumulation wrapper
    (:func:`_as_multisteps`): each rank reads only its slices, and whole
    only what the checkpoint holds in another form (a residual on one side
    only, moments in another storage format).  :func:`_restore_state`
    slices whatever came back whole.  Then, in the JAX loop's order: the
    residual
    (``GradSync.reconcile_resumed_state``; without the wire a residual
    is shed, loudly where the world changed), the accumulation wrapper
    (:func:`_reconcile_multisteps`, on an elastic resume), the moments'
    format (:func:`_reconcile_opt_state_format`), and the dtypes (cast
    into this fit's tensors, :func:`_restore_state`)."""
    from ray_lightning_tpu_torch.parallel.grad_sync import (
        warn_residual_dropped,
    )
    from ray_lightning_tpu_torch.utils import sharded_ckpt

    path = ctx.config.resume_from_checkpoint
    plan = ctx.zero_plan
    recorded_world = None
    if sharded_ckpt.is_sharded_ckpt(path):
        shaped = ctx.state if resize_info is None else _as_multisteps(
            ctx.state, resize_info["old_accum"] > 1, plan)
        targets = sharded_ckpt.state_tree(
            shaped, plan, ctx.global_rank, ctx.world_size,
            residual=ctx.state.grad_residual)
        payload = sharded_ckpt.load_sharded(path, targets=targets,
                                            device=ctx.device)
        recorded_world = payload.get("world_size")
    else:
        payload = load_state_stream(state_stream_from_file(path),
                                    device=ctx.device)
    loaded = _loaded_state(payload["state"], ctx, recorded_world)
    if grad_sync is not None:
        loaded = grad_sync.reconcile_resumed_state(loaded)
    elif loaded.grad_residual is not None:
        if recorded_world is not None and recorded_world != ctx.world_size:
            warn_residual_dropped(tuple(loaded.grad_residual.shape),
                                  ctx.world_size, None, ctx.telemetry)
        loaded = TrainState(loaded.params, loaded.opt_state, loaded.step)
    if resize_info is not None:
        loaded = _reconcile_multisteps(loaded, ctx.state)
    loaded = _reconcile_opt_state_format(loaded, ctx.state)
    ctx.state = _restore_state(ctx.state, loaded, plan)
    if payload.get("mid_epoch"):
        # A step-granular checkpoint: resume inside its epoch, skipping
        # the micro-batches already trained (loaders are epoch-seeded).
        start_epoch = payload["epoch"]
        skip = int(payload.get("batch_in_epoch", 0))
    else:
        start_epoch, skip = payload["epoch"] + 1, 0
    # A checkpoint that covers max_epochs runs no epoch; current_epoch
    # still reports the work done.
    ctx.current_epoch = max(start_epoch - 1, 0)
    if "micro_step" in payload:
        ctx.global_step = payload["global_step"]
        ctx.micro_step = payload["micro_step"]
    else:
        # Legacy streams (and Trainer.save_checkpoint's) store the
        # micro-batch count as "global_step".
        ctx.micro_step = payload["global_step"]
        ctx.global_step = payload["global_step"] // accum
    ctx.callback_metrics.update(payload.get("callback_metrics", {}))
    for cb, cb_state in zip(callbacks, payload.get("callback_states", [])):
        cb.load_state_dict(cb_state)
    return start_epoch, skip


def _run_validation(module: TrainModule, eval_step, loader,
                    ctx: LoopContext, limit: int) -> Dict[str, float]:
    """The epoch means of ``eval_step``'s logs over ``loader``; under a
    strategy each batch's logs averaged over the ranks first and the
    module's derived logs taken from those means (the JAX step's over the
    global batch), on the full params (gathered once under ZeRO-3)."""
    acc = _RunningMeanLogs()
    params = ctx.state.params
    if ctx.zero_plan is not None and ctx.zero_plan.stage == 3:
        params = ctx.zero_plan.all_gather(params)
    for i, batch in enumerate(loader):
        if limit >= 0 and i >= limit:
            break
        logs = eval_step(params, step_fns.place_batch(batch, ctx.device))
        if ctx.dist is not None:
            logs = module.derive_logs(ctx.dist.mean_logs(logs))
        acc.update(logs)
    return acc.result()


def _same_batch_shape(a: Any, b: Any) -> bool:
    """Structure + leaf-shape congruence: the stacking precondition."""
    ia, ib = step_fns._batch_items(a), step_fns._batch_items(b)
    return (list(ia) == list(ib)
            and all(ia[k].shape == ib[k].shape and ia[k].dtype == ib[k].dtype
                    for k in ia))


def _grouped(loader, stack: int, stack_limit: Optional[int]):
    """Group a batch stream into megastep strides.

    Yields ``("stride", [b0..b{k-1}])`` for full shape-congruent groups
    of ``stack`` batches, ``("single", b)`` otherwise.  ``stack_limit``
    (a multiple of ``stack``, or ``None`` for unlimited) bounds the
    stream position a stride may extend to: every batch emitted, strided
    or not, consumes budget, so a ragged single can never push a later
    stride across the limit/max_steps boundary the caller aligned the
    budget to."""
    if stack <= 1:
        for b in loader:
            yield ("single", b)
        return
    it = iter(loader)
    emitted = 0
    pending: List[Any] = []
    while True:
        if stack_limit is not None and emitted + stack > stack_limit:
            for p in pending:
                yield ("single", p)
            emitted += len(pending)
            pending = []
            for b in it:
                yield ("single", b)
            return
        try:
            item = next(it)
        except StopIteration:
            for p in pending:  # partial tail: per-step
                yield ("single", p)
            return
        if pending and not _same_batch_shape(pending[0], item):
            for p in pending:
                yield ("single", p)
            emitted += len(pending)
            pending = [item]
        else:
            pending.append(item)
        if len(pending) == stack:
            yield ("stride", pending)
            emitted += stack
            pending = []


def _wait_device(device: torch.device) -> None:
    """A sampled step's wait: a CUDA event after the work just queued,
    waited for (the CPU runs synchronously)."""
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()


def _examples(batch: Any) -> int:
    leaves = list(step_fns._batch_items(batch).values())
    return int(leaves[0].shape[0]) if leaves and leaves[0].ndim else 1


def run_fit(module: TrainModule, datamodule: TpuDataModule,
            config: FitConfig, callbacks: List[Callback],
            device: torch.device, telemetry: Any = None, dist: Any = None,
            mode: str = "gspmd", zero_stage: int = 0,
            grad_comm: Any = None) -> Dict[str, Any]:
    """The fit loop.  Returns the result package the trainer adopts:
    ``state``, ``callback_metrics``, ``logged_metrics``, ``epochs_run``,
    ``global_step``, ``micro_step``, ``telemetry`` (the report),
    ``comm_stats`` and ``best_model_path`` (the first
    ``ModelCheckpoint``'s).

    Under a strategy, ``dist`` is the rank's ``DistContext``, and the
    flavor (``mode``, ``zero_stage``) and ``grad_comm`` build its
    ``DistributedStep`` (``step_fns.build_dist_step``); the package is
    then the per-rank one (:func:`_rank_package`)."""
    ctx = LoopContext(config, device, dist)
    try:
        return _fit(ctx, module, datamodule, callbacks, telemetry, mode,
                    zero_stage, grad_comm)
    finally:
        # A failed fit still retires its writer thread (a finished one
        # already has).
        ctx._retire_writer()


def _fit(ctx: LoopContext, module: TrainModule, datamodule: TpuDataModule,
         callbacks: List[Callback], telemetry: Any, mode: str,
         zero_stage: int, grad_comm: Any) -> Dict[str, Any]:
    config, device, dist = ctx.config, ctx.device, ctx.dist
    tel = Telemetry.build(telemetry)
    tx = module.configure_optimizers()
    accum = max(int(config.accumulate_grad_batches), 1)
    # An elastic resume re-derives accum from the checkpoint's recorded
    # world before the optimizer is wrapped (global-batch invariance).
    resize_info = None
    if config.resume_from_checkpoint:
        from ray_lightning_tpu_torch.utils import sharded_ckpt

        if sharded_ckpt.is_sharded_ckpt(config.resume_from_checkpoint):
            resize_info = _elastic_resume_info(
                config.resume_from_checkpoint, ctx.world_size, accum)
    if resize_info is not None:
        accum = resize_info["accum"]
    inner_tx = tx
    if accum > 1:
        tx = multi_steps(tx, accum)
    ctx.telemetry = tel
    module.trainer = ctx
    module.precision = config.precision
    tel_stats = tel.step_stats
    if tel_stats is not None:
        tel_stats.configure_model(module, device)
    if resize_info is not None:
        _announce_resize(resize_info, ctx, tel)

    module.setup("fit")
    datamodule.set_shard(ctx.global_rank, ctx.world_size)
    datamodule.prepare_data()
    datamodule.setup("fit")
    _call_hooks(callbacks, "setup", ctx, module, "fit")

    start_epoch, skip_batches = 0, 0
    if dist is not None:
        train_step, (start_epoch, skip_batches) = _init_dist_state(
            ctx, module, tx, tel, callbacks, accum, mode, zero_stage,
            grad_comm, resize_info)
    else:
        # On resume this is the template the checkpoint is written into
        # (its dict order, which orders the clip's norm sum, stays the
        # fit's).
        ctx.state = init_train_state(module, tx, device, config.seed)
        # One device: full width and a replicated update (the JAX rule
        # for a one-device mesh, its warnings included).
        _resolve_comm(ctx, module, tel, ctx.state.params, mode, zero_stage,
                      grad_comm)
        if config.resume_from_checkpoint:
            # In place before the first stride: a captured graph owns the
            # state it captured on.
            start_epoch, skip_batches = _resume(ctx, callbacks, accum,
                                                resize_info=resize_info)
        train_step = step_fns.single_device_step(module, tx)
    rng = step_fns.StepRng(device, config.seed)
    megastep_k = _resolve_megastep(config, device, dist is not None)
    multi_step = (step_fns.MultiStep(module, tx, megastep_k, device, rng)
                  if megastep_k > 1 else None)
    tel.set_meta("megastep", megastep_k)
    val_loader = datamodule.val_dataloader()
    eval_step = (step_fns.build_eval_step(module) if val_loader is not None
                 else None)

    module.on_fit_start()
    _call_hooks(callbacks, "on_fit_start", ctx, module)

    train_loader = datamodule.train_dataloader()
    stop = False
    pending_logs: Optional[Dict[str, Any]] = None
    # Micro-batches since the last optimizer update (the host mirror of
    # multi_steps' window: a flush resets it mid-cycle).
    since_update = (int(ctx.state.opt_state["mini_step"])
                    if config.resume_from_checkpoint and accum > 1 else 0)
    compiled_kinds: set = set()
    for epoch in range(start_epoch, config.max_epochs):
        ctx.current_epoch = epoch
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        module.on_train_epoch_start(epoch)
        _call_hooks(callbacks, "on_train_epoch_start", ctx, module)

        epoch_mean = _RunningMeanLogs()
        # A mid-epoch checkpoint's batches already trained are skipped;
        # batch_idx stays the index within the epoch.
        skip = skip_batches if epoch == start_epoch else 0
        cap = (max(config.limit_train_batches - skip, 0)
               if config.limit_train_batches >= 0 else None)
        if config.max_steps >= 0:
            # max_steps counts optimizer steps; the cap micro-batches.
            remaining = max(
                (config.max_steps - ctx.global_step) * accum - since_update,
                0)
            cap = remaining if cap is None else min(cap, remaining)
        src = iter(train_loader)
        if skip:
            src = itertools.islice(src, skip, None)
        source = src if cap is None else itertools.islice(src, cap + 1)
        # Only full strides lying entirely inside the cap are fused; the
        # rest runs per step, so the boundary checks stay exact.
        stack_limit = (0 if megastep_k <= 1 else None if cap is None
                       else (cap // megastep_k) * megastep_k)
        last_logs: Dict[str, Any] = {}
        last_batch_idx = -1
        batch_idx = skip - 1
        t_mark = time.perf_counter()
        for kind, item in _grouped(source, megastep_k, stack_limit):
            t_ready = time.perf_counter()
            if (config.limit_train_batches >= 0
                    and batch_idx + 1 >= config.limit_train_batches):
                break
            if config.max_steps >= 0 and ctx.global_step >= config.max_steps:
                stop = True
                break
            prev_micro = ctx.micro_step
            first_use = kind not in compiled_kinds
            compiled_kinds.add(kind)
            if kind == "single":
                step_rng = rng.at(ctx.micro_step)
                t_disp = time.perf_counter()
                ctx.state, logs = train_step(
                    ctx.state, step_fns.place_batch(item, device), step_rng)
                t_disp_end = time.perf_counter()
                n = 1
                sampled = tel_stats is not None and tel_stats.should_sample()
                if sampled:
                    _wait_device(device)
                epoch_mean.update(logs)
                ctx.micro_step += 1
                since_update += 1
                if since_update == accum:
                    ctx.global_step += 1
                    since_update = 0
                batch_idx += 1
                examples = _examples(item)
            else:
                n = megastep_k
                t_disp = time.perf_counter()
                saux = multi_step(ctx, item, ctx.micro_step)
                t_disp_end = time.perf_counter()
                # A stride that captured its graph is booked as compile
                # time, as the JAX package books a stride that compiled.
                first_use = first_use or multi_step.captured
                if multi_step.captured and tel_stats is not None:
                    tel_stats.record_capture(multi_step.capture_s)
                sampled = (tel_stats is not None
                           and tel_stats.should_sample_stride(n))
                if sampled:
                    _wait_device(device)
                epoch_mean.update_stride(saux["sum"], saux["cnt"], n)
                logs = saux["last"]
                ctx.micro_step += n
                since_update += n
                ctx.global_step += since_update // accum
                since_update %= accum
                batch_idx += n
                examples = _examples(item[0]) * n
                tel.add_counter("megastep_dispatches", 1)
            tel.add_counter("train_dispatches", 1)
            n_log = config.log_every_n_steps
            if n_log and ctx.micro_step // n_log > prev_micro // n_log:
                # The previous boundary's values are long computed by now:
                # landing them costs no wait on the step just issued.
                if pending_logs is not None:
                    ctx.log_metrics(pending_logs)
                pending_logs = logs
            _call_hooks(callbacks, "on_train_batch_end", ctx, module, logs,
                        batch_idx)
            last_logs, last_batch_idx = logs, batch_idx
            t_end = time.perf_counter()
            if tel_stats is not None:
                if n == 1:
                    tel_stats.record_step(
                        step_s=t_end - t_mark, data_wait_s=t_ready - t_mark,
                        dispatch_s=t_disp_end - t_disp, examples=examples,
                        sampled=sampled, compiled=first_use)
                else:
                    tel_stats.record_stride(
                        stride_s=t_end - t_mark,
                        data_wait_s=t_ready - t_mark,
                        dispatch_s=t_disp_end - t_disp, examples=examples,
                        k=n, sampled=sampled, compiled=first_use)
            t_mark = t_end
        if tel_stats is not None:
            # The epoch's last step or stride waits for the card too: its
            # wall then covers the work still queued, at any fit length.
            t_wait = time.perf_counter()
            _wait_device(device)
            tel_stats.record_drain(time.perf_counter() - t_wait)

        # Flush a partial accumulation window (the last incomplete window
        # of an epoch still steps, from the mean of its micro-grads) —
        # except when stopping at max_steps, which promises exactly
        # max_steps optimizer updates.
        if (accum > 1 and not stop
                and int(ctx.state.opt_state["mini_step"]) > 0):
            ctx.state = (step_fns.accum_flush(ctx.state, inner_tx) if dist is None
                         else train_step.flush(ctx.state, inner_tx))
            ctx.global_step += 1
            since_update = 0
            _call_hooks(callbacks, "on_accumulation_flush", ctx, module,
                        last_logs, last_batch_idx)

        if pending_logs is not None:
            ctx.log_metrics(pending_logs)
            pending_logs = None
        train_metrics = epoch_mean.result()
        ctx.log_metrics(train_metrics)
        if tel.enabled:
            if epoch_mean.nonfinite_count:
                tel.add_counter("nonfinite_logs",
                                epoch_mean.nonfinite_count)
            ctx.log_metrics(tel.headline_metrics())
        module.on_train_epoch_end(epoch, train_metrics)

        if (eval_step is not None
                and (epoch + 1) % config.check_val_every_n_epoch == 0):
            val_metrics = _run_validation(module, eval_step, val_loader, ctx,
                                          config.limit_val_batches)
            ctx.log_metrics(val_metrics)
            module.on_validation_epoch_end(val_metrics)
            _call_hooks(callbacks, "on_validation_epoch_end", ctx, module)

        _call_hooks(callbacks, "on_train_epoch_end", ctx, module)
        if (config.restart_dir
                and (epoch + 1) % (config.restart_every_n_epochs or 1) == 0):
            _write_restart(ctx, callbacks, accum, epoch)
        if stop or ctx.should_stop:
            break

    # Every async write is on disk (or has raised) before on_fit_end,
    # where a callback may read best_model_path.
    ctx.flush_checkpoints()
    module.on_fit_end()
    _call_hooks(callbacks, "on_fit_end", ctx, module)
    ctx.close_checkpoint_writer()
    module.teardown("fit")
    _call_hooks(callbacks, "teardown", ctx, module, "fit")
    datamodule.teardown("fit")
    if dist is not None:
        return _rank_package(ctx, callbacks, tel)
    return {
        "state": ctx.state,
        "callback_metrics": dict(ctx.callback_metrics),
        "logged_metrics": dict(ctx.logged_metrics),
        "epochs_run": ctx.current_epoch + 1,
        "global_step": ctx.global_step,
        "micro_step": ctx.micro_step,
        "telemetry": tel.report(),
        "comm_stats": dict(ctx.comm_stats),
        "best_model_path": next((cb.best_model_path for cb in callbacks
                                 if isinstance(cb, ModelCheckpoint)), ""),
        "events": list(ctx.events),
    }


def _rank_package(ctx: LoopContext, callbacks: List[Callback],
                  tel: Telemetry) -> Dict[str, Any]:
    """A rank's result package under a strategy (the JAX ``run_fit``'s):
    every rank gathers the state (a collective under ZeRO) and ships its
    telemetry snapshot; rank 0's package also carries the state stream
    (the ``RLTCKPT1`` bytes of the JAX ``TrainState`` tree), the metrics,
    the best path and the callback states."""
    gathered = ctx.full_state()
    snapshot = tel.snapshot(ctx.global_rank)
    if not ctx.is_global_zero:
        return {"rank": ctx.global_rank, "telemetry": snapshot}
    return {
        "rank": 0,
        "state_stream": to_state_stream(train_state_to_jax(gathered)),
        "callback_metrics": {k: float(v)
                             for k, v in ctx.callback_metrics.items()},
        "logged_metrics": {k: float(v)
                           for k, v in ctx.logged_metrics.items()},
        "best_model_path": next((cb.best_model_path for cb in callbacks
                                 if isinstance(cb, ModelCheckpoint)), ""),
        "callback_states": [cb.state_dict() for cb in callbacks],
        "epochs_run": ctx.current_epoch + 1,
        "global_step": ctx.global_step,
        "micro_step": ctx.micro_step,
        "comm_stats": dict(ctx.comm_stats),
        "telemetry": snapshot,
        "events": list(ctx.events),
    }


def _resolve_params(module: TrainModule, config: FitConfig,
                    device: torch.device, params: Any,
                    ckpt_path: Optional[str]) -> Any:
    """The parameters an eval runs on: a checkpoint's (``ckpt_path``),
    else ``params`` (the trainer's fitted state, handed over as it is),
    else ``module.init_params`` from a generator seeded ``config.seed``."""
    if ckpt_path:
        payload = load_state_stream(state_stream_from_file(ckpt_path))
        return params_from_jax(jax_train_state_fields(payload["state"])[0],
                               device)
    if params is not None:
        return tree_map(lambda t: t.to(device), params)
    gen = torch.Generator(device=device).manual_seed(config.seed)
    return tree_map(lambda t: t.to(device), module.init_params(gen))


def run_eval(module: TrainModule, datamodule: TpuDataModule,
             config: FitConfig, callbacks: List[Callback],
             device: torch.device, kind: str = "validation", params=None,
             ckpt_path: Optional[str] = None,
             dist: Any = None) -> Dict[str, Any]:
    """The validation or test loop (``kind``): the epoch means of
    ``validation_step``/``test_step`` over the loader (at most
    ``limit_val_batches``), without gradients.  Returns
    ``{"callback_metrics": metrics}`` (under a strategy, with the rank;
    each rank evaluates its rows on the full params and the metrics are
    the means over the ranks)."""
    stage = "validate" if kind == "validation" else "test"
    ctx = LoopContext(config, device, dist)
    module.trainer = ctx
    module.precision = config.precision
    module.setup(stage)
    datamodule.set_shard(ctx.global_rank, ctx.world_size)
    datamodule.setup(stage)
    _call_hooks(callbacks, "setup", ctx, module, stage)
    ctx.state = TrainState(
        _resolve_params(module, config, device, params, ckpt_path), None)
    loader = (datamodule.val_dataloader() if kind == "validation"
              else datamodule.test_dataloader())
    if loader is None:
        raise ValueError(f"datamodule provides no {kind} dataloader")
    metrics = _run_validation(module, step_fns.build_eval_step(module, kind),
                              loader, ctx, config.limit_val_batches)
    ctx.log_metrics(metrics)
    module.teardown(stage)
    _call_hooks(callbacks, "teardown", ctx, module, stage)
    if dist is not None:
        return {"rank": dist.rank, "callback_metrics": metrics}
    return {"callback_metrics": metrics}


def run_predict(module: TrainModule, datamodule: TpuDataModule,
                config: FitConfig, device: torch.device, params=None,
                ckpt_path: Optional[str] = None,
                dist: Any = None) -> Dict[str, Any]:
    """The prediction loop: ``predict_step`` over the predict loader (the
    test loader when there is none), without gradients.  Returns
    ``{"prediction_batches": [host numpy array per batch]}``; the outputs
    stay on the device until the last batch is issued.  Under a strategy
    each rank predicts its rows of every batch and its package carries
    its rank (the driver interleaves them back into row order)."""
    module.precision = config.precision
    module.setup("predict")
    datamodule.set_shard(*((0, 1) if dist is None
                           else (dist.rank, dist.world_size)))
    datamodule.setup("predict")
    params = _resolve_params(module, config, device, params, ckpt_path)
    predict_step = step_fns.build_predict_step(module)
    loader = datamodule.predict_dataloader() or datamodule.test_dataloader()
    if loader is None:
        raise ValueError("datamodule provides no predict/test dataloader")
    outputs = [predict_step(params, step_fns.place_batch(batch, device))
               for batch in loader]
    module.teardown("predict")
    batches = [np.asarray(o.cpu()) for o in outputs]
    if dist is not None:
        return {"rank": dist.rank, "prediction_batches": batches}
    return {"prediction_batches": batches}
