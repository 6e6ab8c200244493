"""Training strategies (``ray_lightning_tpu/parallel/strategies.py``).

:class:`LocalStrategy` runs the fit in this process on one device.  The
data-parallel strategies run it on ``num_workers`` worker processes
(``cluster/actor.py``), one device each, joined by one
``torch.distributed`` process group:

1. ``setup`` spawns the workers through the cluster backend and runs
   ``init_hook`` on each;
2. ``run`` brokers the rendezvous (a free port of worker 0's host),
   ships the task (module, datamodule, config, callbacks) once through the
   object store, submits :func:`_execute_remote` to every rank and pumps
   the queue until every rank answers (``util.process_results``: a dead
   or failed rank raises at once);
3. the trainer adopts rank 0's package and merges every rank's
   telemetry; ``teardown`` kills the workers.

The flavors differ in the gradient sync of their step
(``parallel/step_fns.py::DistributedStep``, built by
``step_fns.build_dist_step``):

* :class:`RayStrategy` (``mode="gspmd"``): bucketed ``all_reduce``
  (``grad_sync.BucketSync``, the JAX bucket plan);
* :class:`HorovodRayStrategy` (``mode="shard_map"``): one ``all_reduce`` a
  leaf (``grad_sync.LeafSync``);
* :class:`RayShardedStrategy`: ZeRO-1 or ZeRO-3 (``sharding.ZeroPlan``).

The gradient wire's knobs, resolved on the workers against the real
world as the JAX package resolves them (``core/loop.py::_resolve_comm``):
``grad_comm`` (the int8 wire with or without error feedback,
``grad_sync.GradSync``; the Horovod flavor and ZeRO-3 keep full width,
warned), ``grad_overlap_segments`` (the sync inside the backward,
``parallel/overlap.py``) and ``update_sharding`` (the sharded weight
update of the ``RayStrategy`` flavor).

Restarts (the JAX ``TpuStrategy.run``'s governor): with
``max_restarts > 0`` a fit whose worker dies (``ActorDiedError``; a
``RemoteError`` from user code is raised, not retried) respawns the whole
worker set, after an exponential, jittered, capped backoff, within a
budget of ``max_restarts`` failures a sliding ``restart_window_s``, and
resumes from the newest verified restart checkpoint (each rank's
``RLTSHRD2`` pieces, written every ``restart_every_n_epochs`` epochs
under ``restart_dir``, else under a scratch directory
``<default_root_dir>/.rlt-restart-<8 hex>`` removed after the fit), which
worker 0 finds (the driver where it cannot), walking back past corrupt
ones.  With ``elastic_min_workers`` the governor shrinks the world to the
capacity ``elastic_capacity_fn`` reports when a worker dies (without
spending the budget, stopped by a flap guard) and grows back at a
restart; a resume at another world re-derives the accumulation factor.
``restarts_used``, ``resizes_used`` and ``recovery_events`` record it.

Model axes (``mesh_axes`` with ``sp``, ``tensor`` or ``expert``; the
JAX package trains them through the same ``Trainer.fit``): the workers
make their model groups (``mesh.model_groups``) and each rank holds its
slices of the weights, its batch rows by its data coordinate and, under
``sp``, its sequence rows (``core/loop.py``; ``parallel/
model_parallel.py``).  Refused, each naming its ROADMAP item: before any
worker runs (:func:`check_model_axes`), ``sp`` without
``attn_impl="ring"`` (JAX's GSPMD would gather K/V; the port does not),
MoE together with ``sp`` (routing positions would cross ranks), LoRA or
int8 moments under a model axis, and ZeRO on a mesh with no ``data`` or
``fsdp`` axis; on every rank, by the loop's resolvers, megastep K > 1,
the int8 wire, the overlapped sync and the sharded update there, and
``RLTSHRD2`` restart checkpoints (``restart_dir``, ``max_restarts``) of
a model-parallel layout (a ``RemoteError`` on the driver).  The ``RLTCKPT1`` checkpoint of such a fit
holds the gathered global arrays.

Departures, each raising rather than ignoring: ``backend`` names the
process group's backend ("nccl", the default for card workers, or
"gloo", the default for CPU workers; the strategy never switches on its
own), and NCCL's one rank a card is checked before spawning; the JAX
``backend`` (the control plane) is the ``RLT_BACKEND`` variable here,
"local" only.  Without ``elastic_capacity_fn`` the capacity is
``num_workers`` (the JAX default reads the fault plane's lost-worker
markers).  Preemption drains (``PreemptedError``, the drain-driven grow
of ``elastic_grow_after_s``, SIGTERM forwarding) and the run monitor are
ROADMAP Queue 1 item 6.

:class:`MpmdStrategy` is the pipeline plane (``mpmd/``): one worker
process a pipeline stage, its own programs on its own device, the stages
exchanging activations over the transfer lane (``mpmd/transfer.py``) and
joined by no process group.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import random
import shutil
import time
import uuid
import warnings
from typing import Any, Callable, Dict, List, Optional

import torch

from ray_lightning_tpu_torch import session as session_mod
from ray_lightning_tpu_torch.cluster import backend as backend_mod
from ray_lightning_tpu_torch.cluster import rpc
from ray_lightning_tpu_torch.cluster.actor import ActorDiedError, RemoteError
from ray_lightning_tpu_torch.core.loop import (
    FitConfig, _normalize_megastep, _normalize_update_sharding, run_eval,
    run_fit, run_predict,
)
from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.parallel import env_bus
from ray_lightning_tpu_torch.parallel.grad_sync import GradCommConfig
from ray_lightning_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from ray_lightning_tpu_torch.parallel.overlap import normalize_grad_overlap
from ray_lightning_tpu_torch.telemetry.monitor import make_event
from ray_lightning_tpu_torch.telemetry.runtime import TelemetryConfig
from ray_lightning_tpu_torch.util import process_results

__all__ = ["TpuStrategy", "LocalStrategy", "RayStrategy",
           "HorovodRayStrategy", "RayShardedStrategy", "MpmdStrategy",
           "RayPlugin", "HorovodRayPlugin", "RayShardedPlugin"]

MODES = ("gspmd", "shard_map")

# The flap guard's "no resize yet", distinct from a resize that resumed
# from scratch (None).
_RESIZE_CKPT_UNSET = object()
# How long a peer's collective error waits for a dead worker's future.
_DEATH_GRACE_S = 10.0

_ZERO2_WARNING = (
    "zero_stage=2 is equivalent to zero_stage=1 on this framework (GSPMD "
    "gradients are transient inside the jitted step; XLA reduce-scatters "
    "them automatically). Normalizing to zero_stage=1 — pass 1 or 3 "
    "explicitly to silence this warning.")


def _check_mode(mode: str, zero_stage: int) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if zero_stage not in (0, 1, 2, 3):
        raise ValueError("zero_stage must be 0, 1, 2 or 3")


# ---------------------------------------------------------------------------
# Worker side (top level: shipped to the workers by reference)
# ---------------------------------------------------------------------------

def _remote_latest_restart_checkpoint(restart_dir: str) -> Dict[str, Any]:
    """The newest complete and verified restart checkpoint in
    ``restart_dir`` (run on worker 0, the writer's filesystem, or in the
    driver): candidates newest first
    (``sharded_ckpt.list_restart_candidates``), each verified
    (``sharded_ckpt.verify_checkpoint``); a corrupt one is walked past to
    the one before it.  ``{"path": the checkpoint or None, "corrupt":
    [{"path", "problems"}, ...]}``."""
    from ray_lightning_tpu_torch.utils.sharded_ckpt import (
        list_restart_candidates, verify_checkpoint,
    )

    corrupt: List[Dict[str, Any]] = []
    for _, _, _, path in list_restart_candidates(restart_dir):
        problems = verify_checkpoint(path)
        if not problems:
            return {"path": path, "corrupt": corrupt}
        corrupt.append({"path": path, "problems": problems[:3]})
    return {"path": None, "corrupt": corrupt}


def _remote_find_free_port() -> int:
    """A free port on the worker's host (worker 0 hosts the rendezvous)."""
    return rpc.find_free_port()


def _worker_device(device: str, local_rank: int) -> torch.device:
    """The rank's device, resolved in its own process: card
    ``local_rank % device_count`` (one rank a card; ranks beyond the
    count share cards, which gloo allows and NCCL refuses), or the CPU."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available on this worker; "
                           "build the strategy with device='cpu'")
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _place_module(module: Any, device: torch.device) -> None:
    """A module built on the driver takes the worker's device (the port's
    GPT keeps the device its ``init_params`` puts params on)."""
    if isinstance(getattr(module, "device", None), torch.device):
        module.device = device


def _execute_remote(task_ref, global_rank: int, queue_handle
                    ) -> Dict[str, Any]:
    """One rank's run of a stage: install the session, resolve the
    device, join the process group, run the stage, return the rank's
    package."""
    import torch.distributed as torch_dist

    from ray_lightning_tpu_torch.parallel.mesh import (
        DistContext, bootstrap_distributed,
    )

    task = task_ref.get()
    world = task["world_size"]
    device = _worker_device(task["device"], global_rank)
    session_mod.init_session(rank=global_rank, queue=queue_handle,
                             num_workers=world, device=device)
    try:
        bootstrap_distributed(task["coordinator"], world, global_rank,
                              task["backend"], task["timeout_s"])
        layout = build_mesh(MeshSpec(task["mesh_axes"]), world)
        dist = DistContext(global_rank, world, device, task["backend"],
                           layout)
        dist.setup_model_groups()
        session_mod.get_session().mesh = layout
        module = task["module"]
        _place_module(module, device)
        kind = task["kind"]
        if kind == "fit":
            out = run_fit(module, task["datamodule"], task["config"],
                          task["callbacks"], device,
                          telemetry=task["telemetry"], dist=dist,
                          mode=task["mode"], zero_stage=task["zero_stage"],
                          grad_comm=task["grad_comm"])
        elif kind in ("validation", "test"):
            out = run_eval(module, task["datamodule"], task["config"],
                           task["callbacks"], device, kind,
                           task["params"], task["ckpt_path"], dist=dist)
        elif kind == "predict":
            out = run_predict(module, task["datamodule"], task["config"],
                              device, task["params"], task["ckpt_path"],
                              dist=dist)
        else:
            raise ValueError(f"Unknown stage kind {kind!r}")
        torch_dist.destroy_process_group()
        return out
    except NotImplementedError:
        # A refusal (the loop's, under model axes): every rank raises it
        # at the same point, with no collective in flight, and leaves the
        # group, so the worker can take the next stage.
        if torch_dist.is_initialized():
            torch_dist.destroy_process_group()
        raise
    finally:
        session_mod.shutdown_session()


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------

class TpuStrategy:
    """The worker lifecycle and the execution loop of the data-parallel
    strategies.  Arguments keep the JAX package's names:

    ``num_workers`` ranks, each ``num_cpus_per_worker`` CPUs and, with
    ``use_gpu`` (the reference's name for the JAX ``use_tpu``), one card;
    ``resources_per_worker`` overrides both (``"CPU"``, ``"GPU"``; other
    keys are kept as ``additional_resources_per_worker``).  ``device``:
    ``"cuda"`` or ``"cpu"`` (each worker takes its own card), by default
    from ``use_gpu``.  ``backend``: the process group's, ``"nccl"`` (card
    workers' default) or ``"gloo"`` (CPU workers' default, and the one
    that lets ranks share a card).  ``timeout_s`` bounds the rendezvous
    and every collective.  ``init_hook`` runs on every worker after it
    starts; ``env_per_worker`` and the forwarded ``RLT_*`` knobs
    (``env_bus``) are set in each worker's environment.  ``mesh_axes``:
    ``{"data": n}`` or ``{"fsdp": n}`` (-1 infers) over the ranks.
    ``telemetry`` and ``megastep`` as ``LocalStrategy``'s.  ``grad_comm``
    (None: ``RLT_GRAD_COMM``, else full width; ``"int8"``, ``"int8_ef"``,
    a dict or a ``GradCommConfig``), ``update_sharding`` (None, "auto",
    "on", "off") and ``grad_overlap_segments`` (None, "off", G) are
    validated here and resolved on the workers; the last two fill the
    Trainer's when that leaves them None.  ``max_restarts``,
    ``restart_every_n_epochs`` (it fills the Trainer's when that is
    unset), ``restart_window_s``, ``restart_backoff_s``,
    ``restart_backoff_max_s``, ``elastic_min_workers`` (else the
    ``RLT_ELASTIC_MIN_WORKERS`` variable, clamped into ``[1,
    num_workers]``) and ``elastic_capacity_fn`` govern restarts, as the
    module says.  The JAX arguments of later slices raise when set:
    ``elastic_grow_after_s`` (or ``RLT_ELASTIC_GROW_AFTER_S``), whose
    grow is driven by a drain, and ``monitor`` (ROADMAP Queue 1 item
    6)."""

    mode: str = "gspmd"
    zero_stage: int = 0

    def __init__(
        self,
        num_workers: int = 1,
        num_cpus_per_worker: int = 1,
        use_gpu: bool = True,
        init_hook: Optional[Callable[[], None]] = None,
        resources_per_worker: Optional[Dict[str, float]] = None,
        backend: Optional[str] = None,
        mesh_axes: Optional[Dict[str, int]] = None,
        env_per_worker: Optional[Dict[str, str]] = None,
        max_restarts: int = 0,
        restart_every_n_epochs: int = 1,
        restart_window_s: float = 3600.0,
        restart_backoff_s: float = 1.0,
        restart_backoff_max_s: float = 60.0,
        grad_comm=None,
        telemetry=None,
        monitor=None,
        megastep=None,
        update_sharding=None,
        grad_overlap_segments=None,
        elastic_min_workers: Optional[int] = None,
        elastic_grow_after_s: Optional[float] = None,
        elastic_capacity_fn: Optional[Callable[[], int]] = None,
        device: Optional[str] = None,
        timeout_s: float = 600.0,
    ):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.num_workers = num_workers
        resources = dict(resources_per_worker or {})
        self.num_cpus_per_worker = int(resources.pop("CPU",
                                                     num_cpus_per_worker))
        if "GPU" in resources:
            use_gpu = resources.pop("GPU") > 0
        self.use_gpu = bool(use_gpu)
        self.additional_resources_per_worker = resources
        self.init_hook = init_hook
        if elastic_grow_after_s is None:
            env = os.environ.get("RLT_ELASTIC_GROW_AFTER_S")
            elastic_grow_after_s = float(env) if env else None
        later = {
            "elastic_grow_after_s": elastic_grow_after_s,
            "monitor": monitor,
        }
        for name, value in later.items():
            if value is not None:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet (the drain plane "
                    f"and the run monitor, ROADMAP Queue 1 item 6)")
        if max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        if restart_every_n_epochs < 1:
            raise ValueError("restart_every_n_epochs must be >= 1")
        if restart_window_s <= 0:
            raise ValueError("restart_window_s must be > 0")
        if restart_backoff_s < 0 or restart_backoff_max_s < 0:
            raise ValueError("restart backoff times must be >= 0")
        self.max_restarts = max_restarts
        self.restart_every_n_epochs = restart_every_n_epochs
        self.restart_window_s = restart_window_s
        self.restart_backoff_s = restart_backoff_s
        self.restart_backoff_max_s = restart_backoff_max_s
        self.restarts_used = 0
        # Drains are not ported (item 6): this stays 0.
        self.preempt_restarts_used = 0
        if elastic_min_workers is None:
            env = os.environ.get("RLT_ELASTIC_MIN_WORKERS")
            if env:
                elastic_min_workers = min(max(int(env), 1), num_workers)
        if elastic_min_workers is not None and not (
                1 <= elastic_min_workers <= num_workers):
            raise ValueError(
                f"elastic_min_workers must be in [1, num_workers="
                f"{num_workers}], got {elastic_min_workers}")
        self.elastic_min_workers = elastic_min_workers
        self.elastic_grow_after_s = elastic_grow_after_s
        self.elastic_capacity_fn = elastic_capacity_fn
        # The world the governor runs: num_workers is the ceiling.
        self.active_workers = num_workers
        self.resizes_used = 0
        self.last_resize_recover_s: Optional[float] = None
        self._last_resize_ckpt: Any = _RESIZE_CKPT_UNSET
        self._resize_streak = 0
        self.recovery_events: List[Dict[str, Any]] = []
        # Validated here, so a typo fails at construction, not on a
        # worker; resolved against the real world on the workers.
        if grad_comm is not None:
            grad_comm = GradCommConfig.coerce(grad_comm)
        self.grad_comm = grad_comm
        _normalize_update_sharding(update_sharding)
        self.update_sharding = update_sharding
        normalize_grad_overlap(grad_overlap_segments)
        self.grad_overlap_segments = grad_overlap_segments
        _check_mode(self.mode, self.zero_stage)
        if telemetry is not None:
            telemetry = TelemetryConfig.coerce(telemetry)
        self.telemetry = telemetry
        _normalize_megastep(megastep)
        self.megastep = megastep
        build_mesh(MeshSpec(mesh_axes), num_workers)
        self.mesh_axes = mesh_axes
        self.device = device or ("cuda" if self.use_gpu else "cpu")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(
                f"device {device!r}: a strategy's workers take 'cuda' (each "
                f"its own card) or 'cpu'")
        self.use_gpu = self.device == "cuda"
        self.backend = backend or ("nccl" if self.use_gpu else "gloo")
        if self.backend not in ("nccl", "gloo"):
            raise ValueError(
                f"backend {backend!r}: the process group's backend is "
                f"'nccl' or 'gloo' (the JAX package's control-plane "
                f"backend is the RLT_BACKEND variable here)")
        self._check_devices()
        self.timeout_s = float(timeout_s)
        self.env_per_worker = dict(env_per_worker or {})
        for var in env_bus.forwarded_vars():
            val = os.environ.get(var)
            if val is not None:
                self.env_per_worker.setdefault(var, val)
        self._backend: Optional[backend_mod.ClusterBackend] = None
        self._workers: list = []

    def _check_devices(self) -> None:
        """Raise before any worker exists for what the workers could not
        run: card workers without a card, NCCL on the CPU, and more NCCL
        ranks than cards (NCCL refuses two ranks on one device).  Reads
        the card count without initialising CUDA in this process."""
        if self.use_gpu and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (and "
                "backend='gloo') to run the workers on the CPU")
        if self.backend == "nccl" and not self.use_gpu:
            raise ValueError("backend='nccl' needs card workers; CPU "
                             "workers take backend='gloo'")
        if self.backend == "nccl":
            cards = torch.cuda.device_count()
            if self.num_workers > cards:
                raise ValueError(
                    f"backend='nccl' with num_workers={self.num_workers} on "
                    f"a host with {cards} card(s): NCCL refuses two ranks "
                    f"on one device; use num_workers <= {cards}, or "
                    f"backend='gloo' to let ranks share a card")

    @property
    def world_size(self) -> int:
        """The governor's current world: ``num_workers`` unless an elastic
        resize changed it."""
        return self.active_workers

    # -- lifecycle ----------------------------------------------------------
    def setup(self, trainer=None) -> None:
        """Spawn the workers and run ``init_hook`` on each."""
        if self._workers:
            return
        self._backend = backend_mod.get_backend()
        self._spawn_workers()

    def _spawn_workers(self) -> None:
        # Names unique a generation: a respawned set never reuses one.
        gen = getattr(self, "_spawn_generation", 0)
        self._spawn_generation = gen + 1
        suffix = "" if gen == 0 else f"-r{gen}"
        for i in range(self.active_workers):
            self._workers.append(self._backend.create_actor(
                name=f"rlt-worker-{i}{suffix}",
                env=self.env_per_worker or None,
                num_cpus=self.num_cpus_per_worker,
                resources=self.additional_resources_per_worker or None))
        if self.init_hook is not None:
            for f in [w.submit(self.init_hook) for w in self._workers]:
                f.result()

    def _kill_workers(self) -> None:
        """Kill every current worker (a dead rank's peers may be stuck in a
        collective); one already dead is fine."""
        for w in self._workers:
            try:
                w.kill()
            except Exception:  # noqa: BLE001 - already dead
                pass
        self._workers = []

    def _respawn_workers(self) -> None:
        """A fresh worker set of ``active_workers``."""
        self._kill_workers()
        self._spawn_workers()

    def _broker_coordinator(self) -> str:
        """Worker 0's host and a free port there: the rendezvous."""
        port = self._workers[0].execute(_remote_find_free_port)
        return f"127.0.0.1:{port}"

    def run(self, kind: str, module, datamodule, config: FitConfig,
            callbacks: List, params=None, ckpt_path: Optional[str] = None
            ) -> List[Dict[str, Any]]:
        """Every rank's package of stage ``kind``, in rank order.  With
        ``max_restarts > 0`` a fit survives worker death: the governor of
        the module docstring respawns the worker set and resumes from the
        newest verified restart checkpoint (at most
        ``restart_every_n_epochs`` epochs of work lost)."""
        if not self._workers:
            raise RuntimeError("setup() must run first")
        config = _fill_config(config, self)
        if kind == "fit":
            check_model_axes(module, self)
        elastic = self.max_restarts > 0 and kind == "fit"
        if elastic and config.restart_every_n_epochs is None:
            config = dataclasses.replace(
                config, restart_every_n_epochs=self.restart_every_n_epochs)
        restart_dir = None
        if elastic and config.restart_dir is None:
            restart_dir = os.path.join(
                config.default_root_dir,
                f".rlt-restart-{uuid.uuid4().hex[:8]}")
            config = dataclasses.replace(config, restart_dir=restart_dir)
        if kind == "fit":
            self.recovery_events = []
            self._resize_streak = 0
            self._last_resize_ckpt = _RESIZE_CKPT_UNSET
        fail_times: List[float] = []
        try:
            while True:
                try:
                    return self._run_once(kind, module, datamodule, config,
                                          callbacks, params, ckpt_path)
                # Only process death is retried: an exception in user
                # code (RemoteError) would only raise again.
                except ActorDiedError as err:
                    if not elastic:
                        raise
                    config = self._recover(err, config, fail_times)
        finally:
            if restart_dir is not None:
                shutil.rmtree(restart_dir, ignore_errors=True)

    def _recover(self, err: ActorDiedError, config: FitConfig,
                 fail_times: List[float]) -> FitConfig:
        """One worker death of an elastic fit: the next attempt's config
        (resuming from the newest verified checkpoint), or ``err``
        raised with its note."""
        t_recover = time.monotonic()
        target, rejected = self._elastic_resize_decision()
        if rejected:
            self._record_resize_rejected(target)
            err.enrich(note=(
                f"fleet capacity {target} below elastic_min_workers="
                f"{self.elastic_min_workers} — shrink rejected, restart "
                f"abandoned"))
            raise err
        if target is not None and target < self.active_workers:
            # Capacity loss explains the death: respawn the survivors
            # without spending the budget, flap-guarded by the resume
            # point's progress.  The doomed set goes first (its peers may
            # be wedged in a collective).
            self._kill_workers()
            resume = self._discover_resume(config)["path"]
            self._resize_streak = (self._resize_streak + 1
                                   if resume == self._last_resize_ckpt
                                   else 0)
            self._last_resize_ckpt = resume
            if self._resize_streak >= 2:
                err.enrich(note="no forward progress across consecutive "
                                "elastic resizes — flap guard stopped the "
                                "shrink loop")
                raise err
            warnings.warn(
                f"Worker loss with reduced fleet capacity ({err}); elastic "
                f"shrink to {target} survivors (budget untouched), resuming "
                f"from {resume or 'scratch'}.")
            self._respawn_resized(target, t_recover, resume,
                                  why="capacity loss")
            return _resume_config(config, resume)
        now = time.monotonic()
        fail_times[:] = [t for t in fail_times
                         if now - t <= self.restart_window_s]
        if len(fail_times) >= self.max_restarts:
            err.enrich(note=(
                f"restart budget exhausted: {self.max_restarts} failure(s) "
                f"within {self.restart_window_s:.0f}s"))
            raise err
        fail_times.append(now)
        self.restarts_used += 1
        # The backoff's exponent: the failures in the window.
        streak = len(fail_times)
        delay = self._backoff_delay(streak)
        if delay > 0:
            self._record_recovery(
                "backoff", delay_s=round(delay, 3), attempt=streak,
                message=(f"waiting {delay:.2f}s before respawn #{streak} "
                         f"(exponential backoff with jitter)"))
            time.sleep(delay)
        t_recover = time.monotonic()
        # A restart is also the chance to grow back to the capacity.
        old = self.active_workers
        grew = target is not None and target != old
        if grew:
            self.active_workers = int(target)
        self._respawn_workers()
        resume = self._discover_resume(config)["path"]
        if grew:
            self._record_resize(old, int(target), t_recover, resume,
                                why="restart")
        self._record_recovery(
            "elastic_restart", attempt=streak,
            recover_s=round(time.monotonic() - t_recover, 3),
            ckpt=resume or "",
            message=(f"worker failure; elastic restart {len(fail_times)}/"
                     f"{self.max_restarts} in window, resuming from "
                     f"{resume or 'scratch'}"))
        warnings.warn(
            f"Worker failure ({err}); elastic restart {len(fail_times)}/"
            f"{self.max_restarts} (window {self.restart_window_s:.0f}s), "
            f"resuming from {resume or 'scratch'}.")
        return _resume_config(config, resume)

    def _run_once(self, kind: str, module, datamodule, config: FitConfig,
                  callbacks: List, params=None,
                  ckpt_path: Optional[str] = None) -> List[Dict[str, Any]]:
        """Ship, submit, pump, collect: one attempt over the current
        worker set."""
        # A module that ran a fit here still points at that fit's loop
        # context (threads, locks): ship a copy without it.
        module = copy.copy(module)
        module.trainer = None
        task = {
            "kind": kind, "module": module, "datamodule": datamodule,
            "config": config, "callbacks": callbacks,
            "world_size": self.active_workers,
            "coordinator": self._broker_coordinator(),
            "mesh_axes": self.mesh_axes, "mode": self.mode,
            "zero_stage": self.zero_stage, "grad_comm": self.grad_comm,
            "telemetry": self.telemetry,
            "device": self.device, "backend": self.backend,
            "timeout_s": self.timeout_s, "params": params,
            "ckpt_path": ckpt_path,
        }
        task_ref = self._backend.put(task)
        queue = self._backend.create_queue()
        futures: list = []
        try:
            futures = [w.submit(_execute_remote, task_ref, rank,
                                queue.handle)
                       for rank, w in enumerate(self._workers)]
            return process_results(futures, queue)
        except RemoteError as err:
            # Over gloo a peer's collective fails at once when a rank's
            # process dies, which can reach the driver first: the death
            # is the failure.
            died = self._dead_peer(futures)
            if died is None:
                raise
            self._enrich_failure(died, futures)
            raise died from err
        except ActorDiedError as err:
            self._enrich_failure(err, futures)
            raise
        finally:
            queue.shutdown()
            task_ref.release()

    def _dead_peer(self, futures) -> Optional[ActorDiedError]:
        """The ``ActorDiedError`` of a worker whose process exited, once
        its future resolves (within ``_DEATH_GRACE_S``); None while every
        worker process lives."""
        deadline = time.monotonic() + _DEATH_GRACE_S
        while True:
            for f in futures:
                if f.done() and isinstance(f.exception(), ActorDiedError):
                    return f.exception()
            if (all(w.is_alive() for w in self._workers)
                    or time.monotonic() > deadline):
                return None
            time.sleep(0.05)

    # -- restart discovery and bookkeeping -----------------------------------
    def _latest_restart_checkpoint(self, restart_dir: Optional[str]
                                   ) -> Dict[str, Any]:
        """The newest verified restart checkpoint, looked up on worker 0
        (the writer's filesystem), in the driver when worker 0 cannot
        answer."""
        if restart_dir is None:
            return {"path": None, "corrupt": []}
        if self._workers:
            try:
                return self._workers[0].execute(
                    _remote_latest_restart_checkpoint, restart_dir)
            except (ActorDiedError, RemoteError):
                pass
        return _remote_latest_restart_checkpoint(restart_dir)

    def _discover_resume(self, config: FitConfig) -> Dict[str, Any]:
        """Discovery, with each checkpoint walked past booked as a
        ``ckpt_corrupt`` event and a warning."""
        info = self._latest_restart_checkpoint(config.restart_dir)
        for item in info.get("corrupt", []):
            problems = "; ".join(str(p) for p in item.get("problems", []))
            self._record_recovery(
                "ckpt_corrupt", ckpt=item.get("path", ""),
                message=(f"checkpoint failed verification, falling back to "
                         f"an older one: {problems}"))
            warnings.warn(f"corrupt restart checkpoint skipped: "
                          f"{item.get('path')} ({problems})")
        return info

    def _record_recovery(self, kind: str, **fields: Any) -> None:
        """A fleet-wide recovery event (``telemetry.monitor.make_event``,
        rank -1), kept in ``recovery_events``."""
        self.recovery_events.append(make_event(kind, -1, **fields))

    def _backoff_delay(self, streak: int) -> float:
        """``restart_backoff_s · 2^(streak-1)``, capped at
        ``restart_backoff_max_s``, plus up to 25% jitter."""
        if self.restart_backoff_s <= 0:
            return 0.0
        base = min(self.restart_backoff_s * (2 ** max(streak - 1, 0)),
                   self.restart_backoff_max_s)
        return base * (1.0 + 0.25 * random.random())

    # -- elastic world sizing ------------------------------------------------
    def _fleet_capacity(self) -> int:
        """The workers the fleet can host now: ``elastic_capacity_fn()``,
        else ``num_workers``."""
        if self.elastic_capacity_fn is not None:
            return int(self.elastic_capacity_fn())
        return self.num_workers

    def _elastic_resize_decision(self):
        """``(target world, rejected)``: None without
        ``elastic_min_workers`` (a fixed world); ``rejected`` where the
        capacity is below that floor."""
        if self.elastic_min_workers is None:
            return None, False
        target = max(min(self._fleet_capacity(), self.num_workers), 0)
        return target, target < self.elastic_min_workers

    def _record_resize_rejected(self, target: int) -> None:
        self._record_recovery(
            "resize_rejected", old_world=self.active_workers,
            new_world=target,
            message=(f"fleet capacity {target} below elastic_min_workers="
                     f"{self.elastic_min_workers}; shrink rejected"))

    def _respawn_resized(self, target: Optional[int], t_recover: float,
                         resume: Optional[str], why: str) -> None:
        old = self.active_workers
        changed = target is not None and target != old
        if changed:
            self.active_workers = int(target)
        self._respawn_workers()
        if changed:
            self._record_resize(old, int(target), t_recover, resume, why)

    def _record_resize(self, old: int, new: int, t_recover: float,
                       resume: Optional[str], why: str) -> None:
        """One applied resize: the ``resize`` event with the old and new
        world and the seconds it took, and a warning."""
        recover_s = round(time.monotonic() - t_recover, 3)
        self.resizes_used += 1
        self.last_resize_recover_s = recover_s
        self._record_recovery(
            "resize", old_world=old, new_world=new, recover_s=recover_s,
            ckpt=resume or "",
            message=(f"elastic resize: world {old} → {new} ({why}); "
                     f"recovered in {recover_s}s"))
        warnings.warn(f"elastic resize: world {old} → {new} ({why})")

    def _enrich_failure(self, err, futures) -> None:
        rank = next((i for i, f in enumerate(futures)
                     if f.done() and f.exception() is err), None)
        if isinstance(err, ActorDiedError) and rank is not None:
            err.enrich(rank=rank, exit_code=self._workers[rank].exit_code)

    def teardown(self) -> None:
        """Kill the workers and shut the backend down."""
        if self._backend is not None:
            self._backend.shutdown()
        self._workers = []
        self._backend = None

    # -- introspection ------------------------------------------------------
    def get_worker_device_info(self) -> List[Dict[str, Any]]:
        """Each worker's devices, as its own process sees them."""
        return [w.get_device_info() for w in self._workers]


def check_model_axes(module: Any, strategy: Any) -> None:
    """Raise, before any worker runs, for a model or a mesh under
    ``strategy``'s model axes that the port does not run, naming its
    ROADMAP item (Queue 1 item 3's leftovers).  The fit's knobs under
    model axes (megastep, the gradient wire, the sharded update,
    ``RLTSHRD2`` restarts) are refused by the loop's resolvers that decide
    them, on every rank (``core/loop.py``)."""
    layout = build_mesh(MeshSpec(strategy.mesh_axes), strategy.world_size)
    model = layout.model_axes
    if not model:
        return
    cfg = getattr(module, "config", None)

    def refuse(what: str) -> None:
        raise NotImplementedError(
            f"{what} under the model axes of mesh {layout.sizes} is not "
            f"ported (ROADMAP Queue 1 item 3)")

    if "sp" in model and getattr(module, "attn_impl", None) != "ring":
        refuse(f"an 'sp' axis with attn_impl="
               f"{getattr(module, 'attn_impl', None)!r} (the JAX package's "
               f"GSPMD gathers K/V over 'sp'; the port cuts the sequence "
               f"for ring attention only: pass attn_impl='ring')")
    if "sp" in model and getattr(cfg, "n_experts", 0) > 0:
        refuse("MoE together with 'sp' (routing positions would cross "
               "ranks)")
    if getattr(cfg, "lora_rank", 0) > 0:
        refuse("LoRA")
    if getattr(cfg, "opt_state_dtype", None) == "int8":
        refuse("opt_state_dtype='int8'")
    if strategy.zero_stage and not any(a in layout.sizes
                                       for a in ("data", "fsdp")):
        raise ValueError(
            f"ZeRO shards over a 'data' or 'fsdp' axis; mesh "
            f"{layout.sizes} has neither")


def _resume_config(config: FitConfig, resume: Optional[str]) -> FitConfig:
    """The next attempt resumes from ``resume`` (from scratch when None)."""
    if resume is None:
        return config
    return dataclasses.replace(config, resume_from_checkpoint=resume)


def _fill_config(config: FitConfig, strategy) -> FitConfig:
    """The strategy's ``megastep``, ``update_sharding`` and
    ``grad_overlap_segments`` where the Trainer's config leaves them None
    (an explicit Trainer knob wins)."""
    for name in ("megastep", "update_sharding", "grad_overlap_segments"):
        value = getattr(strategy, name)
        if getattr(config, name) is None and value is not None:
            config = dataclasses.replace(config, **{name: value})
    return config


class LocalStrategy:
    """Run the fit in this process on ``device`` (``None`` means
    ``"cuda"``, and raises without a card; pass ``"cpu"`` for the plain
    PyTorch path).

    ``telemetry``: ``None`` (the ``RLT_TELEMETRY`` variable, else the
    cheap tier), ``"cheap"``, ``"off"``, a dict with ``tier`` and
    ``sample_every``, or a ``TelemetryConfig``; ``"full"`` raises (a later
    slice).  ``megastep``: K micro-steps a dispatch (``"auto"``, ``"off"``
    or an int); it fills the Trainer's when that is unset.  ``mode`` and
    ``zero_stage`` are the JAX ``LocalStrategy``'s; on one device they
    change nothing, but they are checked.  ``grad_comm``,
    ``update_sharding`` and ``grad_overlap_segments`` are checked as the
    data-parallel strategies check them; on one device they resolve as
    the JAX rule does for one: full width, a replicated update
    (``update_sharding="on"`` warns), and the trunk cut G ways when G is
    set."""

    def __init__(self, device=None, telemetry=None, megastep=None,
                 mode: str = "gspmd", zero_stage: int = 0, grad_comm=None,
                 update_sharding=None, grad_overlap_segments=None):
        if telemetry is not None:
            telemetry = TelemetryConfig.coerce(telemetry)
        self.telemetry = telemetry
        _normalize_megastep(megastep)
        self.megastep = megastep
        _check_mode(mode, zero_stage)
        self.mode = mode
        self.zero_stage = zero_stage
        if grad_comm is not None:
            grad_comm = GradCommConfig.coerce(grad_comm)
        self.grad_comm = grad_comm
        _normalize_update_sharding(update_sharding)
        self.update_sharding = update_sharding
        normalize_grad_overlap(grad_overlap_segments)
        self.grad_overlap_segments = grad_overlap_segments
        self.device = resolve_device(device)

    def setup(self, trainer=None) -> None:
        pass

    def teardown(self) -> None:
        pass

    def run(self, kind: str, module, datamodule, config: FitConfig,
            callbacks: List, params=None,
            ckpt_path: Optional[str] = None) -> Dict[str, Any]:
        """Run stage ``kind`` ("fit", "validation", "test" or "predict")
        here; the eval stages take ``params`` (a fitted state's, handed
        over as they are) or ``ckpt_path``."""
        config = _fill_config(config, self)
        if kind == "fit":
            return run_fit(module, datamodule, config, callbacks,
                           self.device, telemetry=self.telemetry,
                           mode=self.mode, zero_stage=self.zero_stage,
                           grad_comm=self.grad_comm)
        if kind in ("validation", "test"):
            return run_eval(module, datamodule, config, callbacks,
                            self.device, kind, params, ckpt_path)
        if kind == "predict":
            return run_predict(module, datamodule, config, self.device,
                               params, ckpt_path)
        raise ValueError(f"unknown stage {kind!r}: expected 'fit', "
                         f"'validation', 'test' or 'predict'")


class RayStrategy(TpuStrategy):
    """Data parallel over worker processes (≙ ``RayPlugin``): bucketed
    ``all_reduce`` of the gradients (``grad_sync.BucketSync``), or the
    int8 wire (``grad_comm``); ``update_sharding`` shards the update."""

    mode = "gspmd"
    zero_stage = 0


class HorovodRayStrategy(TpuStrategy):
    """The explicit-collective flavor (≙ ``HorovodRayPlugin``): one
    ``all_reduce`` a gradient leaf (``grad_sync.LeafSync``)."""

    mode = "shard_map"
    zero_stage = 0


class RayShardedStrategy(TpuStrategy):
    """ZeRO-sharded data parallel (≙ ``RayShardedPlugin``):
    ``zero_stage=1`` shards the optimizer moments over the ranks,
    ``zero_stage=3`` the params as well (``sharding.ZeroPlan``).
    ``zero_stage=2`` is normalized to 1 with the JAX package's warning."""

    mode = "gspmd"

    def __init__(self, *args, zero_stage: int = 1, **kwargs):
        if zero_stage not in (1, 2, 3):
            raise ValueError("zero_stage must be 1, 2 or 3")
        if zero_stage == 2:
            warnings.warn(_ZERO2_WARNING)
            zero_stage = 1
        self.zero_stage = zero_stage
        super().__init__(*args, **kwargs)


class MpmdStrategy(TpuStrategy):
    """MPMD pipeline parallelism (the JAX package's ``MpmdStrategy``): one
    worker process a pipeline stage, each with its own device and its own
    programs (``mpmd/stage.py``), following explicit per-worker
    instruction streams (``mpmd/schedule.py``) and exchanging
    activations and their gradients over the transfer lane
    (``mpmd/transfer.py``: a shared-memory segment a payload, or the
    queue frame itself below 256 KiB).  There is no process group: the
    lanes carry
    everything, so two stages may share a card (NCCL would refuse two
    ranks on one).

    ``num_stages`` workers; ``schedule`` ("gpipe" | "1f1b");
    ``num_microbatches``; ``interleave`` (model chunks a worker, the
    interleaved 1F1B); ``ckpt_every_n_steps`` (per-stage restart
    checkpoints; the restart governor resumes at the newest step every
    stage persisted); ``tx_factory`` (the per-stage optimizer; default
    the spec's, ``gpt_adamw`` for GPT); ``trace_dir`` (each stage exports
    ``trace-mpmd-stage<k>.jsonl`` there); ``wire_dtype`` (the lane's
    codec, ``mpmd/transfer.py::WireDtypeConfig``; None reads
    ``RLT_MPMD_WIRE_DTYPE``).  A dead stage raises ``ActorDiedError``
    into the inherited restart governor (``max_restarts``).

    Devices: ``use_gpu`` defaults to ``devices_per_stage is None`` (the
    JAX ``use_tpu`` rule): a stage runs on card ``stage % cards`` (on a
    one-card host every stage shares card 0), and without a card the
    strategy raises.  ``devices_per_stage=1`` runs the stages as CPU
    workers (the JAX knob sets the virtual device count of a CPU stage's
    mesh; the math is the same); a stage over several cards (a
    data-parallel group inside each stage) raises, ROADMAP Queue 1 item
    4b.

    Fit-only; ``mpmd_report`` holds the fit's pipeline report (losses,
    per-stage stats, ``op_costs_ms``, ``bubble_fraction``,
    ``stage_occupancy``, ``xfer``), and ``<default_root_dir>/telemetry/
    mpmd-live.json`` the live snapshot.  The Trainer adopts the
    reassembled params (with the untied ``head_w``) and no optimizer
    state: the moments stay with their stages."""

    zero_stage = 0

    def __init__(self, num_stages: int = 2, schedule: str = "1f1b",
                 num_microbatches: int = 8, interleave: int = 1,
                 devices_per_stage: Optional[int] = None,
                 recv_timeout_s: float = 120.0,
                 ckpt_every_n_steps: int = 1,
                 tx_factory: Optional[Callable[[], Any]] = None,
                 trace_dir: Optional[str] = None, wire_dtype: Any = None,
                 **kwargs: Any):
        from ray_lightning_tpu_torch.mpmd.schedule import SCHEDULES
        from ray_lightning_tpu_torch.mpmd.transfer import WireDtypeConfig

        if wire_dtype is not None:
            # A bad codec string fails here, not in a stage worker; the
            # raw knob ships (None defers to RLT_MPMD_WIRE_DTYPE there).
            WireDtypeConfig.coerce(wire_dtype)
        if num_stages < 1:
            raise ValueError("num_stages must be >= 1")
        if schedule not in SCHEDULES:
            raise ValueError(
                f"unknown schedule {schedule!r} (expected one of "
                f"{SCHEDULES})"
            )
        if interleave < 1:
            raise ValueError("interleave must be >= 1")
        if interleave > 1 and schedule != "1f1b":
            raise ValueError(
                "interleave > 1 requires schedule='1f1b' (interleaved "
                "GPipe would deepen the pipe without shrinking the "
                "bubble)"
            )
        if interleave > 1 and num_stages < 2:
            raise ValueError(
                "interleave > 1 needs num_stages >= 2: a single worker "
                "has no pipeline to overlap, and its chunk handoffs "
                "would need a self-loop transfer lane the actor plane "
                "does not wire"
            )
        if num_microbatches < 1:
            raise ValueError("num_microbatches must be >= 1")
        if ckpt_every_n_steps < 1:
            raise ValueError("ckpt_every_n_steps must be >= 1")
        if kwargs.get("elastic_min_workers") is not None:
            raise ValueError(
                "MpmdStrategy cannot resize elastically: the stage "
                "count is structural (the layer split is baked into "
                "every stage's compiled program); run SPMD strategies "
                "for shrink/grow recovery"
            )
        if devices_per_stage is not None and devices_per_stage != 1:
            raise NotImplementedError(
                f"devices_per_stage={devices_per_stage}: a stage over "
                f"several devices (a data-parallel group inside each "
                f"stage) is not ported (ROADMAP Queue 1 item 4b); "
                f"devices_per_stage=1 runs CPU stages, None one card a "
                f"stage")
        kwargs.setdefault("use_gpu", devices_per_stage is None)
        super().__init__(num_workers=num_stages, **kwargs)
        # Set past the SPMD strategies' mode check: the plane runs no
        # SPMD program.
        self.mode = "mpmd"
        # The fleet-wide RLT_ELASTIC_* knobs do not apply to a structural
        # stage count.
        self.elastic_min_workers = None
        self.schedule = schedule
        self.num_microbatches = num_microbatches
        self.interleave = interleave
        self.devices_per_stage = devices_per_stage
        self.recv_timeout_s = recv_timeout_s
        self.ckpt_every_n_steps = ckpt_every_n_steps
        self.tx_factory = tx_factory
        self.wire_dtype = wire_dtype
        self.trace_dir = trace_dir
        self.mpmd_report: Dict[str, Any] = {}
        self._live_stage_items: Dict[int, Dict[str, Any]] = {}
        self._live_written_at = 0.0
        self._live_dir: Optional[str] = None

    def _check_devices(self) -> None:
        """Card stages need a card; the process group's checks do not
        apply (the plane opens none)."""
        if self.use_gpu and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices_per_stage=1 to "
                "run the stages on the CPU")

    def run(self, kind: str, module, datamodule, config: FitConfig,
            callbacks: List, params=None, ckpt_path: Optional[str] = None
            ) -> List[Dict[str, Any]]:
        if kind != "fit":
            raise NotImplementedError(
                "MpmdStrategy supports fit only; run validate/test/"
                "predict through an SPMD strategy on the trained params")
        return super().run(kind, module, datamodule, config, callbacks,
                           params, ckpt_path)

    def _latest_restart_checkpoint(self, restart_dir: Optional[str]
                                   ) -> Dict[str, Any]:
        from ray_lightning_tpu_torch.mpmd.worker import (
            latest_mpmd_checkpoint,
        )

        return latest_mpmd_checkpoint(restart_dir, self.num_workers)

    def _kill_workers(self) -> None:
        """Kill the stage workers and reclaim the segments of dead
        producers (a stage killed mid-handoff leaves its own)."""
        from ray_lightning_tpu_torch.cluster.shm import sweep_stale_segments

        super()._kill_workers()
        sweep_stale_segments()

    # -- live export ---------------------------------------------------------
    def _on_mpmd_item(self, item: Any) -> None:
        if not (isinstance(item, dict)
                and item.get("type") == "mpmd_stage"):
            return
        self._live_stage_items[int(item.get("stage", -1))] = item
        now = time.monotonic()
        if self._live_dir is None or now - self._live_written_at < 0.5:
            return
        self._live_written_at = now
        self._write_live_snapshot()

    def _live_snapshot(self) -> Dict[str, Any]:
        stages = [self._live_stage_items[k]
                  for k in sorted(self._live_stage_items)]
        return {
            "ts": time.time(),
            "mpmd": {
                "schedule": self.schedule,
                "interleave": self.interleave,
                "n_micro": self.num_microbatches,
                "n_stages": self.num_workers,
                "stages": stages,
            },
        }

    def _write_live_snapshot(self) -> None:
        import json

        if self._live_dir is None:
            return
        try:
            os.makedirs(self._live_dir, exist_ok=True)
            path = os.path.join(self._live_dir, "mpmd-live.json")
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self._live_snapshot(), f)
            os.replace(tmp, path)
        except OSError:
            pass

    def _run_once(self, kind: str, module, datamodule, config: FitConfig,
                  callbacks: List, params=None,
                  ckpt_path: Optional[str] = None) -> List[Dict[str, Any]]:
        from ray_lightning_tpu_torch.mpmd import worker as mpmd_worker
        from ray_lightning_tpu_torch.mpmd.plan import (
            StagePlan, resolve_mpmd_spec,
        )
        from ray_lightning_tpu_torch.mpmd.schedule import (
            fleet_pipeline_stats, measured_schedule_bubble, pool_op_costs,
        )

        module = copy.copy(module)
        module.trainer = None
        spec = resolve_mpmd_spec(module)  # fail fast, before any worker
        plan = StagePlan.split(spec.n_layers,
                               self.num_workers * self.interleave)
        self._live_stage_items = {}
        self._live_dir = os.path.join(config.default_root_dir, "telemetry")
        n = self.num_workers
        # Every worker's inbox at once (a fresh worker's first call pays
        # its imports).
        addrs = [f.result() for f in [
            w.submit(mpmd_worker._remote_create_inbox)
            for w in self._workers]]
        task = {
            "module": module, "datamodule": datamodule, "config": config,
            "n_workers": n, "interleave": self.interleave,
            "n_micro": self.num_microbatches, "schedule": self.schedule,
            "device": self.device, "same_host": True,
            "recv_timeout_s": self.recv_timeout_s,
            "restart_dir": config.restart_dir,
            "resume_prefix": config.resume_from_checkpoint,
            "ckpt_every": self.ckpt_every_n_steps,
            "steps": (config.max_steps if config.max_steps
                      and config.max_steps > 0 else None),
            "tx_factory": self.tx_factory, "trace_dir": self.trace_dir,
            "wire_dtype": self.wire_dtype,
        }
        task_ref = self._backend.put(task)
        queue = self._backend.create_queue()
        futures: list = []
        try:
            futures = [
                w.submit(mpmd_worker._stage_execute_remote, task_ref, rank,
                         queue.handle,
                         addrs[(rank - 1) % n] if n > 1 else None,
                         addrs[(rank + 1) % n] if n > 1 else None)
                for rank, w in enumerate(self._workers)]
            results = process_results(futures, queue,
                                      on_item=self._on_mpmd_item)
        except RemoteError as err:
            # A dead stage wedges its peers' lanes: a peer's failure can
            # reach this process before the death does, and the death is
            # the failure (the restart governor takes it).
            died = self._dead_peer(futures)
            if died is None:
                raise
            self._enrich_failure(died, futures)
            first = str(err).splitlines()
            raise ActorDiedError(
                f"stage worker {died.rank} died mid-fit (peer error: "
                f"{first[-1] if first else err})", rank=died.rank,
                exit_code=died.exit_code) from err
        except ActorDiedError as err:
            self._enrich_failure(err, futures)
            raise
        finally:
            queue.shutdown()
            task_ref.release()

        # -- the rank-0 package ----------------------------------------------
        results = sorted(results, key=lambda r: r["rank"])
        parts = [results[g % n]["chunks"][g // n]
                 for g in range(plan.n_stages)]
        full_params = spec.assemble_params(parts, plan)
        loss_result = next(r for r in results if r.get("hosts_loss"))
        final_step = int(loss_result["final_step"])
        per_stage = [r["stats"] for r in results]
        costs = pool_op_costs([r["op_costs"] for r in results])
        report: Dict[str, Any] = {
            "schedule": self.schedule,
            "interleave": self.interleave,
            "n_stages": n,
            "n_micro": self.num_microbatches,
            "steps": final_step,
            "losses": list(loss_result["losses"]),
            "per_stage": per_stage,
            "op_costs_ms": {k: v * 1e3 for k, v in costs.items()},
            "stage_op_costs_ms": [
                {k: v * 1e3 for k, v in r["op_costs"].items()}
                for r in results],
            "stage_peak_bytes": [r["peak_bytes"] for r in results],
            **fleet_pipeline_stats(per_stage),
        }
        if costs:
            report["bubble_fraction"] = measured_schedule_bubble(
                self.schedule, n, self.num_microbatches, self.interleave,
                costs)
        xfers = [r["xfer"] for r in results if r.get("xfer")]
        if xfers:
            sent = sum(int(x.get("bytes_sent", 0)) for x in xfers)
            full = sum(int(x.get("bytes_full_width", 0)) for x in xfers)
            wire: Dict[str, Any] = {
                "bytes_sent": sent, "bytes_full_width": full,
                "wire_ratio": (full / sent) if sent else 1.0,
                "per_stage": xfers,
            }
            enc = next((x["enc"] for x in xfers if x.get("enc")), None)
            if enc is not None:
                wire["enc"] = enc
            report["xfer"] = wire
        self.mpmd_report = report
        self._write_live_snapshot()

        from ray_lightning_tpu_torch.utils.state_stream import (
            to_state_stream,
        )
        from ray_lightning_tpu_torch.utils.treedef import (
            TRAIN_STATE, JaxNode,
        )

        # The moments stay with their stages: the package's state holds
        # the params and the step.
        state = JaxNode(TRAIN_STATE, (
            full_params, None, torch.tensor(final_step, dtype=torch.int32),
            None), custom=True)
        metrics = dict(loss_result["callback_metrics"])
        metrics.update({
            "bubble_fraction": report.get("bubble_fraction", 0.0),
            "stage_occupancy": report["stage_occupancy"],
        })
        return [{
            "rank": 0,
            "state_stream": to_state_stream(state),
            "callback_metrics": metrics,
            "logged_metrics": dict(metrics),
            "best_model_path": "",
            "epochs_run": 1,
            "global_step": final_step,
            "micro_step": final_step * self.num_microbatches,
            "callback_states": [],
            "comm_stats": {},
            "telemetry": None,
        }]


# The reference's names.
RayPlugin = RayStrategy
HorovodRayPlugin = HorovodRayStrategy
RayShardedPlugin = RayShardedStrategy
