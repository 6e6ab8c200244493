"""The fit loop on one device: the spine of ``run_fit``
(``ray_lightning_tpu/core/loop.py``).

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
are kept.  Elastic restart,
drain, prefetch threads and the full telemetry tier are later slices.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import queue
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
    MaskedNode, apply_updates, multi_steps, multi_steps_flush, tree_map,
)
from ray_lightning_tpu_torch.ops.optim_quant import (
    BlockQuantized, dequantize_moment, quantize_moment,
)
from ray_lightning_tpu_torch.parallel import step_fns
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
    default_root_dir: str = "."
    resume_from_checkpoint: Optional[str] = None

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
        # A typo'd megastep fails at construction; "auto" resolves at fit
        # time, against the fit's device.
        _normalize_megastep(self.megastep)


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


def _resolve_megastep(config: FitConfig, device: torch.device) -> int:
    """The concrete stride length K for this fit.

    Strongest first: an explicit ``megastep=`` on the Trainer/strategy →
    the ``RLT_MEGASTEP`` environment variable (set but empty means "off")
    → ``"auto"``.  Auto is K = 8 on the card, where the host's per-step
    issue cost can hold the card back (the JAX package's accelerator
    rule), and 1 on the CPU, where execution is synchronous and fusing
    strides buys nothing."""
    value = config.megastep
    if value is None:
        value = os.environ.get("RLT_MEGASTEP")
        value = "auto" if value is None else value
    value = _normalize_megastep(value)
    if value == "off":
        return 1
    if value == "auto":
        return 8 if device.type == "cuda" else 1
    return int(value)


class LoopContext:
    """The ``trainer`` argument of every hook (the JAX package's
    ``LoopContext``, one device)."""

    def __init__(self, config: FitConfig, device: torch.device):
        self.config = config
        self.device = device
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
        self.default_root_dir = config.default_root_dir
        # The async checkpoint writer (one thread a fit, made on first
        # use): its queue, failures, paths in flight and their lock.
        self._ckpt_queue: Optional[queue.Queue] = None
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_errors: List[BaseException] = []
        self._ckpt_pending: set = set()
        self._ckpt_lock = threading.Lock()

    global_rank = 0  # one process, one device

    @property
    def is_global_zero(self) -> bool:
        return True

    def log_metrics(self, metrics: Dict[str, Any]) -> None:
        for k, v in metrics.items():
            self.logged_metrics[k] = float(v)
            self.callback_metrics[k] = float(v)

    # -- checkpoints ---------------------------------------------------------
    def checkpoint_payload(self) -> Dict[str, Any]:
        """The JAX package's checkpoint payload; the state as the JAX
        ``TrainState`` tree (its tensors still where they live)."""
        return {"state": train_state_to_jax(self.state),
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
        raises its failures."""
        stream = to_state_stream(self.checkpoint_payload())
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
    preset = getattr(module, "initial_params", None)
    if preset is not None:
        params = tree_map(
            lambda t: torch.as_tensor(t).to(device=device,
                                            dtype=torch.float32).clone(),
            dict(preset))
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = tree_map(lambda t: t.to(device),
                          module.init_params(gen))
    return TrainState.create(params, tx)


def _restore_state(template: TrainState, loaded: TrainState) -> TrainState:
    """``loaded``'s values written into ``template``'s tensors, each cast
    to the template's dtype (a dtype policy changed between runs must not
    leak into this one, as the JAX loop casts) on its device; the trees
    and the shapes must agree."""

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
            raise ValueError(
                f"resume: {path}: shape {tuple(src.shape)} in the checkpoint,"
                f" {tuple(dst.shape)} in this fit")
        else:
            dst.copy_(src)

    with torch.no_grad():
        put(template.params, loaded.params, "state.params")
        put(template.opt_state, loaded.opt_state, "state.opt_state")
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
    return TrainState(loaded.params, opt_state, loaded.step)


def _resume(ctx: LoopContext, callbacks: List[Callback], accum: int):
    """Load ``config.resume_from_checkpoint`` into the context (state,
    counters, metrics, callback states); returns ``(start_epoch,
    skip_batches)``."""
    payload = load_state_stream(
        state_stream_from_file(ctx.config.resume_from_checkpoint),
        device=ctx.device)
    loaded = _reconcile_opt_state_format(
        train_state_from_jax(payload["state"]), ctx.state)
    ctx.state = _restore_state(ctx.state, loaded)
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


def _run_validation(eval_step, loader, ctx: LoopContext,
                    limit: int) -> Dict[str, float]:
    acc = _RunningMeanLogs()
    for i, batch in enumerate(loader):
        if limit >= 0 and i >= limit:
            break
        acc.update(eval_step(ctx.state.params,
                             step_fns.place_batch(batch, ctx.device)))
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


def _accum_flush(state: TrainState, inner_tx) -> TrainState:
    """The partial-window flush (``_build_accum_flush``): one optimizer
    update from the running mean of the window's micro-gradients."""
    with torch.no_grad():
        updates, opt_state = multi_steps_flush(inner_tx, state.opt_state,
                                               state.params)
        return TrainState(apply_updates(state.params, updates), opt_state,
                          state.step + 1)


def _examples(batch: Any) -> int:
    leaves = list(step_fns._batch_items(batch).values())
    return int(leaves[0].shape[0]) if leaves and leaves[0].ndim else 1


def run_fit(module: TrainModule, datamodule: TpuDataModule,
            config: FitConfig, callbacks: List[Callback],
            device: torch.device, telemetry: Any = None) -> Dict[str, Any]:
    """The fit loop.  Returns the result package the trainer adopts:
    ``state``, ``callback_metrics``, ``logged_metrics``, ``epochs_run``,
    ``global_step``, ``micro_step``, ``telemetry`` (the report) and
    ``best_model_path`` (the first ``ModelCheckpoint``'s)."""
    ctx = LoopContext(config, device)
    try:
        return _fit(ctx, module, datamodule, callbacks, telemetry)
    finally:
        # A failed fit still retires its writer thread (a finished one
        # already has).
        ctx._retire_writer()


def _fit(ctx: LoopContext, module: TrainModule, datamodule: TpuDataModule,
         callbacks: List[Callback], telemetry: Any) -> Dict[str, Any]:
    config, device = ctx.config, ctx.device
    tel = Telemetry.build(telemetry)
    tx = module.configure_optimizers()
    accum = max(int(config.accumulate_grad_batches), 1)
    inner_tx = tx
    if accum > 1:
        tx = multi_steps(tx, accum)
    ctx.telemetry = tel
    module.trainer = ctx
    module.precision = config.precision
    tel_stats = tel.step_stats
    if tel_stats is not None:
        tel_stats.configure_model(module, device)

    module.setup("fit")
    datamodule.set_shard(0, 1)
    datamodule.prepare_data()
    datamodule.setup("fit")
    _call_hooks(callbacks, "setup", ctx, module, "fit")

    # On resume this is the template the checkpoint is written into (its
    # dict order, which orders the clip's norm sum, stays the fit's).
    ctx.state = init_train_state(module, tx, device, config.seed)
    start_epoch, skip_batches = 0, 0
    if config.resume_from_checkpoint:
        # In place before the first stride: a captured graph owns the
        # state it captured on.
        start_epoch, skip_batches = _resume(ctx, callbacks, accum)
    train_step = step_fns.single_device_step(module, tx)
    rng = step_fns.StepRng(device, config.seed)
    megastep_k = _resolve_megastep(config, device)
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
            ctx.state = _accum_flush(ctx.state, inner_tx)
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
            val_metrics = _run_validation(eval_step, val_loader, ctx,
                                          config.limit_val_batches)
            ctx.log_metrics(val_metrics)
            module.on_validation_epoch_end(val_metrics)
            _call_hooks(callbacks, "on_validation_epoch_end", ctx, module)

        _call_hooks(callbacks, "on_train_epoch_end", ctx, module)
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
    return {
        "state": ctx.state,
        "callback_metrics": dict(ctx.callback_metrics),
        "logged_metrics": dict(ctx.logged_metrics),
        "epochs_run": ctx.current_epoch + 1,
        "global_step": ctx.global_step,
        "micro_step": ctx.micro_step,
        "telemetry": tel.report(),
        "best_model_path": next((cb.best_model_path for cb in callbacks
                                 if isinstance(cb, ModelCheckpoint)), ""),
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
             ckpt_path: Optional[str] = None) -> Dict[str, Any]:
    """The validation or test loop (``kind``): the epoch means of
    ``validation_step``/``test_step`` over the loader (at most
    ``limit_val_batches``), without gradients.  Returns
    ``{"callback_metrics": metrics}``."""
    stage = "validate" if kind == "validation" else "test"
    ctx = LoopContext(config, device)
    module.trainer = ctx
    module.precision = config.precision
    module.setup(stage)
    datamodule.set_shard(0, 1)
    datamodule.setup(stage)
    _call_hooks(callbacks, "setup", ctx, module, stage)
    ctx.state = TrainState(
        _resolve_params(module, config, device, params, ckpt_path), None)
    loader = (datamodule.val_dataloader() if kind == "validation"
              else datamodule.test_dataloader())
    if loader is None:
        raise ValueError(f"datamodule provides no {kind} dataloader")
    metrics = _run_validation(step_fns.build_eval_step(module, kind), loader,
                              ctx, config.limit_val_batches)
    ctx.log_metrics(metrics)
    module.teardown(stage)
    _call_hooks(callbacks, "teardown", ctx, module, stage)
    return {"callback_metrics": metrics}


def run_predict(module: TrainModule, datamodule: TpuDataModule,
                config: FitConfig, device: torch.device, params=None,
                ckpt_path: Optional[str] = None) -> Dict[str, Any]:
    """The prediction loop: ``predict_step`` over the predict loader (the
    test loader when there is none), without gradients.  Returns
    ``{"prediction_batches": [host numpy array per batch]}``; the outputs
    stay on the device until the last batch is issued."""
    module.precision = config.precision
    module.setup("predict")
    datamodule.set_shard(0, 1)
    datamodule.setup("predict")
    params = _resolve_params(module, config, device, params, ckpt_path)
    predict_step = step_fns.build_predict_step(module)
    loader = datamodule.predict_dataloader() or datamodule.test_dataloader()
    if loader is None:
        raise ValueError("datamodule provides no predict/test dataloader")
    outputs = [predict_step(params, step_fns.place_batch(batch, device))
               for batch in loader]
    module.teardown("predict")
    return {"prediction_batches": [np.asarray(o.cpu()) for o in outputs]}
