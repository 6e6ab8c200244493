"""Callbacks: hooks the fit loop calls (``ray_lightning_tpu/core/
callbacks.py``).  ``trainer`` in every hook is the loop's context
(``core/loop.py::LoopContext``): ``current_epoch``, ``global_step``,
``micro_step``, ``callback_metrics``, ``state``, ``should_stop``,
``default_root_dir``, ``device`` and the checkpoint writer.  Kept:
:class:`ModelCheckpoint`, :class:`EarlyStopping`, :class:`CSVLogger`,
:class:`ProfilerCallback` (on ``torch.profiler`` in place of
``jax.profiler``), :class:`DeviceStatsCallback`,
:class:`StochasticWeightAveraging` and :class:`ExponentialMovingAverage`.
``TelemetryCallback`` needs the full telemetry tier (spans and trace
exports), a later slice of the port."""

from __future__ import annotations

import csv
import os
import time
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.core.module import TrainState
from ray_lightning_tpu_torch.models.optim import tree_map

__all__ = ["Callback", "ModelCheckpoint", "EarlyStopping", "CSVLogger",
           "ProfilerCallback", "DeviceStatsCallback",
           "StochasticWeightAveraging", "ExponentialMovingAverage",
           "sync_point_crossed"]


def sync_point_crossed(prev_step: int, step: int, every: int) -> bool:
    """Did the micro-step counter cross a multiple of ``every`` moving
    from ``prev_step`` to ``step``?  One step advances it by 1, a megastep
    stride by K; either way a boundary inside the advance counts once.
    (The JAX package's ``fault/drain.py::sync_point_crossed``; the fault
    plane itself is not ported.)"""
    if every <= 1:
        return True
    return (step // every) > (prev_step // every)


def _wait_device(trainer) -> None:
    device = getattr(trainer, "device", None)
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class Callback:
    """Base callback: override any subset of hooks."""

    def setup(self, trainer, module, stage: str) -> None: ...

    def on_fit_start(self, trainer, module) -> None: ...

    def on_train_epoch_start(self, trainer, module) -> None: ...

    def on_train_batch_end(self, trainer, module, logs: Dict[str, Any],
                           batch_idx: int) -> None:
        """End of one training step, or of a megastep stride (once, with
        the last inner step's logs and index); ``logs`` holds the values as
        device tensors."""

    def on_accumulation_flush(self, trainer, module, logs: Dict[str, Any],
                              batch_idx: int) -> None:
        """End of an epoch whose last accumulation window was partial: its
        flush is an optimizer step (``logs`` and ``batch_idx`` of the last
        micro-batch it covers)."""

    def on_train_epoch_end(self, trainer, module) -> None: ...

    def on_validation_epoch_end(self, trainer, module) -> None: ...

    def on_fit_end(self, trainer, module) -> None: ...

    def teardown(self, trainer, module, stage: str) -> None: ...

    def state_dict(self) -> Dict[str, Any]:
        return {}

    def load_state_dict(self, state: Dict[str, Any]) -> None: ...


class ModelCheckpoint(Callback):
    """Write the training state to ``dirpath`` at the end of every
    ``every_n_epochs``-th epoch, as ``RLTCKPT1`` files the JAX package
    reads (``<filename>.ckpt``, ``filename`` formatted with ``epoch`` and
    ``step``, the optimizer steps so far), keeping the ``save_top_k`` best
    by ``monitor`` (``mode`` "min" or "max"); with ``monitor=None`` the
    newest are the best.  ``dirpath`` defaults to
    ``<default_root_dir>/checkpoints``.

    ``async_write``: the state is copied into its stream at the epoch's
    end as always; a writer thread computes the crc and writes the file,
    and the fit joins pending writes at its end.
    ``verify``: read each file back and check it
    (``sharded_ckpt.verify_checkpoint``, the JAX callback's check; at
    once, or at fit end for async writes).

    Under a strategy every rank runs the callback alike: every rank
    calls ``save_checkpoint`` (its gather is a collective) and keeps the
    same books, and rank 0 alone writes, verifies and deletes files."""

    def __init__(self, dirpath: Optional[str] = None,
                 filename: str = "epoch={epoch}-step={step}",
                 monitor: Optional[str] = None, mode: str = "min",
                 save_top_k: int = 1, every_n_epochs: int = 1,
                 async_write: bool = False, verify: bool = False):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {mode!r}")
        self.dirpath = dirpath
        self.filename = filename
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.every_n_epochs = every_n_epochs
        self.async_write = async_write
        self.verify = verify
        self.best_model_path: str = ""
        self.best_model_score: Optional[float] = None
        self._saved: list = []  # [(score, path)]

    def setup(self, trainer, module, stage: str) -> None:
        if self.dirpath is None:
            self.dirpath = os.path.join(trainer.default_root_dir,
                                        "checkpoints")

    def _score(self, metrics: Dict[str, float]) -> Optional[float]:
        if self.monitor is None:
            return None
        value = metrics.get(self.monitor)
        return None if value is None else float(value)

    def _is_better(self, score: float) -> bool:
        if self.best_model_score is None:
            return True
        return (score < self.best_model_score if self.mode == "min"
                else score > self.best_model_score)

    def on_train_epoch_end(self, trainer, module) -> None:
        epoch = trainer.current_epoch
        if (epoch + 1) % self.every_n_epochs != 0:
            return
        score = self._score(trainer.callback_metrics)
        if self.monitor is not None and score is None:
            return  # the monitored metric was not produced this epoch
        writer = getattr(trainer, "is_global_zero", True)
        if writer:
            os.makedirs(self.dirpath, exist_ok=True)
        name = self.filename.format(epoch=epoch, step=trainer.global_step)
        path = os.path.join(self.dirpath, name + ".ckpt")
        trainer.save_checkpoint(path, async_write=self.async_write)
        if writer and not self.async_write:
            self._verify_written(path)
        if score is None:
            # monitor=None: the newest is the best; rank by recency.
            self.best_model_path = path
            self._saved.append((float(trainer.global_step), path))
            self._prune(trainer, force_mode="max")
            return
        if self._is_better(score):
            self.best_model_score = score
            self.best_model_path = path
        self._saved.append((score, path))
        self._prune(trainer)

    def _prune(self, trainer, force_mode: Optional[str] = None) -> None:
        if self.save_top_k < 0 or len(self._saved) <= self.save_top_k:
            return
        reverse = (force_mode or self.mode) == "max"
        ranked = sorted(self._saved, key=lambda t: t[0], reverse=reverse)
        keep = {p for _, p in ranked[:self.save_top_k]}
        keep.add(self.best_model_path)
        doomed = [p for _, p in self._saved if p not in keep]
        self._saved = [(s, p) for s, p in self._saved if p in keep]
        if not getattr(trainer, "is_global_zero", True):
            return
        # Never delete a file whose write may still be in flight.
        if any(trainer.checkpoint_write_pending(p) for p in doomed):
            trainer.flush_checkpoints()
        for path in doomed:
            try:
                os.remove(path)
            except FileNotFoundError:
                pass

    def _verify_written(self, path: str) -> None:
        if not self.verify:
            return
        from ray_lightning_tpu_torch.utils import sharded_ckpt

        problems = sharded_ckpt.verify_checkpoint(path)
        if problems:
            raise RuntimeError(f"checkpoint {path} failed post-write "
                               f"verification: " + "; ".join(problems))

    def on_fit_end(self, trainer, module) -> None:
        # The loop flushed async writes just before this hook.
        if self.async_write and getattr(trainer, "is_global_zero", True):
            for _, path in self._saved:
                if os.path.exists(path):
                    self._verify_written(path)

    def state_dict(self) -> Dict[str, Any]:
        return {"best_model_path": self.best_model_path,
                "best_model_score": self.best_model_score}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.best_model_path = state.get("best_model_path", "")
        self.best_model_score = state.get("best_model_score")


class EarlyStopping(Callback):
    """Stop the fit when ``monitor`` has not improved by more than
    ``min_delta`` for ``patience`` validation epochs.  Under a strategy
    every rank decides on rank 0's value (``trainer.broadcast_value``), so
    no rank stops while another waits in a collective."""

    def __init__(self, monitor: str = "val_loss", mode: str = "min",
                 patience: int = 3, min_delta: float = 0.0):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {mode!r}")
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.wait = 0
        self.stopped_epoch: Optional[int] = None

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_validation_epoch_end(self, trainer, module) -> None:
        value = trainer.callback_metrics.get(self.monitor)
        broadcast = getattr(trainer, "broadcast_value", None)
        if broadcast is not None:
            value = broadcast(None if value is None else float(value))
        if value is None:
            return
        value = float(value)
        if self._improved(value):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                trainer.should_stop = True
                self.stopped_epoch = trainer.current_epoch

    def state_dict(self) -> Dict[str, Any]:
        return {"best": self.best, "wait": self.wait}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.best = state.get("best")
        self.wait = state.get("wait", 0)


class CSVLogger(Callback):
    """The training and validation curves in ``metrics.csv`` under
    ``dirpath`` (default ``<default_root_dir>/csv``): a row at every
    ``log_every_n_steps`` boundary the micro-step crosses, at each epoch's
    end and at each validation epoch's end, with the union of the metric
    keys seen so far.  ``rows`` holds them; ``state_dict`` carries them."""

    def __init__(self, dirpath: Optional[str] = None,
                 filename: str = "metrics.csv"):
        self.dirpath = dirpath
        self.filename = filename
        self.rows: list = []
        self._flushed_rows = 0
        self._flushed_keys: list = []
        self._last_row_micro = 0

    @property
    def path(self) -> Optional[str]:
        if self.dirpath is None:
            return None
        return os.path.join(self.dirpath, self.filename)

    def setup(self, trainer, module, stage: str) -> None:
        if self.dirpath is None:
            self.dirpath = os.path.join(trainer.default_root_dir, "csv")
        self._last_row_micro = 0

    def _append(self, trainer) -> None:
        self.rows.append({
            "epoch": trainer.current_epoch,
            "step": trainer.global_step,
            **{k: float(v) for k, v in trainer.callback_metrics.items()},
        })
        if trainer.is_global_zero:
            self._flush()

    def _flush(self) -> None:
        # Same keys: append the new rows; new keys: rewrite the file
        # through a temporary, so a reader never sees a torn file.
        keys: list = []
        for row in self.rows:
            for k in row:
                if k not in keys:
                    keys.append(k)
        os.makedirs(self.dirpath, exist_ok=True)
        if (keys == self._flushed_keys and self._flushed_rows
                and os.path.exists(self.path)):
            with open(self.path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=keys).writerows(
                    self.rows[self._flushed_rows:])
        else:
            tmp = self.path + ".tmp"
            with open(tmp, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=keys)
                writer.writeheader()
                writer.writerows(self.rows)
            os.replace(tmp, self.path)
        self._flushed_rows = len(self.rows)
        self._flushed_keys = keys

    def on_train_epoch_start(self, trainer, module) -> None:
        # The cadence is anchored at the epoch's starting micro-step, so a
        # resumed fit keeps its rows on the same grid.
        self._last_row_micro = getattr(trainer, "micro_step", 0) or 0

    def on_train_batch_end(self, trainer, module, logs, batch_idx) -> None:
        n = getattr(getattr(trainer, "config", None), "log_every_n_steps", 0)
        micro = getattr(trainer, "micro_step", None)
        if n and micro and sync_point_crossed(self._last_row_micro, micro,
                                              n):
            self._last_row_micro = micro
            self._append(trainer)

    def on_train_epoch_end(self, trainer, module) -> None:
        self._append(trainer)

    def on_validation_epoch_end(self, trainer, module) -> None:
        self._append(trainer)

    def state_dict(self) -> Dict[str, Any]:
        return {"rows": list(self.rows), "dirpath": self.dirpath}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.rows = list(state.get("rows", []))
        self.dirpath = state.get("dirpath", self.dirpath)


class ProfilerCallback(Callback):
    """A ``torch.profiler`` trace of training-step windows (the JAX
    package's ``jax.profiler`` capture): CPU activity, and the card's
    kernels when the fit runs on one.  Each window is written as a Chrome
    trace, ``trace-step<N>.json`` under ``<dirpath>/rank0/`` (``dirpath``
    defaults to ``<default_root_dir>/profiler``; ``trace_paths`` lists
    the files).  A window opens at the first ``on_train_batch_end`` whose
    ``global_step`` reaches its start and closes once ``num_steps`` more
    have passed (under megastep both round to a stride's end).

    ``schedule`` = ``[(start_step, num_steps), ...]`` for several
    windows; overlapping or touching ones are merged at construction.  A
    window that would start while a profiler is already active is skipped
    with a warning; ``teardown`` closes an open window and is
    idempotent."""

    def __init__(self, dirpath: Optional[str] = None, start_step: int = 2,
                 num_steps: int = 3, rank_zero_only: bool = True,
                 schedule: Optional[list] = None):
        if schedule is None:
            if num_steps < 1:
                raise ValueError("num_steps must be >= 1")
            windows = [(int(start_step), int(num_steps))]
        else:
            if not schedule:
                raise ValueError("schedule must name at least one window")
            spans = []
            for item in schedule:
                s, n = int(item[0]), int(item[1])
                if s < 0 or n < 1:
                    raise ValueError(
                        f"schedule window {item!r}: start must be >= 0 "
                        "and num_steps >= 1")
                spans.append((s, s + n))
            spans.sort()
            merged = [list(spans[0])]
            for s, e in spans[1:]:
                if s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            windows = [(s, e - s) for s, e in merged]
        self.dirpath = dirpath
        self.start_step = windows[0][0]
        self.num_steps = windows[0][1]
        self.rank_zero_only = rank_zero_only
        self._windows = windows
        self._win_i = 0
        self.trace_dir: Optional[str] = None
        self.trace_paths: list = []
        self._active = False
        self._started_at: Optional[int] = None
        self._prof = None

    def setup(self, trainer, module, stage: str) -> None:
        if self.dirpath is None:
            self.dirpath = os.path.join(trainer.default_root_dir, "profiler")
        # Fresh capture state per fit (callbacks are reused across fits).
        self._active = False
        self._win_i = 0
        self._started_at = None
        self._prof = None

    def _enabled(self, trainer) -> bool:
        return trainer.is_global_zero or not self.rank_zero_only

    def _start(self, trainer) -> None:
        if torch._C._autograd._profiler_enabled():
            raise RuntimeError("a profiler is already active")
        activities = [torch.profiler.ProfilerActivity.CPU]
        if trainer.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        self._prof = prof

    def _stop(self, trainer) -> None:
        # The window's device work finishes before the trace closes.
        _wait_device(trainer)
        prof, self._prof = self._prof, None
        prof.stop()
        path = os.path.join(self.trace_dir,
                            f"trace-step{self._started_at}.json")
        prof.export_chrome_trace(path)
        self.trace_paths.append(path)

    def on_train_batch_end(self, trainer, module, logs, batch_idx) -> None:
        if not self._enabled(trainer):
            return
        step = trainer.global_step
        if not self._active:
            if (self._win_i >= len(self._windows)
                    or step < self._windows[self._win_i][0]):
                return
            self.trace_dir = os.path.join(self.dirpath,
                                          f"rank{trainer.global_rank}")
            os.makedirs(self.trace_dir, exist_ok=True)
            try:
                self._start(trainer)
            except RuntimeError as e:
                warnings.warn(f"ProfilerCallback: start_trace skipped ({e})")
                self._win_i += 1
                return
            self._active = True
            self._started_at = step
        elif step >= self._started_at + self._windows[self._win_i][1]:
            try:
                self._stop(trainer)
            finally:
                self._active = False
                self._win_i += 1

    def teardown(self, trainer, module, stage: str) -> None:
        if not self._active:  # idempotent
            return
        try:
            self._stop(trainer)
        finally:
            self._active = False

    def state_dict(self) -> Dict[str, Any]:
        return {"trace_dir": self.trace_dir}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.trace_dir = state.get("trace_dir")
        # A state dict never restores a live trace.
        self._active = False


class DeviceStatsCallback(Callback):
    """Per-epoch wall time and, on the card, peak device memory
    (``torch.cuda.max_memory_allocated``, the counterpart of JAX's
    ``peak_bytes_in_use``); on the CPU wall time only, as the JAX
    package's does on its CPU backend.  Logs ``epoch_time_s``."""

    def __init__(self, log: bool = True):
        self.log = log
        self.epoch_times: list = []
        self.peak_memories: list = []
        self._t0 = 0.0

    def on_train_epoch_start(self, trainer, module) -> None:
        self._t0 = time.perf_counter()

    def on_train_epoch_end(self, trainer, module) -> None:
        dt = time.perf_counter() - self._t0
        self.epoch_times.append(dt)
        device = getattr(trainer, "device", None)
        peak = (torch.cuda.max_memory_allocated(device)
                if device is not None and device.type == "cuda" else None)
        if peak is not None:
            self.peak_memories.append(peak)
        trainer.log_metrics({"epoch_time_s": dt})
        if self.log and trainer.is_global_zero:
            mem = f", peak_mem={peak / 2**20:.0f}MiB" if peak else ""
            print(f"[rlt] epoch {trainer.current_epoch}: {dt:.2f}s{mem}",
                  flush=True)

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self.epoch_times:
            out["avg_epoch_time_s"] = float(np.mean(self.epoch_times))
        if self.peak_memories:
            out["avg_peak_memory_bytes"] = float(np.mean(self.peak_memories))
        return out

    def state_dict(self) -> Dict[str, Any]:
        return {"epoch_times": list(self.epoch_times),
                "peak_memories": list(self.peak_memories)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.epoch_times = list(state.get("epoch_times", []))
        self.peak_memories = list(state.get("peak_memories", []))


class StochasticWeightAveraging(Callback):
    """SWA: from ``swa_start_epoch`` on, the end-of-epoch params enter a
    running mean ``m + (p - m) / n``; at fit end the mean replaces the
    trained params in the returned state (checkpoints written during the
    fit hold the raw weights).  The optimizer state is not averaged.  The
    mean starts as a copy of the params, never an alias: a captured
    megastep stride writes into the live tensors."""

    def __init__(self, swa_start_epoch: int = 1):
        if swa_start_epoch < 0:
            raise ValueError("swa_start_epoch must be >= 0")
        self.swa_start_epoch = swa_start_epoch
        self._mean = None
        self._count = 0

    def on_fit_start(self, trainer, module) -> None:
        self._mean = None
        self._count = 0

    def on_train_epoch_end(self, trainer, module) -> None:
        if trainer.current_epoch < self.swa_start_epoch:
            return
        params = trainer.state.params
        self._count += 1
        if self._mean is None:
            self._mean = tree_map(torch.clone, params)
            return
        n = float(self._count)
        self._mean = tree_map(lambda m, p: m + (p.to(m.dtype) - m) / n,
                              self._mean, params)

    def on_fit_end(self, trainer, module) -> None:
        if self._mean is None:
            return
        st = trainer.state
        trainer.state = TrainState(self._mean, st.opt_state, st.step)

    # The running mean is params-sized and not carried across resumes: a
    # resumed fit restarts the average.
    def state_dict(self) -> Dict[str, Any]:
        return {"swa_start_epoch": self.swa_start_epoch}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.swa_start_epoch = state.get("swa_start_epoch",
                                         self.swa_start_epoch)


class ExponentialMovingAverage(Callback):
    """EMA of the weights, ``ema = d·ema + (1 - d)·params`` per optimizer
    step (``global_step``, so accumulation does not shorten the horizon).
    The decay compounds over the steps actually elapsed: with
    ``update_every_n_steps`` > 1, and under megastep, whose hook fires
    once a stride with ``global_step`` advanced by up to K, it blends
    ``decay**advanced`` against the stride-end params.  The shadow starts
    as a copy of the params, never an alias.

    ``swap_at_end=True`` (default): the EMA weights replace the trained
    ones in the returned state.  Else the shadow stays in ``ema_params``
    and travels in ``state_dict`` as host tensors."""

    def __init__(self, decay: float = 0.999, update_every_n_steps: int = 1,
                 swap_at_end: bool = True):
        if not 0.0 < decay < 1.0:
            raise ValueError("decay must be in (0, 1)")
        if update_every_n_steps < 1:
            raise ValueError("update_every_n_steps must be >= 1")
        self.decay = decay
        self.update_every_n_steps = update_every_n_steps
        self.swap_at_end = swap_at_end
        self.ema_params = None
        self._last_step: Optional[int] = None
        self._host_ema = None

    def on_fit_start(self, trainer, module) -> None:
        self.ema_params = None
        self._last_step = None
        self._host_ema = None

    def on_train_batch_end(self, trainer, module, logs, batch_idx) -> None:
        gs = trainer.global_step
        if gs == 0 or gs == self._last_step:
            return  # no optimizer update since the last EMA
        params = trainer.state.params
        if self.ema_params is None:
            self.ema_params = tree_map(torch.clone, params)
            self._last_step = gs
            return
        advanced = gs - self._last_step
        if advanced < self.update_every_n_steps:
            return
        d = self.decay ** advanced
        self.ema_params = tree_map(
            lambda e, p: e * d + p.to(e.dtype) * (1.0 - d),
            self.ema_params, params)
        self._last_step = gs

    def on_accumulation_flush(self, trainer, module, logs, batch_idx):
        # The flush is one more optimizer step.
        self.on_train_batch_end(trainer, module, logs, batch_idx)

    def on_fit_end(self, trainer, module) -> None:
        if self.ema_params is None:
            return
        if not self.swap_at_end:
            self._host_ema = tree_map(lambda t: t.detach().cpu(),
                                      self.ema_params)
            return
        st = trainer.state
        trainer.state = TrainState(self.ema_params, st.opt_state, st.step)

    def state_dict(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {"decay": self.decay}
        if not self.swap_at_end and self.ema_params is not None:
            state["ema_params"] = (
                self._host_ema if self._host_ema is not None
                else tree_map(lambda t: t.detach().cpu(), self.ema_params))
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.decay = state.get("decay", self.decay)
        if "ema_params" in state:
            self.ema_params = state["ema_params"]
