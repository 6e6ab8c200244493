"""Callbacks: hooks the fit loop calls (``ray_lightning_tpu/core/
callbacks.py``).  ``trainer`` in every hook is the loop's context
(``core/loop.py::LoopContext``): ``current_epoch``, ``global_step``,
``callback_metrics``, ``state``, ``should_stop``, ``default_root_dir``
and the checkpoint writer.  Kept: :class:`ModelCheckpoint` and
:class:`EarlyStopping`; the loggers, the profiler and the telemetry and
device-stats callbacks are later slices of the port."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from ray_lightning_tpu_torch.utils.state_stream import verify_stream_file

__all__ = ["Callback", "ModelCheckpoint", "EarlyStopping"]


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
    ``verify``: read each file back and check its crc (at once, or at
    fit end for async writes)."""

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
        os.makedirs(self.dirpath, exist_ok=True)
        name = self.filename.format(epoch=epoch, step=trainer.global_step)
        path = os.path.join(self.dirpath, name + ".ckpt")
        trainer.save_checkpoint(path, async_write=self.async_write)
        if not self.async_write:
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
        # Never delete a file whose write may still be in flight.
        if any(trainer.checkpoint_write_pending(p) for p in doomed):
            trainer.flush_checkpoints()
        for path in doomed:
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
        self._saved = [(s, p) for s, p in self._saved if p in keep]

    def _verify_written(self, path: str) -> None:
        if not self.verify:
            return
        problems = verify_stream_file(path)
        if problems:
            raise RuntimeError(f"checkpoint {path} failed post-write "
                               f"verification: " + "; ".join(problems))

    def on_fit_end(self, trainer, module) -> None:
        # The loop flushed async writes just before this hook.
        if self.async_write:
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
    ``min_delta`` for ``patience`` validation epochs."""

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
