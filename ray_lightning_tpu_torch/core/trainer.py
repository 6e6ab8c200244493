"""Trainer — the user-facing facade (``ray_lightning_tpu/core/trainer.py``).

``Trainer(...).fit(module, datamodule)`` runs the fit through its
strategy and adopts the result: ``callback_metrics``, ``logged_metrics``,
``state`` (the final :class:`TrainState`, tensors on the fit's device),
``global_step``, ``micro_step``, ``epochs_run``, ``best_model_path`` and
``telemetry_report`` (the step stats' summary, counters and
``meta.megastep``; empty when telemetry is off).  ``validate``, ``test``
and ``predict`` run on a checkpoint's parameters (``ckpt_path``), else on
the fitted state's, else on the seed's init; ``save_checkpoint`` writes
the fitted state as the JAX package's Trainer does.  Checkpoints are
``RLTCKPT1`` files either package reads: ``resume_from_checkpoint`` takes
one written on a TPU, and the JAX package resumes one written here.

One device and one process: the fitted state and the callbacks' state
are the loop's own objects, handed over as they are (the JAX package
streams them from its workers).  Departures from the JAX package, each
until its slice of the port: telemetry has the cheap tier only
(``"full"`` raises) and its report is one device's (no fleet merge);
``megastep`` captures K steps into a CUDA graph on the card where the JAX
package fuses them with ``lax.scan``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from ray_lightning_tpu_torch.core.callbacks import Callback, ModelCheckpoint
from ray_lightning_tpu_torch.core.data import TpuDataModule, _ModuleDataModule
from ray_lightning_tpu_torch.core.loop import FitConfig
from ray_lightning_tpu_torch.core.module import TrainModule
from ray_lightning_tpu_torch.models.convert import train_state_to_jax
from ray_lightning_tpu_torch.utils.state_stream import (
    state_stream_to_file, to_state_stream,
)

__all__ = ["Trainer"]


class Trainer:
    """Drive training and evaluation through a strategy (default
    :class:`LocalStrategy` on the card).  Args mirror the JAX package's
    Trainer subset that the single-device loop runs;
    ``enable_checkpointing`` (the default) appends
    ``ModelCheckpoint(monitor=None)`` unless a ``ModelCheckpoint`` is
    among ``callbacks``, writing under ``default_root_dir``."""

    def __init__(
        self,
        strategy=None,
        max_epochs: int = 1,
        max_steps: int = -1,
        callbacks: Optional[List[Callback]] = None,
        default_root_dir: str = "rlt_logs",
        seed: int = 0,
        precision: str = "f32",
        check_val_every_n_epoch: int = 1,
        limit_train_batches: int = -1,
        limit_val_batches: int = -1,
        log_every_n_steps: int = 50,
        accumulate_grad_batches: int = 1,
        megastep=None,
        enable_checkpointing: bool = True,
        resume_from_checkpoint: Optional[str] = None,
    ):
        from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

        self.strategy = strategy or LocalStrategy()
        self.callbacks: List[Callback] = list(callbacks or [])
        if enable_checkpointing and not any(
                isinstance(cb, ModelCheckpoint) for cb in self.callbacks):
            self.callbacks.append(ModelCheckpoint(monitor=None))
        self.config = FitConfig(
            max_epochs=max_epochs,
            max_steps=max_steps,
            check_val_every_n_epoch=check_val_every_n_epoch,
            limit_train_batches=limit_train_batches,
            limit_val_batches=limit_val_batches,
            log_every_n_steps=log_every_n_steps,
            seed=seed,
            precision=precision,
            accumulate_grad_batches=accumulate_grad_batches,
            megastep=megastep,
            default_root_dir=default_root_dir,
            resume_from_checkpoint=resume_from_checkpoint,
        )
        self.callback_metrics: Dict[str, float] = {}
        self.logged_metrics: Dict[str, float] = {}
        self.best_model_path: str = ""
        self.state = None
        self.predictions: Optional[np.ndarray] = None
        self.epochs_run = 0
        self.global_step = 0
        self.micro_step = 0
        self.telemetry_report: Dict[str, Any] = {}

    def _resolve_datamodule(self, module: TrainModule,
                            datamodule: Optional[TpuDataModule]
                            ) -> TpuDataModule:
        if datamodule is not None:
            return datamodule
        if hasattr(module, "train_dataloader") or hasattr(
                module, "val_dataloader"):
            return _ModuleDataModule(module)
        raise ValueError(
            "Provide a datamodule or implement *_dataloader on the module.")

    def fit(self, module: TrainModule,
            datamodule: Optional[TpuDataModule] = None) -> "Trainer":
        result = self.strategy.run(
            "fit", module, self._resolve_datamodule(module, datamodule),
            self.config, self.callbacks)
        self.state = result["state"]
        self.callback_metrics.update(result["callback_metrics"])
        self.logged_metrics.update(result["logged_metrics"])
        self.best_model_path = result["best_model_path"]
        self.epochs_run = result["epochs_run"]
        self.global_step = result["global_step"]
        self.micro_step = result["micro_step"]
        self.telemetry_report = result["telemetry"]
        return self

    @property
    def params(self):
        """The fitted parameters (tensors on the fit's device)."""
        return None if self.state is None else self.state.params

    def _eval_params(self, ckpt_path: Optional[str]):
        return None if ckpt_path is not None else self.params

    def _run_eval(self, kind: str, module: TrainModule,
                  datamodule: Optional[TpuDataModule],
                  ckpt_path: Optional[str]) -> Dict[str, float]:
        result = self.strategy.run(
            kind, module, self._resolve_datamodule(module, datamodule),
            self.config, self.callbacks, params=self._eval_params(ckpt_path),
            ckpt_path=ckpt_path)
        metrics = result["callback_metrics"]
        self.callback_metrics.update(metrics)
        return metrics

    def validate(self, module: TrainModule,
                 datamodule: Optional[TpuDataModule] = None,
                 ckpt_path: Optional[str] = None) -> Dict[str, float]:
        return self._run_eval("validation", module, datamodule, ckpt_path)

    def test(self, module: TrainModule,
             datamodule: Optional[TpuDataModule] = None,
             ckpt_path: Optional[str] = None) -> Dict[str, float]:
        return self._run_eval("test", module, datamodule, ckpt_path)

    def predict(self, module: TrainModule,
                datamodule: Optional[TpuDataModule] = None,
                ckpt_path: Optional[str] = None) -> np.ndarray:
        """``predict_step``'s outputs over the predict (else test) loader,
        batches concatenated in order, as a host numpy array."""
        result = self.strategy.run(
            "predict", module, self._resolve_datamodule(module, datamodule),
            self.config, [], params=self._eval_params(ckpt_path),
            ckpt_path=ckpt_path)
        self.predictions = np.concatenate(result["prediction_batches"])
        return self.predictions

    def save_checkpoint(self, path: str) -> None:
        """Write the fitted state as the JAX package's Trainer does: its
        payload holds no ``micro_step`` and ``epoch = epochs_run - 1``."""
        if self.state is None:
            raise RuntimeError("No trained state; call fit() first.")
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {"state": train_state_to_jax(self.state),
                   "epoch": self.epochs_run - 1,
                   "global_step": self.global_step,
                   "callback_metrics": dict(self.callback_metrics)}
        state_stream_to_file(to_state_stream(payload), path)
