"""Trainer — the user-facing facade (``ray_lightning_tpu/core/trainer.py``).

``Trainer(...).fit(module, datamodule)`` runs the fit through its
strategy and adopts the result: ``callback_metrics``, ``logged_metrics``,
``state`` (the final :class:`TrainState`, tensors on the fit's device),
``global_step``, ``micro_step``, ``epochs_run`` and ``telemetry_report``
(the step stats' summary, counters and ``meta.megastep``; empty when
telemetry is off).

Departures from the JAX package, each until its slice of the port:
``enable_checkpointing`` defaults to False (there it is True, with a
``ModelCheckpoint``) and True raises; ``resume_from_checkpoint`` raises;
telemetry has the cheap tier only (``"full"`` raises) and its report is
one device's (no fleet merge); ``megastep`` captures K steps into a CUDA
graph on the card where the JAX package fuses them with ``lax.scan``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.core.data import TpuDataModule
from ray_lightning_tpu_torch.core.loop import FitConfig
from ray_lightning_tpu_torch.core.module import TrainModule

__all__ = ["Trainer"]


class Trainer:
    """Drive training through a strategy (default :class:`LocalStrategy`
    on the card).  Args mirror the JAX package's Trainer subset that the
    single-device loop runs."""

    def __init__(
        self,
        strategy=None,
        max_epochs: int = 1,
        max_steps: int = -1,
        callbacks: Optional[List[Callback]] = None,
        seed: int = 0,
        precision: str = "f32",
        check_val_every_n_epoch: int = 1,
        limit_train_batches: int = -1,
        limit_val_batches: int = -1,
        log_every_n_steps: int = 50,
        accumulate_grad_batches: int = 1,
        megastep=None,
        enable_checkpointing: bool = False,
        resume_from_checkpoint: Optional[str] = None,
    ):
        from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

        if enable_checkpointing:
            raise NotImplementedError(
                "checkpointing is not supported by the PyTorch port yet "
                "(the RLTCKPT1 slice); use enable_checkpointing=False")
        if resume_from_checkpoint is not None:
            raise NotImplementedError(
                "resume_from_checkpoint is not supported by the PyTorch "
                "port yet (the RLTCKPT1 slice)")
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
        )
        self.strategy = strategy or LocalStrategy()
        self.callbacks: List[Callback] = list(callbacks or [])
        self.callback_metrics: Dict[str, float] = {}
        self.logged_metrics: Dict[str, float] = {}
        self.state = None
        self.epochs_run = 0
        self.global_step = 0
        self.micro_step = 0
        self.telemetry_report: Dict[str, Any] = {}

    def fit(self, module: TrainModule,
            datamodule: TpuDataModule) -> "Trainer":
        result = self.strategy.run(module, datamodule, self.config,
                                   self.callbacks)
        self.state = result["state"]
        self.callback_metrics.update(result["callback_metrics"])
        self.logged_metrics.update(result["logged_metrics"])
        self.epochs_run = result["epochs_run"]
        self.global_step = result["global_step"]
        self.micro_step = result["micro_step"]
        self.telemetry_report = result["telemetry"]
        return self
