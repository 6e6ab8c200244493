"""Trainer — the user-facing facade (``ray_lightning_tpu/core/trainer.py``).

``Trainer(...).fit(module, datamodule)`` runs the fit through its
strategy and adopts the result: ``callback_metrics``, ``logged_metrics``,
``state`` (the final :class:`TrainState`, tensors on the fit's device),
``global_step``, ``micro_step``, ``epochs_run``, ``best_model_path``,
``telemetry_report`` (the step stats' summary, counters and
``meta.megastep``; empty when telemetry is off) and ``comm_stats`` (the
gradient wire's accounting, ``{"grad_sync_mode": "full"}`` at full
width; under a strategy rank 0's).  ``validate``, ``test``
and ``predict`` run on a checkpoint's parameters (``ckpt_path``), else on
the fitted state's, else on the seed's init; ``save_checkpoint`` writes
the fitted state as the JAX package's Trainer does.  Checkpoints are
``RLTCKPT1`` files either package reads: ``resume_from_checkpoint`` takes
one written on a TPU, and the JAX package resumes one written here.

Under ``LocalStrategy`` (one device, this process) the fitted state and
the callbacks' state are the loop's own objects, handed over as they
are.  Under the data-parallel strategies (``strategy=`` or the
reference's ``plugins=[RayPlugin(...)]``) the trainer calls the
strategy's ``setup`` and ``teardown`` around each stage and adopts rank
0's package as the JAX Trainer does: the state from its ``RLTCKPT1``
stream (tensors on the CPU: the driver never touches a card), the
metrics, the best path, the callbacks' states; ``telemetry_report`` is
every rank's snapshot merged (``telemetry/aggregate.py``), and
``predict`` interleaves the ranks' rows back into the loader's order.
Telemetry has the cheap tier only (``"full"`` raises); ``megastep``
captures K steps into a CUDA graph on the card where the JAX package
fuses them with ``lax.scan``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from ray_lightning_tpu_torch.core.callbacks import Callback, ModelCheckpoint
from ray_lightning_tpu_torch.core.data import TpuDataModule, _ModuleDataModule
from ray_lightning_tpu_torch.core.loop import FitConfig
from ray_lightning_tpu_torch.core.module import TrainModule
from ray_lightning_tpu_torch.models.convert import (
    train_state_from_jax, train_state_to_jax,
)
from ray_lightning_tpu_torch.utils.state_stream import (
    load_state_stream, state_stream_to_file, to_state_stream,
)

__all__ = ["Trainer"]


class Trainer:
    """Drive training and evaluation through a strategy (default
    :class:`LocalStrategy` on the card; ``plugins=`` takes the reference's
    form, the first strategy in the list).  Args mirror the JAX package's
    Trainer subset that the port's loop runs;
    ``enable_checkpointing`` (the default) appends
    ``ModelCheckpoint(monitor=None)`` unless a ``ModelCheckpoint`` is
    among ``callbacks``, writing under ``default_root_dir``."""

    def __init__(
        self,
        strategy=None,
        plugins=None,
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
        update_sharding=None,
        grad_overlap_segments=None,
        enable_checkpointing: bool = True,
        resume_from_checkpoint: Optional[str] = None,
        fast_dev_run: bool = False,
        restart_dir: Optional[str] = None,
        restart_every_n_epochs: Optional[int] = None,
    ):
        from ray_lightning_tpu_torch.parallel.strategies import (
            LocalStrategy, TpuStrategy,
        )

        if (restart_every_n_epochs is not None
                and restart_every_n_epochs < 1):
            raise ValueError("restart_every_n_epochs must be >= 1")
        if strategy is None and plugins:
            # The reference's form: Trainer(plugins=[RayPlugin(...)]).
            strategy = next((p for p in plugins
                             if isinstance(p, (TpuStrategy, LocalStrategy))),
                            None)
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
            update_sharding=update_sharding,
            grad_overlap_segments=grad_overlap_segments,
            default_root_dir=default_root_dir,
            resume_from_checkpoint=resume_from_checkpoint,
            fast_dev_run=fast_dev_run,
            # Restart checkpoints (utils/sharded_ckpt.py): written here
            # and kept after the fit; None under a strategy with
            # max_restarts > 0 is a scratch directory it removes.
            restart_dir=restart_dir,
            restart_every_n_epochs=restart_every_n_epochs,
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
        # The gradient wire's accounting (grad_sync_mode, grad_sync_bytes,
        # the compression ratio: parallel/grad_sync.py).
        self.comm_stats: Dict[str, Any] = {}
        # The fit's recovery events: the strategy's (backoffs, restarts,
        # corrupt checkpoints walked past, resizes) and the loop's (an
        # elastic resume's resize).
        self.recovery_events: List[Dict[str, Any]] = []

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

    def _run_strategy(self, kind: str, *args, **kwargs):
        """The strategy's ``setup``, ``run`` and ``teardown``: a list of
        the ranks' packages from a remote strategy, the loop's own result
        from ``LocalStrategy``."""
        self.strategy.setup(self)
        try:
            return self.strategy.run(kind, *args, **kwargs)
        finally:
            self.strategy.teardown()

    def _merge_telemetry(self, results: List[Dict[str, Any]],
                         replace: bool = False) -> None:
        from ray_lightning_tpu_torch.telemetry.aggregate import (
            merge_snapshots,
        )

        report = merge_snapshots([r.get("telemetry") for r in results])
        if report or replace:
            self.telemetry_report = report

    def fit(self, module: TrainModule,
            datamodule: Optional[TpuDataModule] = None) -> "Trainer":
        result = self._run_strategy(
            "fit", module, self._resolve_datamodule(module, datamodule),
            self.config, self.callbacks)
        if isinstance(result, list):
            self._adopt_remote_fit(result)
            return self
        self.state = result["state"]
        self.callback_metrics.update(result["callback_metrics"])
        self.logged_metrics.update(result["logged_metrics"])
        self.best_model_path = result["best_model_path"]
        self.epochs_run = result["epochs_run"]
        self.global_step = result["global_step"]
        self.micro_step = result["micro_step"]
        self.telemetry_report = result["telemetry"]
        self.comm_stats = dict(result.get("comm_stats", {}))
        self.recovery_events = list(result.get("events", []))
        return self

    def _adopt_remote_fit(self, results: List[Dict[str, Any]]) -> None:
        """Rank 0's package: the state (CPU tensors), metrics, counters,
        best path and the callbacks' states; every rank's telemetry."""
        rank0 = next(r for r in results if r.get("rank") == 0)
        self.state = train_state_from_jax(
            load_state_stream(rank0["state_stream"]))
        self.callback_metrics.update(rank0["callback_metrics"])
        self.logged_metrics.update(rank0["logged_metrics"])
        self.best_model_path = rank0["best_model_path"]
        self.epochs_run = rank0["epochs_run"]
        self.global_step = rank0["global_step"]
        self.micro_step = rank0["micro_step"]
        self.comm_stats = dict(rank0.get("comm_stats", {}))
        self.recovery_events = [
            *getattr(self.strategy, "recovery_events", []),
            *rank0.get("events", [])]
        self._merge_telemetry(results, replace=True)
        for cb, cb_state in zip(self.callbacks, rank0["callback_states"]):
            cb.load_state_dict(cb_state)

    @property
    def params(self):
        """The fitted parameters (tensors on the fit's device)."""
        return None if self.state is None else self.state.params

    def _eval_params(self, ckpt_path: Optional[str]):
        return None if ckpt_path is not None else self.params

    def _run_eval(self, kind: str, module: TrainModule,
                  datamodule: Optional[TpuDataModule],
                  ckpt_path: Optional[str]) -> Dict[str, float]:
        result = self._run_strategy(
            kind, module, self._resolve_datamodule(module, datamodule),
            self.config, self.callbacks, params=self._eval_params(ckpt_path),
            ckpt_path=ckpt_path)
        if isinstance(result, list):
            result = next(r for r in result if r.get("rank") == 0)
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
        batches concatenated in order, as a host numpy array.  From a
        remote strategy each batch is the ranks' rows in rank order (each
        rank held a contiguous slice of every global batch)."""
        result = self._run_strategy(
            "predict", module, self._resolve_datamodule(module, datamodule),
            self.config, [], params=self._eval_params(ckpt_path),
            ckpt_path=ckpt_path)
        if isinstance(result, list):
            per_rank = [r["prediction_batches"]
                        for r in sorted(result, key=lambda r: r["rank"])]
            counts = {len(b) for b in per_rank}
            if len(counts) > 1:
                raise ValueError(
                    "Ragged per-rank prediction batch counts "
                    f"{[len(b) for b in per_rank]}: every rank must see the "
                    "same number of batches (check the datamodule's "
                    "sharding / drop_last handling).")
            batches = [np.concatenate([rank[b] for rank in per_rank])
                       for b in range(counts.pop() if counts else 0)]
        else:
            batches = result["prediction_batches"]
        self.predictions = np.concatenate(batches)
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
