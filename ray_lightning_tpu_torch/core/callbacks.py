"""Callback base: hooks the fit loop calls (``ray_lightning_tpu/core/
callbacks.py::Callback``).  ``trainer`` in every hook is the loop's
context: ``current_epoch``, ``global_step``, ``callback_metrics``,
``state``, ``should_stop``.  The concrete callbacks of the JAX package
(checkpointing, early stopping, loggers) come with later slices."""

from __future__ import annotations

from typing import Any, Dict

__all__ = ["Callback"]


class Callback:
    """Base callback: override any subset of hooks."""

    def setup(self, trainer, module, stage: str) -> None: ...

    def on_fit_start(self, trainer, module) -> None: ...

    def on_train_epoch_start(self, trainer, module) -> None: ...

    def on_train_batch_end(self, trainer, module, logs: Dict[str, Any],
                           batch_idx: int) -> None:
        """End of one training step; ``logs`` holds the step's values as
        device tensors."""

    def on_train_epoch_end(self, trainer, module) -> None: ...

    def on_validation_epoch_end(self, trainer, module) -> None: ...

    def on_fit_end(self, trainer, module) -> None: ...

    def teardown(self, trainer, module, stage: str) -> None: ...
