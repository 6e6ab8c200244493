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
