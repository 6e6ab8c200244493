"""The Lightning-shaped module protocol and the training state.

Port of ``ray_lightning_tpu/core/module.py``: :class:`TrainModule` is the
counterpart of the JAX package's ``TpuModule`` (same hooks, same division
of labour: the module owns the model math and the optimizer, the trainer
owns the loop), and :class:`TrainState` of its ``TrainState``.  Step
methods take the parameters explicitly, as there: ``training_step(params,
batch, rng)`` returns ``(loss, logs)`` and the loop differentiates it with
``torch.autograd``.  ``rng`` is a ``torch.Generator`` whose draws are a
function of the fit seed and the micro-step alone, with megastep on and
off (``parallel/step_fns.py::StepRng``); they differ from the JAX
package's keys.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ray_lightning_tpu_torch.models.optim import apply_updates, tree_leaves

__all__ = ["TrainModule", "TpuModule", "TrainState"]

Logs = Dict[str, torch.Tensor]


class TrainState:
    """Parameters, optimizer state and the step count (micro-steps).  The
    optimizer lives with the module (``configure_optimizers``), so the
    state holds tensors (the optimizer's counts among them) and the host
    int ``step``."""

    def __init__(self, params: Any, opt_state: Any, step: int = 0):
        self.params = params
        self.opt_state = opt_state
        self.step = step

    @classmethod
    def create(cls, params: Any, tx) -> "TrainState":
        return cls(params=params, opt_state=tx.init(params), step=0)

    def apply_gradients(self, grads: Any, tx) -> "TrainState":
        with torch.no_grad():
            updates, new_opt_state = tx.update(grads, self.opt_state,
                                               self.params)
            new_params = apply_updates(self.params, updates)
        return TrainState(new_params, new_opt_state, self.step + 1)

    def __repr__(self) -> str:
        n = sum(t.numel() for t in tree_leaves(self.params))
        return f"TrainState(step={self.step}, params={n} elems)"


class TrainModule:
    """Base class for user models (≙ ``pl.LightningModule``; the JAX
    package's ``TpuModule``).

    Subclasses implement ``init_params(generator)``, ``training_step``,
    ``validation_step`` and ``configure_optimizers`` (a
    ``models.optim.GradientTransformation``); ``test_step`` defaults to
    ``validation_step``, and ``predict_step`` is for ``Trainer.predict``."""

    def __init__(self):
        self.hparams: Dict[str, Any] = {}
        self.trainer = None  # set by the loop
        self.precision: str = "f32"
        # Warm-start hook: a parameter dict (same structure as
        # init_params) the fit starts from instead of a fresh init.
        self.initial_params = None

    def save_hyperparameters(self, **kwargs: Any) -> None:
        self.hparams.update(kwargs)

    def configure_optimizers(self):
        raise NotImplementedError

    def init_params(self, generator: torch.Generator) -> Any:
        raise NotImplementedError

    def training_step(self, params: Any, batch: Any, rng
                      ) -> Tuple[torch.Tensor, Logs]:
        raise NotImplementedError

    def validation_step(self, params: Any, batch: Any) -> Logs:
        raise NotImplementedError

    def test_step(self, params: Any, batch: Any) -> Logs:
        return self.validation_step(params, batch)

    def predict_step(self, params: Any, batch: Any) -> Any:
        raise NotImplementedError

    def trainable(self, params: Any) -> Any:
        """Which parameter leaves need a gradient: a tree of bools in the
        params' structure, or None for every leaf (the default).  A frozen
        leaf's gradient is never computed; the optimizer must leave it
        unchanged (GPT under LoRA: ``set_to_zero``)."""
        return None

    # -- lifecycle hooks (inside the fit loop) ------------------------------
    def setup(self, stage: str) -> None:
        """Called before the loop ('fit', 'validate', 'test' or
        'predict')."""

    def on_fit_start(self) -> None:
        ...

    def on_fit_end(self) -> None:
        ...

    def on_train_epoch_start(self, epoch: int) -> None:
        ...

    def on_train_epoch_end(self, epoch: int,
                           metrics: Dict[str, float]) -> None:
        ...

    def on_validation_epoch_end(self, metrics: Dict[str, float]) -> None:
        ...

    def teardown(self, stage: str) -> None:
        ...


# The JAX package's name for the module base class.
TpuModule = TrainModule
