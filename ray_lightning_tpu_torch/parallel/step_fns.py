"""Step functions of the fit loop on one device: the port of
``_loss_and_grads`` and ``_single_device_raw_step``
(``ray_lightning_tpu/parallel/step_fns.py``).  PyTorch runs eagerly, so
there is nothing to compile: ``torch.autograd.grad`` takes the place of
``jax.value_and_grad``."""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ray_lightning_tpu_torch.core.module import TrainModule, TrainState
from ray_lightning_tpu_torch.models.optim import tree_leaves, tree_map

__all__ = ["loss_and_grads", "single_device_step", "eval_step"]


def loss_and_grads(module: TrainModule, params: Any, batch: Any, rng
                   ) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """``(grads, logs)`` of ``module.training_step``: grads in the params'
    tree, logs detached, with ``loss`` added when the module logs none."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, logs = module.training_step(leaves, batch, rng)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(t)
              for g, t in zip(grads, flat))
    grad_tree = tree_map(lambda _: next(it), leaves)
    logs = {k: v.detach() for k, v in dict(logs).items()}
    logs.setdefault("loss", loss.detach())
    return grad_tree, logs


def single_device_step(module: TrainModule, tx
                       ) -> Callable[[TrainState, Any, Any],
                                     Tuple[TrainState, Dict[str, Any]]]:
    def step(state: TrainState, batch, rng):
        grads, logs = loss_and_grads(module, state.params, batch, rng)
        return state.apply_gradients(grads, tx), logs

    return step


def eval_step(module: TrainModule) -> Callable[[Any, Any], Dict[str, Any]]:
    def step(params, batch):
        with torch.no_grad():
            return module.validation_step(params, batch)

    return step
