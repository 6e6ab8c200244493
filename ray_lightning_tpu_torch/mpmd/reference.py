"""The one-program GPipe reference fit, the pipeline plane's parity oracle
(``ray_lightning_tpu/mpmd/reference.py``).

The same decomposition (:class:`~.plan.MpmdSpec`), micro-batch count and
optimizer as a pipeline fit, but every stage inside one program through
:func:`~..parallel.pipeline.pipeline_apply` over a pipe group (one rank:
the plain scan over micro-batches).  Micro-batch-mean gradients equal the
full-batch mean for equal micro sizes and AdamW is elementwise, so a
pipeline fit matches its per-step losses up to float association order.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from ray_lightning_tpu_torch.models.optim import (
    tree_leaves, tree_map, tree_unflatten,
)
from ray_lightning_tpu_torch.mpmd.plan import MpmdSpec
from ray_lightning_tpu_torch.parallel.pipeline import (
    layer_splits, pipe_group, pipeline_apply,
)

__all__ = ["gpipe_reference_fit"]


def gpipe_reference_fit(spec: MpmdSpec, full_params: Any, tx,
                        batches: Callable[[int], Any], steps: int,
                        n_stages: int, n_micro: int, group=None,
                        device=None) -> Dict[str, Any]:
    """Train ``steps`` optimizer steps of the one-program GPipe
    formulation; ``{"losses": [...], "state": the final TrainState}``.

    ``full_params`` carries the spec's untied layout (GPT: ``head_w``
    present); ``batches(step)`` yields the full batch the pipeline fit
    splits at that step.  ``group``: the pipe group (``n_stages`` ranks,
    each calling this with the same inputs); None runs the one-rank pipe
    here, its layers checked to split over ``n_stages`` as the JAX mesh
    would.  ``device``: where the params and batches go (None: the
    card).  On a rank of a group the state's stage rows of
    ``blocks`` are its own (the others stay as initialised)."""
    from ray_lightning_tpu_torch.core.module import TrainState
    from ray_lightning_tpu_torch.device import resolve_device

    g = pipe_group(group)
    if g is not None and g.size != n_stages:
        raise ValueError(f"reference fit over {n_stages} stages got a pipe "
                         f"group of {g.size} ranks")
    layer_splits(spec.n_layers, n_stages, require_divisible=True)
    dev = resolve_device(device)
    state = TrainState.create(tree_map(
        lambda a: torch.as_tensor(a).detach().to(dev, copy=True),
        full_params), tx)

    def loss_fn(params, batch):
        x0 = spec.embed_fn(params, batch)
        out = pipeline_apply(spec.stage_fn, params["blocks"], x0, g,
                             num_microbatches=n_micro)
        loss, _ = spec.loss_fn(params, out, batch)
        return loss

    losses: List[float] = []
    for step in range(steps):
        batch = tree_map(lambda a: torch.as_tensor(a).to(dev),
                         batches(step))
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(state.params)]
        loss = loss_fn(tree_unflatten(state.params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        state = state.apply_gradients(
            tree_unflatten(state.params, grads), tx)
        losses.append(float(loss.detach()))
    return {"losses": losses, "state": state}
