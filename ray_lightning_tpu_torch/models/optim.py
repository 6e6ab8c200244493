"""The GPT family's optimizer: global-norm clip + masked warmup-cosine AdamW.

A functional port of what the JAX package builds with optax
(``ray_lightning_tpu/models/gpt.py::GPT.configure_optimizers`` and
``gpt_adamw``)::

    chain(clip_by_global_norm(1.0),
          adamw(warmup_cosine_decay_schedule(0, lr, warmup,
                                             max(10·warmup, 1000)),
                b1=0.9, b2=0.95, weight_decay, mask=decay_mask,
                mu_dtype=bfloat16))

with optax 0.2.6's order of operations (``scale_by_adam``,
``add_decayed_weights``, ``scale_by_learning_rate``), not
``torch.optim.AdamW``:

* the schedule's count starts at 0, so the first update uses lr = 0;
* ``mu = (1-b1)·g + b1·mu`` and ``nu = (1-b2)·g² + b2·nu`` in f32, the
  bias corrections ``1 - b**count`` in f32, and mu rounded to bf16 only
  when it is stored.  In ``b1·mu`` the constant takes mu's storage dtype
  (JAX's weak-typed scalar: 0.8984375 for a bf16 mu) and the product stays
  f32, as the JAX package's jitted step computes it;
* ``update = mu_hat / (sqrt(nu_hat) + eps)`` with eps 1e-8 outside the
  root;
* decay ``+ weight_decay·param`` on the masked leaves only;
* then ``-lr·update`` added to the parameter.

A transformation is a pair ``init(params) -> state`` and ``update(grads,
state, params) -> (updates, state)`` over parameter dicts, optax's shape.
The step counts live in the state as host ints, so a step needs no device
sync; the clip's trigger stays on the device.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple

import numpy as np
import torch

__all__ = ["GradientTransformation", "chain", "clip_by_global_norm",
           "adamw", "warmup_cosine_decay_schedule", "gpt_adamw",
           "decay_mask", "tree_map", "apply_updates"]

# Matrix-valued params by naming convention: ``*_w`` projections plus the
# tied token embedding; biases, LayerNorm gains and ``wpe`` are exempt.
_DECAY_EXACT = {"wte"}


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts (``rest`` trees alike)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def decay_mask(params: Dict[str, Any]) -> Dict[str, Any]:
    """AdamW weight-decay mask: True for ``*_w`` leaves and ``wte``."""
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return name.endswith("_w") or name in _DECAY_EXACT

    return walk(params, "")


def apply_updates(params: Any, updates: Any) -> Any:
    """``params + updates``, leaf by leaf, in each param's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax's ``clip_by_global_norm``: leaves unchanged when the global
    norm is below ``max_norm``, else ``(t / norm)·max_norm``."""

    def update(updates, state, params=None):
        leaves = tree_leaves(updates)
        norm = torch.sqrt(sum(torch.sum(t * t) for t in leaves))
        trigger = norm < max_norm
        return tree_map(
            lambda t: torch.where(trigger, t,
                                  (t / norm.to(t.dtype)) * max_norm),
            updates), state

    return GradientTransformation(lambda params: (), update)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int
                                 ) -> Callable[[int], float]:
    """optax's schedule (end value 0): linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine to 0 at
    ``decay_steps``."""
    cos_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = count / warmup_steps
            return (init_value - peak_value) * (1 - frac) + peak_value
        c = min(count - warmup_steps, cos_steps)
        return peak_value * 0.5 * (1 + math.cos(math.pi * c / cos_steps))

    return schedule


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in f32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def adamw(learning_rate: Callable[[int], float], b1: float, b2: float,
          weight_decay: float, mask: Callable[[Any], Any],
          mu_dtype: torch.dtype, eps: float = 1e-8) -> GradientTransformation:
    """optax's ``adamw`` = ``scale_by_adam`` → masked
    ``add_decayed_weights`` → ``scale_by_learning_rate``.  State:
    ``{"count": int, "mu": tree, "nu": tree}``."""

    def init(params):
        return {
            "count": 0,
            "mu": tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype),
                           params),
            "nu": tree_map(torch.zeros_like, params),
        }

    # b1 as JAX's weak-typed scalar becomes next to the stored mu.
    b1_mu = float(torch.tensor(b1, dtype=mu_dtype))

    def update(grads, state, params):
        count = state["count"] + 1
        c1 = _bias_correction(b1, count)
        c2 = _bias_correction(b2, count)
        lr = learning_rate(state["count"])
        decay = mask(params)

        def leaf(g, m, v, p, dec):
            m = (1 - b1) * g + b1_mu * m.float()
            v = (1 - b2) * (g * g) + b2 * v
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if dec:
                u = u + weight_decay * p
            return (-lr) * u, m.to(mu_dtype), v

        out = tree_map(leaf, grads, state["mu"], state["nu"], params, decay)
        updates = tree_map(lambda o: o[0], out)
        mu = tree_map(lambda o: o[1], out)
        nu = tree_map(lambda o: o[2], out)
        return updates, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def gpt_adamw(cfg) -> GradientTransformation:
    """The family's scheduled, masked AdamW without the clip
    (``gpt_adamw`` of the JAX package).  ``cfg.opt_state_dtype`` other
    than None is refused: int8 and bf16 optimizer state are a later
    slice of the port."""
    if getattr(cfg, "opt_state_dtype", None) is not None:
        raise NotImplementedError(
            f"opt_state_dtype={cfg.opt_state_dtype!r} is not supported by "
            f"the PyTorch port yet (int8/bf16 optimizer state is a later "
            f"slice); leave it None")
    schedule = warmup_cosine_decay_schedule(
        0.0, cfg.lr, cfg.warmup_steps, max(10 * cfg.warmup_steps, 1000))
    mu_dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg.mu_dtype]
    return adamw(schedule, b1=0.9, b2=0.95, weight_decay=cfg.weight_decay,
                 mask=decay_mask, mu_dtype=mu_dtype)
