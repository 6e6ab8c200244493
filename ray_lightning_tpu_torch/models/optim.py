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
Everything an update reads lives on the device, as under ``jit``: the
step count is an int32 tensor of the state, and the schedule, the bias
corrections and the clip's trigger are computed from it in f32 there.  So
a step needs no host sync, and a CUDA graph that captured steps replays
them at the count, learning rate and bias correction each replay reaches
(a count held on the host would freeze its capture-time value into the
graph).  :func:`multi_steps` is ``optax.MultiSteps`` (gradient
accumulation) and :func:`multi_steps_flush` the JAX loop's flush of a
partial window.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple

import torch

__all__ = ["GradientTransformation", "chain", "clip_by_global_norm",
           "adamw", "warmup_cosine_decay_schedule", "gpt_adamw",
           "multi_steps", "multi_steps_flush", "decay_mask", "tree_map",
           "tree_leaves", "tree_unflatten", "apply_updates"]

# Matrix-valued params by naming convention: ``*_w`` projections plus the
# tied token embedding; biases, LayerNorm gains and ``wpe`` are exempt.
_DECAY_EXACT = {"wte"}


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts, tuples and lists (``rest``
    trees alike)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(template: Any, leaves) -> Any:
    """``leaves`` (in :func:`tree_leaves` order) in ``template``'s
    structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


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
                                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """optax's schedule on a device count: ``join_schedules`` of
    ``linear_schedule(init_value, peak_value, warmup_steps)`` and
    ``cosine_decay_schedule(peak_value, decay_steps - warmup_steps)`` (end
    value 0) at ``warmup_steps``.  ``count`` is an int32 tensor; the value
    is an f32 tensor on its device, computed in optax's order of
    operations."""
    cos_steps = decay_steps - warmup_steps

    def linear(count):
        c = torch.clamp(count, 0, warmup_steps)
        frac = 1 - c / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    def cosine(count):
        c = torch.clamp(count.float(), max=float(cos_steps))
        return peak_value * (0.5 * (1 + torch.cos(math.pi * c / cos_steps)))

    def schedule(count: torch.Tensor) -> torch.Tensor:
        return torch.where(count < warmup_steps, linear(count),
                           cosine(count - warmup_steps))

    return schedule


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``1 - decay**count`` in f32 on the count's device, as optax
    computes it under ``jit``."""
    return 1 - torch.pow(decay, count.float())


def _zero_count(params: Any) -> torch.Tensor:
    device = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw(learning_rate: Callable[[torch.Tensor], torch.Tensor], b1: float,
          b2: float, weight_decay: float, mask: Callable[[Any], Any],
          mu_dtype: torch.dtype, eps: float = 1e-8) -> GradientTransformation:
    """optax's ``adamw`` = ``scale_by_adam`` → masked
    ``add_decayed_weights`` → ``scale_by_learning_rate``.  State:
    ``{"count": int32 tensor, "mu": tree, "nu": tree}``."""

    def init(params):
        return {
            "count": _zero_count(params),
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
        decay = tree_leaves(mask(params))
        updates, mus, nus = [], [], []
        for g, m, v, p, dec in zip(tree_leaves(grads),
                                   tree_leaves(state["mu"]),
                                   tree_leaves(state["nu"]),
                                   tree_leaves(params), decay):
            m = (1 - b1) * g + b1_mu * m.float()
            v = (1 - b2) * (g * g) + b2 * v
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if dec:
                u = u + weight_decay * p
            updates.append((-lr) * u)
            mus.append(m.to(mu_dtype))
            nus.append(v)
        return tree_unflatten(grads, updates), {
            "count": count, "mu": tree_unflatten(grads, mus),
            "nu": tree_unflatten(grads, nus)}

    return GradientTransformation(init, update)


def multi_steps(inner: GradientTransformation,
                every_k: int) -> GradientTransformation:
    """``optax.MultiSteps(inner, every_k_schedule=every_k)`` (optax 0.2.6,
    ``use_grad_mean=True``): each update folds the micro-gradient into the
    running mean ``acc + (g - acc) / (mini_step + 1)``, runs ``inner`` on
    it, and keeps the inner result only where the window ends (``emit``);
    between emits the updates are zero.  Every decision is a device
    select, as under ``jit``.  State: ``{"mini_step", "gradient_step"``
    (int32 tensors), ``"inner_opt_state", "acc_grads"}``."""

    def init(params):
        return {"mini_step": _zero_count(params),
                "gradient_step": _zero_count(params),
                "inner_opt_state": inner.init(params),
                "acc_grads": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        n = state["mini_step"]
        acc = tree_map(lambda g, a: a + (g - a) / (n + 1), grads,
                       state["acc_grads"])
        final, inner_new = inner.update(acc, state["inner_opt_state"],
                                        params)
        emit = n == every_k - 1
        keep = 1 - emit.to(torch.int32)
        new_state = {
            "mini_step": (n + 1) % every_k,
            "gradient_step": (emit * (state["gradient_step"] + 1)
                              + keep * state["gradient_step"]),
            "inner_opt_state": tree_map(
                lambda old, new: torch.where(emit, new, old),
                state["inner_opt_state"], inner_new),
            "acc_grads": tree_map(lambda a, u: keep * a.to(u.dtype),
                                  acc, final),
        }
        return tree_map(lambda u: emit * u, final), new_state

    return GradientTransformation(init, update)


def multi_steps_flush(inner: GradientTransformation, state: Dict[str, Any],
                      params: Any):
    """The partial-window flush of the JAX loop (``_build_accum_flush``):
    one ``inner`` update from the running mean of the window's
    micro-gradients, the window reset.  Returns ``(updates, state)``."""
    updates, inner_new = inner.update(state["acc_grads"],
                                      state["inner_opt_state"], params)
    return updates, {
        "mini_step": torch.zeros_like(state["mini_step"]),
        "gradient_step": state["gradient_step"] + 1,
        "inner_opt_state": inner_new,
        "acc_grads": tree_map(torch.zeros_like, state["acc_grads"]),
    }


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
