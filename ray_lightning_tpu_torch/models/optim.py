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

LoRA's optimizer (``GPT.configure_optimizers``) needs optax's
``identity``, ``set_to_zero`` and ``multi_transform``: a transform runs
on the params of its label with the others masked out (a
:class:`MaskedNode` in their place, as optax's ``masked`` puts one), so
the frozen base holds no moments.  A frozen leaf's gradient and update
are :func:`known_zeros`, a broadcast zero that allocates nothing; the
clip leaves it out of the norm (adding an exact 0.0 changes no sum) and
:func:`apply_updates` passes its parameter through.

The optimizer-state precision policy (``opt_state_dtype``) is the JAX
package's ``models/optim.py``: :func:`quantize_opt_state` stores the
AdamW moments in bf16 or block-scaled int8 (``ops/optim_quant.py``)
between steps and updates them on a transient f32 view;
:func:`opt_state_bytes` is its analytic accounting.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from ray_lightning_tpu_torch.ops.optim_quant import (
    DEFAULT_BLOCK_SIZE, MIN_QUANT_SIZE, BlockQuantized, dequantize_moment,
    is_block_quantized, quantize_moment,
)

__all__ = ["GradientTransformation", "chain", "clip_by_global_norm",
           "adamw", "warmup_cosine_decay_schedule", "gpt_adamw",
           "multi_steps", "multi_steps_flush", "decay_mask", "tree_map",
           "tree_leaves", "tree_unflatten", "apply_updates", "MaskedNode",
           "identity", "set_to_zero", "multi_transform", "known_zeros",
           "is_known_zeros", "OPT_STATE_DTYPES", "resolve_opt_state_dtype",
           "quantize_opt_state", "apply_opt_state_dtype", "opt_state_bytes",
           "moment_bytes"]

# Matrix-valued params by naming convention: ``*_w`` projections plus the
# tied token embedding; biases, LayerNorm gains and ``wpe`` are exempt.
_DECAY_EXACT = {"wte"}


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]


class MaskedNode:
    """optax's ``MaskedNode``: the place of a parameter that a masked
    transform does not see.  A node with no leaves: :func:`tree_map`
    keeps it, :func:`tree_leaves` skips it."""

    __slots__ = ()

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, MaskedNode)

    def __hash__(self) -> int:
        return hash(MaskedNode)

    def __repr__(self) -> str:
        return "MaskedNode()"


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts, tuples, lists and
    :class:`BlockQuantized` nodes (``rest`` trees alike); a
    :class:`MaskedNode` stays as it is."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if isinstance(tree, MaskedNode):
        return tree
    if isinstance(tree, BlockQuantized):
        return tree.replace(fn(tree.q, *(r.q for r in rest)),
                            fn(tree.scale, *(r.scale for r in rest)))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    if isinstance(tree, MaskedNode):
        return []
    if isinstance(tree, BlockQuantized):
        return [tree.q, tree.scale]
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
        if isinstance(node, MaskedNode):
            return node
        return name.endswith("_w") or name in _DECAY_EXACT

    return walk(params, "")


def known_zeros(t: torch.Tensor,
                zero: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zeros of ``t``'s shape and dtype that allocate nothing: one zero
    (``zero``, a 0-d tensor of ``t``'s dtype, or a new one) broadcast as a
    stride-0 view, marked so :func:`is_known_zeros` can pass it by."""
    if zero is None:
        zero = torch.zeros((), dtype=t.dtype, device=t.device)
    z = zero.expand(t.shape)
    z.rlt_known_zeros = True
    return z


def is_known_zeros(t: Any) -> bool:
    """True for a tensor made by :func:`known_zeros` (never for a tensor
    that merely holds zeros)."""
    return getattr(t, "rlt_known_zeros", False)


def apply_updates(params: Any, updates: Any) -> Any:
    """``params + updates``, leaf by leaf, in each param's dtype; a
    :func:`known_zeros` update returns the parameter itself (p + 0 = p,
    and the write-back of a captured step then copies nothing)."""
    return tree_map(
        lambda p, u: p if is_known_zeros(u) else (p + u).to(p.dtype),
        params, updates)


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
        # A known-zero leaf adds an exact 0.0 to the norm: left out.
        leaves = [t for t in tree_leaves(updates) if not is_known_zeros(t)]
        norm = torch.sqrt(sum(torch.sum(t * t) for t in leaves))
        trigger = norm < max_norm
        return tree_map(
            lambda t: t if is_known_zeros(t) else torch.where(
                trigger, t, (t / norm.to(t.dtype)) * max_norm),
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
    leaves = tree_leaves(params)
    if not leaves:
        raise ValueError("an optimizer state needs at least one parameter "
                         "(every leaf is masked out)")
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device)


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


def identity() -> GradientTransformation:
    """optax's ``identity``: updates unchanged, empty state."""
    return GradientTransformation(lambda params: (),
                                  lambda updates, state, params=None:
                                  (updates, state))


def set_to_zero() -> GradientTransformation:
    """optax's ``set_to_zero``: every update :func:`known_zeros`, empty
    state."""

    def update(updates, state, params=None):
        return tree_map(lambda t: t if is_known_zeros(t) else known_zeros(t),
                        updates), state

    return GradientTransformation(lambda params: (), update)


def _masked(tree: Any, labels: Any, label: str) -> Any:
    """``tree`` with the leaves of other labels replaced by
    :class:`MaskedNode` (optax's ``masked`` view)."""
    return tree_map(lambda t, lab: t if lab == label else MaskedNode(),
                    tree, labels)


def multi_transform(transforms: Dict[str, GradientTransformation],
                    param_labels: Callable[[Any], Any]
                    ) -> GradientTransformation:
    """optax's ``multi_transform``: ``transforms[label]`` runs on the
    leaves ``param_labels(params)`` gives that label, the others masked
    out.  State: ``{label: inner state}`` (the JAX package's
    ``PartitionState`` of ``MaskedState``s, ``models/convert.py``)."""

    def init(params):
        labels = param_labels(params)
        return {name: tx.init(_masked(params, labels, name))
                for name, tx in transforms.items()}

    def update(updates, state, params=None):
        labels = param_labels(updates if params is None else params)
        names = list(transforms)
        parts, new_state = [], {}
        for name in names:
            u, new_state[name] = transforms[name].update(
                _masked(updates, labels, name), state[name],
                None if params is None else _masked(params, labels, name))
            parts.append(u)
        return tree_map(lambda lab, *us: us[names.index(lab)], labels,
                        *parts), new_state

    return GradientTransformation(init, update)


# -- optimizer-state precision ------------------------------------------------

# None is "no policy": the family keeps its mu_dtype first moment.
OPT_STATE_DTYPES = ("float32", "bfloat16", "int8")
_OPT_DTYPE_ALIASES = {"f32": "float32", "fp32": "float32",
                      "bf16": "bfloat16"}


def resolve_opt_state_dtype(value: Optional[str]) -> Optional[str]:
    """The normal name of an ``opt_state_dtype`` value (None stays None);
    anything else raises."""
    if value is None:
        return None
    name = _OPT_DTYPE_ALIASES.get(str(value), str(value))
    if name not in OPT_STATE_DTYPES:
        raise ValueError(
            f"opt_state_dtype {value!r} not in {OPT_STATE_DTYPES} "
            f"(aliases: {sorted(_OPT_DTYPE_ALIASES)})")
    return name


_ADAM_KEYS = frozenset({"count", "mu", "nu"})


def _is_adam_state(node: Any) -> bool:
    return isinstance(node, dict) and set(node) == _ADAM_KEYS


def _map_moment_leaves(tree: Any, fn: Callable) -> Any:
    """``fn`` over the moment leaves of a mu/nu tree: tensors and
    :class:`BlockQuantized` nodes alike; masked places kept."""
    if isinstance(tree, dict):
        return {k: _map_moment_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, MaskedNode):
        return tree
    return fn(tree)


def _map_adam_moments(state: Any, mu_fn: Callable, nu_fn: Callable) -> Any:
    """``mu_fn``/``nu_fn`` over the moment leaves of every AdamW state in
    an optimizer-state tree (at any depth: chains, partitions,
    ``multi_steps``), everything else untouched."""
    if _is_adam_state(state):
        return {"count": state["count"],
                "mu": _map_moment_leaves(state["mu"], mu_fn),
                "nu": _map_moment_leaves(state["nu"], nu_fn)}
    if isinstance(state, dict):
        return {k: _map_adam_moments(v, mu_fn, nu_fn)
                for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(_map_adam_moments(v, mu_fn, nu_fn)
                           for v in state)
    return state


def _compress_fns(dtype: str, block_size: int, min_quant_size: int):
    """((store_mu, store_nu), (load_mu, load_nu)) leaf converters."""

    def store_bf16(v):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.to(torch.bfloat16)
        return v

    def load_bf16(v):
        if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            return v.float()
        return v

    def make_store_int8(sqrt_domain: bool):
        def store(v):
            if (isinstance(v, torch.Tensor) and v.is_floating_point()
                    and v.numel() >= min_quant_size):
                return quantize_moment(v, block_size=block_size,
                                       sqrt_domain=sqrt_domain)
            return v

        return store

    def load_int8(v):
        return dequantize_moment(v) if is_block_quantized(v) else v

    if dtype == "bfloat16":
        return (store_bf16, store_bf16), (load_bf16, load_bf16)
    return ((make_store_int8(False), make_store_int8(True)),
            (load_int8, load_int8))


def quantize_opt_state(inner: GradientTransformation, dtype: str,
                       block_size: int = DEFAULT_BLOCK_SIZE,
                       min_quant_size: int = MIN_QUANT_SIZE
                       ) -> GradientTransformation:
    """``inner`` with its AdamW moments stored in ``dtype`` between
    steps: ``"int8"`` block-scaled (first moment linear, second in the
    sqrt domain; leaves under ``min_quant_size`` elements stay float),
    ``"bfloat16"`` cast.  Each update dequantizes, runs ``inner`` in f32
    and requantizes; the new state's leaves are new tensors, written back
    leafwise under megastep like any other."""
    dtype = resolve_opt_state_dtype(dtype)
    if dtype in (None, "float32"):
        return inner
    (store_mu, store_nu), (load_mu, load_nu) = _compress_fns(
        dtype, block_size, min_quant_size)

    def init(params):
        return _map_adam_moments(inner.init(params), store_mu, store_nu)

    def update(updates, state, params=None):
        new_updates, new_state = inner.update(
            updates, _map_adam_moments(state, load_mu, load_nu), params)
        return new_updates, _map_adam_moments(new_state, store_mu, store_nu)

    return GradientTransformation(init, update)


def apply_opt_state_dtype(adamw_tx: GradientTransformation,
                          opt_state_dtype: Optional[str],
                          block_size: int = DEFAULT_BLOCK_SIZE
                          ) -> GradientTransformation:
    """``adamw_tx`` under the configured state-precision policy
    (None/"float32": unchanged)."""
    dtype = resolve_opt_state_dtype(opt_state_dtype)
    if dtype in (None, "float32"):
        return adamw_tx
    return quantize_opt_state(adamw_tx, dtype, block_size=block_size)


def _numel(leaf: Any) -> int:
    return math.prod(tuple(getattr(leaf, "shape", ())))


def opt_state_bytes(params: Any, dtype: Optional[str],
                    block_size: int = DEFAULT_BLOCK_SIZE,
                    min_quant_size: int = MIN_QUANT_SIZE) -> int:
    """Analytic bytes of the persistent AdamW moments of ``params`` (any
    leaves with a ``shape``: tensors, meta tensors) under a precision
    policy, both moments a leaf.  ``dtype=None`` is the GPT default (bf16
    mu, f32 nu); under ``"int8"`` a leaf under ``min_quant_size`` keeps
    f32 moments."""
    dtype = resolve_opt_state_dtype(dtype) if dtype is not None else None
    total = 0
    for leaf in tree_leaves(params):
        size = _numel(leaf)
        if size == 0:
            continue
        if dtype == "int8" and size >= min_quant_size:
            padded = size + ((-size) % block_size)
            total += 2 * (padded + 4 * (padded // block_size))
        elif dtype == "bfloat16":
            total += 2 * 2 * size
        elif dtype is None:
            total += (2 + 4) * size
        else:  # float32, or int8's small-leaf carve-out
            total += 2 * 4 * size
    return total


def moment_bytes(opt_state: Any) -> int:
    """The bytes the AdamW moments of ``opt_state`` hold on their device
    (payloads and scales of quantized leaves included): what
    :func:`opt_state_bytes` predicts."""
    total = 0

    def count(v):
        nonlocal total
        for t in tree_leaves(v):
            total += t.numel() * t.element_size()
        return v

    _map_adam_moments(opt_state, count, count)
    return total


def gpt_adamw(cfg) -> GradientTransformation:
    """The family's scheduled, masked AdamW without the clip
    (``gpt_adamw`` of the JAX package).  An explicit ``opt_state_dtype``
    policy owns the moments' storage: the inner AdamW then keeps f32
    moments and ``mu_dtype`` is ignored."""
    schedule = warmup_cosine_decay_schedule(
        0.0, cfg.lr, cfg.warmup_steps, max(10 * cfg.warmup_steps, 1000))
    osd = resolve_opt_state_dtype(getattr(cfg, "opt_state_dtype", None))
    mu_dtype = ({"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg.mu_dtype] if osd is None else torch.float32)
    return apply_opt_state_dtype(
        adamw(schedule, b1=0.9, b2=0.95, weight_decay=cfg.weight_decay,
              mask=decay_mask, mu_dtype=mu_dtype), osd)
