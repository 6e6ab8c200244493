"""Convert the JAX package's trees to the port's tensors and back.

The input is the JAX pytree with numpy leaves (``jax.tree.map(np.asarray,
tree)``) or a checkpoint read back by the port (``utils/state_stream.py``:
torch leaves, namedtuples and custom nodes as ``treedef.JaxNode``);
nothing of JAX is imported here.  Keys, nesting, shapes and dtypes are
kept, so the stacked ``blocks`` layout with its leading ``n_layer`` axis
carries over as is.

A training state converts both ways between the port's
:class:`TrainState` and the JAX package's ``TrainState(params, opt_state,
step, grad_residual)``, for the GPT family's optimizers:

* the plain chain: JAX ``(EmptyState(), (ScaleByAdamState(count, mu,
  nu), MaskedState(EmptyState()), ScaleByScheduleState(count)))`` is the
  port's ``((), {"count", "mu", "nu"})`` (``models/optim.py``);
* the LoRA chain: JAX ``(PartitionState({"freeze":
  MaskedState(EmptyState()), "train": MaskedState(EmptyState())}),
  EmptyState(), PartitionState({"freeze": MaskedState(EmptyState()),
  "train": MaskedState(<the AdamW triple>)}))`` is the port's
  ``({"freeze": (), "train": ()}, (), {"freeze": (), "train": {...}})``,
  the frozen leaves of mu and nu ``MaskedNode`` on both sides;
* under accumulation, ``MultiStepsState(mini_step, gradient_step,
  inner_opt_state, acc_grads, skip_state=())`` and the port's
  ``multi_steps`` dict around either;
* a moment leaf is a tensor, or under ``opt_state_dtype="int8"`` a
  ``BlockQuantized`` node (``ops/optim_quant.py``; its static fields are
  the JAX node's aux data, kept as read).

A model-parallel rank holds slices of the JAX global arrays
(:func:`shard_params` cuts them by the module's ``param_partition_specs``
and :func:`gather_params` puts them back together over the ranks' groups,
so what a fit streams back holds the JAX global arrays).  One departure:
``qkv_w``/``qkv_b`` (:data:`HEAD_ALIGNED`), whose JAX spec splits the
``3·d`` columns contiguously, are split by heads here: a rank holds the
same ``d/t`` columns of each of q, k and v.

JAX keeps two counts (Adam's and the schedule's) where the port keeps
one: they advance together, so a read takes Adam's (and refuses a tree
where they differ) and a write writes it to both.  JAX's step is a 0-d
int32 leaf, the port's a host int.  Any other tree raises, naming the
path.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.core.module import TrainState
from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.models.optim import MaskedNode
from ray_lightning_tpu_torch.ops.optim_quant import BlockQuantized
from ray_lightning_tpu_torch.utils.treedef import (
    ADAM_STATE, BLOCK_QUANTIZED, EMPTY_STATE, MASKED_NODE, MASKED_STATE,
    MULTI_STEPS_STATE, PARTITION_STATE, SCHEDULE_STATE, TRAIN_STATE, JaxNode,
)

__all__ = ["params_from_jax", "adapter_from_jax", "jax_train_state_fields",
           "train_state_from_jax", "train_state_to_jax",
           "stage_state_from_jax", "stage_state_to_jax", "HEAD_ALIGNED",
           "shard_leaf", "gather_leaf", "shard_params", "gather_params",
           "spec_of"]

# Leaves whose last dim is [q | k | v] and which a ``tensor`` rank holds by
# heads: its run of each third.
HEAD_ALIGNED = ("qkv_w", "qkv_b")

_FACTOR_KEYS = ("qkv_a", "qkv_b", "proj_a", "proj_b")
_LORA_LABELS = ("freeze", "train")


def _tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    # np.array copies: torch.from_numpy needs a writable, owned buffer.
    return torch.from_numpy(np.array(x)).to(device)


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """A GPT parameter tree with numpy (or torch) leaves → the same tree
    of torch tensors on ``device`` (``None`` means ``"cuda"``)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node, dev)

    return conv(tree)


def adapter_from_jax(adapter: Dict[str, Any], device=None) -> Dict[str, Any]:
    """One LoRA adapter (``extract_lora``/``synthetic_lora_adapter``
    output: four stacked factors plus ``scale``) → torch factors on
    ``device`` and a float ``scale``."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {k: _tensor(adapter[k], dev) for k in _FACTOR_KEYS}
    out["scale"] = float(adapter.get("scale", 1.0))
    return out


def _refuse(node: Any, path: str, wanted: str) -> ValueError:
    if isinstance(node, JaxNode):
        got = str(node.cls)
    elif isinstance(node, (tuple, list)):
        got = f"a {type(node).__name__} of {len(node)}"
    else:
        got = type(node).__name__
    return ValueError(
        f"{path}: expected {wanted}, got {got}.  The port converts the GPT "
        "family's TrainState (clip + masked AdamW, or the LoRA chain; "
        "optax.MultiSteps under accumulation; float or int8 moments)")


def _fields(node: Any, cls, arity: int, path: str) -> Tuple[Any, ...]:
    if not (isinstance(node, JaxNode) and node.cls == cls
            and len(node.children) == arity):
        raise _refuse(node, path, f"{cls} with {arity} children")
    return node.children


def _fields_tuple(node: Any, arity: int, path: str) -> Tuple[Any, ...]:
    if not (isinstance(node, tuple) and len(node) == arity):
        raise _refuse(node, path, f"a tuple of {arity}")
    return node


def _leaves(tree: Any, path: str) -> Any:
    """A dict (or list) tree of array leaves as torch tensors, where they
    are."""
    if isinstance(tree, dict):
        return {k: _leaves(v, f"{path}['{k}']") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaves(v, f"{path}[{i}]") for i, v in enumerate(tree)]
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return _tensor(tree, tree.device if isinstance(tree, torch.Tensor)
                       else torch.device("cpu"))
    raise _refuse(tree, path, "an array leaf")


def _count(leaf: Any, path: str) -> torch.Tensor:
    t = _leaves(leaf, path)
    if t.dim() != 0:
        raise _refuse(leaf, path, "a 0-d count")
    return t


def jax_train_state_fields(tree: Any, path: str = "state"
                           ) -> Tuple[Any, Any, Any]:
    """``(params, opt_state, step)`` of a JAX ``TrainState`` node, as the
    tree holds them (a ``grad_residual`` is dropped, as the JAX loop drops
    it when resuming without gradient compression)."""
    params, opt_state, step, _ = _fields(tree, TRAIN_STATE, 4, path)
    return params, opt_state, step


def _moments(tree: Any, path: str) -> Any:
    """A mu/nu tree: tensors, ``BlockQuantized`` nodes and ``MaskedNode``
    places."""
    if isinstance(tree, dict):
        return {k: _moments(v, f"{path}['{k}']") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_moments(v, f"{path}[{i}]") for i, v in enumerate(tree)]
    if isinstance(tree, JaxNode) and tree.cls == MASKED_NODE:
        _fields(tree, MASKED_NODE, 0, path)
        return MaskedNode()
    if isinstance(tree, JaxNode) and tree.cls == BLOCK_QUANTIZED:
        q, scale = _fields(tree, BLOCK_QUANTIZED, 2, path)
        aux = tree.aux
        if not (tree.custom and isinstance(aux, tuple) and len(aux) == 3
                and isinstance(aux[0], tuple)):
            raise _refuse(tree, path, "BlockQuantized aux data (shape, "
                          "block_size, sqrt_domain)")
        return BlockQuantized(_leaves(q, f"{path}.q"),
                              _leaves(scale, f"{path}.scale"), *aux,
                              aux=aux)
    return _leaves(tree, path)


def _adam_from_jax(adamw: Any, path: str) -> Dict[str, Any]:
    """The AdamW triple ``(ScaleByAdamState, MaskedState(EmptyState),
    ScaleByScheduleState)`` → the port's ``{"count", "mu", "nu"}``."""
    adam, masked, sched = _fields_tuple(adamw, 3, path)
    count, mu, nu = _fields(adam, ADAM_STATE, 3, f"{path}[0]")
    (inner,) = _fields(masked, MASKED_STATE, 1, f"{path}[1]")
    _fields(inner, EMPTY_STATE, 0, f"{path}[1].inner_state")
    (sched_count,) = _fields(sched, SCHEDULE_STATE, 1, f"{path}[2]")
    count = _count(count, f"{path}[0].count")
    sched_count = _count(sched_count, f"{path}[2].count")
    if int(count) != int(sched_count):
        raise ValueError(
            f"{path}: the Adam count {int(count)} and the schedule's count "
            f"{int(sched_count)} differ; the port keeps one count for both")
    return {"count": count.to(torch.int32),
            "mu": _moments(mu, f"{path}[0].mu"),
            "nu": _moments(nu, f"{path}[0].nu")}


def _partition(tree: Any, path: str) -> Dict[str, Any]:
    """A LoRA ``PartitionState`` → ``{label: MaskedState's inner}``."""
    (inner,) = _fields(tree, PARTITION_STATE, 1, path)
    if not (isinstance(inner, dict) and sorted(inner) == list(_LORA_LABELS)):
        raise _refuse(inner, f"{path}.inner_states",
                      f"a dict of the labels {_LORA_LABELS}")
    out = {}
    for label in _LORA_LABELS:
        (out[label],) = _fields(inner[label], MASKED_STATE, 1,
                                f"{path}.inner_states['{label}']")
    return out


def _empty(node: Any, path: str) -> Tuple[()]:
    _fields(node, EMPTY_STATE, 0, path)
    return ()


def _adamw_from_jax(tree: Any, path: str) -> Tuple[Any, ...]:
    """The GPT family's optimizer state: the plain chain or the LoRA
    chain."""
    if isinstance(tree, tuple) and len(tree) == 3:
        first, clip, second = tree
        gates = _partition(first, f"{path}[0]")
        for label in _LORA_LABELS:
            _empty(gates[label], f"{path}[0].inner_states['{label}']"
                                 ".inner_state")
        opt = _partition(second, f"{path}[2]")
        p = f"{path}[2].inner_states"
        return ({label: () for label in _LORA_LABELS},
                _empty(clip, f"{path}[1]"),
                {"freeze": _empty(opt["freeze"],
                                  f"{p}['freeze'].inner_state"),
                 "train": _adam_from_jax(opt["train"],
                                         f"{p}['train'].inner_state")})
    clip, adamw = _fields_tuple(tree, 2, path)
    return _empty(clip, f"{path}[0]"), _adam_from_jax(adamw, f"{path}[1]")


def train_state_from_jax(tree: Any) -> TrainState:
    """A JAX ``TrainState`` (a checkpoint's ``payload["state"]``) → the
    port's, its tensors where the tree's leaves are (numpy leaves land on
    the CPU)."""
    params, opt_state, step = jax_train_state_fields(tree)
    if opt_state is None:
        # A pipeline fit's reassembled params: the moments stay with the
        # stages (``parallel/strategies.py::MpmdStrategy``).
        opt = None
    elif (isinstance(opt_state, JaxNode)
          and opt_state.cls == MULTI_STEPS_STATE):
        path = "state.opt_state"
        mini, grad_step, inner, acc, skip = _fields(
            opt_state, MULTI_STEPS_STATE, 5, path)
        if skip != ():
            raise _refuse(skip, f"{path}.skip_state", "()")
        opt = {"mini_step": _count(mini, f"{path}.mini_step").to(torch.int32),
               "gradient_step": _count(grad_step, f"{path}.gradient_step"
                                       ).to(torch.int32),
               "inner_opt_state": _adamw_from_jax(
                   inner, f"{path}.inner_opt_state"),
               "acc_grads": _leaves(acc, f"{path}.acc_grads")}
    else:
        opt = _adamw_from_jax(opt_state, "state.opt_state")
    return TrainState(_leaves(params, "state.params"), opt,
                      int(_count(step, "state.step")))


def _moments_to_jax(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _moments_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_moments_to_jax(v) for v in tree]
    if isinstance(tree, MaskedNode):
        return JaxNode(MASKED_NODE, ())
    if isinstance(tree, BlockQuantized):
        aux = tree.aux if tree.aux == tree.static() else tree.static()
        return JaxNode(BLOCK_QUANTIZED, (tree.q, tree.scale), custom=True,
                       aux=aux)
    return tree


def _adam_to_jax(adam: Dict[str, Any]) -> Tuple[Any, Any, Any]:
    count = adam["count"]
    return (JaxNode(ADAM_STATE, (count, _moments_to_jax(adam["mu"]),
                                 _moments_to_jax(adam["nu"]))),
            JaxNode(MASKED_STATE, (JaxNode(EMPTY_STATE, ()),)),
            JaxNode(SCHEDULE_STATE, (count,)))


def _adamw_to_jax(opt: Any) -> Tuple[Any, ...]:
    empty = JaxNode(EMPTY_STATE, ())
    if len(opt) == 3:  # the LoRA chain
        def partition(inner):
            return JaxNode(PARTITION_STATE, ({
                label: JaxNode(MASKED_STATE, (inner[label],))
                for label in _LORA_LABELS},))

        return (partition({"freeze": empty, "train": empty}), empty,
                partition({"freeze": empty,
                           "train": _adam_to_jax(opt[2]["train"])}))
    return empty, _adam_to_jax(opt[1])


def train_state_to_jax(state: TrainState) -> JaxNode:
    """The port's :class:`TrainState` → the JAX ``TrainState`` tree that
    ``utils/state_stream.py`` writes and the JAX package loads (tensors
    as they are: the stream copies them to the host)."""
    opt = state.opt_state
    if opt is None:
        pass
    elif isinstance(opt, dict):
        opt = JaxNode(MULTI_STEPS_STATE, (
            opt["mini_step"], opt["gradient_step"],
            _adamw_to_jax(opt["inner_opt_state"]), opt["acc_grads"], ()))
    else:
        opt = _adamw_to_jax(opt)
    step = torch.tensor(int(state.step), dtype=torch.int32)
    return JaxNode(TRAIN_STATE, (state.params, opt, step, None), custom=True)


def stage_state_to_jax(state: TrainState) -> JaxNode:
    """A pipeline stage's :class:`TrainState` (params ``{"chunks": [...]}``
    under the clip-free ``gpt_adamw``) → the JAX stage's ``TrainState``
    tree: the optax ``adamw`` state ``(ScaleByAdamState,
    MaskedState(EmptyState), ScaleByScheduleState)``."""
    step = torch.tensor(int(state.step), dtype=torch.int32)
    return JaxNode(TRAIN_STATE, (state.params, _adam_to_jax(state.opt_state),
                                 step, None), custom=True)


def stage_state_from_jax(tree: Any) -> TrainState:
    """The JAX stage's ``TrainState`` (an ``mpmd-step*-stage*.ckpt``
    payload's ``"state"``) → the port's, as :func:`stage_state_to_jax`
    writes it."""
    params, opt_state, step = jax_train_state_fields(tree)
    return TrainState(_leaves(params, "state.params"),
                      _adam_from_jax(opt_state, "state.opt_state"),
                      int(_count(step, "state.step")))


# ---------------------------------------------------------------------------
# Model-parallel slices
# ---------------------------------------------------------------------------

def spec_of(specs: Any, path: Tuple) -> Tuple:
    """The partition spec of the param at key ``path`` in ``specs`` (a
    params-shaped dict of tuples; ``()`` replicated)."""
    node = specs
    for k in path:
        node = node[k]
    return tuple(node)


def shard_leaf(t: torch.Tensor, spec: Tuple, groups: Any,
               head_aligned: bool = False) -> torch.Tensor:
    """This rank's slice of the global leaf ``t``: along each dim that
    ``spec`` names an axis for, its run ``index`` of ``size`` (``groups``:
    an object whose ``axis(name)`` gives the rank's ``AxisGroup`` along
    it, or None for an axis the mesh lacks).  ``head_aligned``: the last
    dim is ``[q | k | v]`` and the rank takes its run of each third."""
    for dim, axis in enumerate(spec):
        g = None if axis is None else _group(groups, axis)
        if g is None or g.size == 1:
            continue
        if head_aligned and dim == t.dim() - 1:
            parts = t.unflatten(dim, (3, t.shape[dim] // 3))
            c = parts.shape[-1] // g.size
            t = parts.narrow(-1, g.index * c, c).flatten(-2)
        else:
            c = t.shape[dim] // g.size
            t = t.narrow(dim, g.index * c, c)
    return t.contiguous()


def gather_leaf(t: torch.Tensor, spec: Tuple, groups: Any,
                head_aligned: bool = False) -> torch.Tensor:
    """The global leaf from every rank's slice :func:`shard_leaf` cut:
    one all-gather a sharded dim, over the rank's group along its axis (a
    collective of those groups)."""
    import torch.distributed as dist

    for dim in reversed(range(len(spec))):
        axis = spec[dim]
        g = None if axis is None else _group(groups, axis)
        if g is None or g.size == 1:
            continue
        parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
                 for _ in range(g.size)]
        dist.all_gather(parts, t.contiguous(), group=g.group)
        if head_aligned and dim == t.dim() - 1:
            # [q_r | k_r | v_r] for each rank r -> [q | k | v].
            t = torch.stack([p.unflatten(dim, (3, p.shape[dim] // 3))
                             for p in parts], dim=-2).flatten(-3)
        else:
            t = torch.cat(parts, dim=dim)
    return t


def _group(groups: Any, axis: str):
    try:
        return groups.axis(axis)
    except AttributeError:
        return None


def _map_specs(tree: Any, specs: Any, fn, path: Tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_specs(v, specs[k], fn, path + (k,))
                for k, v in tree.items()}
    return fn(tree, tuple(specs), path[-1] in HEAD_ALIGNED)


def shard_params(full: Dict[str, Any], groups: Any,
                 specs: Dict[str, Any]) -> Dict[str, Any]:
    """A rank's slices of a full params tree by ``specs``
    (``GPT.param_partition_specs``) over its model groups (a
    ``parallel.model_parallel.ModelParallel``): :func:`shard_leaf` a
    leaf."""
    return _map_specs(full, specs, lambda t, spec, ha: shard_leaf(
        t, spec, groups, ha))


def gather_params(local: Dict[str, Any], groups: Any,
                  specs: Dict[str, Any]) -> Dict[str, Any]:
    """The full params tree from every rank's slices (a collective of the
    model groups): :func:`gather_leaf` a leaf."""
    return _map_specs(local, specs, lambda t, spec, ha: gather_leaf(
        t, spec, groups, ha))
