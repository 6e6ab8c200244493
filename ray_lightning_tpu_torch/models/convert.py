"""Convert the JAX package's trees to the port's tensors and back.

The input is the JAX pytree with numpy leaves (``jax.tree.map(np.asarray,
tree)``) or a checkpoint read back by the port (``utils/state_stream.py``:
torch leaves, namedtuples and custom nodes as ``treedef.JaxNode``);
nothing of JAX is imported here.  Keys, nesting, shapes and dtypes are
kept, so the stacked ``blocks`` layout with its leading ``n_layer`` axis
carries over as is.

A training state converts both ways between the port's
:class:`TrainState` and the JAX package's ``TrainState(params, opt_state,
step, grad_residual)``, for the GPT family's optimizer: the JAX opt state
``(EmptyState(), (ScaleByAdamState(count, mu, nu),
MaskedState(EmptyState()), ScaleByScheduleState(count)))`` is the port's
``((), {"count", "mu", "nu"})`` (``models/optim.py``), and under
accumulation ``MultiStepsState(mini_step, gradient_step,
inner_opt_state, acc_grads, skip_state=())`` its ``multi_steps`` dict.
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
from ray_lightning_tpu_torch.utils.treedef import (
    ADAM_STATE, EMPTY_STATE, MASKED_STATE, MULTI_STEPS_STATE, SCHEDULE_STATE,
    TRAIN_STATE, JaxNode,
)

__all__ = ["params_from_jax", "adapter_from_jax", "jax_train_state_fields",
           "train_state_from_jax", "train_state_to_jax"]

_FACTOR_KEYS = ("qkv_a", "qkv_b", "proj_a", "proj_b")
# Classes a JAX checkpoint may hold that the port reads but cannot
# convert yet, and why.
_LATER = {
    "BlockQuantized": "a block-quantized int8 opt_state_dtype moment "
                      "(ops/optim_quant.py, a later slice of the port)",
    "PartitionState": "the LoRA optimizer's partition (LoRA training is a "
                      "later slice of the port)",
    "MaskedNode": "the LoRA optimizer's frozen base (LoRA training is a "
                  "later slice of the port)",
}


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


def _later(node: Any) -> str:
    """The first class in ``node`` that a later slice converts, and why
    (or "")."""
    if isinstance(node, JaxNode):
        if node.cls.name in _LATER:
            return f"{node.cls}, {_LATER[node.cls.name]}"
        kids = node.children
    elif isinstance(node, dict):
        kids = tuple(node.values())
    elif isinstance(node, (tuple, list)):
        kids = node
    else:
        return ""
    return next((w for w in map(_later, kids) if w), "")


def _refuse(node: Any, path: str, wanted: str) -> ValueError:
    if isinstance(node, JaxNode):
        got = str(node.cls)
    elif isinstance(node, (tuple, list)):
        got = f"a {type(node).__name__} of {len(node)}"
    else:
        got = type(node).__name__
    why = _later(node)
    return ValueError(
        f"{path}: expected {wanted}, got {got}"
        + (f" holding {why}" if why and not got.startswith(why) else "")
        + ".  The port converts the GPT family's TrainState (clip + masked "
        "AdamW, optax.MultiSteps under accumulation)")


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
    """A dict tree of array leaves as torch tensors, where they are."""
    if isinstance(tree, dict):
        return {k: _leaves(v, f"{path}['{k}']") for k, v in tree.items()}
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


def _adamw_from_jax(tree: Any, path: str) -> Tuple[Any, Dict[str, Any]]:
    clip, adamw = _fields_tuple(tree, 2, path)
    _fields(clip, EMPTY_STATE, 0, f"{path}[0]")
    adam, masked, sched = _fields_tuple(adamw, 3, f"{path}[1]")
    count, mu, nu = _fields(adam, ADAM_STATE, 3, f"{path}[1][0]")
    (inner,) = _fields(masked, MASKED_STATE, 1, f"{path}[1][1]")
    _fields(inner, EMPTY_STATE, 0, f"{path}[1][1].inner_state")
    (sched_count,) = _fields(sched, SCHEDULE_STATE, 1, f"{path}[1][2]")
    count = _count(count, f"{path}[1][0].count")
    sched_count = _count(sched_count, f"{path}[1][2].count")
    if int(count) != int(sched_count):
        raise ValueError(
            f"{path}: the Adam count {int(count)} and the schedule's count "
            f"{int(sched_count)} differ; the port keeps one count for both")
    return (), {"count": count.to(torch.int32),
                "mu": _leaves(mu, f"{path}[1][0].mu"),
                "nu": _leaves(nu, f"{path}[1][0].nu")}


def train_state_from_jax(tree: Any) -> TrainState:
    """A JAX ``TrainState`` (a checkpoint's ``payload["state"]``) → the
    port's, its tensors where the tree's leaves are (numpy leaves land on
    the CPU)."""
    params, opt_state, step = jax_train_state_fields(tree)
    if isinstance(opt_state, JaxNode) and opt_state.cls == MULTI_STEPS_STATE:
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


def _adamw_to_jax(opt: Any) -> Tuple[Any, Any]:
    empty = JaxNode(EMPTY_STATE, ())
    count = opt[1]["count"]
    return (empty, (JaxNode(ADAM_STATE, (count, opt[1]["mu"], opt[1]["nu"])),
                    JaxNode(MASKED_STATE, (empty,)),
                    JaxNode(SCHEDULE_STATE, (count,))))


def train_state_to_jax(state: TrainState) -> JaxNode:
    """The port's :class:`TrainState` → the JAX ``TrainState`` tree that
    ``utils/state_stream.py`` writes and the JAX package loads (tensors
    as they are: the stream copies them to the host)."""
    opt = state.opt_state
    if isinstance(opt, dict):
        opt = JaxNode(MULTI_STEPS_STATE, (
            opt["mini_step"], opt["gradient_step"],
            _adamw_to_jax(opt["inner_opt_state"]), opt["acc_grads"], ()))
    else:
        opt = _adamw_to_jax(opt)
    step = torch.tensor(int(state.step), dtype=torch.int32)
    return JaxNode(TRAIN_STATE, (state.params, opt, step, None), custom=True)
