"""The pickled JAX treedef of a state stream, read and written without JAX.

A state stream of the JAX package (``ray_lightning_tpu/utils/
state_stream.py::tree_to_bytes``) stores its tree's structure as
``pickle.dumps(PyTreeDef)``.  jaxlib pickles a ``PyTreeDef`` as the class
global, an empty ``NEWOBJ`` and the state ``(default_registry, nodes)``
that ``PyTreeDef.__setstate__`` receives, where ``nodes`` lists the tree
in post-order, one :class:`Node` ``(kind, arity, node_data, custom_type,
num_leaves, num_nodes)`` each:

* kind 0 a leaf, 1 ``None``, 2 a tuple, 4 a list;
* kind 3 a namedtuple, ``node_data`` its class;
* kind 5 a dict, ``node_data`` its sorted key list;
* kind 6 a registered custom node, ``node_data`` its aux data and
  ``custom_type`` its class.

:func:`decode` reads that pickle with an unpickler that imports nothing:
each class it may name is an inert :class:`JaxClass` stand-in, from an
allow-list (:data:`CONVERTED`, the classes of a GPT checkpoint's
``TrainState``, int8 moments and the LoRA optimizer's partition among
them); any other global raises, naming it.  :func:`encode`
writes the same opcodes under the same globals, so ``pickle.loads`` in
the JAX package gives the ``PyTreeDef`` JAX builds itself.

In the port's trees a namedtuple or custom node is a :class:`JaxNode`
that keeps its JAX class, so a tree read and written again names the
same classes.  This depends on jaxlib's pickled layout (the six-field
node of jax 0.9): a node of another layout raises, naming it.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
from typing import Any, List, NamedTuple, Tuple

__all__ = ["JaxClass", "JaxNode", "Node", "CONVERTED",
           "TRAIN_STATE", "decode", "encode", "flatten", "unflatten"]

LEAF, NONE, TUPLE, NAMEDTUPLE, LIST, DICT, CUSTOM = range(7)


@dataclasses.dataclass(frozen=True)
class JaxClass:
    """A class (or object) of the JAX side, named but never imported."""

    module: str
    name: str

    def __str__(self) -> str:
        return f"{self.module}.{self.name}"


@dataclasses.dataclass(frozen=True)
class JaxNode:
    """A namedtuple (``custom`` False) or registered custom node of a JAX
    tree: its class, its children in order and, for a custom node, its
    aux data."""

    cls: JaxClass
    children: Tuple[Any, ...]
    custom: bool = False
    aux: Any = None


class Node(NamedTuple):
    kind: int
    arity: int
    node_data: Any
    custom_type: Any
    num_leaves: int
    num_nodes: int


_TREEDEF = JaxClass("jaxlib._jax.pytree", "PyTreeDef")
_REGISTRY = JaxClass("jax._src.tree_util", "default_registry")
TRAIN_STATE = JaxClass("ray_lightning_tpu.core.module", "TrainState")
EMPTY_STATE = JaxClass("optax._src.base", "EmptyState")
ADAM_STATE = JaxClass("optax._src.transform", "ScaleByAdamState")
MASKED_STATE = JaxClass("optax.transforms._masking", "MaskedState")
SCHEDULE_STATE = JaxClass("optax._src.transform", "ScaleByScheduleState")
MULTI_STEPS_STATE = JaxClass("optax.transforms._accumulation",
                             "MultiStepsState")
BLOCK_QUANTIZED = JaxClass("ray_lightning_tpu.ops.optim_quant",
                           "BlockQuantized")
PARTITION_STATE = JaxClass("optax.transforms._combining", "PartitionState")
MASKED_NODE = JaxClass("optax.transforms._masking", "MaskedNode")
# The classes of a GPT TrainState with the family's optimizer (under
# accumulation, int8 moments and LoRA too): the port converts these
# (models/convert.py).
CONVERTED = frozenset({TRAIN_STATE, EMPTY_STATE, ADAM_STATE, MASKED_STATE,
                       SCHEDULE_STATE, MULTI_STEPS_STATE, BLOCK_QUANTIZED,
                       PARTITION_STATE, MASKED_NODE})
_ALLOWED = CONVERTED | {_REGISTRY}


class _TreeDef:
    """A pickled ``PyTreeDef`` here: the state ``NEWOBJ`` + ``BUILD`` hand
    it when read, and the state it is written with."""

    def __init__(self, state=None):
        self.state = state

    def __setstate__(self, state):
        self.state = state


class _Reader(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        cls = JaxClass(module, name)
        if cls == _TREEDEF:
            return _TreeDef
        if cls in _ALLOWED:
            return cls
        raise pickle.UnpicklingError(
            f"treedef: the pickled global {module}.{name} is not one a "
            f"state stream the port reads may name (allowed: "
            f"{sorted(map(str, _ALLOWED | {_TREEDEF}))})")


def _check_node(raw: Any, i: int) -> Node:
    if not (isinstance(raw, tuple) and len(raw) == 6
            and all(isinstance(raw[j], int) for j in (0, 1, 4, 5))):
        raise ValueError(
            f"treedef: node {i} has a layout this reader does not know "
            f"({type(raw).__name__} of "
            f"{len(raw) if isinstance(raw, (tuple, list)) else '?'} fields:"
            f" {raw!r}); it reads jaxlib's six-field node (kind, arity, "
            f"node_data, custom_type, num_leaves, num_nodes)")
    node = Node(*raw)
    kind = node.kind
    ok = {
        LEAF: node.arity == 0 and node.node_data is None
        and node.custom_type is None,
        NONE: node.arity == 0 and node.node_data is None
        and node.custom_type is None,
        TUPLE: node.node_data is None and node.custom_type is None,
        LIST: node.node_data is None and node.custom_type is None,
        NAMEDTUPLE: isinstance(node.node_data, JaxClass)
        and node.custom_type is None,
        DICT: isinstance(node.node_data, list)
        and len(node.node_data) == node.arity and node.custom_type is None,
        CUSTOM: isinstance(node.custom_type, JaxClass),
    }.get(kind)
    if not ok:
        raise ValueError(
            f"treedef: node {i} {raw!r} has a layout this reader does not "
            f"know (kind {kind})")
    return node


def decode(pickled: bytes) -> List[Node]:
    """The post-order node list of a pickled ``PyTreeDef``."""
    obj = _Reader(io.BytesIO(pickled)).load()
    state = getattr(obj, "state", None)
    if not (isinstance(obj, _TreeDef) and isinstance(state, tuple)
            and len(state) == 2 and state[0] == _REGISTRY
            and isinstance(state[1], list)):
        raise ValueError(
            "treedef: not a pickled PyTreeDef of the default registry "
            f"(got {type(obj).__name__})")
    return [_check_node(raw, i) for i, raw in enumerate(state[1])]


def unflatten(nodes: List[Node], leaves: List[Any]) -> Any:
    """The tree of ``nodes`` over ``leaves`` (in order): dicts, tuples,
    lists, ``None`` and :class:`JaxNode`."""
    stack: List[Tuple[Any, int, int]] = []  # (subtree, leaves, nodes)
    it = iter(leaves)
    for i, node in enumerate(nodes):
        k = node.arity
        if len(stack) < k:
            raise ValueError(f"treedef: node {i} {node!r} has {k} children "
                             f"but {len(stack)} precede it")
        kids = stack[len(stack) - k:] if k else []
        del stack[len(stack) - k:]
        children = tuple(c[0] for c in kids)
        n_leaves = sum(c[1] for c in kids)
        n_nodes = 1 + sum(c[2] for c in kids)
        if node.kind == LEAF:
            try:
                tree = next(it)
            except StopIteration:
                raise ValueError(
                    "treedef: fewer leaves than the treedef holds") from None
            n_leaves = 1
        elif node.kind == NONE:
            tree = None
        elif node.kind == TUPLE:
            tree = children
        elif node.kind == LIST:
            tree = list(children)
        elif node.kind == DICT:
            tree = dict(zip(node.node_data, children))
        else:
            tree = JaxNode(node.node_data if node.kind == NAMEDTUPLE
                           else node.custom_type, children,
                           custom=node.kind == CUSTOM,
                           aux=node.node_data if node.kind == CUSTOM
                           else None)
        if (n_leaves, n_nodes) != (node.num_leaves, node.num_nodes):
            raise ValueError(
                f"treedef: node {i} {node!r} counts ({node.num_leaves}, "
                f"{node.num_nodes}) leaves and nodes; its children make "
                f"({n_leaves}, {n_nodes})")
        stack.append((tree, n_leaves, n_nodes))
    if len(stack) != 1:
        raise ValueError(f"treedef: {len(stack)} roots, not 1")
    if next(it, it) is not it:
        raise ValueError("treedef: more leaves than the treedef holds")
    return stack[0][0]


def flatten(tree: Any) -> Tuple[List[Node], List[Any]]:
    """JAX's ``tree_flatten`` of a port tree: the post-order nodes (dict
    keys sorted, as JAX sorts them) and the leaves in the same order.  A
    leaf is anything but a dict, list, tuple, ``None`` or
    :class:`JaxNode`."""
    nodes: List[Node] = []
    leaves: List[Any] = []

    def walk(t) -> Tuple[int, int]:
        if t is None:
            nodes.append(Node(NONE, 0, None, None, 0, 1))
            return 0, 1
        if isinstance(t, dict):
            keys = sorted(t)
            kids = [t[k] for k in keys]
        elif isinstance(t, (tuple, list)):
            kids = list(t)
        elif isinstance(t, JaxNode):
            kids = list(t.children)
        else:
            leaves.append(t)
            nodes.append(Node(LEAF, 0, None, None, 1, 1))
            return 1, 1
        n_leaves, n_nodes = 0, 1
        for c in kids:
            a, b = walk(c)
            n_leaves += a
            n_nodes += b
        if isinstance(t, dict):
            node = Node(DICT, len(kids), keys, None, n_leaves, n_nodes)
        elif isinstance(t, JaxNode) and t.custom:
            node = Node(CUSTOM, len(kids), t.aux, t.cls, n_leaves, n_nodes)
        elif isinstance(t, JaxNode):
            node = Node(NAMEDTUPLE, len(kids), t.cls, None, n_leaves,
                        n_nodes)
        else:
            node = Node(LIST if isinstance(t, list) else TUPLE, len(kids),
                        None, None, n_leaves, n_nodes)
        nodes.append(node)
        return n_leaves, n_nodes

    walk(tree)
    # ``walk`` holds itself through its closure: unbound here, that cycle
    # does not keep ``leaves`` (a state's tensors, on the card) alive past
    # the caller's last reference, until the collector happens to run.
    del walk
    return nodes, leaves


class _Writer(pickle._Pickler):
    """The pure-Python pickler, with a :class:`JaxClass` written as the
    global it names (``STACK_GLOBAL``, nothing imported) and the
    ``PyTreeDef`` as jaxlib writes it."""

    def save(self, obj, save_persistent_id=True):
        if isinstance(obj, (JaxClass, _TreeDef)):
            memo = self.memo.get(id(obj))
            if memo is not None:
                self.write(self.get(memo[0]))
                return
        if isinstance(obj, JaxClass):
            self.save(obj.module)
            self.save(obj.name)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
        elif isinstance(obj, _TreeDef):
            self.save(_TREEDEF)
            self.write(pickle.EMPTY_TUPLE + pickle.NEWOBJ)
            self.memoize(obj)
            self.save(obj.state)
            self.write(pickle.BUILD)
        else:
            super().save(obj, save_persistent_id)


def encode(nodes: List[Node]) -> bytes:
    """``nodes`` pickled as jaxlib pickles the ``PyTreeDef`` they
    describe (protocol 4)."""
    for i, node in enumerate(nodes):
        _check_node(tuple(node), i)
    state = (_REGISTRY, [tuple(n) for n in nodes])
    buf = io.BytesIO()
    _Writer(buf, protocol=4).dump(_TreeDef(state))
    return buf.getvalue()
