"""The tree codec of the queue plane's tensor frames, as in
``ray_lightning_tpu/mpmd/transfer.py`` (``encode_tree``, ``decode_tree``,
``resolve_payload``): a tree of arrays pickled with its leaves on the
host as numpy arrays, and the ``data``/``shm`` pair every tensor frame
carries its payload in.  ``WireCodec``, ``Mailbox`` and the channels wait
for the pipeline slice.

Decoding reads the JAX package's frames too.  A JAX sender's bf16 leaf
pickles as an ``ml_dtypes.bfloat16`` array, and the card's machine has
no ``ml_dtypes``: :func:`decode_tree` unpickles through
:class:`_WireUnpickler`, which stands in for that dtype and yields the
leaf's raw bytes as a ``torch.bfloat16`` tensor.  A leaf of any other
``ml_dtypes`` type raises a :class:`ValueError` that names it.
"""

from __future__ import annotations

import io
import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

from ray_lightning_tpu_torch.cluster import rpc

__all__ = ["encode_tree", "decode_tree", "resolve_payload",
           "SHM_THRESHOLD_BYTES"]

# Same-host payloads above this ride tmpfs segments rather than the TCP
# loopback.
SHM_THRESHOLD_BYTES = 256 << 10

_WIRE_TAG = "__wire__"


def _map_tree(fn, tree: Any, is_leaf=None) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v, is_leaf) for v in tree)
    return fn(tree)


def _host(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise ValueError(
                "a torch.bfloat16 leaf has no numpy dtype: cast it to "
                "float32 before encoding"
            )
        return leaf.detach().cpu().numpy()
    return leaf


def encode_tree(tree: Any) -> bytes:
    """Serialize a tree of arrays with every torch tensor moved to the
    host as a numpy array."""
    return rpc.dumps(_map_tree(_host, tree))


# -- decoding: the JAX package's bf16 leaves without ml_dtypes ---------------

class _Bf16Type:
    """Stands in for the ``ml_dtypes.bfloat16`` scalar type."""


class _Bf16Dtype:
    """What ``numpy.dtype(bfloat16)`` unpickles to here."""

    def __setstate__(self, state):
        pass  # byte order and sizes of a 2-byte little-endian type


_BF16_DTYPE = _Bf16Dtype()


def _bf16_tensor(raw, shape) -> torch.Tensor:
    """Little-endian bf16 bytes as a ``torch.bfloat16`` tensor."""
    u16 = np.frombuffer(bytes(raw), dtype="<u2").astype(np.int16)
    return torch.from_numpy(u16.copy()).view(torch.bfloat16).reshape(
        tuple(int(s) for s in shape))


def _dtype(obj, *args):
    if obj is _Bf16Type:
        return _BF16_DTYPE
    return np.dtype(obj, *args)


class _ArrayStandIn:
    """An array while it unpickles: its dtype is known only at its
    state, so the value is made there and resolved after the load."""

    value: Any = None

    def __setstate__(self, state):
        _, shape, dtype, fortran, raw = state
        if dtype is _BF16_DTYPE:
            if fortran:
                self.value = _bf16_tensor(raw, tuple(shape)[::-1]).permute(
                    *reversed(range(len(shape))))
            else:
                self.value = _bf16_tensor(raw, shape)
            return
        arr = np.ndarray.__new__(np.ndarray, (0,), np.uint8)
        arr.__setstate__(state)
        self.value = arr


def _reconstruct(cls, shape, typecode):
    return _ArrayStandIn()


def _scalar(dtype, raw=None):
    if dtype is _BF16_DTYPE:
        return _bf16_tensor(raw, ())
    return np.frombuffer(raw, dtype=dtype)[0] if raw is not None \
        else dtype.type()


def _frombuffer(buf, dtype, shape, order):
    if dtype is _BF16_DTYPE:
        t = _bf16_tensor(buf, shape if order == "C" else tuple(shape)[::-1])
        return t if order == "C" else t.permute(*reversed(range(len(shape))))
    return np.frombuffer(buf, dtype=dtype).reshape(shape, order=order)


_NUMPY_CORE = ("numpy.core.multiarray", "numpy._core.multiarray")
_NUMPY_NUMERIC = ("numpy.core.numeric", "numpy._core.numeric")


class _WireUnpickler(pickle.Unpickler):
    """The stdlib unpickler with numpy's array and dtype constructors
    replaced by versions that accept the bf16 stand-in."""

    def find_class(self, module, name):
        if module.split(".")[0] == "ml_dtypes":
            if name == "bfloat16":
                return _Bf16Type
            raise ValueError(
                f"wire leaf of dtype ml_dtypes.{name} is not supported "
                f"(only bfloat16 decodes without ml_dtypes)"
            )
        if module == "numpy" and name == "dtype":
            return _dtype
        if module in _NUMPY_CORE and name == "_reconstruct":
            return _reconstruct
        if module in _NUMPY_CORE and name == "scalar":
            return _scalar
        if module in _NUMPY_NUMERIC and name == "_frombuffer":
            return _frombuffer
        return super().find_class(module, name)


def _resolve(tree: Any) -> Any:
    return _map_tree(
        lambda x: x.value if isinstance(x, _ArrayStandIn) else x, tree)


def _wire_loads(payload: bytes) -> Any:
    return _resolve(_WireUnpickler(io.BytesIO(payload)).load())


def _dewire_leaf(leaf: Any) -> Any:
    """A codec-tagged leaf of the JAX package's ``WireCodec`` back to a
    numpy array of its original dtype; any other leaf as it is."""
    if not (isinstance(leaf, dict) and _WIRE_TAG in leaf):
        return leaf
    mode = leaf[_WIRE_TAG]
    if mode == "bf16":
        data = leaf["data"]
        if isinstance(data, torch.Tensor):
            data = data.float().numpy()
        return np.asarray(data).astype(leaf["dtype"])
    if mode == "int8":
        block = int(leaf["block"])
        q = np.asarray(leaf["q"], np.float32).reshape(-1, block)
        deq = (q * np.asarray(leaf["s"], np.float32)[:, None]).reshape(-1)
        shape = tuple(leaf["shape"])
        n = int(np.prod(shape)) if shape else 1
        return deq[:n].reshape(shape).astype(leaf["dtype"])
    raise ValueError(f"unknown wire codec tag {mode!r}")


def _dewire_tree(tree: Any) -> Any:
    return _map_tree(
        _dewire_leaf, tree,
        is_leaf=lambda x: isinstance(x, dict) and _WIRE_TAG in x,
    )


def decode_tree(payload: bytes) -> Any:
    """Deserialize a wire payload (either package's), dequantizing any
    codec-tagged leaves."""
    return _dewire_tree(_wire_loads(payload))


def resolve_payload(item: Dict[str, Any], unlink: bool = True) -> bytes:
    """The payload bytes of a ``data``/``shm`` wire item.  A segment is
    read once and unlinked here (the consumer owns it); the producer's
    teardown sweep collects segments no consumer read."""
    shm_path = item.get("shm")
    if shm_path is None:
        return item["data"]
    from ray_lightning_tpu_torch.cluster.shm import SegmentStore

    payload = SegmentStore.get(shm_path)
    if unlink:
        try:
            os.unlink(shm_path)
        except OSError:
            pass
    return payload
