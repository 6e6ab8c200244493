"""State streams and ``RLTCKPT1`` checkpoint files, without JAX.

The port of ``ray_lightning_tpu/utils/state_stream.py``: the same bytes
on disk, so a checkpoint written by either package loads in the other.
A stream is a msgpack map ``{"treedef": pickled PyTreeDef, "leaves":
[...]}``; each leaf is ``{"k": 0, "d": dtype name, "s": shape, "b": raw
C-order bytes}`` (an array; bf16 named ``"bfloat16"``), ``{"k": 1, "v":
scalar}``, ``{"k": 2}`` or ``{"k": 3, "v": str}``.  A file is
``RLTCKPT1`` + the crc32 of the stream (little-endian) + the stream; an
unframed legacy file is read as the bare stream.

Without ``msgpack``, ``ml_dtypes`` or ``pickle.loads``: the msgpack
codec is ``utils/msgpack_codec.py`` and the treedef
``utils/treedef.py`` (an unpickler that imports nothing and refuses
every global off its allow-list).  Leaves load as torch tensors.  A
tensor leaf is copied once, from its device straight into its slice of
the stream's one buffer; reading, each leaf is one copy out of the file's
buffer (onto ``device`` when given).

Left out: the JAX package's ``_chaos.fire("ckpt_write")`` hook after a
file write, which belongs to the fault plane (a later slice of the port).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Any, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.utils import treedef as td
from ray_lightning_tpu_torch.utils.msgpack_codec import (
    RawBin, Unpacker, packb,
)

__all__ = ["CorruptCheckpointError", "tree_to_bytes", "tree_from_bytes",
           "to_state_stream", "load_state_stream", "state_stream_to_file",
           "state_stream_from_file", "verify_stream_file"]


class CorruptCheckpointError(RuntimeError):
    """A checkpoint failed its integrity check (crc mismatch, torn
    frame, unparsable body)."""


_FILE_MAGIC = b"RLTCKPT1"
_HEADER = len(_FILE_MAGIC) + 4

_KIND_ARRAY = 0
_KIND_SCALAR = 1
_KIND_NONE = 2
_KIND_STRING = 3

# numpy's dtype names (as ``str(arr.dtype)`` writes them) and torch's.
_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _unframe(data, where: str = "stream") -> memoryview:
    """The stream inside a file's bytes, its crc checked; unframed
    (legacy) bytes pass through.  No copy."""
    view = memoryview(data).cast("B")
    if view[:len(_FILE_MAGIC)] != _FILE_MAGIC:
        return view
    if len(view) < _HEADER:
        raise CorruptCheckpointError(
            f"{where}: truncated checkpoint frame ({len(view)} bytes)")
    (expected,) = struct.unpack_from("<I", view, len(_FILE_MAGIC))
    body = view[_HEADER:]
    actual = zlib.crc32(body)
    if actual != expected:
        raise CorruptCheckpointError(
            f"{where}: checksum mismatch (stored {expected:#010x}, "
            f"computed {actual:#010x}) — torn write or bit corruption")
    return body


def _array_msg(leaf: Any) -> dict:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = _NAMES.get(t.dtype)
        if name is None:
            raise TypeError(f"state stream: no name for dtype {t.dtype}")
        shape = list(t.shape)

        def fill(dst: memoryview, t=t) -> None:
            # One copy, from the tensor's device into the stream.
            out = torch.frombuffer(dst, dtype=torch.uint8)
            out.copy_(t.contiguous().reshape(-1).view(torch.uint8))

        nbytes = t.numel() * t.element_size()
    else:
        arr = np.ascontiguousarray(leaf)
        name, shape = str(arr.dtype), list(arr.shape)

        def fill(dst: memoryview, arr=arr) -> None:
            dst[:] = arr.reshape(-1).view(np.uint8)

        nbytes = arr.nbytes
    return {"k": _KIND_ARRAY, "d": name, "s": shape,
            "b": RawBin(nbytes, fill) if nbytes else b""}


def _leaf_to_msg(leaf: Any) -> dict:
    if leaf is None:
        return {"k": _KIND_NONE}
    if isinstance(leaf, str):
        return {"k": _KIND_STRING, "v": leaf}
    if isinstance(leaf, (int, float, bool)):
        return {"k": _KIND_SCALAR, "v": leaf}
    return _array_msg(leaf)


def _leaf_from_msg(msg: dict, device: Optional[torch.device]) -> Any:
    kind = msg["k"]
    if kind == _KIND_NONE:
        return None
    if kind in (_KIND_SCALAR, _KIND_STRING):
        return msg["v"]
    dtype = _DTYPES.get(msg["d"])
    if dtype is None:
        raise TypeError(f"state stream: leaf dtype {msg['d']!r} is not one "
                        f"the port reads ({sorted(_DTYPES)})")
    shape = tuple(msg["s"])
    raw = msg["b"]
    n = len(raw)
    if n != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
        raise CorruptCheckpointError(
            f"state stream: a {msg['d']} leaf of shape {shape} holds {n} "
            f"bytes")
    if n == 0:
        return torch.empty(shape, dtype=dtype, device=device)
    src = torch.frombuffer(bytearray(raw) if raw.readonly else raw,
                           dtype=torch.uint8)
    # The copy (onto the card, or a fresh aligned host buffer) is what
    # lets the bytes be viewed as the dtype.
    on_card = device is not None and device.type != "cpu"
    out = src.to(device) if on_card else src.clone()
    return out.view(dtype).reshape(shape)


def tree_to_bytes(tree: Any) -> bytearray:
    """A tree (dicts, tuples, lists, ``None``, ``treedef.JaxNode``; tensor,
    numpy or scalar leaves) as a state stream (one ``bytearray``)."""
    nodes, leaves = td.flatten(tree)
    return packb({"treedef": td.encode(nodes),
                  "leaves": [_leaf_to_msg(x) for x in leaves]})


def tree_from_bytes(data, device=None) -> Any:
    """Inverse of :func:`tree_to_bytes`; takes a bare stream or a framed
    file's bytes.  Array leaves become torch tensors on ``device`` (the
    CPU when ``None``)."""
    dev = None if device is None else torch.device(device)
    payload = Unpacker(_unframe(data), bin=lambda v: v).load()
    nodes = td.decode(bytes(payload["treedef"]))
    return td.unflatten(nodes, [_leaf_from_msg(m, dev)
                                for m in payload["leaves"]])


def to_state_stream(state: Any) -> bytearray:
    """A state (params, optimizer state, counters) as stream bytes."""
    return tree_to_bytes(state)


def load_state_stream(stream, device=None) -> Any:
    """Stream bytes → tree, its tensors on ``device`` (the CPU when
    ``None``)."""
    return tree_from_bytes(stream, device)


def state_stream_to_file(stream, path: str) -> None:
    """Write ``stream`` framed (magic + crc32) to ``path``, atomically: a
    temporary file renamed over ``path`` once written, so a writer killed
    mid-write never leaves a torn file where a resume would find it."""
    view = memoryview(stream).cast("B")
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(_FILE_MAGIC + struct.pack("<I", zlib.crc32(view)))
            f.write(view)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except FileNotFoundError:
            pass
        raise


def _read(path: str) -> bytearray:
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        n = f.readinto(buf)
    del buf[n:]
    return buf


def state_stream_from_file(path: str) -> memoryview:
    """The stream of a checkpoint file, its crc checked."""
    return _unframe(_read(path), where=path)


def verify_stream_file(path: str) -> list:
    """Integrity problems of a checkpoint file (empty = valid): framed
    files by their crc, legacy unframed files by a full parse."""
    try:
        data = _read(path)
    except OSError as e:
        return [f"{path}: unreadable ({e})"]
    try:
        body = _unframe(data, where=path)
        if body.nbytes == len(data):
            Unpacker(body, bin=lambda v: v).load()
    except CorruptCheckpointError as e:
        return [str(e)]
    except Exception as e:  # noqa: BLE001 - any parse failure = corrupt
        return [f"{path}: unparsable checkpoint ({e})"]
    return []
