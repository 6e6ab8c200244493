"""The pipeline plane's transfer lane, as in
``ray_lightning_tpu/mpmd/transfer.py``: activations and activation
gradients between stage workers.

Each stage process owns a :class:`StageInbox`: a
``cluster/queue.py::DriverQueue`` server whose pump thread files decoded
payloads into a keyed :class:`Mailbox` as they arrive, so micro-batch
``i+1``'s activation streams in while the stage computes on ``i``; a
``RECV`` blocks only until its key is there, and that wait is the bubble
signal.  Its neighbours send through a :class:`QueueChannel` (the queue's
chunked, size-scaled sends); same-host payloads above
``SHM_THRESHOLD_BYTES`` go through a shared-memory segment
(``cluster/shm.py``) and only its path rides the queue.
:class:`LocalChannel` delivers straight into a mailbox (the threaded
in-process pipeline).  A tensor on the card is copied to the host (a
blocking copy, finished before the bytes are encoded) before it is sent.

:class:`WireCodec` (``wire_dtype`` knob / ``RLT_MPMD_WIRE_DTYPE``,
:class:`WireDtypeConfig`) encodes a payload's float leaves host-side:
bf16 or block-scaled int8, the grad direction's int8 with a sender-side
error-feedback residual a (kind, mb, chunk, leaf) slot.  Its payloads
are byte-identical to the JAX codec's for the same numpy tree, and each
package decodes the other's.  A ``torch.bfloat16`` leaf pickles as the
JAX package's ``ml_dtypes.bfloat16`` array (without ml_dtypes:
:class:`_WirePickler`).  The JAX codec's ``np.issubdtype(…, np.floating)``
is False for ``ml_dtypes.bfloat16``, so it ships a bf16 leaf raw under
every mode and counts it at its own 2 bytes in ``bytes_full_width``;
so does this codec, with one departure: an int8 lane quantizes a bf16
leaf as it does an f32 one (a payload tagged dtype ``"bfloat16"``), so
a bf16 pipeline's wire sends about 2x fewer bytes than its f32 wire.

The tree codec of the queue plane's tensor frames (``encode_tree``,
``decode_tree``, ``resolve_payload``) serves the serving plane's
adapter and KV frames too; ``encode_tree`` writes the JAX package's
bytes for the same tree.  Decoding reads the JAX package's frames: a JAX
sender's bf16 leaf pickles as an ``ml_dtypes.bfloat16`` array, and the
card's machine has no ``ml_dtypes``: :func:`decode_tree` unpickles
through :class:`_WireUnpickler`, which stands in for that dtype and
yields the leaf's raw bytes as a ``torch.bfloat16`` tensor.  A leaf of
any other ``ml_dtypes`` type raises a :class:`ValueError` that names it.

Departure: the JAX lane's chaos point (``fault/inject``'s
``handoff_send``) is ROADMAP Queue 1 item 6, not ported.
"""

from __future__ import annotations

import dataclasses
import io
import os
import pickle
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.cluster import rpc
from ray_lightning_tpu_torch.cluster.queue import DriverQueue, QueueHandle

__all__ = ["encode_tree", "decode_tree", "resolve_payload",
           "SHM_THRESHOLD_BYTES", "Mailbox", "StageInbox", "LocalChannel",
           "QueueChannel", "WireDtypeConfig", "WireCodec"]

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
    """A codec-tagged leaf (either package's ``WireCodec``) back to an
    array of its original dtype: numpy, or a ``torch.bfloat16`` tensor
    for a port sender's int8-quantized bf16 leaf (tagged ``"bfloat16"``);
    any other leaf as it is."""
    if not (isinstance(leaf, dict) and _WIRE_TAG in leaf):
        return leaf
    mode = leaf[_WIRE_TAG]
    if mode == "int8" and leaf.get("dtype") == "bfloat16":
        deq = _dewire_leaf({**leaf, "dtype": "<f4"})
        return torch.from_numpy(np.ascontiguousarray(deq)).bfloat16()
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


# -- the lane's encoding: the JAX package's bytes ----------------------------

class _Bf16Array:
    """A bf16 array's raw bytes and shape, pickled as the JAX package's
    ``ml_dtypes.bfloat16`` numpy array (:class:`_WirePickler`)."""

    def __init__(self, t: torch.Tensor):
        t = t.detach().contiguous().cpu()
        self.shape = tuple(int(n) for n in t.shape)
        self.raw = t.view(torch.int16).numpy().tobytes()


class _Bf16Global:
    """Stands in for the global ``ml_dtypes.bfloat16`` while pickling."""


_BF16_PICKLE_DTYPE = object()  # numpy.dtype(ml_dtypes.bfloat16)
_NP_RECONSTRUCT = np.ndarray.__reduce__(np.zeros(1))[0]
# Numpy's reduce hands out one cached typecode object; shapes it makes
# anew (pickle memoizes by identity, so this keeps the bytes equal).
_TYPECODE = np.ndarray.__reduce__(np.zeros(1))[1][2]


class _WirePickler(pickle._Pickler):
    """The pure-Python pickler (protocol 5, the bytes of the C pickler the
    JAX package's ``cloudpickle`` uses for such trees), with each
    :class:`_Bf16Array` written as numpy writes an ``ml_dtypes.bfloat16``
    array: nothing of ml_dtypes imported."""

    def reducer_override(self, obj):
        if isinstance(obj, _Bf16Array):
            return (_NP_RECONSTRUCT, (np.ndarray, tuple([0]), _TYPECODE),
                    (1, tuple(obj.shape), _BF16_PICKLE_DTYPE, False,
                     obj.raw))
        if obj is _BF16_PICKLE_DTYPE:
            return (np.dtype, (_Bf16Global, False, True),
                    (3, "<", None, None, None, 2, 2, 64))
        return NotImplemented

    def save_global(self, obj, name=None):
        if obj is _Bf16Global:
            self.save("ml_dtypes")
            self.save("bfloat16")
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def _has_bf16(tree: Any) -> bool:
    if isinstance(tree, _Bf16Array):
        return True
    if isinstance(tree, dict):
        return any(_has_bf16(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_bf16(v) for v in tree)
    return False


def _wire_dumps(tree: Any) -> bytes:
    """``rpc.dumps`` of a host tree; one with a bf16 leaf through
    :class:`_WirePickler` (the same bytes for every other leaf)."""
    if not _has_bf16(tree):
        return rpc.dumps(tree)
    buf = io.BytesIO()
    _WirePickler(buf, protocol=5).dump(tree)
    return buf.getvalue()


def _tree_map_sorted(fn, tree: Any) -> Any:
    """``jax.tree_util.tree_map`` over dicts (rebuilt in sorted key
    order, as JAX rebuilds them), lists, tuples and ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map_sorted(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_sorted(fn, v) for v in tree)
    return fn(tree)


def _wire_host(leaf: Any) -> Any:
    """A leaf on the host as the JAX lane ships it: a tensor's numpy
    array (bf16 as :class:`_Bf16Array`), anything else ``np.asarray``."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return _Bf16Array(leaf)
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def encode_tree(tree: Any) -> bytes:
    """Serialize a tree of arrays as the JAX package's ``encode_tree``
    does: dicts in sorted key order, every leaf on the host (a tensor's
    numpy array, a bf16 one's as ``ml_dtypes.bfloat16``; anything else
    ``np.asarray``)."""
    return _wire_dumps(_tree_map_sorted(_wire_host, tree))


# -- quantized wire codec ----------------------------------------------------

_WIRE_DTYPES = ("f32", "bf16", "int8")


@dataclasses.dataclass(frozen=True)
class WireDtypeConfig:
    """Per-direction payload dtypes of the transfer lane (the JAX
    package's): ``act`` for forward activations, ``grad`` for activation
    gradients; ``"f32"`` full width, ``"bf16"`` rounding only, ``"int8"``
    the block-scaled codec (with error feedback on the grad direction)."""

    act: str = "f32"
    grad: str = "f32"
    block_size: int = 256

    def __post_init__(self):
        for field in ("act", "grad"):
            v = getattr(self, field)
            if v not in _WIRE_DTYPES:
                raise ValueError(
                    f"mpmd_wire_dtype {field}={v!r}: expected one of "
                    f"{_WIRE_DTYPES}"
                )
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")

    @property
    def active(self) -> bool:
        return self.act != "f32" or self.grad != "f32"

    @property
    def enc(self) -> str:
        """Compact mode string recorded on wire items and reports."""
        return f"act:{self.act},grad:{self.grad}"

    @classmethod
    def coerce(cls, value: Any) -> "WireDtypeConfig":
        """None | str | dict | WireDtypeConfig → WireDtypeConfig.
        ``None`` reads ``RLT_MPMD_WIRE_DTYPE`` (forwarded to workers),
        else f32; a bare mode applies to both directions;
        ``"act:bf16,grad:int8"`` sets them apart."""
        if isinstance(value, cls):
            return value
        if value is None:
            value = os.environ.get("RLT_MPMD_WIRE_DTYPE") or "f32"
        if isinstance(value, dict):
            kw = dict(value)
        elif isinstance(value, str):
            s = value.strip().lower()
            if not s:
                s = "f32"
            if ":" in s:
                kw = {}
                for part in s.split(","):
                    k, _, v = part.partition(":")
                    kw[k.strip()] = v.strip()
            else:
                kw = {"act": s, "grad": s}
        else:
            raise TypeError(
                f"mpmd_wire_dtype must be a mode string, dict or "
                f"WireDtypeConfig; got {type(value).__name__}"
            )
        unknown = set(kw) - {"act", "grad", "block_size"}
        if unknown:
            raise ValueError(
                f"mpmd_wire_dtype: unknown keys {sorted(unknown)} "
                "(expected act/grad/block_size)"
            )
        return cls(**kw)


def _quantize_leaf_int8(flat: np.ndarray, block: int):
    """Block-scaled int8 of a flat f32 vector → (q int8, scales f32):
    absmax/127 a block, an all-zero block's scale 1.0 (numpy on the host,
    as the JAX lane computes it)."""
    n = flat.size
    pad = (-n) % block
    if pad:
        flat = np.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scales = np.abs(blocks).max(axis=1).astype(np.float32) / 127.0
    scales[scales == 0.0] = 1.0
    q = np.clip(np.rint(blocks / scales[:, None]), -127, 127).astype(
        np.int8
    )
    return q.reshape(-1), scales


class WireCodec:
    """Sender-side payload codec and wire accounting of one channel.

    Holds the int8 grad direction's error-feedback residuals, a
    (kind, mb, chunk, leaf) slot each: schedules re-send the same slots
    every step, so each slot's compression error is added to the next
    step's payload before quantizing and telescopes.  A slot whose leaf
    changes shape starts from a zero residual.  ``bytes_full_width``:
    the f32 footprint of every float leaf plus the raw bytes of the
    others, a bf16 leaf's included (the bytes the f32 wire sends; the
    wire ratio's numerator)."""

    def __init__(self, cfg: WireDtypeConfig):
        self.cfg = cfg
        self._resid: Dict[Tuple, np.ndarray] = {}
        self.bytes_full_width = 0

    def mode_for(self, kind: str) -> str:
        return self.cfg.grad if kind == "grad" else self.cfg.act

    def encode_payload(self, kind: str, step: int, mb: int, chunk: int,
                       tree: Any) -> bytes:
        """Host-ify, wire-encode and serialize one segment payload."""
        del step  # residual slots are keyed per (mb, chunk), not step
        mode = self.mode_for(kind)
        use_ef = mode == "int8" and kind == "grad"
        counter = [0]

        def _encode(leaf):
            idx = counter[0]
            counter[0] += 1
            if isinstance(leaf, torch.Tensor) and \
                    leaf.dtype == torch.bfloat16:
                # Raw at its own width, as the JAX codec ships an
                # ml_dtypes.bfloat16 leaf; quantized on an int8 lane (the
                # module docstring's departure).
                self.bytes_full_width += leaf.numel() * 2
                if mode != "int8":
                    return _wire_host(leaf)
                flat = leaf.detach().float().cpu().numpy().reshape(-1)
                dtype_str, shape = "bfloat16", tuple(leaf.shape)
            else:
                a = _wire_host(leaf)
                if not np.issubdtype(a.dtype, np.floating):
                    self.bytes_full_width += a.nbytes
                    return a
                self.bytes_full_width += a.size * 4
                if mode == "f32":
                    return a
                if mode == "bf16":
                    data = torch.from_numpy(
                        np.ascontiguousarray(a, np.float32)).bfloat16()
                    return {_WIRE_TAG: "bf16", "data": _Bf16Array(data),
                            "dtype": a.dtype.str}
                flat = a.astype(np.float32, copy=False).reshape(-1)
                dtype_str, shape = a.dtype.str, tuple(a.shape)
            key = (kind, int(mb), int(chunk), idx)
            if use_ef:
                resid = self._resid.get(key)
                if resid is not None and resid.shape == flat.shape:
                    flat = flat + resid
            q, scales = _quantize_leaf_int8(flat, self.cfg.block_size)
            if use_ef:
                deq = (
                    q.astype(np.float32).reshape(-1, self.cfg.block_size)
                    * scales[:, None]
                ).reshape(-1)[: flat.size]
                self._resid[key] = flat - deq
            return {
                _WIRE_TAG: "int8",
                "q": q,
                "s": scales,
                "shape": shape,
                "dtype": dtype_str,
                "block": self.cfg.block_size,
            }

        return _wire_dumps(_tree_map_sorted(_encode, tree))


# -- mailbox, inbox and channels ---------------------------------------------

class Mailbox:
    """Keyed rendezvous: the pump thread ``deliver``s payloads as they
    arrive; ``recv`` blocks until its key is there and reports how long
    it waited.  ``deliver`` may file the frame's trace envelope beside the
    payload (:meth:`recv_traced` returns it)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._items: Dict[Tuple, Any] = {}      # guarded by self._cond
        self._error: Optional[BaseException] = None  # guarded by self._cond

    def deliver(self, key: Tuple, payload: Any,
                trace: Optional[Dict[str, Any]] = None) -> None:
        with self._cond:
            self._items[key] = (payload, trace)
            self._cond.notify_all()

    def fail(self, exc: BaseException) -> None:
        """Poison the mailbox: every current and future recv raises."""
        with self._cond:
            self._error = exc
            self._cond.notify_all()

    def ready(self, key: Tuple) -> bool:
        with self._cond:
            return key in self._items

    def recv(self, key: Tuple, timeout: float = 120.0) -> Tuple[Any, float]:
        """Blocking receive → ``(payload, blocked_seconds)``."""
        payload, blocked, _ = self.recv_traced(key, timeout)
        return payload, blocked

    def recv_traced(
        self, key: Tuple, timeout: float = 120.0
    ) -> Tuple[Any, float, Optional[Dict[str, Any]]]:
        """Blocking receive → ``(payload, blocked_seconds, trace)``."""
        deadline = time.monotonic() + timeout
        t0 = time.perf_counter()
        with self._cond:
            while key not in self._items:
                if self._error is not None:
                    raise RuntimeError(
                        f"transfer lane failed while waiting for {key}"
                    ) from self._error
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"transfer recv timed out after {timeout:.0f}s "
                        f"waiting for {key} (peer stage dead or wedged?)"
                    )
                self._cond.wait(min(remaining, 1.0))
            payload, trace = self._items.pop(key)
        return payload, time.perf_counter() - t0, trace


class StageInbox:
    """A stage's receive plane: a ``DriverQueue`` server and the pump
    thread that files decoded payloads into the :class:`Mailbox` (this
    thread is the comm/compute overlap)."""

    def __init__(self, host: str = "127.0.0.1",
                 advertise_host: Optional[str] = None):
        self.queue = DriverQueue(host=host, advertise_host=advertise_host)
        self.mailbox = Mailbox()
        self._closed = threading.Event()
        self._pump = threading.Thread(
            target=self._pump_loop, name="rlt-mpmd-inbox", daemon=True
        )
        self._pump.start()

    @property
    def handle(self) -> QueueHandle:
        return self.queue.handle

    def _pump_loop(self) -> None:
        import queue as _pyqueue

        while not self._closed.is_set():
            try:
                item = self.queue.get(timeout=0.2)
            except _pyqueue.Empty:
                continue
            except Exception as e:  # noqa: BLE001 - server torn down
                if not self._closed.is_set():
                    self.mailbox.fail(e)
                return
            try:
                self._file(item)
            except Exception as e:  # noqa: BLE001 - a malformed frame
                # must poison recvs loudly, not vanish in a daemon thread
                self.mailbox.fail(e)
                return

    def _file(self, item: Any) -> None:
        if not (isinstance(item, dict) and item.get("type") == "mpmd_xfer"):
            raise ValueError(f"unexpected item on stage inbox: {type(item)}")
        key = (
            item["kind"], int(item["step"]), int(item["mb"]),
            int(item.get("chunk", 0)),
        )
        self.mailbox.deliver(key, decode_tree(resolve_payload(item)),
                             trace=item.get("trace"))

    def close(self) -> None:
        self._closed.set()
        self.queue.shutdown()


def _channel_xfer_stats(channel) -> Dict[str, Any]:
    """Wire accounting view shared by both channel flavors."""
    codec: Optional[WireCodec] = channel._codec
    sent = channel.bytes_sent
    full = codec.bytes_full_width if codec is not None else sent
    return {
        "bytes_sent": sent,
        "bytes_full_width": full,
        "wire_ratio": round(full / sent, 3) if sent else None,
        "enc": codec.cfg.enc if codec is not None else "act:f32,grad:f32",
    }


def _payload(channel, kind: str, step: int, mb: int, chunk: int,
             tree: Any) -> bytes:
    if channel._codec is not None:
        return channel._codec.encode_payload(kind, step, mb, chunk, tree)
    return encode_tree(tree)


class LocalChannel:
    """In-process channel straight into a :class:`Mailbox` (the threaded
    in-process pipeline): the payload still round-trips through the
    lane's encoder and codec, so in-process runs compute what the wire
    delivers."""

    def __init__(self, mailbox: Mailbox, codec: Optional[WireCodec] = None):
        self._mailbox = mailbox
        self._codec = codec
        self.bytes_sent = 0

    def send(self, kind: str, step: int, mb: int, tree: Any,
             chunk: int = 0, trace=None) -> None:
        payload = _payload(self, kind, step, mb, chunk, tree)
        self.bytes_sent += len(payload)
        envelope: Dict[str, Any] = {}
        if trace is not None:
            from ray_lightning_tpu_torch.telemetry.propagate import inject

            inject(envelope, trace)
        self._mailbox.deliver(
            (kind, step, mb, chunk), decode_tree(payload),
            trace=envelope.get("trace"),
        )

    def xfer_stats(self) -> Dict[str, Any]:
        return _channel_xfer_stats(self)


class QueueChannel:
    """Cross-process channel to a neighbour stage's :class:`StageInbox`.
    ``same_host=True`` routes payloads of ``shm_threshold`` bytes or more
    through the segment store; the queue frame then carries the path."""

    def __init__(self, handle: QueueHandle, same_host: bool = False,
                 shm_threshold: int = SHM_THRESHOLD_BYTES,
                 codec: Optional[WireCodec] = None):
        self._handle = handle
        self._store = None
        if same_host:
            from ray_lightning_tpu_torch.cluster.shm import SegmentStore

            self._store = SegmentStore(prefix="rlt-seg")
        self._shm_threshold = shm_threshold
        self._codec = codec
        self.bytes_sent = 0
        self.shm_sends = 0

    def send(self, kind: str, step: int, mb: int, tree: Any,
             chunk: int = 0, trace=None) -> None:
        payload = _payload(self, kind, step, mb, chunk, tree)
        self.bytes_sent += len(payload)
        item: Dict[str, Any] = {
            "type": "mpmd_xfer", "kind": kind, "step": int(step),
            "mb": int(mb), "chunk": int(chunk),
        }
        if self._codec is not None:
            item["enc"] = self._codec.cfg.enc
        if trace is not None:
            from ray_lightning_tpu_torch.telemetry.propagate import inject

            inject(item, trace)
        if self._store is not None and len(payload) >= self._shm_threshold:
            item["shm"] = self._store.put(payload)
            self.shm_sends += 1
        else:
            item["data"] = payload
        self._handle.put(item)

    def xfer_stats(self) -> Dict[str, Any]:
        stats = _channel_xfer_stats(self)
        stats["shm_sends"] = self.shm_sends
        return stats

    def close(self) -> None:
        self._handle.close()
        if self._store is not None:
            self._store.unlink_all()
