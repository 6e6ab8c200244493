"""Frames of the port's control plane, as in
``ray_lightning_tpu/cluster/rpc.py``: an ``!Q`` length header, then the
payload.

Payloads are stdlib ``pickle`` where the JAX package uses ``cloudpickle``
(the card's machine has no ``cloudpickle``).  The wire stays compatible
both ways for the frames the serving plane sends, which hold only dicts,
lists, ints, floats, strings, bytes and numpy arrays: ``cloudpickle.loads``
reads stdlib pickles, and ``pickle.loads`` reads cloudpickle's output for
such data.  Unpickle only frames of this program or of the JAX package's
plane: unpickling can run code.
"""

from __future__ import annotations

import pickle
import socket
import struct
from typing import Any

__all__ = ["FRAME_HEADER", "dumps", "loads", "send_frame", "recv_exact",
           "recv_frame", "send_obj", "recv_obj", "find_free_port"]

_LEN = struct.Struct("!Q")
# Callers that stream a frame in pieces (the queue's chunked sender) emit
# the exact header this module parses.
FRAME_HEADER = _LEN


def dumps(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def loads(data: bytes) -> Any:
    return pickle.loads(data)


def send_frame(sock: socket.socket, payload: bytes) -> None:
    # Two sendalls, not header + payload: a concatenation would copy a
    # large payload once more.
    sock.sendall(_LEN.pack(len(payload)))
    sock.sendall(payload)


def recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Exactly ``n`` bytes, read into one buffer allocated up front (a
    worker's result frame carries a whole training state)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("socket closed mid-frame")
        got += k
    return buf


def recv_frame(sock: socket.socket, max_len: int = 0) -> bytearray:
    """One frame; ``max_len`` (if nonzero) refuses a longer claim before
    allocating."""
    (length,) = _LEN.unpack(recv_exact(sock, _LEN.size))
    if max_len and length > max_len:
        raise ConnectionError(
            f"frame of {length} bytes exceeds limit {max_len}"
        )
    return recv_exact(sock, length)


def send_obj(sock: socket.socket, obj: Any) -> None:
    send_frame(sock, dumps(obj))


def recv_obj(sock: socket.socket) -> Any:
    return loads(recv_frame(sock))


def find_free_port(host: str = "") -> int:
    """A port the OS reports free (the exporter's and the queue's
    rendezvous)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        return s.getsockname()[1]
