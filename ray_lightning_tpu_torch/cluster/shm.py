"""Same-host payload segments on tmpfs, as in
``ray_lightning_tpu/cluster/shm.py``: a producer writes a payload once
to a checksummed file and ships only its path.

The file is the JAX package's segment format (``ray_lightning_tpu/
native``), written here in Python: a 32-byte little-endian header (magic
``RLTSEG1\\0``, payload length, checksum, checksum algorithm) and the
payload.  The port writes zlib CRC32 (algorithm 2, what the JAX package
writes without its native library) and reads both algorithms, CRC32C
(algorithm 1, the JAX package's native writes) through a table in
Python, so either package reads the other's segments.
"""

from __future__ import annotations

import atexit
import os
import re
import struct
import tempfile
import threading
import uuid
import zlib
from typing import List

__all__ = ["SegmentError", "SegmentStore", "segment_dir",
           "sweep_stale_segments", "write_segment", "read_segment",
           "ALL_PREFIXES"]

_MAGIC = b"RLTSEG1\0"
_HEADER = struct.Struct("<8sQII8x")
_ALGO_CRC32C = 1
_ALGO_ZLIB = 2
_NAME_RE = re.compile(r"^(?P<prefix>.+)-(?P<pid>\d+)-[0-9a-f]{32}$")

# Every segment family of the queue plane: MPMD activation transfers
# ("rlt-seg") and the serving plane's KV handoffs ("rlt-kv").
ALL_PREFIXES = ("rlt-seg", "rlt-kv")


class SegmentError(RuntimeError):
    """Corrupt, truncated or missing payload segment."""


_crc32c_table: List[int] = []


def _crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli, reflected 0x82F63B78), as the JAX package's
    native library computes it."""
    if not _crc32c_table:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
            _crc32c_table.append(c)
    table = _crc32c_table
    c = 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ table[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def write_segment(path: str, payload: bytes) -> None:
    """Create ``path`` (fails if it exists) holding ``payload``."""
    header = _HEADER.pack(_MAGIC, len(payload),
                          zlib.crc32(payload) & 0xFFFFFFFF, _ALGO_ZLIB)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    try:
        for buf in (header, payload):
            view = memoryview(buf)
            while view:  # os.write may be partial
                view = view[os.write(fd, view):]
    finally:
        os.close(fd)


def read_segment(path: str, verify: bool = True) -> bytes:
    """The payload of a segment, its checksum verified."""
    file_len = os.stat(path).st_size
    with open(path, "rb") as f:
        raw = f.read(_HEADER.size)
        if len(raw) < _HEADER.size:
            raise SegmentError(f"segment {path!r}: truncated header")
        magic, length, checksum, algo = _HEADER.unpack(raw)
        if magic != _MAGIC:
            raise SegmentError(f"segment {path!r}: bad magic")
        if length > file_len - _HEADER.size:
            raise SegmentError(
                f"segment {path!r}: header claims {length} payload bytes "
                f"but the file holds {file_len - _HEADER.size}"
            )
        payload = f.read(length)
    if verify:
        if algo == _ALGO_ZLIB:
            ok = (zlib.crc32(payload) & 0xFFFFFFFF) == checksum
        elif algo == _ALGO_CRC32C:
            ok = _crc32c(payload) == checksum
        else:
            raise SegmentError(
                f"segment {path!r}: unknown checksum algorithm {algo}")
        if not ok:
            raise SegmentError(f"segment {path!r}: checksum mismatch")
    return payload


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    return True


def segment_dir() -> str:
    """tmpfs where there is one (``/dev/shm``), else the temp dir."""
    base = "/dev/shm"
    if not os.path.isdir(base) or not os.access(base, os.W_OK):
        base = tempfile.gettempdir()
    return base


def sweep_stale_segments(prefix="rlt-seg") -> int:
    """Unlink the segments of ``prefix`` (a name or a tuple of them)
    whose owner pid is gone: tmpfs is memory, and a killed producer's
    segments would stay until reboot.  Returns the count removed."""
    prefixes = (prefix,) if isinstance(prefix, str) else tuple(prefix)
    removed = 0
    try:
        entries = os.listdir(segment_dir())
    except OSError:
        return 0
    for entry in entries:
        m = _NAME_RE.match(entry)
        if not m or m.group("prefix") not in prefixes:
            continue
        if _pid_alive(int(m.group("pid"))):
            continue
        try:
            os.unlink(os.path.join(segment_dir(), entry))
            removed += 1
        except OSError:
            pass
    return removed


class SegmentStore:
    """The segments one producer owns; it unlinks what is left of them
    at :meth:`unlink_all` or interpreter exit."""

    def __init__(self, prefix: str = "rlt-seg"):
        self._prefix = prefix
        self._dir = segment_dir()
        self._paths: List[str] = []
        self._lock = threading.Lock()
        sweep_stale_segments(prefix)
        atexit.register(self.unlink_all)

    def put(self, payload: bytes) -> str:
        path = os.path.join(
            self._dir, f"{self._prefix}-{os.getpid()}-{uuid.uuid4().hex}"
        )
        write_segment(path, payload)
        with self._lock:
            self._paths.append(path)
        return path

    @staticmethod
    def get(path: str, verify: bool = True) -> bytes:
        return read_segment(path, verify=verify)

    def unlink_all(self) -> None:
        with self._lock:
            paths, self._paths = self._paths, []
        for p in paths:
            try:
                os.unlink(p)
            except OSError:
                pass
