"""Per-rank sharded restart checkpoints, without an all-gather and without
JAX (``ray_lightning_tpu/utils/sharded_ckpt.py``, the ``RLTSHRD2``
layout): the same bytes on disk, so a directory either package writes
loads in the other.

A checkpoint is a DIRECTORY (``<tag>/shard-00001-of-00002.ckpt`` and
``META.ckpt``):

* :func:`save_shard`: each rank writes one file of the pieces of the state
  it holds.  Each leaf is a record ``{"s": global shape, "d": dtype name,
  "e": entries}``; an entry is a block of the leaf at its global index
  ``[[start, stop], ...]``.  Under ZeRO a rank's piece of a sharded leaf
  is its slice, the contiguous run along ``ZeroPlan.dims[i]``
  (:class:`Shard`), written under its global index as JAX writes an
  array's ``addressable_shards``; a replicated leaf is one entry with the
  full index in every rank's file.  The file is ``RLTSHRD2`` + a u32
  header length + a msgpack header (each entry's index and its offset,
  length and crc32 in the data section) + the data section, so a reader
  can seek to the entries it needs.  A ``.crc32`` sidecar holds the
  file's checksum.
* :func:`save_meta` (rank 0, after a barrier): the v2 envelope
  ``{"v": 2, "crc", "body"}`` around ``{"world", "treedef", "extra",
  "shard_crcs"}``.  A directory without META is an incomplete write and
  is never resumed from.
* :func:`load_sharded`: without ``targets`` every leaf is reassembled in
  full; with ``targets`` (this rank's state in the new world's layout,
  :func:`state_tree` over the new ``ZeroPlan``) the index-selective
  reader seeks only to the entries whose recorded index overlaps this
  rank's own slice and stitches the slice together without building the
  full leaf (reshard-on-load).  :data:`LOAD_STATS` counts what it read.

The treedef is written with ``utils/treedef.encode`` under the JAX class
names, so ``pickle.loads`` in the JAX package gives its own
``TrainState``, and a JAX-written META decodes here without JAX.
``extra`` is pickled with the standard library and may hold only
builtins and numpy scalars (a torch scalar is written as a Python
number); it is read back with an unpickler that imports nothing else.
bf16 leaves are their uint16 bits viewed as ``torch.bfloat16``.

Left out: the JAX package's ``_chaos.fire("ckpt_write" | "meta_write")``
hooks, which belong to the fault plane (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.utils import treedef as td
from ray_lightning_tpu_torch.utils.msgpack_codec import packb, unpackb
from ray_lightning_tpu_torch.utils.state_stream import (
    CorruptCheckpointError, verify_stream_file,
)

__all__ = ["Shard", "state_tree", "save_shard", "save_meta", "load_sharded",
           "load_meta", "is_sharded_ckpt", "verify_sharded",
           "verify_checkpoint", "list_restart_candidates",
           "RESTART_CKPT_PREFIXES", "CorruptCheckpointError",
           "UnsupportedLeafDtypeError", "LEAF_DTYPE_CODECS", "LOAD_STATS"]


class UnsupportedLeafDtypeError(TypeError):
    """A leaf's dtype has no registered codec: raised when a leaf of it is
    saved, and at the header when one is loaded (``verify_sharded`` flags
    it, so restart discovery walks back past it)."""


_META = "META.ckpt"
_CRC_SUFFIX = ".crc32"
_SHARD_MAGIC = b"RLTSHRD2"

# The last load_sharded call's reads in this process: shard-file bytes
# read, entries read, and whether the index-selective path ran.
LOAD_STATS: Dict[str, Any] = {
    "bytes_read": 0, "entries_read": 0, "selective": False,
}

# The JAX package's closed set of leaf dtype names, each with its torch
# dtype and the numpy dtype its bytes are held in (bf16 as uint16 bits).
LEAF_DTYPE_CODECS: Dict[str, Tuple[torch.dtype, np.dtype]] = {
    name: (getattr(torch, name), np.dtype(name))
    for name in ("float16", "float32", "float64", "int8", "int16", "int32",
                 "int64", "uint8", "uint16", "uint32", "uint64", "bool")
}
LEAF_DTYPE_CODECS["bfloat16"] = (torch.bfloat16, np.dtype(np.uint16))
_NAMES = {t: name for name, (t, _) in LEAF_DTYPE_CODECS.items()}


class Shard:
    """A rank's piece of a leaf: ``data`` (a tensor of the piece's shape),
    the leaf's global ``shape`` and the piece's global ``index``, one
    ``(start, stop)`` a dim."""

    __slots__ = ("data", "shape", "index")

    def __init__(self, data: Any, shape: Sequence[int],
                 index: Sequence[Tuple[int, int]]):
        self.data = data
        self.shape = tuple(int(s) for s in shape)
        self.index = tuple((int(a), int(b)) for a, b in index)

    @classmethod
    def along(cls, data: Any, dim: int, rank: int, world: int) -> "Shard":
        """Rank ``rank``'s contiguous run along ``dim`` of a leaf cut in
        ``world`` (``data`` the run)."""
        shape = list(data.shape)
        c = shape[dim]
        shape[dim] = c * world
        index = [(0, s) for s in shape]
        index[dim] = (rank * c, (rank + 1) * c)
        return cls(data, shape, index)


def _shard_name(rank: int, world: int) -> str:
    return f"shard-{rank:05d}-of-{world:05d}.ckpt"


def _codec_name(dtype: Any) -> str:
    name = _NAMES.get(dtype) if isinstance(dtype, torch.dtype) else str(
        np.dtype(dtype))
    if name is None or name not in LEAF_DTYPE_CODECS:
        raise UnsupportedLeafDtypeError(
            f"cannot checkpoint a leaf of dtype {dtype}: no registered "
            f"codec (registered: {sorted(LEAF_DTYPE_CODECS)})")
    return name


def _dtype_of(name: str) -> Tuple[torch.dtype, np.dtype]:
    codec = LEAF_DTYPE_CODECS.get(name)
    if codec is None:
        raise UnsupportedLeafDtypeError(
            f"checkpoint leaf dtype {name!r} has no registered codec "
            f"(registered: {sorted(LEAF_DTYPE_CODECS)})")
    return codec


def _host_bytes(x: Any) -> Tuple[str, List[int], memoryview]:
    """``(dtype name, shape, C-order bytes)`` of a tensor (copied to the
    host once) or a numpy array or scalar."""
    if isinstance(x, torch.Tensor):
        name = _codec_name(x.dtype)
        t = x.detach().contiguous().cpu()
        raw = t.reshape(-1).view(torch.uint8).numpy() if t.numel() else \
            np.zeros(0, np.uint8)
        return name, list(x.shape), memoryview(raw)
    arr = np.ascontiguousarray(x)
    name = _codec_name(arr.dtype)
    return name, list(arr.shape), memoryview(arr.reshape(-1).view(np.uint8))


def _leaf_record(leaf: Any) -> Dict[str, Any]:
    """One leaf's record: a :class:`Shard` as its piece at its global
    index, anything else as one entry at the full index."""
    if leaf is None:
        return {"s": None, "d": None, "e": []}
    if isinstance(leaf, Shard):
        name, shape, raw = _host_bytes(leaf.data)
        want = [b - a for a, b in leaf.index]
        if shape != want:
            raise ValueError(f"a shard of shape {shape} at index "
                             f"{leaf.index} (size {want})")
        return {"s": list(leaf.shape), "d": name,
                "e": [{"i": [list(p) for p in leaf.index], "b": raw}]}
    name, shape, raw = _host_bytes(leaf)
    return {"s": shape, "d": name,
            "e": [{"i": [[0, s] for s in shape], "b": raw}]}


def _header_and_parts(rank: int, world: int,
                      records: List[Dict[str, Any]]
                      ) -> Tuple[bytes, List[memoryview]]:
    parts: List[memoryview] = []
    offset = 0
    leaves = []
    for rec in records:
        entries = []
        for e in rec["e"]:
            b = e["b"]
            entries.append({"i": e["i"], "o": offset, "n": b.nbytes,
                            "c": zlib.crc32(b)})
            parts.append(b)
            offset += b.nbytes
        leaves.append({"s": rec["s"], "d": rec["d"], "e": entries})
    header = bytes(packb({"rank": rank, "world": world, "leaves": leaves}))
    return (_SHARD_MAGIC + struct.pack("<I", len(header)) + header, parts)


def _encode_shard_v2(rank: int, world: int,
                     records: List[Dict[str, Any]]) -> bytes:
    """The v2 file's bytes (the JAX ``_encode_shard_v2``)."""
    records = [{**r, "e": [{**e, "b": memoryview(e["b"]).cast("B")}
                           for e in r["e"]]} for r in records]
    head, parts = _header_and_parts(rank, world, records)
    return b"".join([head, *(bytes(p) for p in parts)])


def _write_atomic(path: str, parts: Sequence[Any]) -> int:
    """``parts`` written to ``path`` through a temporary file renamed over
    it; returns their crc32."""
    tmp = f"{path}.tmp{os.getpid()}"
    crc = 0
    try:
        with open(tmp, "wb") as f:
            for p in parts:
                f.write(p)
                crc = zlib.crc32(p, crc)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except FileNotFoundError:
            pass
        raise
    return crc


def save_shard(tree: Any, dirpath: str, rank: int, world: int) -> str:
    """Write this rank's pieces of ``tree`` (a JAX-shaped tree whose
    leaves are tensors, arrays or :class:`Shard` s), atomically, and its
    ``.crc32`` sidecar, which rank 0 folds into META."""
    os.makedirs(dirpath, exist_ok=True)
    _, leaves = td.flatten(tree)
    head, parts = _header_and_parts(rank, world,
                                    [_leaf_record(x) for x in leaves])
    path = os.path.join(dirpath, _shard_name(rank, world))
    crc = _write_atomic(path, [head, *parts])
    _write_atomic(f"{path}{_CRC_SUFFIX}", [str(crc).encode()])
    return path


def _collect_shard_crcs(dirpath: str, world: int) -> Dict[str, int]:
    crcs: Dict[str, int] = {}
    for r in range(world):
        sidecar = os.path.join(dirpath, _shard_name(r, world) + _CRC_SUFFIX)
        try:
            with open(sidecar) as f:
                crcs[str(r)] = int(f.read().strip())
        except (OSError, ValueError):
            continue
    return crcs


def _plain(obj: Any, path: str = "extra") -> Any:
    """``obj`` as builtins and numpy scalars only: a 0-d torch tensor
    becomes its Python number; anything else raises."""
    if obj is None or isinstance(obj, (bool, int, float, str, bytes,
                                       np.generic)):
        return obj
    if isinstance(obj, torch.Tensor) and obj.dim() == 0:
        return obj.item()
    if isinstance(obj, dict):
        return {k: _plain(v, f"{path}[{k!r}]") for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v, f"{path}[{i}]")
                         for i, v in enumerate(obj))
    raise TypeError(
        f"{path}: a {type(obj).__name__} in a restart checkpoint's extra; "
        f"it may hold only builtins and numpy scalars (the JAX package "
        f"unpickles it)")


def save_meta(tree: Any, dirpath: str, world: int,
              extra: Optional[Dict[str, Any]] = None) -> str:
    """Rank 0's completeness marker, written after a barrier that follows
    every rank's :func:`save_shard`: ``tree``'s structure, ``extra`` and
    every shard's checksum in the self-checksummed v2 envelope."""
    nodes, _ = td.flatten(tree)
    body = packb({"world": world, "treedef": td.encode(nodes),
                  "extra": pickle.dumps(_plain(extra or {})),
                  "shard_crcs": _collect_shard_crcs(dirpath, world)})
    blob = packb({"v": 2, "crc": zlib.crc32(body), "body": bytes(body)})
    path = os.path.join(dirpath, _META)
    _write_atomic(path, [blob])
    return path


class _ExtraReader(pickle.Unpickler):
    """``extra``'s unpickler: builtins, and numpy's scalars and arrays."""

    _ALLOWED = {("numpy", "dtype"), ("numpy", "ndarray"),
                ("numpy.core.multiarray", "scalar"),
                ("numpy._core.multiarray", "scalar"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("collections", "OrderedDict"), ("_codecs", "encode"),
                ("builtins", "set"), ("builtins", "frozenset"),
                ("builtins", "complex"), ("builtins", "slice")}

    def find_class(self, module: str, name: str):
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"restart checkpoint extra: the pickled global {module}.{name} "
            f"is not one it may name (builtins and numpy scalars)")


def _loads_extra(raw: bytes) -> Dict[str, Any]:
    return _ExtraReader(io.BytesIO(bytes(raw))).load()


def _load_meta(dirpath: str) -> Dict[str, Any]:
    path = os.path.join(dirpath, _META)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise CorruptCheckpointError(f"{path}: unreadable ({e})") from e
    try:
        doc = unpackb(raw)
    except Exception as e:  # noqa: BLE001 - any parse failure = corrupt
        raise CorruptCheckpointError(f"{path}: unparsable META ({e})") from e
    if isinstance(doc, dict) and "body" in doc and "crc" in doc:
        body = doc["body"]
        actual = zlib.crc32(body)
        if actual != doc["crc"]:
            raise CorruptCheckpointError(
                f"{path}: META checksum mismatch (stored {doc['crc']:#010x}"
                f", computed {actual:#010x})")
        try:
            doc = unpackb(body)
        except Exception as e:  # noqa: BLE001
            raise CorruptCheckpointError(
                f"{path}: unparsable META body ({e})") from e
    if not isinstance(doc, dict) or "world" not in doc:
        raise CorruptCheckpointError(f"{path}: META has no world size")
    return doc


def is_sharded_ckpt(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, _META))


def load_meta(dirpath: str) -> Dict[str, Any]:
    """META alone: ``{"world": shard count, "extra": {...}}``, no shard
    file touched (an elastic resume reads the recorded ``world_size`` and
    ``accum`` here before it builds its optimizer)."""
    meta = _load_meta(dirpath)
    return {"world": meta["world"],
            "extra": _loads_extra(meta["extra"]) if "extra" in meta else {}}


def _parse_header_from_blob(raw, path: str) -> Tuple[Dict[str, Any], int]:
    """A shard blob's header, without its data: ``(header, data offset)``,
    the offset -1 for a v1 blob (its "header" is the whole payload)."""
    view = memoryview(raw).cast("B")
    if bytes(view[:len(_SHARD_MAGIC)]) == _SHARD_MAGIC:
        base = len(_SHARD_MAGIC) + 4
        if len(view) < base:
            raise CorruptCheckpointError(
                f"{path}: truncated shard header — torn write")
        (hlen,) = struct.unpack_from("<I", view, len(_SHARD_MAGIC))
        try:
            header = unpackb(view[base:base + hlen])
        except Exception as e:  # noqa: BLE001
            raise CorruptCheckpointError(
                f"{path}: unparsable shard header ({e})") from e
        return header, base + hlen
    try:
        return unpackb(view), -1
    except Exception as e:  # noqa: BLE001
        raise CorruptCheckpointError(
            f"{path}: unparsable shard file ({e})") from e


def _parse_shard_blob(raw, path: str) -> Dict[str, Any]:
    """A shard blob → the v1-shaped payload (entry bytes under ``"b"``)."""
    header, off = _parse_header_from_blob(raw, path)
    if off >= 0:
        view = memoryview(raw).cast("B")
        for rec in header["leaves"]:
            for e in rec["e"]:
                e["b"] = view[off + e["o"]:off + e["o"] + e["n"]]
    return header


def _read_shard_header(path: str, expected_crc: Optional[int] = None
                       ) -> Tuple[Dict[str, Any], int]:
    """A shard file's header without its data section: ``(header, data
    offset)``.  A v1 file is read whole (offset -1, bytes inline) and
    checked against META's whole-file checksum here."""
    with open(path, "rb") as f:
        magic = f.read(len(_SHARD_MAGIC))
        if magic == _SHARD_MAGIC:
            (hlen,) = struct.unpack("<I", f.read(4))
            try:
                header = unpackb(f.read(hlen))
            except Exception as e:  # noqa: BLE001
                raise CorruptCheckpointError(
                    f"{path}: unparsable shard header ({e})") from e
            LOAD_STATS["bytes_read"] += len(_SHARD_MAGIC) + 4 + hlen
            return header, len(_SHARD_MAGIC) + 4 + hlen
        raw = magic + f.read()
    LOAD_STATS["bytes_read"] += len(raw)
    if expected_crc is not None and zlib.crc32(raw) != expected_crc:
        raise CorruptCheckpointError(
            f"{path}: checksum mismatch — torn write or bit corruption")
    try:
        return unpackb(raw), -1
    except Exception as e:  # noqa: BLE001
        raise CorruptCheckpointError(
            f"{path}: unparsable shard file ({e})") from e


def _entry_bytes(path: str, entry: Dict[str, Any], data_offset: int,
                 fh=None) -> bytes:
    """One entry's bytes: inline (v1), or read from the data section and
    checked against the entry's own crc32."""
    if data_offset < 0:
        return entry["b"]
    if fh is None:
        with open(path, "rb") as f:
            f.seek(data_offset + entry["o"])
            b = f.read(entry["n"])
    else:
        fh.seek(data_offset + entry["o"])
        b = fh.read(entry["n"])
    LOAD_STATS["bytes_read"] += len(b)
    LOAD_STATS["entries_read"] += 1
    expected = entry.get("c")
    if len(b) != entry["n"] or (expected is not None
                                and zlib.crc32(b) != expected):
        raise CorruptCheckpointError(
            f"{path}: shard entry at offset {entry['o']} failed its crc32 "
            f"— torn write or bit corruption")
    return b


def _check_shard_identity(payload: Dict[str, Any], dirpath: str, path: str,
                          rank: int, world: int) -> None:
    if payload.get("rank") != rank or payload.get("world") != world:
        raise ValueError(
            f"sharded checkpoint {dirpath}: {os.path.basename(path)} claims "
            f"rank={payload.get('rank')} world={payload.get('world')} — "
            f"rank mixup or stale copy")


def _regions_overlap(a: tuple, b: tuple) -> bool:
    return all(max(a0, b0) < min(a1, b1)
               for (a0, a1), (b0, b1) in zip(a, b))


def _needed_region(target: Any, shape: tuple) -> tuple:
    """The global region of a leaf of ``shape`` that ``target`` holds: a
    :class:`Shard`'s index where its leaf has the recorded shape, else the
    whole leaf (a replicated leaf, or one recorded at another shape,
    such as a residual written at another world size)."""
    if isinstance(target, Shard) and target.shape == shape:
        return target.index
    return tuple((0, s) for s in shape)


_WHOLE = object()  # a recorded leaf the targets do not place: read whole


def _overlay(recorded: Any, target: Any) -> Any:
    """The checkpoint's tree (``recorded``, its leaves :data:`_WHOLE`)
    with ``target``'s leaf wherever ``target`` holds one at the same place:
    the same dict key, tuple position or node class on the way down."""
    if recorded is _WHOLE:
        leaf = not isinstance(target, (dict, tuple, list, td.JaxNode))
        return target if leaf and target is not None else _WHOLE
    if isinstance(recorded, dict):
        t = target if isinstance(target, dict) else {}
        return {k: _overlay(v, t.get(k)) for k, v in recorded.items()}
    if isinstance(recorded, (tuple, list)):
        same = (type(target) is type(recorded)
                and len(target) == len(recorded))
        kids = [_overlay(v, target[i] if same else None)
                for i, v in enumerate(recorded)]
        return kids if isinstance(recorded, list) else tuple(kids)
    if isinstance(recorded, td.JaxNode):
        same = (isinstance(target, td.JaxNode) and target.cls == recorded.cls
                and len(target.children) == len(recorded.children))
        return td.JaxNode(recorded.cls, tuple(
            _overlay(v, target.children[i] if same else None)
            for i, v in enumerate(recorded.children)),
            custom=recorded.custom, aux=recorded.aux)
    return recorded  # None


def _to_torch(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t if device is None else t.to(device)


def load_sharded(dirpath: str, targets: Any = None,
                 device: Any = None) -> Dict[str, Any]:
    """The payload ``{"state": tree, **extra}`` of a sharded checkpoint,
    its tensor leaves on ``device`` (the CPU when None).

    Without ``targets`` every leaf is reassembled in full from every
    shard file, each checked whole against META's checksum.  With
    ``targets`` (:func:`state_tree` of this rank's state over the new
    world's ``ZeroPlan``) the index-selective reader runs: this rank reads
    only the entries whose index overlaps its own region of each leaf (a
    :class:`Shard`'s index, else the whole leaf), each checked against its
    entry crc32, and a sharded leaf comes back as this rank's slice.  The
    tree comes back in the checkpoint's structure: a recorded leaf that
    ``targets`` does not hold at the same place (a residual on one side
    only, moments in another storage format) is read whole, and a leaf
    of ``targets`` the checkpoint lacks is left out."""
    meta = _load_meta(dirpath)
    world = meta["world"]
    nodes = td.decode(bytes(meta["treedef"]))
    extra = _loads_extra(meta["extra"])
    shard_crcs = meta.get("shard_crcs") or {}
    LOAD_STATS.update(bytes_read=0, entries_read=0, selective=False)
    dev = None if device is None else torch.device(device)

    shard_files = [os.path.join(dirpath, _shard_name(r, world))
                   for r in range(world)]
    missing = [p for p in shard_files if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"sharded checkpoint {dirpath} is missing {len(missing)}/{world}"
            f" shard files (e.g. {missing[0]})")

    if targets is not None:
        t_nodes, t_leaves = td.flatten(targets)
        if [tuple(n) for n in t_nodes] != [tuple(n) for n in nodes]:
            recorded = td.unflatten(nodes, [_WHOLE] * nodes[-1].num_leaves)
            t_leaves = td.flatten(_overlay(recorded, targets))[1]
        out = _load_selective(dirpath, shard_files, world, t_leaves,
                              shard_crcs, dev)
        LOAD_STATS["selective"] = True
        return {"state": td.unflatten(nodes, out), **extra}

    leaves: List[Optional[np.ndarray]] = []
    covered: List[Optional[np.ndarray]] = []
    dtypes: List[Optional[torch.dtype]] = []
    for rank, path in enumerate(shard_files):
        with open(path, "rb") as f:
            raw = f.read()
        LOAD_STATS["bytes_read"] += len(raw)
        expected = shard_crcs.get(str(rank))
        if expected is not None and zlib.crc32(raw) != expected:
            raise CorruptCheckpointError(
                f"sharded checkpoint {dirpath}: {os.path.basename(path)} "
                f"checksum mismatch — torn write or bit corruption")
        payload = _parse_shard_blob(raw, f"sharded checkpoint {dirpath}")
        _check_shard_identity(payload, dirpath, path, rank, world)
        records = payload["leaves"]
        if not leaves:
            leaves = [None] * len(records)
            covered = [None] * len(records)
            dtypes = [None] * len(records)
        for i, rec in enumerate(records):
            if rec["s"] is None:
                continue
            shape = tuple(rec["s"])
            tdt, ndt = _dtype_of(rec["d"])
            if leaves[i] is None:
                leaves[i] = np.empty(shape, ndt)
                covered[i] = np.zeros(shape, bool)
                dtypes[i] = tdt
            for entry in rec["e"]:
                idx = tuple(slice(a, b) for a, b in entry["i"])
                block = np.frombuffer(entry["b"], dtype=ndt).reshape(
                    tuple(b - a for a, b in entry["i"]))
                if idx:
                    leaves[i][idx] = block
                    covered[i][idx] = True
                else:
                    leaves[i] = block.copy()
                    covered[i] = np.ones((), bool)
    for i, mask in enumerate(covered):
        if mask is None or leaves[i] is None or leaves[i].size == 0:
            continue
        if not bool(np.all(mask)):
            holes = int(mask.size - np.count_nonzero(mask))
            raise ValueError(
                f"sharded checkpoint {dirpath}: leaf {i} has {holes}/"
                f"{mask.size} uncovered elements — shard entries are "
                f"incomplete or corrupt")
    out = [None if a is None else _to_torch(a, t, dev)
           for a, t in zip(leaves, dtypes)]
    return {"state": td.unflatten(nodes, out), **extra}


def _load_selective(dirpath: str, shard_files: List[str], world: int,
                    targets: List[Any], shard_crcs: Dict[str, int],
                    device) -> List[Any]:
    """The index-selective reader: each leaf's region (the target's) read
    from the entries that overlap it, into a buffer of the region's
    shape."""
    headers = []
    for rank, path in enumerate(shard_files):
        header, off = _read_shard_header(path, shard_crcs.get(str(rank)))
        _check_shard_identity(header, dirpath, path, rank, world)
        headers.append((header, off))
    first = headers[0][0]["leaves"]
    if len(first) != len(targets):
        raise ValueError(
            f"sharded checkpoint {dirpath}: {len(first)} leaves recorded, "
            f"{len(targets)} in the target tree")
    regions: List[Optional[tuple]] = []
    bufs: List[Optional[np.ndarray]] = []
    masks: List[Optional[np.ndarray]] = []
    dtypes: List[Any] = []
    for rec, target in zip(first, targets):
        if rec["s"] is None:
            regions.append(None)
            bufs.append(None)
            masks.append(None)
            dtypes.append(None)
            continue
        shape = tuple(rec["s"])
        tdt, ndt = _dtype_of(rec["d"])
        region = _needed_region(target, shape)
        box = tuple(b - a for a, b in region)
        regions.append(region)
        bufs.append(np.empty(box, ndt))
        masks.append(np.zeros(box, bool))
        dtypes.append((tdt, ndt))

    seen: List[set] = [set() for _ in targets]
    for rank, (header, off) in enumerate(headers):
        path = shard_files[rank]
        fh = open(path, "rb") if off >= 0 else None
        try:
            for i, rec in enumerate(header["leaves"]):
                region = regions[i]
                if region is None or rec["s"] is None:
                    continue
                for entry in rec["e"]:
                    eidx = tuple((a, b) for a, b in entry["i"])
                    if eidx in seen[i]:
                        continue  # a replica already read
                    if not region:  # 0-d: any entry is the value
                        seen[i].add(eidx)
                        b = _entry_bytes(path, entry, off, fh)
                        bufs[i] = np.frombuffer(
                            b, dtype=dtypes[i][1]).reshape(()).copy()
                        masks[i] = np.ones((), bool)
                        continue
                    if not _regions_overlap(eidx, region):
                        continue
                    seen[i].add(eidx)
                    b = _entry_bytes(path, entry, off, fh)
                    block = np.frombuffer(b, dtype=dtypes[i][1]).reshape(
                        tuple(b1 - a1 for a1, b1 in eidx))
                    dst = tuple(slice(max(a1, lo) - lo, min(b1, hi) - lo)
                                for (a1, b1), (lo, hi) in zip(eidx, region))
                    src = tuple(slice(max(a1, lo) - a1, min(b1, hi) - a1)
                                for (a1, b1), (lo, hi) in zip(eidx, region))
                    bufs[i][dst] = block[src]
                    masks[i][dst] = True
        finally:
            if fh is not None:
                fh.close()
    for i, region in enumerate(regions):
        if region is not None and not bool(np.all(masks[i])):
            raise ValueError(
                f"sharded checkpoint {dirpath}: leaf {i} region {region} is "
                f"not fully covered by any shard — entries are incomplete "
                f"or corrupt")
    return [None if r is None else _to_torch(b, d[0], device)
            for r, b, d in zip(regions, bufs, dtypes)]


def verify_sharded(dirpath: str) -> List[str]:
    """A sharded checkpoint's integrity problems (empty = valid): META's
    parse and self-checksum, every shard present and matching its
    recorded checksum, no shard file of another world size, every leaf
    dtype registered.  Deserializes no leaf."""
    try:
        meta = _load_meta(dirpath)
    except CorruptCheckpointError as e:
        return [str(e)]
    world = meta["world"]
    shard_crcs = meta.get("shard_crcs") or {}
    problems: List[str] = []
    try:
        names = [n for n in os.listdir(dirpath)
                 if n.startswith("shard-") and n.endswith(".ckpt")]
    except OSError as e:
        return [f"{dirpath}: unreadable ({e})"]
    for name in sorted(names):
        try:
            claimed = int(name.split("-of-")[1].split(".")[0])
        except (IndexError, ValueError):
            problems.append(f"{dirpath}/{name}: unparsable shard name")
            continue
        if claimed != world:
            problems.append(
                f"{dirpath}/{name}: shard written for world size {claimed} "
                f"but META records {world} — stale copy or mixed-topology "
                f"write")
    for r in range(world):
        path = os.path.join(dirpath, _shard_name(r, world))
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            problems.append(f"{path}: unreadable ({e})")
            continue
        expected = shard_crcs.get(str(r))
        if expected is not None and zlib.crc32(raw) != expected:
            problems.append(f"{path}: checksum mismatch — torn write or bit "
                            f"corruption")
            continue
        if raw[:len(_SHARD_MAGIC)] != _SHARD_MAGIC:
            continue
        try:
            header, _ = _parse_header_from_blob(raw, path)
        except CorruptCheckpointError as e:
            problems.append(str(e))
            continue
        records = header.get("leaves", []) if isinstance(header, dict) \
            else []
        unknown = sorted({rec["d"] for rec in records
                          if isinstance(rec, dict) and rec.get("d") is not None
                          and rec["d"] not in LEAF_DTYPE_CODECS})
        if unknown:
            problems.append(
                f"{path}: leaf dtypes {unknown} have no registered codec "
                f"(newer writer?) — this checkpoint cannot be loaded by "
                f"this build")
    return problems


def verify_checkpoint(path: str) -> List[str]:
    """The integrity problems of any checkpoint, a sharded directory or an
    ``RLTCKPT1`` file (empty = valid)."""
    if os.path.isdir(path):
        if not os.path.exists(os.path.join(path, _META)):
            return [f"{path}: incomplete sharded checkpoint (no META)"]
        return verify_sharded(path)
    if os.path.isfile(path):
        return verify_stream_file(path)
    return [f"{path}: no such checkpoint"]


RESTART_CKPT_PREFIXES = ("restart-epoch-", "drain-step-")


def list_restart_candidates(restart_dir: str) -> List[tuple]:
    """The complete restart and drain checkpoints in ``restart_dir``,
    newest first, as ``(mtime, drain rank, name, path)``: ordered by
    completion time (META's for a directory), a drain checkpoint above an
    epoch one at equal time, then by name.  Restart discovery and pruning
    share it."""
    entries = []
    try:
        names = os.listdir(restart_dir)
    except OSError:
        return []
    for name in names:
        if not (name.endswith(".ckpt")
                and name.startswith(RESTART_CKPT_PREFIXES)):
            continue
        path = os.path.join(restart_dir, name)
        if os.path.isdir(path):
            meta = os.path.join(path, _META)
            if not os.path.exists(meta):
                continue
            mtime = os.path.getmtime(meta)
        elif os.path.isfile(path):
            mtime = os.path.getmtime(path)
        else:
            continue
        entries.append((mtime, 1 if name.startswith("drain-step-") else 0,
                        name, path))
    return sorted(entries, reverse=True)


def state_tree(state: Any, plan: Any = None, rank: int = 0, world: int = 1,
               residual: Any = None) -> td.JaxNode:
    """A port ``TrainState`` as the JAX ``TrainState`` tree a rank writes
    (and, as ``targets``, reads): under a ZeRO plan (``plan``, this
    world's) each sharded leaf of the params (stage 3) and of the
    optimizer state as this rank's :class:`Shard`; the error-feedback
    residual (``residual``, this rank's row of ``total_padded``) as row
    ``rank`` of the ``(world, total_padded)`` leaf JAX keeps, index
    ``((rank, rank + 1), (0, total_padded))``."""
    from ray_lightning_tpu_torch.core.module import TrainState
    from ray_lightning_tpu_torch.models.convert import train_state_to_jax
    from ray_lightning_tpu_torch.models.optim import (
        tree_leaves, tree_unflatten,
    )

    params, opt = state.params, state.opt_state
    if plan is not None:
        if plan.stage == 3:
            params = tree_unflatten(params, [
                t if d is None else Shard.along(t, d, rank, world)
                for t, d in zip(tree_leaves(params), plan.dims)])
        opt = tree_unflatten(opt, [
            t if d is None else Shard.along(t, d, rank, world)
            for t, d in zip(tree_leaves(opt),
                            plan.opt_dims(opt, sharded=True))])
    node = train_state_to_jax(TrainState(params, opt, state.step))
    if residual is not None:
        n = residual.numel()
        row = Shard(residual.reshape(1, n), (world, n),
                    ((rank, rank + 1), (0, n)))
        node = td.JaxNode(node.cls, node.children[:3] + (row,), custom=True,
                          aux=node.aux)
    return node
