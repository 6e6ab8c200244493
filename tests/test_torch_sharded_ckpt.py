"""The port's ``RLTSHRD2`` sharded restart checkpoints
(``ray_lightning_tpu_torch/utils/sharded_ckpt.py``) held against the JAX
package's ``utils/sharded_ckpt.py``, in one process.

The states are the GPT family's ``TrainState`` at ``GPTConfig.tiny()``
(f32 params, bf16 first moments, f32 second moments, int32 counts; and
int8 block-scaled moments), cut over two ranks by the ZeRO-3 leaf rule
(``parallel/sharding.py::ZeroPlan``).  The JAX package cannot write a
two-host directory from one process, so its writer is handed two fake
per-rank views of each leaf (the pieces a rank holds, as
``tests/test_sharded_ckpt.py`` builds them); the port writes the same
ranks through ``state_tree``.  Every comparison is bitwise: the shard
files byte for byte, each leaf either package reads, the selective
reader's accounting.
"""

import dataclasses
import os
import time
import zlib

import jax
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.module import TrainState as JaxTrainState
from ray_lightning_tpu.parallel import strategies as jax_strategies
from ray_lightning_tpu.utils import sharded_ckpt as jsc
from ray_lightning_tpu.utils import state_stream as jss
from ray_lightning_tpu_torch.core.module import TrainState
from ray_lightning_tpu_torch.models.convert import (
    train_state_from_jax, train_state_to_jax,
)
from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
from ray_lightning_tpu_torch.models.optim import tree_map
from ray_lightning_tpu_torch.parallel import sharding
from ray_lightning_tpu_torch.parallel import strategies as port_strategies
from ray_lightning_tpu_torch.utils import sharded_ckpt as sc
from ray_lightning_tpu_torch.utils import state_stream as ss
from ray_lightning_tpu_torch.utils import treedef as td

EXTRA = {"epoch": 1, "global_step": 6, "micro_step": 6, "world_size": 2,
         "accum": 1, "callback_metrics": {"train_loss": 5.25},
         "callback_states": [{"epochs": [0, 1]}, {"best_model_path": "",
                                                  "best_model_score": None}]}


def _port_state(opt_state_dtype=None, seed=0):
    """A tiny GPT's state after one nonzero update of its moments."""
    cfg = dataclasses.replace(GPTConfig.tiny(),
                              opt_state_dtype=opt_state_dtype)
    m = GPT(cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    params = m.init_params(gen)
    tx = m.configure_optimizers()
    grads = tree_map(lambda v: torch.randn(v.shape, generator=gen) * 1e-2,
                     params)
    state = TrainState.create(params, tx)
    return state.apply_gradients(grads, tx)


def _jax_state(state):
    """The same state as the JAX package's ``TrainState`` (numpy leaves,
    bf16 as ``ml_dtypes``), through the state stream both packages read."""
    return jss.load_state_stream(bytes(ss.to_state_stream(
        train_state_to_jax(state))))


def _rank_trees(state, world, zero):
    """Each rank's ``state_tree``: its ZeRO-3 slices, or (``zero``
    False) the whole state replicated."""
    trees = []
    for r in range(world):
        if not zero:
            trees.append(sc.state_tree(state))
            continue
        plan = sharding.ZeroPlan(state.params, 3, r, world)
        mine = TrainState(plan.shard_tree(state.params, own=True),
                          plan.shard_opt_state(state.opt_state), state.step)
        trees.append(sc.state_tree(mine, plan, r, world))
    return trees


def _port_write(tag, trees, extra=EXTRA):
    world = len(trees)
    for r, tree in enumerate(trees):
        sc.save_shard(tree, tag, r, world)
    sc.save_meta(trees[0], tag, world, extra=extra)


class _Pieces:
    """A JAX leaf as one rank holds it: its pieces at their global
    indices (what ``addressable_shards`` gives on a host)."""

    def __init__(self, shape, dtype, pieces):
        self.shape, self.dtype, self.pieces = shape, dtype, pieces


def _jax_write(tag, state, trees, monkeypatch, extra=EXTRA):
    """The JAX package's writer, each rank handed the pieces the port's
    ``state_tree`` says it holds (the leaves of ``state``, the JAX tree,
    cut at those indices)."""
    full = jax.tree_util.tree_leaves(state)
    orig = jsc._leaf_record

    def record(leaf):
        if not isinstance(leaf, _Pieces):
            return orig(leaf)
        return {"s": list(leaf.shape), "d": str(leaf.dtype),
                "e": [{"i": [list(p) for p in idx], "b": data.tobytes()}
                      for idx, data in leaf.pieces]}

    monkeypatch.setattr(jsc, "_leaf_record", record)
    world = len(trees)
    treedef = jax.tree_util.tree_structure(state)
    for r, tree in enumerate(trees):
        views = []
        for arr, mine in zip(full, td.flatten(tree)[1]):
            arr = np.asarray(arr)
            idx = (mine.index if isinstance(mine, sc.Shard)
                   else tuple((0, s) for s in arr.shape))
            views.append(_Pieces(arr.shape, arr.dtype, [
                (idx, np.ascontiguousarray(
                    arr[tuple(slice(a, b) for a, b in idx)]))]))
        jsc.save_shard(jax.tree_util.tree_unflatten(treedef, views), tag, r,
                       world)
    jsc.save_meta(state, tag, world, extra=extra)
    monkeypatch.setattr(jsc, "_leaf_record", orig)


def _same_port_leaves(a, b):
    la, lb = td.flatten(a)[1], td.flatten(b)[1]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.dtype == torch.bfloat16
                           else x, y.view(torch.uint8)
                           if y.dtype == torch.bfloat16 else y)


def _same_jax_leaves(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


CASES = [("zero3", None, True), ("int8_replicated", "int8", False)]


@pytest.mark.parametrize("name,opt_dtype,zero", CASES,
                         ids=[c[0] for c in CASES])
def test_both_writers_make_the_same_shard_files(tmp_path, monkeypatch, name,
                                                opt_dtype, zero):
    """The JAX writer and the port's write byte-identical shard files and
    crc sidecars for the same ranks' pieces; their META bodies hold the
    same world, checksums and extra, and treedefs that decode alike."""
    state = _port_state(opt_dtype)
    trees = _rank_trees(state, 2, zero)
    jtag, ptag = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    _jax_write(jtag, _jax_state(state), trees, monkeypatch)
    _port_write(ptag, trees)
    for r in range(2):
        for suffix in ("", ".crc32"):
            name_r = f"shard-{r:05d}-of-00002.ckpt{suffix}"
            with open(os.path.join(jtag, name_r), "rb") as f:
                want = f.read()
            with open(os.path.join(ptag, name_r), "rb") as f:
                assert f.read() == want, name_r
    jm, pm = jsc._load_meta(jtag), sc._load_meta(ptag)
    assert jm["world"] == pm["world"] == 2
    assert jm["shard_crcs"] == pm["shard_crcs"]
    assert td.decode(bytes(jm["treedef"])) == td.decode(bytes(pm["treedef"]))
    assert sc._loads_extra(jm["extra"]) == sc._loads_extra(pm["extra"]) \
        == EXTRA


@pytest.mark.parametrize("name,opt_dtype,zero", CASES,
                         ids=[c[0] for c in CASES])
def test_port_reads_a_jax_directory(tmp_path, monkeypatch, name, opt_dtype,
                                    zero):
    """A directory the JAX package wrote: the full read gives the state
    bitwise, ``TrainState`` and extra included; each rank's selective read
    gives its own slices bitwise."""
    state = _port_state(opt_dtype)
    trees = _rank_trees(state, 2, zero)
    tag = str(tmp_path / "jax.ckpt")
    _jax_write(tag, _jax_state(state), trees, monkeypatch)
    assert sc.is_sharded_ckpt(tag) and sc.verify_sharded(tag) == []
    payload = sc.load_sharded(tag)
    assert not sc.LOAD_STATS["selective"]
    assert {k: v for k, v in payload.items() if k != "state"} == EXTRA
    _same_port_leaves(payload["state"], train_state_to_jax(state))
    got = train_state_from_jax(payload["state"])
    assert got.step == state.step
    if not zero:
        return
    for r, tree in enumerate(trees):
        part = sc.load_sharded(tag, targets=tree)
        assert sc.LOAD_STATS["selective"]
        want = [x.data if isinstance(x, sc.Shard) else x
                for x in td.flatten(tree)[1]]
        _same_port_leaves(part["state"], td.unflatten(
            td.flatten(tree)[0], want))


@pytest.mark.parametrize("name,opt_dtype,zero", CASES,
                         ids=[c[0] for c in CASES])
def test_jax_reads_a_port_directory(tmp_path, name, opt_dtype, zero):
    """A two-rank directory the port wrote, read by the JAX package:
    ``load_sharded`` gives its own ``TrainState`` (classes and all)
    bitwise, and ``load_meta`` the extra."""
    state = _port_state(opt_dtype)
    tag = str(tmp_path / "port.ckpt")
    _port_write(tag, _rank_trees(state, 2, zero))
    assert jsc.verify_sharded(tag) == []
    payload = jsc.load_sharded(tag)
    assert isinstance(payload["state"], JaxTrainState)
    _same_jax_leaves(payload["state"], _jax_state(state))
    assert jax.tree_util.tree_structure(payload["state"]) == \
        jax.tree_util.tree_structure(_jax_state(state))
    assert jsc.load_meta(tag) == {"world": 2, "extra": EXTRA}
    assert {k: v for k, v in payload.items() if k != "state"} == EXTRA


def test_selective_reader_reads_what_jax_reads(tmp_path, monkeypatch):
    """On one directory and one rank's target, the port's selective reader
    and the JAX package's read the same entries and bytes: this rank's
    slice of each sharded leaf (about half the sharded bytes) and each
    replicated leaf once."""
    state = _port_state()
    trees = _rank_trees(state, 2, True)
    tag = str(tmp_path / "port.ckpt")
    _port_write(tag, trees)
    jstate = _jax_state(state)
    treedef = jax.tree_util.tree_structure(jstate)

    class _Region:
        """A sharding of one region of the leaf, held by this process."""

        def __init__(self, region):
            self.region = region

        def addressable_devices_indices_map(self, shape):
            return {0: tuple(slice(a, b) for a, b in self.region)}

    def place(shape, sharding, cb):  # no device: the host buffer
        return np.asarray(cb(tuple(slice(a, b) for a, b in sharding.region)))

    monkeypatch.setattr(jsc.jax, "make_array_from_callback", place)
    sharded_bytes = 0
    for r, tree in enumerate(trees):
        regions = []
        for leaf in td.flatten(tree)[1]:
            if isinstance(leaf, sc.Shard):
                regions.append(_Region(leaf.index))
                sharded_bytes += leaf.data.numel() * leaf.data.element_size()
            else:
                regions.append(_Region(tuple((0, s) for s in leaf.shape)))
        jax_payload = jsc.load_sharded(
            tag, shardings=jax.tree_util.tree_unflatten(treedef, regions))
        want = dict(jsc.LOAD_STATS)
        port_payload = sc.load_sharded(tag, targets=tree)
        assert sc.LOAD_STATS == want
        assert want["selective"]
        got = [t.view(torch.uint8) if t.dtype == torch.bfloat16 else t
               for t in td.flatten(port_payload["state"])[1]]
        for a, b in zip(jax.tree_util.tree_leaves(jax_payload["state"]),
                        got):
            assert np.asarray(a).tobytes() == b.numpy().tobytes()
    # Each rank read its half of the sharded bytes, plus the replicated
    # leaves and the headers.
    files = sum(os.path.getsize(os.path.join(tag, n))
                for n in os.listdir(tag) if n.endswith("of-00002.ckpt"))
    assert sc.LOAD_STATS["bytes_read"] < 0.6 * files


def test_v1_shard_files_load_both_ways(tmp_path):
    """A pre-``RLTSHRD2`` shard file (a bare msgpack map, entry bytes
    inline) loads through the full and the selective reader, its META
    checksum checked on the selective path too."""
    state = _port_state()
    trees = _rank_trees(state, 2, True)
    tag = str(tmp_path / "v1.ckpt")
    _port_write(tag, trees)
    path = os.path.join(tag, "shard-00001-of-00002.ckpt")
    with open(path, "rb") as f:
        header, _ = sc._parse_header_from_blob(f.read(), path)
    blob = jsc.msgpack.packb(sc._parse_shard_blob(
        open(path, "rb").read(), path) | {"leaves": [
            {"s": rec["s"], "d": rec["d"],
             "e": [{"i": e["i"], "b": bytes(e["b"])} for e in rec["e"]]}
            for rec in sc._parse_shard_blob(open(path, "rb").read(),
                                            path)["leaves"]]},
        use_bin_type=True)
    with open(path, "wb") as f:
        f.write(blob)
    with open(path + ".crc32", "w") as f:
        f.write(str(zlib.crc32(blob)))
    sc.save_meta(trees[0], tag, 2, extra=EXTRA)
    _same_port_leaves(sc.load_sharded(tag)["state"],
                      train_state_to_jax(state))
    assert jsc.load_sharded(tag)["epoch"] == 1
    part = sc.load_sharded(tag, targets=trees[1])
    want = [x.data if isinstance(x, sc.Shard) else x
            for x in td.flatten(trees[1])[1]]
    for a, b in zip(td.flatten(part["state"])[1], want):
        assert torch.equal(a.float(), b.float())
    # A flipped byte of the v1 file: its whole-file checksum, on both
    # paths.
    raw = bytearray(blob)
    raw[len(raw) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(raw)
    with pytest.raises(sc.CorruptCheckpointError, match="checksum"):
        sc.load_sharded(tag, targets=trees[1])
    with pytest.raises(sc.CorruptCheckpointError, match="checksum"):
        sc.load_sharded(tag)


def test_a_flipped_byte_is_caught(tmp_path):
    """One data byte of rank 1's file flipped: its entry's crc32 on the
    selective path, META's checksum on the full path, and
    ``verify_sharded`` / ``verify_checkpoint`` of either package."""
    state = _port_state()
    trees = _rank_trees(state, 2, True)
    tag = str(tmp_path / "restart-epoch-000000.ckpt")
    _port_write(tag, trees)
    path = os.path.join(tag, "shard-00001-of-00002.ckpt")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size - 10)
        b = f.read(1)
        f.seek(size - 10)
        f.write(bytes([b[0] ^ 0x01]))
    with pytest.raises(sc.CorruptCheckpointError, match="crc32"):
        sc.load_sharded(tag, targets=trees[1])
    with pytest.raises(sc.CorruptCheckpointError, match="checksum"):
        sc.load_sharded(tag)
    for verify in (sc.verify_sharded, sc.verify_checkpoint,
                   jsc.verify_sharded):
        problems = verify(tag)
        assert len(problems) == 1 and "checksum mismatch" in problems[0]


def test_world_mismatch_is_flagged_and_discovery_walks_back(tmp_path):
    """A newest candidate holding a leftover shard of a larger world is
    flagged by both packages' ``verify_sharded``, and restart discovery
    (the port's and the JAX package's) walks back to the previous
    verified checkpoint, naming the skipped one."""
    state = _port_state()
    rdir = tmp_path / "restarts"
    good = str(rdir / "restart-epoch-000000.ckpt")
    _port_write(good, _rank_trees(state, 1, False))
    time.sleep(0.05)
    stale = str(rdir / "restart-epoch-000001.ckpt")
    _port_write(stale, _rank_trees(state, 1, False))
    with open(os.path.join(stale, "shard-00000-of-00004.ckpt"), "wb") as f:
        f.write(b"leftover")
    for verify in (sc.verify_sharded, jsc.verify_sharded):
        assert any("world size 4" in p for p in verify(stale))
    for find in (port_strategies._remote_latest_restart_checkpoint,
                 jax_strategies._remote_latest_restart_checkpoint):
        info = find(str(rdir))
        assert info["path"] == good
        assert [c["path"] for c in info["corrupt"]] == [stale]
    # No META (a write cut before the barrier): never a candidate.
    os.remove(os.path.join(good, "META.ckpt"))
    info = port_strategies._remote_latest_restart_checkpoint(str(rdir))
    assert info == {"path": None, "corrupt": [
        {"path": stale, "problems": sc.verify_sharded(stale)[:3]}]}


def test_restart_candidates_order_as_jax(tmp_path):
    """A mixed directory (sharded epoch checkpoints, a drain file at the
    same mtime as one of them, an incomplete directory, a stray file):
    the same candidates in the same order as the JAX package's."""
    state = _port_state()
    rdir = tmp_path / "rs"
    for epoch in (0, 1):
        _port_write(str(rdir / f"restart-epoch-{epoch:06d}.ckpt"),
                    _rank_trees(state, 1, False))
    drain = rdir / "drain-step-00000009.ckpt"
    ss.state_stream_to_file(ss.to_state_stream(train_state_to_jax(state)),
                            str(drain))
    meta1 = rdir / "restart-epoch-000001.ckpt" / "META.ckpt"
    t = os.path.getmtime(meta1)
    os.utime(drain, (t, t))
    (rdir / "restart-epoch-000002.ckpt").mkdir()   # no META
    (rdir / "notes.txt").write_text("x")
    got = sc.list_restart_candidates(str(rdir))
    assert got == jsc.list_restart_candidates(str(rdir))
    assert [n for _, _, n, _ in got] == [
        "drain-step-00000009.ckpt", "restart-epoch-000001.ckpt",
        "restart-epoch-000000.ckpt"]
    assert sc.verify_checkpoint(str(drain)) == []
    assert sc.verify_checkpoint(str(rdir / "restart-epoch-000002.ckpt")) \
        == jsc.verify_checkpoint(str(rdir / "restart-epoch-000002.ckpt"))
    assert sc.list_restart_candidates(str(tmp_path / "nope")) == []


def test_extra_and_dtypes_are_checked(tmp_path):
    """``extra`` takes builtins and numpy scalars (a 0-d torch tensor is
    written as its number) and refuses a tensor; a leaf of an unregistered
    dtype raises ``UnsupportedLeafDtypeError`` at save, and a header
    naming one at load, which ``verify_sharded`` flags."""
    tag = str(tmp_path / "ck.ckpt")
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    sc.save_shard(tree, tag, 0, 1)
    sc.save_meta(tree, tag, 1, extra={"loss": torch.tensor(1.5),
                                      "n": np.int64(3)})
    assert sc.load_meta(tag)["extra"] == {"loss": 1.5, "n": 3}
    assert jsc.load_meta(tag)["extra"] == {"loss": 1.5, "n": 3}
    with pytest.raises(TypeError, match="builtins and numpy scalars"):
        sc.save_meta(tree, tag, 1, extra={"w": torch.ones(2)})
    with pytest.raises(sc.UnsupportedLeafDtypeError, match="complex64"):
        sc.save_shard({"z": torch.zeros(2, dtype=torch.complex64)}, tag, 0, 1)
    path = os.path.join(tag, "shard-00000-of-00001.ckpt")
    with open(path, "rb") as f:
        header, _ = sc._parse_header_from_blob(f.read(), path)
    header["leaves"][0]["d"] = "float8_e4m3fn"
    leaves = [{"s": rec["s"], "d": rec["d"],
               "e": [{"i": e["i"], "b": tree["w"].numpy().tobytes()}
                     for e in rec["e"]]} for rec in header["leaves"]]
    blob = sc._encode_shard_v2(0, 1, leaves)
    with open(path, "wb") as f:
        f.write(blob)
    with open(path + ".crc32", "w") as f:
        f.write(str(zlib.crc32(blob)))
    sc.save_meta(tree, tag, 1)
    assert any("float8_e4m3fn" in p for p in sc.verify_sharded(tag))
    with pytest.raises(sc.UnsupportedLeafDtypeError, match="float8"):
        sc.load_sharded(tag)


def test_residual_row_is_written_at_its_index(tmp_path):
    """The error-feedback residual: rank r's row of ``total_padded`` is
    written under ``((r, r + 1), (0, total_padded))`` of a ``(world,
    total_padded)`` leaf, as the JAX package keeps it, and the JAX reader
    stitches the rows."""
    state = _port_state()
    rows = [torch.randn(512, generator=torch.Generator().manual_seed(r))
            for r in range(2)]
    tag = str(tmp_path / "ef.ckpt")
    trees = [sc.state_tree(state, None, r, 2, residual=rows[r])
             for r in range(2)]
    _port_write(tag, trees)
    jstate = jsc.load_sharded(tag)["state"]
    np.testing.assert_array_equal(np.asarray(jstate.grad_residual),
                                  torch.stack(rows).numpy())
    part = sc.load_sharded(tag, targets=trees[1])
    assert sc.LOAD_STATS["selective"]
    assert torch.equal(part["state"].children[3], rows[1].reshape(1, -1))
    # At another world the row index does not fit: the whole leaf comes
    # back, for the loop to drop loudly.
    other = sc.state_tree(state, None, 0, 3, residual=torch.zeros(512))
    part = sc.load_sharded(tag, targets=other)
    assert tuple(part["state"].children[3].shape) == (2, 512)
