"""Checkpoints of the port held against the JAX package's (CPU, f32,
``GPTConfig.tiny()``).

The file format is the JAX package's ``RLTCKPT1`` state stream: the port
reads it without ``msgpack``, ``ml_dtypes`` or ``pickle.loads``
(``utils/msgpack_codec.py``, ``utils/treedef.py``) and writes the same
bytes.  Tolerances: a file read or written by either package holds the
other's leaves bitwise; a fit resumed across the packages lands within
1e-5 absolute of the other package's straight fit in every parameter, as
``test_torch_train.py::test_fit_matches_the_jax_fit_over_five_steps``
holds the per-step fit (the same f32 arithmetic in another order, and a
bf16 first moment that may round the other way near a boundary); the
port's split fit against its own straight fit: bitwise.
"""

import dataclasses
import io
import os
import pickle

import jax
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ray_lightning_tpu.core.callbacks import EarlyStopping as JaxEarlyStopping
from ray_lightning_tpu.core.callbacks import (
    ModelCheckpoint as JaxModelCheckpoint,
)
from ray_lightning_tpu.core.module import TrainState as JaxTrainState
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.models.gpt import (
    SyntheticLMDataModule as JaxSyntheticLM,
)
from ray_lightning_tpu.parallel.strategies import (
    LocalStrategy as JaxLocalStrategy,
)
from ray_lightning_tpu.utils import state_stream as jss
from ray_lightning_tpu_torch.core import loop as tloop
from ray_lightning_tpu_torch.core.callbacks import (
    EarlyStopping, ModelCheckpoint,
)
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.convert import (
    params_from_jax, train_state_from_jax, train_state_to_jax,
)
from ray_lightning_tpu_torch.models.gpt import (
    GPT, GPTConfig, SyntheticLMDataModule,
)
from ray_lightning_tpu_torch.models.optim import tree_leaves
from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy
from ray_lightning_tpu_torch.utils import msgpack_codec as mc
from ray_lightning_tpu_torch.utils import state_stream as ss
from ray_lightning_tpu_torch.utils import treedef as td

TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny fits here run on one CPU thread: under the suite's
    parallel workers, torch's threads per worker oversubscribe the cores
    and a fit that takes a second alone takes minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
BATCH, BATCHES, SEED = 8, 3, 4


# ---------------------------------------------------------------------------
# (a) the msgpack codec
# ---------------------------------------------------------------------------

_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
         2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
         -2**31 - 1, -2**63]
_SIZES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


def _boundary_objects():
    out = [None, True, False, 0.0, -2.5, 1e300, *_INTS]
    for n in _SIZES:
        out += ["x" * n, "é" * (n // 2), b"\x01" * n, list(range(n)),
                {str(i): i for i in range(n)}]
    return out


_OBJECTS = st.recursive(
    st.none() | st.booleans()
    | st.integers(min_value=-2**63, max_value=2**64 - 1)
    | st.floats(allow_nan=False) | st.text() | st.binary(),
    lambda kids: st.lists(kids) | st.dictionaries(st.text(), kids),
    max_leaves=40)


@pytest.mark.parametrize("i", range(len(_boundary_objects())))
def test_msgpack_codec_round_trips_every_width_boundary(i):
    obj = _boundary_objects()[i]
    assert mc.unpackb(mc.packb(obj)) == obj


@given(_OBJECTS)
@settings(max_examples=150, deadline=None, database=None)
def test_msgpack_codec_round_trips_hypothesis_objects(obj):
    assert mc.unpackb(mc.packb(obj)) == obj


def _same_as_msgpack(obj):
    msgpack = pytest.importorskip("msgpack")
    packed = msgpack.packb(obj, use_bin_type=True)
    assert mc.packb(obj) == packed
    assert mc.unpackb(packed) == msgpack.unpackb(packed, raw=False)


@pytest.mark.parametrize("i", range(len(_boundary_objects())))
def test_msgpack_codec_is_byte_equal_to_msgpack_at_each_boundary(i):
    _same_as_msgpack(_boundary_objects()[i])


@given(_OBJECTS)
@settings(max_examples=150, deadline=None, database=None)
def test_msgpack_codec_is_byte_equal_to_msgpack(obj):
    _same_as_msgpack(obj)


def test_msgpack_codec_refuses_what_a_stream_does_not_hold():
    with pytest.raises(TypeError, match="can not serialize"):
        mc.packb({1, 2})
    with pytest.raises(OverflowError):
        mc.packb(2**64)
    with pytest.raises(ValueError, match="truncated"):
        mc.unpackb(mc.packb("abc")[:-1])
    with pytest.raises(ValueError, match="extra data"):
        mc.unpackb(bytes(mc.packb(1)) + b"\x01")
    with pytest.raises(ValueError, match="0xc7"):
        mc.unpackb(b"\xc7\x01\x00\x00")  # an ext type


# ---------------------------------------------------------------------------
# Fits of both packages, shared by the tests below
# ---------------------------------------------------------------------------

_CACHE = {}


def _init_tree():
    if "tree" not in _CACHE:
        _CACHE["tree"] = jax.tree.map(np.asarray, JaxGPT(
            JaxGPTConfig.tiny()).init_params(jax.random.PRNGKey(3)))
    return _CACHE["tree"]


def _jax_fit(root, epochs, accum=1, resume=None, callbacks=(),
             batches=BATCHES, val=0):
    m = JaxGPT(JaxGPTConfig.tiny())
    m.initial_params = _init_tree()
    tr = JaxTrainer(strategy=JaxLocalStrategy(), max_epochs=epochs,
                    limit_val_batches=val, accumulate_grad_batches=accum,
                    default_root_dir=str(root), callbacks=list(callbacks),
                    resume_from_checkpoint=resume)
    tr.fit(m, JaxSyntheticLM(JaxGPTConfig.tiny(), batch_size=BATCH,
                             num_batches=batches, seed=SEED))
    return tr


def _port_fit(root, epochs, accum=1, resume=None, callbacks=(),
              batches=BATCHES, val=0, megastep=None):
    cfg = GPTConfig.tiny()
    m = GPT(cfg, device="cpu")
    m.initial_params = params_from_jax(_init_tree(), "cpu")
    tr = Trainer(LocalStrategy(device="cpu", megastep=megastep),
                 max_epochs=epochs, limit_val_batches=val,
                 accumulate_grad_batches=accum, default_root_dir=str(root),
                 callbacks=list(callbacks), resume_from_checkpoint=resume)
    tr.fit(m, SyntheticLMDataModule(cfg, batch_size=BATCH,
                                    num_batches=batches, seed=SEED))
    return tr


def _only_ckpt(root):
    d = os.path.join(str(root), "checkpoints")
    (name,) = os.listdir(d)
    return os.path.join(d, name)


def _jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _bits(x):
    """Raw bytes of a leaf (torch or numpy, bf16 included)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        return t.reshape(-1).view(torch.uint8).numpy().tobytes(), \
            str(t.dtype).replace("torch.", ""), tuple(t.shape)
    a = np.asarray(x)
    return a.tobytes(), str(a.dtype), a.shape


# ---------------------------------------------------------------------------
# (b) a JAX-written file read by the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_port_reads_a_jax_checkpoint_bitwise(tmp_path, accum):
    """One JAX epoch of 3 micro-batches (with accumulation 2 the last
    window is partial and flushed, and the file holds MultiStepsState)."""
    jt = _jax_fit(tmp_path, 1, accum)
    path = _only_ckpt(tmp_path)
    assert os.path.basename(path) == f"epoch=0-step={jt.global_step}.ckpt"
    want = jss.load_state_stream(jss.state_stream_from_file(path))
    got = ss.load_state_stream(ss.state_stream_from_file(path))
    # Every leaf, in the stream's order, bitwise (bf16 mu by its bits).
    nodes, leaves = td.flatten(got)
    assert len(leaves) == len(jax.tree_util.tree_leaves(want))
    for g, w in zip(leaves, jax.tree_util.tree_leaves(want)):
        assert _bits(g) == _bits(w)
    # The treedef decodes to the structure JAX's tree_flatten gives.
    assert len(nodes) == jax.tree_util.tree_structure(want).num_nodes
    for k in ("epoch", "global_step", "micro_step"):
        assert got[k] == want[k]
    assert got["global_step"] == jt.global_step
    assert got["callback_metrics"] == want["callback_metrics"]
    # Converted to the port's TrainState: the live JAX state's leaves.
    state = train_state_from_jax(got["state"])
    assert state.step == int(jt.state.step)
    opt = state.opt_state
    jopt = jt.state.opt_state
    if accum > 1:
        assert int(opt["mini_step"]) == int(jopt.mini_step) == 0
        assert int(opt["gradient_step"]) == int(jopt.gradient_step) == 2
        assert [_bits(x) for x in tree_leaves(opt["acc_grads"])] == [
            _bits(x) for x in _jax_leaves(jopt.acc_grads)]
        opt, jopt = opt["inner_opt_state"], jopt.inner_opt_state
    adam = jopt[1][0]
    assert int(opt[1]["count"]) == int(adam.count) == jt.global_step
    for name, tree, jtree in (("params", state.params, jt.state.params),
                              ("mu", opt[1]["mu"], adam.mu),
                              ("nu", opt[1]["nu"], adam.nu)):
        flat = {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_flatten_with_path(jtree)[0]}
        port = {}

        def walk(node, p):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, p + f"['{k}']")
            else:
                port[p] = node
        walk(tree, "")
        assert set(port) == set(flat), name
        for k in flat:
            assert _bits(port[k]) == _bits(flat[k]), (name, k)


# ---------------------------------------------------------------------------
# (c) a port-written file read by JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_jax_reads_a_port_checkpoint_with_its_own_treedef(tmp_path, accum):
    tr = _port_fit(tmp_path, 1, accum)
    path = _only_ckpt(tmp_path)
    got = jss.load_state_stream(jss.state_stream_from_file(path))
    # The treedef JAX builds for the same module, optimizer and payload.
    jm = JaxGPT(JaxGPTConfig.tiny())
    tx = jm.configure_optimizers()
    if accum > 1:
        tx = optax.MultiSteps(tx, accum)
    template = {"state": JaxTrainState.create(_init_tree(), tx),
                "epoch": 0, "global_step": 0, "micro_step": 0,
                "callback_metrics": dict.fromkeys(got["callback_metrics"],
                                                  0.0)}
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(template))
    assert (got["epoch"], got["global_step"], got["micro_step"]) == (
        0, tr.global_step, tr.micro_step)
    assert got["callback_metrics"] == pytest.approx(tr.callback_metrics)
    # Leaves bitwise the port's (the schedule's count is the Adam count).
    _, mine = td.flatten(train_state_to_jax(tr.state))
    theirs = _jax_leaves(got["state"])
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert _bits(a) == _bits(b)


def test_port_stream_round_trips_a_jax_stream_byte_for_byte():
    """The codec writes back exactly the bytes it read (treedef pickle
    included), for a payload with a MultiStepsState."""
    jm = JaxGPT(JaxGPTConfig.tiny())
    st_ = JaxTrainState.create(_init_tree(), optax.MultiSteps(
        jm.configure_optimizers(), 2))
    stream = jss.to_state_stream({"state": st_, "epoch": 1,
                                  "global_step": 2, "micro_step": 4,
                                  "callback_metrics": {"val_loss": 5.5}})
    assert bytes(ss.to_state_stream(ss.load_state_stream(stream))) == stream


# ---------------------------------------------------------------------------
# (d) resume across the packages
# ---------------------------------------------------------------------------

def _max_param_diff(port_params, jax_params):
    flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(jax_params)[0]}
    worst = 0.0

    def walk(node, p):
        nonlocal worst
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, p + f"['{k}']")
        else:
            worst = max(worst, float(np.abs(
                node.detach().numpy() - flat[p]).max()))
    walk(port_params, "")
    return worst


def test_resume_parity_both_ways(tmp_path):
    straight = _jax_fit(tmp_path / "straight", 2)
    # JAX epoch 0 → the port resumes epoch 1.
    _jax_fit(tmp_path / "jax1", 1)
    port2 = _port_fit(tmp_path / "port2", 2,
                      resume=_only_ckpt(tmp_path / "jax1"))
    assert (port2.global_step, port2.epochs_run) == (2 * BATCHES, 2)
    assert _max_param_diff(port2.state.params, straight.state.params) < TOL
    # Port epoch 0 → JAX resumes epoch 1.
    _port_fit(tmp_path / "port1", 1)
    jax2 = _jax_fit(tmp_path / "jax2", 2,
                    resume=_only_ckpt(tmp_path / "port1"))
    assert jax2.global_step == 2 * BATCHES
    port_view = params_from_jax(jax.tree.map(np.asarray, jax2.state.params),
                                "cpu")
    assert _max_param_diff(port_view, straight.state.params) < TOL
    assert port2.callback_metrics["train_loss"] == pytest.approx(
        straight.callback_metrics["train_loss"], abs=TOL)


# ---------------------------------------------------------------------------
# (e) the port alone: split equals straight
# ---------------------------------------------------------------------------

def _by_path(tree, path=""):
    """Leaves by key path: a resumed fit's dicts keep its own key order
    (its init), a warm-started one the JAX tree's."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _by_path(v, f"{path}['{k}']").items()}
    if isinstance(tree, (tuple, list)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _by_path(v, f"{path}[{i}]").items()}
    return {path: tree}


@pytest.fixture
def deterministic():
    # The embedding's backward sums wte's gradient in a thread-dependent
    # order on the CPU unless deterministic algorithms are asked for.
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.mark.parametrize("megastep", [2, "off"])
@pytest.mark.parametrize("accum", [1, 2])
def test_split_fit_equals_straight_fit_bitwise(tmp_path, deterministic,
                                               megastep, accum):
    kw = dict(batches=4, megastep=megastep, accum=accum)
    straight = _port_fit(tmp_path / "a", 2, **kw)
    _port_fit(tmp_path / "b", 1, **kw)
    split = _port_fit(tmp_path / "c", 2, resume=_only_ckpt(tmp_path / "b"),
                      **kw)
    assert (split.global_step, split.micro_step, split.epochs_run) == (
        straight.global_step, straight.micro_step, 2)
    a = _by_path((straight.state.params, straight.state.opt_state))
    b = _by_path((split.state.params, split.state.opt_state))
    assert set(a) == set(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert split.state.step == straight.state.step
    assert split.callback_metrics["train_loss"] == (
        straight.callback_metrics["train_loss"])


def test_a_count_left_at_zero_breaks_the_parity(tmp_path, deterministic):
    """The optimizer's count restarts the schedule (lr 0 at count 0): a
    resume that dropped it would be caught by the split-vs-straight
    gate."""
    straight = _port_fit(tmp_path / "a", 2)
    _port_fit(tmp_path / "b", 1)
    path = _only_ckpt(tmp_path / "b")
    payload = ss.load_state_stream(ss.state_stream_from_file(path))
    state = train_state_from_jax(payload["state"])
    state.opt_state[1]["count"].zero_()
    payload["state"] = train_state_to_jax(state)
    ss.state_stream_to_file(ss.to_state_stream(payload), path)
    split = _port_fit(tmp_path / "c", 2, resume=path)
    a, b = _by_path(straight.state.params), _by_path(split.state.params)
    assert not all(torch.equal(a[k], b[k]) for k in a)


def test_resume_refuses_a_tree_of_another_shape(tmp_path):
    _port_fit(tmp_path / "a", 1, accum=2)
    with pytest.raises(ValueError, match="state.opt_state"):
        _port_fit(tmp_path / "b", 2, resume=_only_ckpt(tmp_path / "a"))


# ---------------------------------------------------------------------------
# (f) integrity, (g) the restricted unpickler, (h) atomic writes
# ---------------------------------------------------------------------------

def _small_stream():
    return ss.to_state_stream({"w": torch.arange(6.0).reshape(2, 3),
                               "b": torch.ones(3, dtype=torch.bfloat16),
                               "n": None, "i": 7, "s": "x"})


def test_corrupt_and_legacy_files(tmp_path):
    path = str(tmp_path / "a.ckpt")
    ss.state_stream_to_file(_small_stream(), path)
    assert ss.verify_stream_file(path) == []
    tree = ss.load_state_stream(ss.state_stream_from_file(path))
    assert torch.equal(tree["w"], torch.arange(6.0).reshape(2, 3))
    assert tree["b"].dtype == torch.bfloat16 and tree["n"] is None
    raw = bytearray(open(path, "rb").read())
    # A flipped byte in the body.
    flipped = bytearray(raw)
    flipped[-3] ^= 0x40
    open(path, "wb").write(flipped)
    with pytest.raises(ss.CorruptCheckpointError, match="checksum"):
        ss.state_stream_from_file(path)
    assert "checksum" in ss.verify_stream_file(path)[0]
    # A truncated frame, and a truncated body.
    for cut, what in ((10, "truncated"), (len(raw) - 5, "checksum")):
        open(path, "wb").write(raw[:cut])
        with pytest.raises(ss.CorruptCheckpointError, match=what):
            ss.state_stream_from_file(path)
    # A legacy unframed body loads; garbage does not verify.
    open(path, "wb").write(bytes(_small_stream()))
    assert ss.verify_stream_file(path) == []
    assert ss.load_state_stream(ss.state_stream_from_file(path))["i"] == 7
    open(path, "wb").write(b"\x85garbage")
    assert "unparsable" in ss.verify_stream_file(path)[0]


class _Evil:
    def __reduce__(self):
        return (os.system, ("echo pwned",))


def test_restricted_unpickler_refuses_foreign_globals():
    with pytest.raises(pickle.UnpicklingError, match="system"):
        td.decode(pickle.dumps(_Evil()))
    # Inside a stream too: the treedef is all it reads of the pickle.
    stream = mc.packb({"treedef": pickle.dumps(_Evil()), "leaves": []})
    with pytest.raises(pickle.UnpicklingError, match="system"):
        ss.load_state_stream(stream)
    # A node of a layout it does not know (five fields) raises, naming it.
    buf = io.BytesIO()
    td._Writer(buf, protocol=4).dump(
        td._TreeDef((td._REGISTRY, [(0, 0, None, None, 1)])))
    with pytest.raises(ValueError, match="layout.*5 fields"):
        td.decode(buf.getvalue())


def test_int8_and_lora_states_raise_naming_the_path():
    """The int8 and LoRA states convert; a tree that departs from them
    (a BlockQuantized node without its aux data, a partition of other
    labels) raises, naming the path."""
    for cfg, what in (
            (dataclasses.replace(JaxGPTConfig.tiny(), opt_state_dtype="int8"),
             r"state.opt_state\[1\]\[0\].mu\['blocks'\]\['mlp_in_w'\]"
             r".*BlockQuantized"),
            (dataclasses.replace(JaxGPTConfig.tiny(), lora_rank=4),
             r"state.opt_state\[2\].inner_states.*labels")):
        jm = JaxGPT(cfg)
        state = JaxTrainState.create(jm.init_params(jax.random.PRNGKey(0)),
                                     jm.configure_optimizers())
        tree = ss.load_state_stream(jss.to_state_stream(state))
        train_state_from_jax(tree)  # converts
        params, opt, step, res = tree.children
        if cfg.lora_rank:
            part = opt[2]
            inner = dict(part.children[0])
            inner["other"] = inner.pop("train")
            opt = (opt[0], opt[1], td.JaxNode(part.cls, (inner,)))
        else:
            adam = opt[1][0]
            mu = dict(adam.children[1])
            mu["blocks"] = dict(mu["blocks"])
            bq = mu["blocks"]["mlp_in_w"]
            mu["blocks"]["mlp_in_w"] = td.JaxNode(bq.cls, bq.children,
                                                  custom=True, aux=None)
            opt = (opt[0], (td.JaxNode(adam.cls, (adam.children[0], mu,
                                                  adam.children[2])),
                            *opt[1][1:]))
        with pytest.raises(ValueError, match=what):
            train_state_from_jax(td.JaxNode(tree.cls, (params, opt, step,
                                                       res), custom=True))


def test_no_partial_file_when_a_write_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "a.ckpt")

    def boom(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError, match="disk full"):
        ss.state_stream_to_file(_small_stream(), path)
    assert os.listdir(tmp_path) == []


def test_async_write_failure_raises_at_fit_end(tmp_path, monkeypatch):
    def boom(stream, path):
        raise OSError("disk full")

    monkeypatch.setattr(tloop, "state_stream_to_file", boom)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        _port_fit(tmp_path, 1, callbacks=[ModelCheckpoint(async_write=True)])
    assert not os.path.exists(os.path.join(str(tmp_path), "checkpoints",
                                           "epoch=0-step=3.ckpt"))


def test_async_and_verified_writes_hold_the_same_state(tmp_path,
                                                      deterministic):
    sync = _port_fit(tmp_path / "a", 2, callbacks=[
        ModelCheckpoint(verify=True, save_top_k=-1)])
    _port_fit(tmp_path / "b", 2, callbacks=[
        ModelCheckpoint(async_write=True, verify=True, save_top_k=-1)])
    for name in ("epoch=0-step=3.ckpt", "epoch=1-step=6.ckpt"):
        a, b = (ss.load_state_stream(ss.state_stream_from_file(
            str(tmp_path / r / "checkpoints" / name))) for r in "ab")
        assert (a["global_step"], a["micro_step"]) == (
            b["global_step"], b["micro_step"])
        for x, y in zip(td.flatten(a["state"])[1],
                        td.flatten(b["state"])[1]):
            assert _bits(x) == _bits(y)
    assert sync.telemetry_report["counters"]["checkpoint_writes"] == 2


# ---------------------------------------------------------------------------
# (i) ModelCheckpoint and EarlyStopping against the JAX callbacks
# ---------------------------------------------------------------------------

def test_callbacks_keep_the_jax_files_and_stop_at_its_epoch(tmp_path):
    def callbacks(mc_cls, es_cls, root):
        return [mc_cls(dirpath=str(root / "none")),
                mc_cls(dirpath=str(root / "top1"), monitor="val_loss"),
                mc_cls(dirpath=str(root / "top2"), monitor="val_loss",
                       save_top_k=2, filename="{epoch}-{step}"),
                # val_loss falls every epoch: "max" stops at patience.
                es_cls(monitor="val_loss", mode="max", patience=2)]

    jcb = callbacks(JaxModelCheckpoint, JaxEarlyStopping, tmp_path / "j")
    tcb = callbacks(ModelCheckpoint, EarlyStopping, tmp_path / "t")
    jt = _jax_fit(tmp_path / "j", 5, callbacks=jcb, batches=2, val=1)
    tr = _port_fit(tmp_path / "t", 5, callbacks=tcb, batches=2, val=1)
    assert tr.epochs_run == jt.epochs_run == 3
    assert tcb[3].stopped_epoch == jcb[3].stopped_epoch == 2
    for sub in ("none", "top1", "top2"):
        assert sorted(os.listdir(tmp_path / "t" / sub)) == sorted(
            os.listdir(tmp_path / "j" / sub)), sub
    assert os.path.basename(tr.best_model_path) == os.path.basename(
        jt.best_model_path) == "epoch=2-step=6.ckpt"
    for a, b in zip(tcb[:3], jcb[:3]):
        assert os.path.basename(a.best_model_path) == os.path.basename(
            b.best_model_path)
    assert tcb[3].state_dict()["wait"] == jcb[3].state_dict()["wait"]
