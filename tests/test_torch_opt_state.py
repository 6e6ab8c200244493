"""The port's optimizer-state precision (``opt_state_dtype``) held against
the JAX package (CPU, f32 compute, ``GPTConfig.tiny()``, in which the
matrices' moments quantize and the LayerNorm and bias moments stay f32).

Tolerances: the block codec is bitwise JAX's (same f32 division, halves
to even); ``opt_state_bytes`` exact; the optimizer fed the same
gradients from the same state, params within 1e-6 of their scale and
each moment within one quantization step of JAX's (an int8 block's ``scale`` in its stored
domain; for a bf16 leaf one ulp of its largest element, the same
leaf-wide step, since a moment that cancels to ~1e-9 of its leaf keeps
the absolute rounding of the terms it summed; f32 leaves 1e-5 of their
largest element); six-step fits loss
within 1e-5 absolute and params as
:func:`test_six_step_fit_matches_the_jax_fit` states; a JAX int8
stream read and written back byte-identical; the cross-policy
reconcile bitwise JAX's.
"""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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
from ray_lightning_tpu.ops import collective_quant as jcq
from ray_lightning_tpu.ops import optim_quant as joq
from ray_lightning_tpu.parallel.strategies import (
    LocalStrategy as JaxLocalStrategy,
)
from ray_lightning_tpu.utils import state_stream as jss
from ray_lightning_tpu_torch.core import loop as tloop
from ray_lightning_tpu_torch.core.module import TrainState
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models import optim as topt
from ray_lightning_tpu_torch.models.convert import (
    params_from_jax, train_state_from_jax, train_state_to_jax,
)
from ray_lightning_tpu_torch.models.gpt import (
    GPT, GPTConfig, SyntheticLMDataModule,
)
from ray_lightning_tpu_torch.ops import optim_quant as toq
from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy
from ray_lightning_tpu_torch.utils import state_stream as ss

jloop = importlib.import_module("ray_lightning_tpu.core.loop")
jopt = importlib.import_module("ray_lightning_tpu.models.optim")
jgpt = importlib.import_module("ray_lightning_tpu.models.gpt")

TOL = 1e-5
BATCH, BATCHES, SEED, STEPS = 8, 6, 4, 6


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: under the suite's parallel workers torch's own
    threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the codec
# ---------------------------------------------------------------------------

def _codec_inputs(seed, n, zero_blocks, block):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 2, n)).astype(
        np.float32)
    for b in zero_blocks:
        v[b * block:(b + 1) * block] = 0.0
    return v


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 1100),
       block=st.sampled_from([16, 64, 128]), sqrt=st.booleans(),
       zero=st.lists(st.integers(0, 8), max_size=3))
def test_codec_is_bitwise_jax(seed, n, block, sqrt, zero):
    """``quantize_moment`` (ragged sizes padded, all-zero blocks, sqrt
    domain) and the flat codec under it: payloads and scales bitwise, the
    dequantized moment bitwise."""
    v = _codec_inputs(seed, n, zero, block)
    if sqrt:
        v = v * v
    want = joq.quantize_moment(jnp.asarray(v), block_size=block,
                               sqrt_domain=sqrt)
    got = toq.quantize_moment(torch.from_numpy(v), block_size=block,
                              sqrt_domain=sqrt)
    assert got.static() == (tuple(want.shape), want.block_size,
                            want.sqrt_domain)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(
        toq.dequantize_moment(got).numpy(),
        np.asarray(joq.dequantize_moment(want)))
    pad = (-n) % block
    flat = np.concatenate([v, np.zeros(pad, np.float32)])
    jq, js = jcq.quantize_block_scaled(jnp.asarray(flat), block)
    tq, ts = toq.quantize_block_scaled(torch.from_numpy(flat), block)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        toq.dequantize_block_scaled(tq, ts, block).numpy(),
        np.asarray(jcq.dequantize_block_scaled(jq, js, block)))


def test_codec_rounds_halves_to_even_and_clips():
    v = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 126.5], np.float32)
    v = np.concatenate([v, np.zeros(1, np.float32)])
    q, s = toq.quantize_block_scaled(torch.from_numpy(v), 8)
    jq, js = jcq.quantize_block_scaled(jnp.asarray(v), 8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s[0]) == np.float32(127.0) / np.float32(127.0)
    assert q.tolist()[:5] == [0, 2, 2, 0, -2]


# ---------------------------------------------------------------------------
# (b) the accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [None, "float32", "bfloat16", "int8"])
@pytest.mark.parametrize("which", ["tiny", "gpt2_small"])
def test_opt_state_bytes_equals_jax(which, dtype):
    """Shapes from ``jax.eval_shape`` (nothing allocated), the port's
    count over meta tensors of the same shapes."""
    jcfg = getattr(JaxGPTConfig, which)()
    shapes = jax.eval_shape(JaxGPT(jcfg).init_params, jax.random.PRNGKey(0))
    meta = jax.tree.map(
        lambda s: torch.empty(s.shape, device="meta"), shapes)
    assert topt.opt_state_bytes(meta, dtype) == jopt.opt_state_bytes(
        shapes, dtype)


def test_moment_bytes_of_a_real_state_equal_the_formula():
    cfg = GPTConfig.tiny()
    m = GPT(cfg, device="cpu")
    params = m.init_params()
    for dtype in (None, "bfloat16", "int8"):
        tx = GPT(dataclasses.replace(cfg, opt_state_dtype=dtype),
                 device="cpu").configure_optimizers()
        assert topt.moment_bytes(tx.init(params)) == topt.opt_state_bytes(
            params, dtype), dtype


def test_policy_names_resolve_and_typos_raise():
    assert topt.resolve_opt_state_dtype("bf16") == "bfloat16"
    assert topt.resolve_opt_state_dtype("fp32") == "float32"
    assert topt.resolve_opt_state_dtype(None) is None
    with pytest.raises(ValueError, match="opt_state_dtype"):
        GPT(dataclasses.replace(GPTConfig.tiny(), opt_state_dtype="int4"),
            device="cpu")


# ---------------------------------------------------------------------------
# (c) six-step fits against the JAX fit
# ---------------------------------------------------------------------------

_CACHE = {}


def _init_tree():
    if "tree" not in _CACHE:
        _CACHE["tree"] = jax.tree.map(np.asarray, JaxGPT(
            JaxGPTConfig.tiny()).init_params(jax.random.PRNGKey(3)))
    return _CACHE["tree"]


def _jax_fit(root, dtype, epochs=1, resume=None, callbacks=()):
    jcfg = dataclasses.replace(JaxGPTConfig.tiny(), opt_state_dtype=dtype)
    m = JaxGPT(jcfg)
    m.initial_params = _init_tree()
    tr = JaxTrainer(strategy=JaxLocalStrategy(), max_epochs=epochs,
                    limit_val_batches=0, default_root_dir=str(root),
                    callbacks=list(callbacks), resume_from_checkpoint=resume,
                    enable_checkpointing=bool(callbacks))
    tr.fit(m, JaxSyntheticLM(jcfg, batch_size=BATCH, num_batches=BATCHES,
                             seed=SEED))
    return tr


def _port_fit(root, dtype, epochs=1, resume=None, callbacks=()):
    cfg = dataclasses.replace(GPTConfig.tiny(), opt_state_dtype=dtype)
    m = GPT(cfg, device="cpu")
    m.initial_params = params_from_jax(_init_tree(), "cpu")
    tr = Trainer(LocalStrategy(device="cpu"), max_epochs=epochs,
                 limit_val_batches=0, default_root_dir=str(root),
                 callbacks=list(callbacks), resume_from_checkpoint=resume,
                 enable_checkpointing=bool(callbacks))
    tr.fit(m, SyntheticLMDataModule(cfg, batch_size=BATCH,
                                    num_batches=BATCHES, seed=SEED))
    return tr


def _jax_by_path(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_by_path(tree, path=""):
    """Leaves by JAX key path (``['k']``, ``[i]``, ``.q``/``.scale``)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _port_by_path(v, f"{path}['{k}']").items()}
    if isinstance(tree, toq.BlockQuantized):
        return {f"{path}.q": tree.q, f"{path}.scale": tree.scale}
    if isinstance(tree, topt.MaskedNode):
        return {}
    return {path: tree}


def _f32(t):
    return t.detach().float().cpu().numpy()


def _stored(q, scale, block):
    """A quantized moment in its stored domain (before any square)."""
    return (q.astype(np.float32).reshape(-1, block)
            * scale[:, None]).reshape(-1), np.repeat(scale, block)


def _moments_agree(port_tree, jax_tree):
    """Each moment within one quantization step of JAX's; returns the
    largest error in steps."""
    want = jax.tree_util.tree_leaves(jax_tree,
                                     is_leaf=joq.is_block_quantized)
    got = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            got.append(node)
    walk(port_tree)
    assert len(got) == len(want)
    worst = 0.0
    for g, w in zip(got, want):
        if joq.is_block_quantized(w):
            assert isinstance(g, toq.BlockQuantized)
            assert g.static() == (tuple(w.shape), w.block_size,
                                  w.sqrt_domain)
            a, sa = _stored(g.q.numpy(), g.scale.numpy(), g.block_size)
            b, sb = _stored(np.asarray(w.q), np.asarray(w.scale),
                            w.block_size)
            # One payload step, plus what the scales' own f32 difference
            # moves a payload of at most 127 by, plus the f32 rounding of
            # the products payload·scale.
            step = (np.maximum(sa, sb) + 127 * np.abs(sa - sb)) * (1 + TOL)
        elif np.asarray(w).dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16
            a, b = _f32(g), np.asarray(w).astype(np.float32)
            step = np.abs(b).max() * 2.0 ** -7 + 1e-30
        else:
            assert g.dtype == torch.float32
            a, b = _f32(g), np.asarray(w)
            step = np.abs(b).max() * TOL + 1e-30
        worst = max(worst, float((np.abs(a - b) / step).max()))
    assert worst <= 1.0, worst
    return worst


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("fits")
    out = {}
    for dtype in ("bfloat16", "int8"):
        out[dtype] = (_jax_fit(root / f"j{dtype}", dtype),
                      _port_fit(root / f"p{dtype}", dtype))
    return out


def _port_state(jp, jstate):
    """A live JAX (params, opt_state) as the port's state, through the
    checkpoint conversion."""
    tree = ss.load_state_stream(jss.to_state_stream(
        JaxTrainState(jp, jstate, jnp.int32(0))))
    return train_state_from_jax(tree)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_optimizer_matches_jitted_optax_over_six_steps(dtype):
    """Six steps of the JAX package's jitted optimizer (GPT tiny params,
    lr 1e-2, steps 0 and 3 clip); before each, its state converted to the
    port's takes the same step with the same gradients.  Params within
    1e-6 of their scale, each moment within one quantization step of
    JAX's (the two updates differ in the last ulp, which moves a stored
    moment that lies on a rounding boundary by one step)."""
    jcfg = dataclasses.replace(JaxGPTConfig.tiny(), opt_state_dtype=dtype,
                               lr=1e-2, warmup_steps=2)
    cfg = dataclasses.replace(GPTConfig.tiny(), opt_state_dtype=dtype,
                              lr=1e-2, warmup_steps=2)
    rng = np.random.default_rng(0)
    params = _init_tree()
    jtx = JaxGPT(jcfg).configure_optimizers()
    jupdate = jax.jit(jtx.update)  # as the JAX trainer's step runs it
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jp)
    tx = GPT(cfg, device="cpu").configure_optimizers()
    for step, scale in enumerate((10.0, 0.05, 0.1, 5.0, 0.02, 0.1)):
        g = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale
                                    * 0.01).astype(np.float32), params)
        mine = _port_state(jp, jstate)
        assert int(mine.opt_state[1]["count"]) == step
        tu, topt_state = tx.update(params_from_jax(g, "cpu"),
                                   mine.opt_state, mine.params)
        tp = topt.apply_updates(mine.params, tu)
        ju, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, ju)
        want, got = _jax_by_path(jp), _port_by_path(tp)
        for k in want:
            np.testing.assert_allclose(_f32(got[k]), want[k], rtol=0,
                                       atol=1e-6 * np.abs(want[k]).max())
        for name in ("mu", "nu"):
            _moments_agree(topt_state[1][name],
                           getattr(jstate[1][0], name))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_six_step_fit_matches_the_jax_fit(fits, dtype):
    """Loss within 1e-5 (the moments are held step by step in
    :func:`test_optimizer_matches_jitted_optax_over_six_steps`: a
    trajectory's moments drift with its params).  Params within 1e-5; under int8 at all but 0.5% of a leaf's elements, and
    within 1e-4 everywhere: a gradient ~1e-7 apart (the f32 backward in
    another order) puts an element that lies on a payload's rounding
    boundary on the neighbouring step, and a second moment near zero in
    the sqrt domain then moves that element's next update by up to a
    fifth of the learning rate (3e-5 at 1.5e-4, the second step's)."""
    jt, tr = fits[dtype]
    assert tr.global_step == jt.global_step == STEPS
    assert tr.callback_metrics["train_loss"] == pytest.approx(
        jt.callback_metrics["train_loss"], abs=TOL)
    want, got = _jax_by_path(jt.state.params), _port_by_path(tr.state.params)
    assert set(want) == set(got)
    for k in want:
        diff = np.abs(_f32(got[k]) - want[k])
        if dtype == "int8":
            assert float(diff.max()) < 1e-4, k
            assert float((diff >= TOL).mean()) <= 5e-3, k
        else:
            assert float(diff.max()) < TOL, k
    adam, jadam = tr.state.opt_state[1], jt.state.opt_state[1][0]
    assert int(adam["count"]) == int(jadam.count) == STEPS
    # The state's structure is JAX's: int8 where JAX quantized, f32 small
    # leaves, bf16 both moments under "bfloat16".
    mu = adam["mu"]
    if dtype == "int8":
        assert isinstance(mu["blocks"]["qkv_w"], toq.BlockQuantized)
        assert mu["blocks"]["ln1_g"].dtype == torch.float32
        assert adam["nu"]["wte"].sqrt_domain and not mu["wte"].sqrt_domain
    else:
        assert mu["wte"].dtype == adam["nu"]["wte"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# (d) checkpoints of an int8 state
# ---------------------------------------------------------------------------

def _only_ckpt(root):
    d = os.path.join(str(root), "checkpoints")
    (name,) = os.listdir(d)
    return os.path.join(d, name)


@pytest.fixture(scope="module")
def jax_int8_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("j8")
    jt = _jax_fit(root, "int8",
                  callbacks=[JaxModelCheckpoint(monitor=None)])
    return _only_ckpt(root), jt


def test_jax_int8_checkpoint_reads_resumes_and_writes_back_bytewise(
        jax_int8_ckpt, tmp_path):
    path, jt = jax_int8_ckpt
    raw = bytes(ss.state_stream_from_file(path))
    payload = ss.load_state_stream(raw)
    # Read and written back: the same bytes.
    state = train_state_from_jax(payload["state"])
    again = dict(payload, state=train_state_to_jax(state))
    assert bytes(ss.to_state_stream(again)) == raw
    # Resumed by a port fit (its epoch already done: no step runs), the
    # state restored into the fit's own tensors and written back.
    tr = _port_fit(tmp_path, "int8", epochs=1, resume=path)
    assert tr.global_step == jt.global_step
    resumed = dict(payload, state=train_state_to_jax(tr.state))
    assert bytes(ss.to_state_stream(resumed)) == raw


def test_int8_resume_continues_like_the_jax_fit(jax_int8_ckpt, tmp_path):
    """A second epoch resumed from the JAX int8 file in each package:
    loss within 1e-5, params as the int8 fit holds them
    (:func:`test_six_step_fit_matches_the_jax_fit`)."""
    path, _ = jax_int8_ckpt
    jt = _jax_fit(tmp_path / "j", "int8", epochs=2, resume=path)
    tr = _port_fit(tmp_path / "p", "int8", epochs=2, resume=path)
    assert tr.global_step == jt.global_step == 2 * STEPS
    assert tr.callback_metrics["train_loss"] == pytest.approx(
        jt.callback_metrics["train_loss"], abs=TOL)
    want, got = _jax_by_path(jt.state.params), _port_by_path(tr.state.params)
    for k in want:
        diff = np.abs(_f32(got[k]) - want[k])
        assert float(diff.max()) < 1e-4, k
        assert float((diff >= TOL).mean()) <= 5e-3, k


# ---------------------------------------------------------------------------
# (e) the cross-policy resume
# ---------------------------------------------------------------------------

def _templates(dtype, block=None):
    """(JAX template, port template) TrainStates of the tiny params under
    ``dtype``, or int8 of another block size."""
    tree = _init_tree()
    jcfg = dataclasses.replace(JaxGPTConfig.tiny(), opt_state_dtype=dtype)
    cfg = dataclasses.replace(GPTConfig.tiny(), opt_state_dtype=dtype)
    if block is None:
        jtx, tx = (JaxGPT(jcfg).configure_optimizers(),
                   GPT(cfg, device="cpu").configure_optimizers())
    else:
        f32j = dataclasses.replace(jcfg, opt_state_dtype="float32")
        f32t = dataclasses.replace(cfg, opt_state_dtype="float32")
        jtx = optax.chain(optax.clip_by_global_norm(1.0),
                          jopt.quantize_opt_state(jgpt.gpt_adamw(f32j),
                                                  "int8", block_size=block))
        tx = topt.chain(topt.clip_by_global_norm(1.0),
                        topt.quantize_opt_state(topt.gpt_adamw(f32t),
                                                "int8", block_size=block))
    return (JaxTrainState.create(tree, jtx),
            TrainState.create(params_from_jax(tree, "cpu"), tx))


@pytest.fixture(scope="module")
def jax_default_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("jnone")
    _jax_fit(root, None, callbacks=[JaxModelCheckpoint(monitor=None)])
    return _only_ckpt(root)


@pytest.mark.parametrize("case", ["float_to_int8", "int8_to_float",
                                  "reblock", "same"])
def test_cross_policy_reconcile_equals_jax(case, jax_default_ckpt,
                                           jax_int8_ckpt):
    src = jax_default_ckpt if case == "float_to_int8" else jax_int8_ckpt[0]
    dtype, block = {"float_to_int8": ("int8", None),
                    "int8_to_float": (None, None),
                    "reblock": ("int8", 64), "same": ("int8", None)}[case]
    jtmpl, ttmpl = _templates(dtype, block)
    jhost = jss.load_state_stream(jss.state_stream_from_file(src))["state"]
    loaded = train_state_from_jax(
        ss.load_state_stream(ss.state_stream_from_file(src))["state"])
    if case == "same":
        assert tloop._reconcile_opt_state_format(loaded, ttmpl) is loaded
        return
    with pytest.warns(UserWarning, match="opt_state_dtype change"):
        want = jloop._reconcile_opt_state_format(jhost, jtmpl)
    with pytest.warns(UserWarning, match="opt_state_dtype change"):
        got = tloop._reconcile_opt_state_format(loaded, ttmpl)
    for name in ("mu", "nu"):
        w = _jax_by_path(getattr(want.opt_state[1][0], name))
        g = _port_by_path(got.opt_state[1][name])
        assert set(w) == set(g)
        for k in w:
            assert _bits(g[k]) == _bits(w[k]), (name, k)
    # The reconciled state then restores into the template's tensors.
    tloop._restore_state(ttmpl, got)


def _bits(x):
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        return (t.reshape(-1).view(torch.uint8).numpy().tobytes(),
                str(t.dtype).replace("torch.", ""), tuple(t.shape))
    a = np.asarray(x)
    return a.tobytes(), str(a.dtype), a.shape


def test_a_port_fit_resumes_across_a_policy_change(jax_default_ckpt,
                                                   tmp_path):
    """The JAX file of the default policy resumed by an int8 port fit for
    a second epoch: it warns, converts, and trains on within 1e-5 of the
    JAX package's own cross-policy resume."""
    jt = _jax_fit(tmp_path / "j", "int8", epochs=2, resume=jax_default_ckpt)
    with pytest.warns(UserWarning, match="opt_state_dtype change"):
        tr = _port_fit(tmp_path / "p", "int8", epochs=2,
                       resume=jax_default_ckpt)
    assert tr.global_step == jt.global_step == 2 * STEPS
    assert tr.callback_metrics["train_loss"] == pytest.approx(
        jt.callback_metrics["train_loss"], abs=TOL)
    want, got = _jax_by_path(jt.state.params), _port_by_path(tr.state.params)
    for k in want:
        diff = np.abs(_f32(got[k]) - want[k])
        assert float(diff.max()) < 1e-4, k
        assert float((diff >= TOL).mean()) <= 5e-3, k
