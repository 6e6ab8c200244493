"""The port's gradient wire held against the JAX package on the CPU: the
int8 codec and all-reduce (``ops/collective_quant.py``), the bucket and
overlap plans and ``GradSync`` (``parallel/grad_sync.py``,
``parallel/overlap.py``), the sharded weight update, and their fits.

The narrow GPT of ``tests/test_torch_strategies.py`` (2 layers, d 64, 4
heads, vocab 256, seq 32) from one JAX ``init_params`` tree.

Tolerances.
* The codec and the reference all-reduce against the JAX ones, compiled
  (``jax.jit``, as the JAX island always runs): bitwise, at n = 2, 3, 4.
  XLA computes ``amax / 127`` as a product with f32(1/127) and fuses
  each ``acc + q·s`` and ``v - q·s``; the port does the same (eager JAX's
  division differs from it by one ulp of a scale in a few blocks).
* The port's gloo collective against its reference, and its
  ``GradSync`` against the reference applied to the ranks' own partials:
  bitwise (the same f32 operations in the same order).
* Three synced steps at fixed params (the residual threaded) against the
  JAX island (``maybe_build_grad_sync(...).build_synced_grad_fn()`` on a
  mesh of the first n CPU devices), n = 2 and 3: the two packages' local
  gradients differ by ~1e-7 relative (another reduction order), so a code
  may flip where its value sits at a rounding tie.  Held: at least 99% of
  the elements of the synced gradients and of each rank's residual row
  within 1e-6 of the bucket's absmax, none off by more than one
  quantization step a phase (the larger phase-1 scale of the ranks'
  partials plus the phase-2 scale: ``(max|partial| + max|reduced|) /
  127``); the loss within 1e-6.  Measured at these inputs: at most
  1.3e-4 of the elements beyond 1e-6 of the absmax (codes that flipped at
  a tie), the largest difference 0.12 of that bound.
* Fits on two gloo ranks, 12 steps at lr 3e-3: ``int8_ef`` within 1% of
  the full-width final loss, ``int8`` within 10% (the JAX tests' bounds),
  with and without the taps, under accumulation and under ZeRO-1; the
  ranks' final params bitwise equal.  Measured: 0.9e-5 to 4.3e-5
  relative.

Every multi-process fixture runs under its own time limit; the workers
are spawned once per fixture (three for the wire checks, two for the
fits) and every fit of this file reuses the two.
"""

import contextlib
import dataclasses
import signal
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.ops import collective_quant as jcq
from ray_lightning_tpu.parallel import grad_sync as jgs
from ray_lightning_tpu.parallel import overlap as jovl
from ray_lightning_tpu.core import loop as jloop
from ray_lightning_tpu.core.module import TpuModule as JaxTpuModule
from ray_lightning_tpu.utils.jax_compat import shard_map
from ray_lightning_tpu.utils import state_stream as jax_ss
from ray_lightning_tpu_torch.core.loop import (
    FitConfig, _resolve_update_sharding,
)
from ray_lightning_tpu_torch.core.module import TrainModule, TrainState
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
from ray_lightning_tpu_torch.models.optim import tree_leaves, tree_map
from ray_lightning_tpu_torch.ops import collective_quant as cq
from ray_lightning_tpu_torch.parallel import grad_sync as gs_mod
from ray_lightning_tpu_torch.parallel import overlap as ovl
from ray_lightning_tpu_torch.parallel.step_fns import loss_and_grads
from ray_lightning_tpu_torch.parallel.strategies import (
    LocalStrategy, RayShardedStrategy, RayStrategy,
)
from ray_lightning_tpu_torch.telemetry.runtime import Telemetry

import torch_dist_helpers as helpers
from torch_dist_helpers import ArraysDataModule, LossLog

CFG = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, seq_len=32,
           warmup_steps=2, mu_dtype="float32")
FIT_CFG = dict(CFG, lr=3e-3)
WORKER = dict(device="cpu", timeout_s=120.0,
              env_per_worker={"OMP_NUM_THREADS": "1"})
LIMIT_S = 300
SEGMENTS = 2
ROWS = 6            # a global batch: 3 rows a rank at n = 2, 2 at n = 3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _limit(seconds):
    """Fail (and tear the workers down) past ``seconds`` instead of
    letting a hung collective hold the suite."""
    def expire(signum, frame):
        raise TimeoutError(f"multi-process test exceeded {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, JaxGPT(JaxGPTConfig(**CFG)).init_params(
        jax.random.PRNGKey(3)))


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


def _flat_jax(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# The codec and the reference all-reduce
# ---------------------------------------------------------------------------

def _vector(seed, n_blocks, block, ragged):
    """Magnitudes over five decades, an all-zero block, and (``ragged``)
    a tail shorter than a block, zero-padded as the buckets pad."""
    rng = np.random.default_rng(seed)
    size = n_blocks * block - (block // 3 if ragged else 0)
    v = (rng.standard_normal(size) * np.logspace(-3, 2, size)).astype(
        np.float32)
    v[block:2 * block] = 0.0
    return np.pad(v, (0, n_blocks * block - size))


@pytest.mark.parametrize("seed,block,ragged", [
    (0, 256, False), (1, 256, True), (2, 32, True), (3, 7, False)])
def test_codec_is_bitwise_the_compiled_jax_codec(seed, block, ragged):
    v = _vector(seed, 40, block, ragged)
    quant = jax.jit(jcq.quantize_block_scaled, static_argnums=1)
    deq = jax.jit(jcq.dequantize_block_scaled, static_argnums=2)
    jq, js = quant(jnp.asarray(v), block)
    q, s = cq.quantize_block_scaled(torch.from_numpy(v), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        cq.dequantize_block_scaled(q, s, block).numpy(),
        np.asarray(deq(jq, js, block)))
    assert s.numpy()[1] == 1.0 and not q.numpy()[block:2 * block].any()
    # Eager JAX divides by 127: at most one ulp of a scale apart.
    _, es = jcq.quantize_block_scaled(jnp.asarray(v), block)
    es = np.asarray(es)
    assert np.all(np.abs(es - s.numpy()) <= np.spacing(es))


def test_codec_rounds_halves_to_even_and_clips():
    v = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -127.0])
    q, s = cq.quantize_block_scaled(v, 8)
    jq, _ = jax.jit(jcq.quantize_block_scaled, static_argnums=1)(
        jnp.asarray(v.numpy()), 8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.tolist()[1:6] == [0, 2, 2, 0, -2]


@pytest.mark.parametrize("n", [2, 3, 4])
def test_reference_all_reduce_is_bitwise_the_jax_one(n):
    """``int8_all_reduce_reference`` against the JAX ``int8_all_reduce``
    under ``shard_map`` on the first n CPU devices: every rank's reduced
    vector and error share, bit for bit."""
    block = 32
    parts = np.stack([_vector(10 * n + r, 7 * n, block, r == 0)
                      for r in range(n)])

    def body(v):
        r, e = jcq.int8_all_reduce(v[0], ("data",), n, block,
                                   want_error=True)
        return r[None], e[None]

    fn = jax.jit(shard_map(body, mesh=_mesh(n), in_specs=P("data"),
                           out_specs=(P("data"), P("data")),
                           check_vma=False))
    jr, je = (np.asarray(x) for x in fn(jnp.asarray(parts)))
    got = cq.int8_all_reduce_reference([torch.from_numpy(p) for p in parts],
                                       block)
    for r, (red, err) in enumerate(got):
        np.testing.assert_array_equal(red.numpy(), jr[r])
        np.testing.assert_array_equal(err.numpy(), je[r])
    # The error shares add up to what the wire lost.
    lost = parts.astype(np.float64).sum(0) - jr[0]
    np.testing.assert_allclose(
        sum(e.numpy().astype(np.float64) for _, e in got), lost,
        atol=1e-5 * np.abs(parts).max())


# ---------------------------------------------------------------------------
# Plans against the JAX package's
# ---------------------------------------------------------------------------

def _port_params(tree):
    return params_from_jax(tree, "cpu")


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("bucket_bytes", [4 * 2 ** 20, 64 * 2 ** 10])
@pytest.mark.parametrize("mode", ["int8", "int8_ef"])
def test_bucket_plan_and_stats_equal_jax(tree, n, bucket_bytes, mode):
    cfg = {"mode": mode, "bucket_bytes": bucket_bytes, "dcn_only": False}
    want = jgs.maybe_build_grad_sync(JaxGPT(JaxGPTConfig(**CFG)), _mesh(n),
                                     cfg)
    got = gs_mod.maybe_build_grad_sync(GPT(GPTConfig(**CFG), device="cpu"),
                                       cfg, n, params=_port_params(tree))
    assert dataclasses.asdict(got.plan) == dataclasses.asdict(want.plan)
    assert got.stats() == want.stats()
    assert (got.plan.num_buckets == 1) == (bucket_bytes > 2 ** 20)
    for m in ("full", "int8", "int8_ef"):
        assert got.plan.wire_bytes_per_step(m) == \
            want.plan.wire_bytes_per_step(m)
        assert got.plan.collectives_per_step(m) == \
            want.plan.collectives_per_step(m)


DEEP = dict(CFG, n_layer=4)   # G = 3 cuts unevenly, G = n_layer + 1 clamps


@pytest.mark.parametrize("segments", [1, 2, 3, DEEP["n_layer"] + 1])
def test_overlap_plan_equals_jax(segments):
    jm = JaxGPT(JaxGPTConfig(**DEEP))
    abstract = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    want = jovl.build_overlap_plan(jm.grad_overlap_groups(abstract,
                                                          segments), 3)
    m = GPT(GPTConfig(**DEEP), device="cpu")
    params = m.init_params(torch.Generator().manual_seed(0))
    got = ovl.build_overlap_plan(m.grad_overlap_groups(params, segments), 3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.trunk_segments == min(segments, DEEP["n_layer"])
    jsync = jgs.maybe_build_grad_sync(jm, _mesh(3), {"mode": "int8_ef",
                                                     "dcn_only": False},
                                      overlap_segments=segments)
    psync = gs_mod.maybe_build_grad_sync(m, "int8_ef", 3, params=params,
                                         overlap_segments=segments)
    assert psync.stats() == jsync.stats()


# ---------------------------------------------------------------------------
# Collectives and synced steps on gloo ranks against the JAX island
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wire(tree):
    """``torch_dist_helpers.wire_rank`` on three CPU workers, then on two
    of them, each a world of its own: n -> [each rank's results]."""
    rng = np.random.default_rng(0)
    payload = {
        "block_size": 256, "bucket_bytes": 4 * 2 ** 20, "cfg": CFG,
        "tree": tree, "modes": ["int8", "int8_ef"], "segments": SEGMENTS,
        "partials": {n: np.stack([_vector(100 + 10 * n + r, 5 * n, 256,
                                          r == 1) for r in range(n)])
                     for n in (2, 3)},
        "batches": [rng.integers(0, CFG["vocab_size"],
                                 size=(ROWS, CFG["seq_len"] + 1)).astype(
                                     np.int32) for _ in range(3)],
    }
    strategy = RayStrategy(num_workers=3, **WORKER)
    with _limit(LIMIT_S):
        strategy.setup()
        try:
            results = helpers.wire_worlds(strategy._workers, payload,
                                          LIMIT_S)
        finally:
            strategy.teardown()
    return {"payload": payload, "ranks": results}


@pytest.mark.parametrize("n", [2, 3])
def test_gloo_collective_and_sync_equal_the_reference(wire, n):
    """The collective against ``int8_all_reduce_reference``, and each
    ``GradSync`` step (int8, int8_ef) against the reference applied to the
    ranks' own partials of ``loss / n``, with their residual rows: bitwise
    on every rank."""
    for rank in range(n):
        out = wire["ranks"][n][rank]
        assert out["collective_equal"]
        for mode in ("int8", "int8_ef"):
            assert [s["ref_equal"] for s in out[mode]] == [True] * 3


def _jax_island_steps(tree, batches, n, mode):
    """The JAX island's three steps at fixed params, residual threaded:
    [(flat grads, residual rows or None, loss)]."""
    mesh = _mesh(n)
    sync = jgs.maybe_build_grad_sync(JaxGPT(JaxGPTConfig(**CFG)), mesh,
                                     {"mode": mode, "dcn_only": False})
    fn = jax.jit(sync.build_synced_grad_fn())
    params = jax.device_put(tree, NamedSharding(mesh, P()))
    resid = sync.init_residual() if sync.use_ef else None
    key = jax.random.PRNGKey(0)
    out = []
    for tokens in batches:
        batch = {"tokens": jax.device_put(tokens,
                                          NamedSharding(mesh, P("data")))}
        if sync.use_ef:
            grads, logs, resid = fn(params, resid, batch, key)
        else:
            grads, logs = fn(params, batch, key)
        out.append((_flat_jax(grads),
                    None if resid is None else np.asarray(resid),
                    float(logs["loss"])))
    return out


def _hold(got, want, a1, a2, what):
    """The stated tolerance: >= 99% of the elements within 1e-6 of the
    absmax, none beyond one quantization step a phase."""
    amax = max(a1, a2)
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    step = (a1 + a2) / 127.0
    assert d.max() <= step * (1 + 1e-6), (what, d.max(), step)
    assert np.mean(d > 1e-6 * amax) <= 0.01, (what, np.mean(
        d > 1e-6 * amax))


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("mode", ["int8", "int8_ef"])
def test_three_synced_steps_match_the_jax_island(wire, tree, n, mode):
    want = _jax_island_steps(tree, wire["payload"]["batches"], n, mode)
    ranks = [wire["ranks"][n][r][mode] for r in range(n)]
    for step, (jgrads, jresid, jloss) in enumerate(want):
        mine = ranks[0][step]
        # Every rank holds the same synced gradients.
        for other in ranks[1:]:
            assert all(np.array_equal(mine["grads"][k], other[step][
                "grads"][k]) for k in mine["grads"])
        assert set(mine["grads"]) == set(jgrads)
        a1 = max(r[step]["partial_amax"] for r in ranks) * 1.01
        a2 = max(float(np.abs(v).max()) for v in jgrads.values())
        got = np.concatenate([mine["grads"][k].ravel() for k in
                              sorted(jgrads)])
        ref = np.concatenate([jgrads[k].ravel() for k in sorted(jgrads)])
        _hold(got, ref, a1, a2, f"step {step} grads")
        assert mine["loss"] == pytest.approx(jloss, abs=1e-6)
        if mode == "int8_ef":
            assert jresid.shape[0] == n
            for r in range(n):
                _hold(ranks[r][step]["resid"], jresid[r], a1, a2,
                      f"step {step} rank {r} residual")
            assert np.abs(jresid).max() > 0
        else:
            assert jresid is None and mine["resid"] is None


@pytest.mark.parametrize("n", [2, 3])
def test_overlapped_sync_equals_the_step_end_sync(wire, n):
    """The taps (G = 2: head, seg0, seg1, embed) sync each group in the
    backward to bitwise what the step-end sync over the same overlap plan
    gives, two steps with the residual threaded, on every rank."""
    for rank in range(n):
        out = wire["ranks"][n][rank]
        assert out["overlap_equal"]
        assert out["overlap_plan"][0] == SEGMENTS


class _LocalPlane(ovl.TapPlane):
    """A tap plane whose taps keep each group's local cotangent (JAX
    order) in place of syncing it."""

    def _sync(self, grp, cts):
        self.fired.add(grp.name)
        self._parts[grp.name] = [t.clone() for t in cts]


def test_full_width_segmentation_is_bitwise_neutral(tree):
    """The trunk is cut only under a tap plane: at full width (the knob
    set, no plane) the forward runs the uncut trunk, and the trunk cut in
    G row ranges under a plane computes bit for bit the loss and, group
    by group, the local gradients of the uncut trunk."""
    torch.use_deterministic_algorithms(True)
    try:
        m = GPT(GPTConfig(**CFG), device="cpu")
        params = _port_params(tree)
        tokens = np.random.default_rng(1).integers(
            0, CFG["vocab_size"], size=(4, CFG["seq_len"] + 1))
        batch = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
        m.trainer = helpers._Trainer()
        want, logs = loss_and_grads(m, params, batch, None)
        want, want_loss = helpers._flat(want), float(logs["loss"])
        got = {}
        for segs in (2, 3):
            oplan = ovl.build_overlap_plan(
                m.grad_overlap_groups(params, segs), 2)
            plane = _LocalPlane(oplan, 2, False, torch.device("cpu"))
            leaves = tree_map(lambda t: t.detach().requires_grad_(True),
                              params)
            with torch.enable_grad():
                tapped = plane.apply_entry_taps(leaves)
                m.trainer.grad_tap_plane = plane
                try:
                    loss, _ = m.training_step(tapped, batch, None)
                finally:
                    m.trainer.grad_tap_plane = None
                plane.check_consumed()
                torch.autograd.grad(loss, tree_leaves(leaves),
                                    allow_unused=True)
            grads = ovl.join_groups(leaves, oplan, plane._parts)
            got[segs] = (helpers._flat(grads), float(loss.detach()))
        m.trainer = None
    finally:
        torch.use_deterministic_algorithms(False)
    for segs in (2, 3):
        assert got[segs][1] == want_loss
        assert set(got[segs][0]) == set(want)
        assert all(np.array_equal(got[segs][0][k], want[k]) for k in want)


def _tap_plane(tree, segments=SEGMENTS):
    m = GPT(GPTConfig(**CFG), device="cpu")
    oplan = ovl.build_overlap_plan(
        m.grad_overlap_groups(_port_params(tree), segments), 2)
    return ovl.TapPlane(oplan, 2, False, torch.device("cpu")), m


def test_tap_plane_refuses_what_jax_refuses(tree):
    plane, m = _tap_plane(tree)
    params = _port_params(tree)
    sub = {k: v[:1] for k, v in params["blocks"].items()}
    with pytest.raises(ValueError, match="not in the overlap plan"):
        plane.tap("seg7", sub)
    with pytest.raises(ValueError, match="does not match the plan"):
        plane.tap("seg0", {k: v[:2] for k, v in params["blocks"].items()})
    plane.tap("seg0", sub)
    with pytest.raises(ValueError, match="consumed twice"):
        plane.tap("seg0", sub)
    plane.apply_entry_taps(params)
    with pytest.raises(ValueError, match=r"never tapped this trace: "
                                         r"\['seg1'\]"):
        plane.check_consumed()


# ---------------------------------------------------------------------------
# Downgrades and knobs, in the JAX package's words
# ---------------------------------------------------------------------------

class NoGroups(TrainModule):
    """A module that cannot be tapped (no ``grad_overlap_groups``)."""


def _words(fn):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(x.message) for x in w]


@pytest.mark.parametrize("case", ["horovod", "zero3", "no_groups",
                                  "one_rank"])
def test_downgrades_warn_with_the_jax_words(tree, case):
    cfg = {"mode": "int8_ef", "dcn_only": False}
    jm, pm = JaxGPT(JaxGPTConfig(**CFG)), GPT(GPTConfig(**CFG), device="cpu")
    params = _port_params(tree)
    kw = {"horovod": {"mode": "shard_map"}, "zero3": {"zero_stage": 3},
          "no_groups": {"overlap_segments": 2}, "one_rank": {}}[case]
    n = 1 if case == "one_rank" else 2
    if case == "no_groups":
        # The JAX GPT has groups: a module without them, in each package.
        jm = type("NoGroups", (JaxTpuModule,), {
            "init_params": lambda self, key: {
                "w": jnp.zeros((4, 4), jnp.float32)}})()
        pm = NoGroups()
        params = {"w": torch.zeros(4, 4)}
    want, jw = _words(lambda: jgs.maybe_build_grad_sync(
        jm, _mesh(n), cfg, **kw))
    got, pw = _words(lambda: gs_mod.maybe_build_grad_sync(
        pm, cfg, n, params=params, **kw))
    assert pw == jw
    assert (got is None) == (want is None)
    if case == "one_rank":
        assert got is None and pw == []
    elif case == "no_groups":
        assert got.overlap is None and "step end" in pw[0]
    else:
        assert got is None and "full width" in pw[0]


def test_a_partition_that_misses_leaves_raises_as_jax(tree):
    class Partial(GPT):
        def grad_overlap_groups(self, params, segments):
            return super().grad_overlap_groups(params, segments)[:-1]

    class JaxPartial(JaxGPT):
        def grad_overlap_groups(self, params, segments):
            return super().grad_overlap_groups(params, segments)[:-1]

    cfg = {"mode": "int8", "dcn_only": False}
    with pytest.raises(ValueError) as jerr:
        jgs.maybe_build_grad_sync(JaxPartial(JaxGPTConfig(**CFG)), _mesh(2),
                                  cfg, overlap_segments=2)
    with pytest.raises(ValueError) as perr:
        gs_mod.maybe_build_grad_sync(Partial(GPTConfig(**CFG), device="cpu"),
                                     cfg, 2, params=_port_params(tree),
                                     overlap_segments=2)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("value", [None, "int8", "int8_ef", "full",
                                   {"mode": "int8", "block_size": 64},
                                   {"bucket_bytes": 8}, "int4", 3])
def test_grad_comm_coerces_as_jax(value, monkeypatch):
    monkeypatch.setenv("RLT_GRAD_BUCKET_MB", "0.5")
    monkeypatch.setenv("RLT_GRAD_DCN_ONLY", "0")
    try:
        want = dataclasses.asdict(jgs.GradCommConfig.coerce(value))
    except (ValueError, TypeError) as e:
        with pytest.raises(type(e)) as err:
            gs_mod.GradCommConfig.coerce(value)
        assert str(err.value) == str(e)
        return
    assert dataclasses.asdict(gs_mod.GradCommConfig.coerce(value)) == want


@pytest.mark.parametrize("wire", [None, "int8_ef"])
def test_sharded_update_is_zero1s_step(tree, wire):
    """The sharded weight update builds ZeRO-1's step: at full width no
    gradient sync of its own (the step reduce-scatters onto the slices,
    the wire's bytes of the replicated update), with the int8 wire that
    wire (its output, held in full, is sliced)."""
    import types

    from ray_lightning_tpu_torch.parallel.step_fns import build_dist_step

    m = GPT(GPTConfig(**CFG), device="cpu")
    params = _port_params(tree)
    sync = (None if wire is None else gs_mod.maybe_build_grad_sync(
        m, {"mode": wire}, 2, params=params))
    dist = types.SimpleNamespace(rank=0, world_size=2)
    step = build_dist_step(m, None, dist, params, "gspmd", 0, sync,
                           shard_update=True)
    assert step.sync is sync and step.plan.stage == 1
    assert any(d is not None for d in step.plan.dims)
    plain = build_dist_step(m, None, dist, params, "gspmd", 0, None)
    assert plain.plan is None and isinstance(plain.sync, gs_mod.BucketSync)


def test_update_sharding_and_overlap_knobs_resolve_as_jax(monkeypatch):
    from ray_lightning_tpu_torch.core import loop

    for v in (None, "auto", "on", "off", "", True, False, " ON "):
        assert loop._normalize_update_sharding(v) == \
            jloop._normalize_update_sharding(v)
    for v in (None, 0, 2, "off", "", "3"):
        assert ovl.normalize_grad_overlap(v) == \
            jovl.normalize_grad_overlap(v)
    with pytest.raises(ValueError, match="update_sharding='sometimes'"):
        Trainer(LocalStrategy(device="cpu"), update_sharding="sometimes")
    with pytest.raises(ValueError, match="expected 'off'"):
        Trainer(LocalStrategy(device="cpu"), grad_overlap_segments="many")
    with pytest.raises(ValueError, match=">= 0"):
        RayStrategy(num_workers=2, grad_overlap_segments=-1, **WORKER)
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    cfg = FitConfig()
    # auto: on for eligible ranks on the card, off on the CPU and wherever
    # the flavor is not eligible.
    assert _resolve_update_sharding(cfg, 2, "gspmd", 0, cuda)
    assert not _resolve_update_sharding(cfg, 2, "gspmd", 0, cpu)
    assert not _resolve_update_sharding(cfg, 2, "shard_map", 0, cuda)
    assert not _resolve_update_sharding(cfg, 2, "gspmd", 1, cuda)
    assert not _resolve_update_sharding(cfg, None, "gspmd", 0, cuda)
    on = FitConfig(update_sharding="on")
    assert _resolve_update_sharding(on, 2, "gspmd", 0, cpu)
    monkeypatch.setenv("RLT_UPDATE_SHARDING", "off")
    assert not _resolve_update_sharding(cfg, 2, "gspmd", 0, cuda)
    assert ovl.resolve_grad_overlap(None) == 0
    monkeypatch.setenv("RLT_GRAD_OVERLAP", "2")
    assert ovl.resolve_grad_overlap(None) == 2
    assert ovl.resolve_grad_overlap("off") == 0
    # "on" on one device warns with the JAX words and stays off.
    _, pw = _words(lambda: _resolve_update_sharding(on, None, "gspmd", 0,
                                                    cpu))
    _, jw = _words(lambda: jloop._resolve_update_sharding(
        jloop.FitConfig(update_sharding="on"), None, "gspmd", 0))
    assert pw == jw and "replicated update" in pw[0]


def test_local_strategy_takes_the_knobs_at_full_width(tree, tmp_path):
    """One device: the int8 request resolves to full width with no
    warning, ``update_sharding="on"`` warns and stays off, and G = 2 with
    no tap plane leaves the trunk whole (the same loss as the plain
    fit)."""
    dm = ArraysDataModule(helpers.scaled_batches(256, 32, 8, 3, seed=5), 8)

    def fit(**kw):
        m = helpers.ScaledGPT(GPTConfig(**CFG), device="cpu")
        m.initial_params = _port_params(tree)
        tr = Trainer(LocalStrategy(device="cpu", **kw), max_steps=3,
                     limit_val_batches=0, enable_checkpointing=False,
                     default_root_dir=str(tmp_path))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tr.fit(m, dm)
        return tr, [str(x.message) for x in w]

    torch.use_deterministic_algorithms(True)
    try:
        plain, w0 = fit()
        cut, w1 = fit(grad_comm="int8_ef", grad_overlap_segments=2)
        _, w2 = fit(update_sharding="on")
    finally:
        torch.use_deterministic_algorithms(False)
    assert cut.comm_stats == plain.comm_stats == {"grad_sync_mode": "full"}
    assert w1 == [] and any("update_sharding='on'" in m for m in w2)
    assert cut.callback_metrics["train_loss"] == \
        plain.callback_metrics["train_loss"]
    meta = cut.telemetry_report["meta"]
    assert (meta["grad_sync_mode"], meta["grad_overlap_segments"],
            meta["update_sharding"]) == ("full", 2, "off")
    assert cut.state.grad_residual is None


def test_reconcile_drops_a_residual_of_another_layout(tree):
    """A residual row of another length (another world size or overlap
    layout) is dropped with the JAX warning and the
    ``grad_residual_dropped`` counter, and reset to zeros; one of this
    run's length passes untouched; without EF it is shed."""
    m = GPT(GPTConfig(**dict(CFG, n_layer=6)), device="cpu")
    params = m.init_params(torch.Generator().manual_seed(0))

    def build(segments, mode="int8_ef"):
        return gs_mod.maybe_build_grad_sync(m, mode, 8, params=params,
                                            overlap_segments=segments)

    g1, g2 = build(1), build(2)
    assert g1.plan.total_padded != g2.plan.total_padded
    tel = Telemetry.build("cheap")
    g2.register_telemetry(tel)
    stale = TrainState(params, None, 0, torch.ones(g1.plan.total_padded))
    with pytest.warns(UserWarning, match="resetting to zero"):
        out = g2.reconcile_resumed_state(stale)
    assert out.grad_residual.shape == (g2.plan.total_padded,)
    assert not out.grad_residual.any()
    assert tel.counters["grad_residual_dropped"] == 1
    good = TrainState(params, None, 0, torch.ones(g2.plan.total_padded))
    assert g2.reconcile_resumed_state(good) is good
    shed = build(0, "int8").reconcile_resumed_state(good)
    assert shed.grad_residual is None
    assert g2.reconcile_resumed_state(TrainState(params, None, 0)) \
        .grad_residual.shape == (g2.plan.total_padded,)


# ---------------------------------------------------------------------------
# Fits on two gloo ranks
# ---------------------------------------------------------------------------

class _KeptWorkers(Trainer):
    """A Trainer whose strategy's workers outlive the stage (every fit of
    this file runs on the same two workers)."""

    def _run_strategy(self, kind, *args, **kwargs):
        return self.strategy.run(kind, *args, **kwargs)


@pytest.fixture(scope="module")
def pool():
    strategy = RayStrategy(num_workers=2, **WORKER)
    with _limit(LIMIT_S):
        strategy.setup()
    yield strategy
    strategy.teardown()


@pytest.fixture(scope="module")
def fit_data():
    rng = np.random.default_rng(11)
    return {"tokens": rng.integers(0, CFG["vocab_size"], size=(
        32, CFG["seq_len"] + 1)).astype(np.int32)}


def _on_pool(pool, cls=RayStrategy, **kw):
    s = cls(num_workers=2, **WORKER, **kw)
    s._backend, s._workers = pool._backend, pool._workers
    return s


def _fit(pool, tree, data, tmp, label, cls=RayStrategy, accumulate=1,
         epochs=3, resume=None, trainer_kw=None, probe=False, **kw):
    m = GPT(GPTConfig(**FIT_CFG), device="cpu")
    m.initial_params = _port_params(tree)
    log = LossLog()
    probes = [helpers.WireProbe(label + "_wire")] if probe else []
    tr = _KeptWorkers(_on_pool(pool, cls, **kw), max_epochs=epochs,
                      accumulate_grad_batches=accumulate,
                      limit_val_batches=0, log_every_n_steps=1,
                      callbacks=[log, helpers.FinalDigest(label), *probes],
                      enable_checkpointing=False,
                      default_root_dir=str(tmp / label),
                      resume_from_checkpoint=resume, **(trainer_kw or {}))
    with _limit(LIMIT_S):
        tr.fit(m, ArraysDataModule(data, 8))
    digests = {r["digest"] for r in helpers.RECORDS[label].values()}
    assert len(helpers.RECORDS[label]) == 2 and len(digests) == 1, label
    return tr


@pytest.fixture(scope="module")
def refs(pool, tree, fit_data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("refs")
    return {"full": _fit(pool, tree, fit_data, tmp, "full"),
            "full_accum": _fit(pool, tree, fit_data, tmp, "full_accum",
                               accumulate=2)}


ARMS = {
    # arm: (strategy class, its kwargs, Trainer kwargs, accumulate,
    #       reference, relative bound)
    "int8_ef": (RayStrategy, {"grad_comm": "int8_ef"}, {}, 1, "full", 0.01),
    "int8": (RayStrategy, {"grad_comm": "int8"}, {}, 1, "full", 0.10),
    "int8_ef_overlap": (RayStrategy, {"grad_comm": "int8_ef"},
                        {"grad_overlap_segments": SEGMENTS}, 1, "full",
                        0.01),
    "int8_overlap": (RayStrategy, {"grad_comm": "int8",
                                   "grad_overlap_segments": SEGMENTS}, {},
                     1, "full", 0.10),
    "int8_ef_accum": (RayStrategy, {"grad_comm": "int8_ef"}, {}, 2,
                      "full_accum", 0.01),
    "zero1_int8_ef": (RayShardedStrategy, {"zero_stage": 1,
                                           "grad_comm": "int8_ef"}, {}, 1,
                      "full", 0.01),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_two_rank_wire_fits_hold_the_jax_bounds(arm, pool, refs, tree,
                                                fit_data, tmp_path):
    cls, kw, tkw, accum, ref_name, bound = ARMS[arm]
    tr = _fit(pool, tree, fit_data, tmp_path, arm, cls=cls,
              accumulate=accum, trainer_kw=tkw, probe=True, **kw)
    # The wire inside the fit, on both ranks: every call's probed bucket
    # bitwise its plain version, and under EF every residual slice handed
    # in the one the previous micro-step wrote.
    for counts in helpers.RECORDS[arm + "_wire"].values():
        assert counts["calls"] > 0 and counts["equal"] == counts["calls"]
        assert counts["threaded"] == counts["thread_checks"]
        assert (counts["thread_checks"] > 0) == (kw["grad_comm"] == "int8_ef")
    ref = refs[ref_name]
    want = ref.callback_metrics["train_loss"]
    got = tr.callback_metrics["train_loss"]
    assert abs(got - want) <= bound * abs(want), (got, want)
    assert got != want  # the wire rounds: not the full-width run
    assert ref.callback_metrics["train_loss"] < 5.4  # the fit learns
    assert ref.comm_stats == {"grad_sync_mode": "full"}
    stats = tr.comm_stats
    mode = kw["grad_comm"]
    assert stats["grad_sync_mode"] == mode
    assert stats["grad_sync_compression_ratio"] >= 3.5
    assert stats["grad_sync_devices"] == 2
    assert stats["grad_sync_overlap_segments"] == (
        SEGMENTS if "overlap" in arm else 0)
    assert tr.callback_metrics["grad_sync_bytes"] == stats["grad_sync_bytes"]
    report = tr.telemetry_report
    assert report["counters"]["grad_sync_bytes"]["mean"] == \
        stats["grad_sync_bytes"]
    assert "sum" not in report["counters"]["grad_sync_bytes"]
    assert report["meta"]["grad_sync_mode"] == mode
    assert report["meta"]["update_sharding"] == "off"
    assert tr.state.grad_residual is None  # never in the rank-0 package
    if "overlap" in arm:
        step_end = gs_mod.maybe_build_grad_sync(
            GPT(GPTConfig(**CFG), device="cpu"), mode, 2,
            params=_port_params(tree))
        assert abs(stats["grad_sync_bytes"] - step_end.bytes_per_step) <= \
            0.02 * step_end.bytes_per_step


def test_residual_on_resume(pool, refs, tree, fit_data, tmp_path):
    """EF → EF, EF → full and full → EF resumes, and an EF checkpoint
    resumed on one device (another world size): the checkpoint holds no
    residual (the JAX reader sees ``grad_residual`` None), a resumed EF
    run starts from a zero row, every resume trains on."""
    ef = _fit(pool, tree, fit_data, tmp_path, "ef_first", epochs=1,
              grad_comm="int8_ef")
    ckpt = str(tmp_path / "ef.ckpt")
    ef.save_checkpoint(ckpt)
    payload = jax_ss.load_state_stream(jax_ss.state_stream_from_file(ckpt))
    assert payload["state"].grad_residual is None
    plain = str(tmp_path / "plain.ckpt")
    refs["full"].save_checkpoint(plain)
    ef_ef = _fit(pool, tree, fit_data, tmp_path, "ef_ef", epochs=2,
                 resume=ckpt, grad_comm="int8_ef")
    ef_full = _fit(pool, tree, fit_data, tmp_path, "ef_full", epochs=2,
                   resume=ckpt)
    full_ef = _fit(pool, tree, fit_data, tmp_path, "full_ef", epochs=4,
                   resume=plain, grad_comm="int8_ef")
    assert ef_ef.comm_stats["grad_sync_mode"] == "int8_ef"
    assert ef_full.comm_stats == {"grad_sync_mode": "full"}
    assert full_ef.comm_stats["grad_sync_mode"] == "int8_ef"
    assert ef_ef.global_step == ef_full.global_step == 2 * ef.global_step
    assert full_ef.global_step == refs["full"].global_step + ef.global_step
    # The same checkpoint on one device: EF resolves to full width there.
    m = GPT(GPTConfig(**FIT_CFG), device="cpu")
    one = Trainer(LocalStrategy(device="cpu", grad_comm="int8_ef"),
                  max_epochs=2, limit_val_batches=0,
                  enable_checkpointing=False, resume_from_checkpoint=ckpt,
                  default_root_dir=str(tmp_path / "one"))
    one.fit(m, ArraysDataModule(fit_data, 8))
    assert one.global_step == 2 * ef.global_step
    assert one.comm_stats == {"grad_sync_mode": "full"}
    for tr in (ef_ef, ef_full, full_ef, one):
        assert np.isfinite(tr.callback_metrics["train_loss"])
