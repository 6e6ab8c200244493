"""The port's data-parallel strategies held against the JAX package and
against the port's own one-rank fit, on the CPU over gloo.

A narrow GPT (2 layers, d 64, 4 heads, vocab 256, seq 32), global batch
8, f32 with f32 AdamW moments, 3 steps whose losses are scaled so that
the global-norm clip binds at steps 1 and 3 and not at step 2
(``torch_dist_helpers.SCALES``): a clip that took another norm than the
global one would move the later updates.  Every fit starts from the same
JAX ``init_params`` tree and draws the same numpy batches.

Tolerances.  Against the JAX package's ``LocalStrategy(mode, zero_stage)``
over the 8 CPU test devices: per-step losses within 2e-6, final params
within 2e-6 absolute.  Both take the same f32 arithmetic in another
reduction order (XLA's fused program against eager PyTorch's, and 8
devices' partial sums against 2 ranks'), ~1e-7 relative in the
gradients; AdamW's first steps normalise each element's update by its
own gradient's root mean square, so that noise reaches a param as
~lr·1e-7 and an element whose gradient sits at the scale of AdamW's eps
(1e-8) can move by up to ~lr·1e-3 (lr 3e-4); measured 4.8e-7 (one f32
ulp of the loss) and 2.9e-7.  Against the port's own ``LocalStrategy``
(one rank, the same eager arithmetic on the whole batch), where the two
ranks' halves summed by gloo are the only difference: losses within two
ulps (1e-6), params and moments within 5e-7 (measured 1.2e-7).  Every
multi-process test runs under its own time limit.
"""

import dataclasses
import functools
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.data import ArrayDataset as JaxArrayDataset
from ray_lightning_tpu.core.data import NumpyLoader as JaxNumpyLoader
from ray_lightning_tpu.core.data import TpuDataModule as JaxDataModule
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.parallel import grad_sync as jax_grad_sync
from ray_lightning_tpu.parallel import mesh as jax_mesh
from ray_lightning_tpu.parallel import sharding as jax_sharding
from ray_lightning_tpu.parallel.strategies import (
    LocalStrategy as JaxLocalStrategy,
)
from ray_lightning_tpu.utils import state_stream as jax_ss
from ray_lightning_tpu_torch.cluster.actor import RemoteError
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.convert import (
    params_from_jax, train_state_to_jax,
)
from ray_lightning_tpu_torch.models.gpt import GPTConfig
from ray_lightning_tpu_torch.models.optim import tree_leaves
from ray_lightning_tpu_torch.parallel import grad_sync, mesh, sharding
from ray_lightning_tpu_torch.parallel.sharding import leaves_with_paths
from ray_lightning_tpu_torch.parallel.strategies import (
    HorovodRayPlugin, HorovodRayStrategy, LocalStrategy, RayPlugin,
    RayShardedPlugin, RayShardedStrategy, RayStrategy,
)
from ray_lightning_tpu_torch.utils import treedef

from torch_dist_helpers import (
    ArraysDataModule, Exploding, LossLog, RankProbe, ScaledGPT,
    scaled_batches, write_marker,
)

CFG = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, seq_len=32,
           warmup_steps=2, mu_dtype="float32")
BATCH, STEPS = 8, 3
# Workers of these tests: one torch thread each (the suite runs tests in
# parallel), a short collective timeout, and each test a wall limit.
WORKER = dict(device="cpu", timeout_s=120.0,
              env_per_worker={"OMP_NUM_THREADS": "1"})
LIMIT_S = 300

FLAVORS = {
    "ray": (RayStrategy, {}, "gspmd", 0),
    # The sharded weight update: ZeRO-1's step (the gradients
    # reduce-scattered, the moments and the update sliced over the ranks).
    "ray_update": (RayStrategy, {"update_sharding": "on"}, "gspmd", 0),
    "horovod": (HorovodRayStrategy, {}, "shard_map", 0),
    "zero1": (RayShardedStrategy, {"zero_stage": 1}, "gspmd", 1),
    "zero3": (RayShardedStrategy, {"zero_stage": 3}, "gspmd", 3),
}


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread in this process too: the suite runs test files in
    parallel, and every multi-process test here adds its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def time_limit():
    """Fail the test (and tear its workers down) past LIMIT_S instead of
    letting a hung collective hold the whole suite."""
    def expire(signum, frame):
        raise TimeoutError(f"multi-process test exceeded {LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


# ---------------------------------------------------------------------------
# The same params and batches for both packages
# ---------------------------------------------------------------------------

class JaxScaledGPT(JaxGPT):
    def training_step(self, params, batch, rng):
        loss, logs = super().training_step(params, batch, rng)
        return loss * jnp.mean(batch["scale"]), logs


class JaxArrays(JaxDataModule):
    def __init__(self, arrays, batch_size):
        super().__init__()
        self.arrays, self.batch_size = arrays, batch_size

    def _loader(self):
        return JaxNumpyLoader(JaxArrayDataset(**self.arrays),
                              batch_size=self.batch_size,
                              shard_index=self.shard_index,
                              num_shards=self.num_shards)

    train_dataloader = val_dataloader = _loader


class JaxLossLog(JaxCallback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, logs, batch_idx):
        self.losses.append(float(logs["train_loss"]))


@pytest.fixture(scope="module")
def world():
    tree = jax.tree.map(np.asarray, JaxGPT(JaxGPTConfig(**CFG)).init_params(
        jax.random.PRNGKey(3)))
    return {"tree": tree,
            "arrays": scaled_batches(CFG["vocab_size"], CFG["seq_len"], BATCH,
                                     STEPS, seed=5),
            "jax": {}, "one_rank": {}}


def _flat_port(tree):
    return {"/".join(map(str, p)): t.detach().float().cpu().numpy()
            for p, t in leaves_with_paths(tree)}


def _flat_jax(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_module(world, cls=ScaledGPT):
    m = cls(GPTConfig(**CFG), device="cpu")
    m.initial_params = params_from_jax(world["tree"], "cpu")
    return m


def _port_fit(world, strategy, callbacks=(), root=".", ckpt=False):
    log = LossLog()
    tr = Trainer(strategy, max_steps=STEPS, limit_val_batches=1,
                 callbacks=[log, *callbacks], enable_checkpointing=ckpt,
                 log_every_n_steps=1, default_root_dir=str(root))
    tr.fit(_port_module(world), ArraysDataModule(world["arrays"], BATCH))
    return tr, log.losses


def _jax_fit(world, mode, zero_stage, root, update_sharding=None):
    key = (mode, zero_stage, update_sharding)
    if key not in world["jax"]:
        m = JaxScaledGPT(JaxGPTConfig(**CFG))
        m.initial_params = world["tree"]
        log = JaxLossLog()
        tr = JaxTrainer(strategy=JaxLocalStrategy(
                            mode=mode, zero_stage=zero_stage,
                            update_sharding=update_sharding),
                        max_steps=STEPS, limit_val_batches=1,
                        callbacks=[log], enable_checkpointing=False,
                        log_every_n_steps=1, default_root_dir=str(root))
        tr.fit(m, JaxArrays(world["arrays"], BATCH))
        world["jax"][key] = (_flat_jax(tr.state.params), log.losses,
                             dict(tr.callback_metrics))
    return world["jax"][key]


def _one_rank_fit(world, mode, zero_stage):
    key = (mode, zero_stage)
    if key not in world["one_rank"]:
        tr, losses = _port_fit(world, LocalStrategy(
            device="cpu", mode=mode, zero_stage=zero_stage))
        world["one_rank"][key] = (tr, losses)
    return world["one_rank"][key]


def _max_diff(got, want):
    assert set(got) == set(want)
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


# ---------------------------------------------------------------------------
# The flavors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flavor", sorted(FLAVORS))
def test_two_rank_fit_matches_jax_and_one_rank(flavor, world, tmp_path,
                                               time_limit):
    """Each flavor's two-rank gloo fit: per-step losses and final params
    against the JAX package's fit and, more tightly, the port's one-rank
    fit; every rank saw its session rank and the world in its callbacks
    (``RankProbe``); under ZeRO each rank holds its slices (1/2 of every
    sharded leaf of the moments, and of the params under stage 3); the
    default checkpoint of the ZeRO-3 fit, read by the JAX package's
    reader, is bitwise the gathered state the trainer adopted.  The
    sharded weight update (``update_sharding="on"``) is held against the
    JAX ``LocalStrategy(update_sharding="on")`` and, like ZeRO-1, holds
    half of every sharded moment leaf."""
    cls, kw, mode, zero = FLAVORS[flavor]
    probe_dir = tmp_path / "probe"
    probe_dir.mkdir()
    hook_dir = tmp_path / "hooks"
    hook_dir.mkdir()
    strategy = cls(num_workers=2, **kw, **WORKER,
                   init_hook=functools.partial(write_marker, str(hook_dir)))
    tr, losses = _port_fit(world, strategy, [RankProbe(str(probe_dir))],
                           root=tmp_path, ckpt=(flavor == "zero3"))
    jparams, jlosses, jmetrics = _jax_fit(world, mode, zero, tmp_path,
                                          kw.get("update_sharding"))
    one, one_losses = _one_rank_fit(world, mode, zero)

    assert tr.global_step == one.global_step == STEPS
    assert len(losses) == len(jlosses) == len(one_losses) == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=2e-6)
    np.testing.assert_allclose(losses, one_losses, rtol=0, atol=1e-6)
    got = _flat_port(tr.state.params)
    assert _max_diff(got, jparams) < 2e-6
    assert _max_diff(got, _flat_port(one.state.params)) < 5e-7
    assert _max_diff(_flat_port(tr.state.opt_state),
                     _flat_port(one.state.opt_state)) < 5e-7
    for key in ("train_loss", "val_loss"):
        assert tr.callback_metrics[key] == pytest.approx(
            jmetrics[key], abs=2e-6), key
        assert tr.callback_metrics[key] == pytest.approx(
            one.callback_metrics[key], abs=1e-6), key
    # The fleet's telemetry: both ranks' snapshots merged.
    assert tr.telemetry_report["world_size"] == 2
    assert [s["rank"] for s in tr.telemetry_report["per_rank"]] == [0, 1]
    assert len(os.listdir(hook_dir)) == 2

    records = {}
    for rank in (0, 1):
        records[rank] = eval((probe_dir / f"rank{rank}.txt").read_text())
        assert records[rank]["session_rank"] == records[rank][
            "global_rank"] == rank
        assert records[rank]["world_size"] == 2
    full = [list(t.shape) for _, t in leaves_with_paths(
        params_from_jax(world["tree"], "cpu"))]
    dims = [sharding.shard_leaf_spec(s, 2) for s in full]
    for rank in (0, 1):
        held = records[rank]["params"]
        if zero == 3:
            for shape, h, d in zip(full, held, dims):
                want = list(shape)
                if d is not None:
                    want[d] //= 2
                assert h == want
            n_full = sum(np.prod(s) for s, d in zip(full, dims)
                         if d is not None)
            n_held = sum(np.prod(h) for h, d in zip(held, dims)
                         if d is not None)
            assert n_held * 2 == n_full
        else:
            assert held == full
        moments = [np.prod(s) for s in records[rank]["opt"]]
        one_moments = [int(t.numel())
                       for t in tree_leaves(one.state.opt_state)]
        if zero or flavor == "ray_update":
            assert sum(moments) < 0.6 * sum(one_moments)
        else:
            assert moments == one_moments
        # Every slice owns its memory: no view keeps a whole leaf alive.
        assert records[rank]["storage"] == records[rank]["elements"]

    if flavor == "zero3":
        path = tr.best_model_path
        assert path and os.path.exists(path)
        payload = jax_ss.load_state_stream(jax_ss.state_stream_from_file(
            path))
        want = jax.tree_util.tree_leaves(payload["state"])
        mine = treedef.flatten(train_state_to_jax(tr.state))[1]
        assert len(want) == len(mine)
        for a, b in zip(want, mine):
            np.testing.assert_array_equal(np.asarray(a),
                                          b.detach().cpu().numpy())


def test_validate_and_predict_at_two_ranks_equal_one_rank(world, time_limit):
    """``validate`` and ``predict`` on two ranks from the same fitted
    params.  A rank's logs are averaged over the ranks, so a log that is
    a mean over the rows (``val_loss``) is the one-rank value, and one
    that is not (``val_ppl = exp(loss)`` of the batch) is derived from
    that mean (``GPT.derive_logs``), not averaged over the ranks' halves:
    it too is the one-rank value, and not the half-batch runs' mean.  The
    predictions come back in the loader's row order."""
    one, _ = _one_rank_fit(world, "gspmd", 0)

    def local(batch_size):
        tr = Trainer(LocalStrategy(device="cpu"), enable_checkpointing=False,
                     limit_val_batches=2 * BATCH // batch_size)
        tr.state = one.state
        return tr, ArraysDataModule(world["arrays"], batch_size)

    whole, dm = local(BATCH)
    want = whole.validate(_port_module(world), dm)
    want_rows = whole.predict(_port_module(world), dm)
    halves, half_dm = local(BATCH // 2)
    want_half = halves.validate(_port_module(world), half_dm)
    remote = Trainer(RayStrategy(num_workers=2, **WORKER),
                     limit_val_batches=2, enable_checkpointing=False)
    remote.state = one.state
    got = remote.validate(_port_module(world), dm)
    assert set(got) == set(want) == {"val_loss", "val_ppl"}
    assert got["val_loss"] == pytest.approx(want["val_loss"], rel=1e-6)
    assert got["val_loss"] == pytest.approx(want_half["val_loss"], rel=1e-6)
    assert got["val_ppl"] == pytest.approx(want["val_ppl"], rel=1e-6)
    assert got["val_ppl"] != pytest.approx(want_half["val_ppl"], rel=1e-6)
    rows = remote.predict(_port_module(world), dm)
    assert rows.shape == want_rows.shape == (BATCH * STEPS, CFG["seq_len"])
    np.testing.assert_array_equal(rows, want_rows)


def test_worker_exception_comes_back_with_its_traceback(tmp_path,
                                                         time_limit):
    strategy = RayStrategy(num_workers=1, **WORKER)
    tr = Trainer(strategy, max_steps=1, enable_checkpointing=False,
                 default_root_dir=str(tmp_path))
    arrays = scaled_batches(CFG["vocab_size"], CFG["seq_len"], BATCH, 1, 0)
    with pytest.raises(RemoteError, match="worker-side boom") as err:
        tr.fit(Exploding(GPTConfig(**CFG), device="cpu"),
               ArraysDataModule(arrays, BATCH))
    assert "Traceback" in err.value.remote_traceback
    assert "configure_optimizers" in err.value.remote_traceback
    assert strategy._workers == []  # torn down


# ---------------------------------------------------------------------------
# Plans held leaf by leaf against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world_size", [1, 2, 4, 3])
def test_shard_leaf_rule_equals_jax(world_size):
    """The ZeRO leaf rule on every GPT leaf (and on shapes that exercise
    the ties, the size floor and no divisible dim) names the dim the JAX
    ``shard_leaf_spec`` puts the axis at."""
    params = params_from_jax(jax.tree.map(np.asarray, JaxGPT(
        JaxGPTConfig(**CFG)).init_params(jax.random.PRNGKey(0))), "cpu")
    shapes = [tuple(t.shape) for _, t in leaves_with_paths(params)]
    shapes += [(64, 64), (4096,), (4095,), (7, 1024), (3, 5, 7, 11 * 13),
               (), (2, 2048), (2048, 2), (12, 768, 2304)]
    sharded = 0
    for shape in shapes:
        spec = jax_sharding.shard_leaf_spec(shape, world_size, "data")
        want = spec.index("data") if "data" in tuple(spec) else None
        assert sharding.shard_leaf_spec(shape, world_size) == want, shape
        sharded += want is not None
    assert sharded >= 3


@pytest.mark.parametrize("bucket_mb", [4.0, 0.05, 0.001])
def test_bucket_plan_equals_jax(bucket_mb):
    """The bucket plan over the GPT grads (in JAX tree order) is the JAX
    ``build_bucket_plan``'s, bucket for bucket."""
    jtree = JaxGPT(JaxGPTConfig(**CFG)).init_params(jax.random.PRNGKey(0))
    nbytes = int(bucket_mb * 2 ** 20)
    want = jax_grad_sync.build_bucket_plan(jtree, 2, bucket_bytes=nbytes)
    tree = params_from_jax(jax.tree.map(np.asarray, jtree), "cpu")
    leaves = tree_leaves(tree)
    order = grad_sync.jax_order(tree)
    got = grad_sync.build_bucket_plan(
        [tuple(leaves[i].shape) for i in order], 2, bucket_bytes=nbytes)
    assert [dataclasses.astuple(b) for b in got.buckets] == [
        dataclasses.astuple(b) for b in want.buckets]
    assert got.num_buckets > (1 if bucket_mb < 1 else 0)
    assert (got.total_elems, got.total_padded, got.full_width_bytes) == (
        want.total_elems, want.total_padded, want.full_width_bytes)
    assert [tuple(leaves[i].shape) for i in order] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jtree)]


@pytest.mark.parametrize("axes,n", [
    (None, 4), ({"data": -1}, 8), ({"data": 2, "fsdp": -1}, 8),
    ({"fsdp": 4}, 4), ({"data": 3}, 4), ({"data": -1, "fsdp": 3}, 8),
    ({"data": 2, "fsdp": 2}, 4)])
def test_mesh_spec_resolve_equals_jax(axes, n):
    try:
        want = jax_mesh.MeshSpec(axes).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            mesh.MeshSpec(axes).resolve(n)
        return
    assert mesh.MeshSpec(axes).resolve(n) == want
    layout = mesh.build_mesh(mesh.MeshSpec(axes), n)
    assert layout.sizes == want and layout.world_size == n


def test_mesh_refuses_model_axes_and_two_minus_ones():
    # The model axes are taken (tests/test_torch_model_parallel.py); the
    # pipeline axis raises, naming the port's pipelines (pipeline_apply
    # over a process group, MpmdStrategy), and an unknown axis raises.
    with pytest.raises(NotImplementedError, match="MpmdStrategy"):
        mesh.build_mesh(mesh.MeshSpec({"data": 2, "pipe": 2}), 4)
    with pytest.raises(ValueError, match="unknown mesh axes"):
        mesh.build_mesh(mesh.MeshSpec({"data": 2, "model": 2}), 4)
    with pytest.raises(ValueError, match="Only one axis"):
        mesh.MeshSpec({"data": -1, "fsdp": -1})
    with pytest.raises(NotImplementedError, match="pipeline_apply"):
        RayStrategy(num_workers=2, mesh_axes={"pipe": 2}, **WORKER)
    layout = mesh.build_mesh(mesh.MeshSpec({"data": 2, "tensor": 2}), 4)
    assert layout.model_axes == ("tensor",)
    # Rank r's rows follow its data coordinate: the tensor ranks share.
    assert [layout.data_coord(r) for r in range(4)] == [
        (0, 2), (0, 2), (1, 2), (1, 2)]
    assert RayShardedStrategy(num_workers=4, zero_stage=3,
                              mesh_axes={"data": 2, "fsdp": 2},
                              **WORKER).world_size == 4
    assert RayShardedStrategy(num_workers=4, mesh_axes={"fsdp": 2,
                                                        "tensor": 2},
                              **WORKER).world_size == 4
    assert RayStrategy(num_workers=4, mesh_axes={"data": 2, "sp": 2},
                       **WORKER).world_size == 4


def test_loader_shards_equal_jax():
    """A rank's rows are its contiguous slice of each global batch, as the
    JAX loader cuts them; a batch that does not split raises with the JAX
    loader's message."""
    from ray_lightning_tpu.core.data import NumpyLoader as JL
    from ray_lightning_tpu_torch.core.data import ArrayDataset, NumpyLoader

    x = np.arange(48, dtype=np.float32).reshape(24, 2)
    for rank in range(4):
        port = NumpyLoader(ArrayDataset(x=x), batch_size=8, shuffle=True)
        port.set_shard(rank, 4)
        ref = JL(JaxArrayDataset(x=x), batch_size=8, shuffle=True)
        ref.set_shard(rank, 4)
        port.set_epoch(1)
        ref.set_epoch(1)
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a["x"], b["x"])
        full = next(iter(NumpyLoader(ArrayDataset(x=x), batch_size=8)))
        np.testing.assert_array_equal(
            full["x"][2 * rank:2 * rank + 2],
            next(iter(NumpyLoader(ArrayDataset(x=x), batch_size=8,
                                  shard_index=rank, num_shards=4)))["x"])
    with pytest.raises(ValueError) as port_err:
        NumpyLoader(ArrayDataset(x=x), batch_size=8).set_shard(0, 3)
    with pytest.raises(ValueError) as jax_err:
        JL(JaxArrayDataset(x=x), batch_size=8).set_shard(0, 3)
    assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# The strategies' surface
# ---------------------------------------------------------------------------

def test_resource_matrix_aliases_and_plugins():
    s = RayStrategy(num_workers=2, num_cpus_per_worker=4, **WORKER)
    assert s.num_cpus_per_worker == 4 and s.world_size == 2
    s = RayStrategy(num_workers=2, resources_per_worker={"CPU": 2, "GPU": 0},
                    timeout_s=60)
    assert s.num_cpus_per_worker == 2 and not s.use_gpu
    assert (s.device, s.backend) == ("cpu", "gloo")
    s = RayStrategy(num_workers=1, resources_per_worker={"custom": 1.0},
                    **WORKER)
    assert s.additional_resources_per_worker == {"custom": 1.0}
    with pytest.raises(ValueError, match="num_workers"):
        RayStrategy(num_workers=0, **WORKER)
    assert (RayPlugin, HorovodRayPlugin, RayShardedPlugin) == (
        RayStrategy, HorovodRayStrategy, RayShardedStrategy)
    assert (RayStrategy.mode, HorovodRayStrategy.mode) == ("gspmd",
                                                           "shard_map")
    plugin = RayPlugin(num_workers=2, **WORKER)
    assert Trainer(plugins=[object(), plugin]).strategy is plugin
    assert isinstance(Trainer(strategy=LocalStrategy(device="cpu"),
                              plugins=[plugin]).strategy, LocalStrategy)


def test_zero_stage_two_warns_with_the_jax_words():
    from ray_lightning_tpu.parallel.strategies import (
        RayShardedStrategy as JaxSharded,
    )

    with pytest.warns(UserWarning) as port_w:
        s = RayShardedStrategy(num_workers=2, zero_stage=2, **WORKER)
    with pytest.warns(UserWarning) as jax_w:
        JaxSharded(num_workers=2, zero_stage=2)
    assert s.zero_stage == 1
    assert str(port_w[0].message) == str(jax_w[0].message)
    assert RayShardedStrategy(**WORKER).zero_stage == 1
    with pytest.raises(ValueError, match="zero_stage"):
        RayShardedStrategy(zero_stage=4, **WORKER)
    # LocalStrategy checks its flavor knobs, and they change nothing.
    with pytest.raises(ValueError, match="mode"):
        LocalStrategy(device="cpu", mode="pmap")
    with pytest.raises(ValueError, match="zero_stage"):
        LocalStrategy(device="cpu", zero_stage=5)


@pytest.mark.parametrize("kwargs,where", [
    ({"elastic_grow_after_s": 1.0}, "item 6"),
    ({"RLT_ELASTIC_GROW_AFTER_S": "2.5"}, "item 6"),
    ({"monitor": {"hang_intervals": 2}}, "item 6"),
    ({"RLT_BACKEND": "ray"}, "item 6"),
])
def test_later_slices_raise_naming_roadmap(kwargs, where, monkeypatch):
    env = [name for name in kwargs if name.startswith("RLT_")]
    for name in env:
        monkeypatch.setenv(name, kwargs.pop(name))
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {where}"):
        s = RayStrategy(num_workers=1, **{**WORKER, **kwargs})
        s.setup()
    for name in env:
        monkeypatch.delenv(name)
    # Their inert values pass, and the restart governance is ported.
    RayStrategy(num_workers=1, max_restarts=0, restart_every_n_epochs=1,
                restart_window_s=3600, restart_backoff_s=1,
                restart_backoff_max_s=60, update_sharding="off",
                grad_overlap_segments=None, grad_comm="full", **WORKER)
    RayStrategy(num_workers=2, max_restarts=1, restart_every_n_epochs=2,
                restart_window_s=60.0, restart_backoff_s=5,
                restart_backoff_max_s=10.0, elastic_min_workers=1,
                elastic_capacity_fn=lambda: 1, **WORKER)


@pytest.mark.parametrize("kwargs", [
    {"update_sharding": "on"},
    {"grad_overlap_segments": 2},
    {"grad_comm": "int8_ef"},
    {"grad_comm": {"mode": "int8"}},
])
def test_wire_knobs_are_accepted_and_resolve_as_jax(kwargs):
    """The gradient wire's knobs (once raising as later slices) are taken
    by every strategy and the Trainer, validated as the JAX package
    validates them, and handed to the fit as it hands them."""
    from ray_lightning_tpu.core import loop as jax_loop
    from ray_lightning_tpu.parallel import overlap as jax_overlap
    from ray_lightning_tpu_torch.core import loop
    from ray_lightning_tpu_torch.parallel import overlap

    (name, value), = kwargs.items()
    for cls, kw in ((RayStrategy, {}), (HorovodRayStrategy, {}),
                    (RayShardedStrategy, {"zero_stage": 1})):
        s = cls(num_workers=2, **kw, **WORKER, **kwargs)
        got = getattr(s, name)
        if name == "grad_comm":
            assert dataclasses.asdict(got) == dataclasses.asdict(
                jax_grad_sync.GradCommConfig.coerce(value))
        else:
            assert got == value
    local = LocalStrategy(device="cpu", **kwargs)
    if name == "update_sharding":
        assert loop._normalize_update_sharding(value) == \
            jax_loop._normalize_update_sharding(value)
        tr = Trainer(local, update_sharding=value, enable_checkpointing=False)
        assert tr.config.update_sharding == value
    elif name == "grad_overlap_segments":
        assert overlap.normalize_grad_overlap(value) == \
            jax_overlap.normalize_grad_overlap(value)
        tr = Trainer(local, grad_overlap_segments=value,
                     enable_checkpointing=False)
        assert tr.config.grad_overlap_segments == value
    else:
        assert local.grad_comm.mode == jax_grad_sync.GradCommConfig.coerce(
            value).mode


def test_backend_is_explicit_and_nccl_ranks_fit_the_cards(monkeypatch):
    """No silent switch: NCCL is the card workers' default, gloo the CPU
    workers'; NCCL with more ranks than cards raises before any worker
    is spawned, naming gloo; NCCL on CPU workers raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    s = RayStrategy(num_workers=1)
    assert (s.device, s.backend) == ("cuda", "nccl")
    with pytest.raises(ValueError, match="backend='gloo'"):
        RayStrategy(num_workers=2)
    with pytest.raises(ValueError, match="backend='gloo'"):
        RayShardedStrategy(num_workers=2, backend="nccl", zero_stage=3)
    s = RayStrategy(num_workers=2, backend="gloo")
    assert (s.device, s.backend, s._workers) == ("cuda", "gloo", [])
    with pytest.raises(ValueError, match="needs card workers"):
        RayStrategy(num_workers=1, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        RayStrategy(num_workers=1, backend="mpi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RayStrategy(num_workers=1)


def test_megastep_is_off_under_a_process_group():
    """Megastep under a strategy's process group: over NCCL on the card a
    stride is captured with its collectives (auto is 8, the JAX
    accelerator rule, and K > 1 is taken); over gloo on the card it stays
    off (auto is 1) and K > 1 raises, naming gloo's collectives, which a
    CUDA graph cannot capture; on CPU workers K > 1 runs eagerly (auto 1,
    as on one CPU device)."""
    from ray_lightning_tpu_torch.core.loop import FitConfig, _resolve_megastep

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert _resolve_megastep(FitConfig(megastep="auto"), cuda) == 8
    assert _resolve_megastep(FitConfig(megastep="auto"), cuda, "nccl") == 8
    assert _resolve_megastep(FitConfig(megastep=4), cuda, "nccl") == 4
    assert _resolve_megastep(FitConfig(megastep="auto"), cuda, "gloo") == 1
    assert _resolve_megastep(FitConfig(megastep="off"), cuda, "gloo") == 1
    assert _resolve_megastep(FitConfig(megastep=1), cuda, "gloo") == 1
    with pytest.raises(NotImplementedError,
                       match="gloo's cannot be captured"):
        _resolve_megastep(FitConfig(megastep=4), cuda, "gloo")
    assert _resolve_megastep(FitConfig(megastep="auto"), cpu, "gloo") == 1
    assert _resolve_megastep(FitConfig(megastep=4), cpu, "gloo") == 4


def _spec_dim(spec) -> object:
    dims = [i for i, e in enumerate(spec) if e is not None]
    return dims[0] if dims else None


def test_int8_moments_under_zero_raise():
    """(Once the refusal of int8 moments under ZeRO; now their layout.)
    An int8 moment's payload and scale shard as the JAX package's
    ``state_shardings_for_module`` shards them over a 2-device ``data``
    mesh (``shard_leaf_spec`` of each 1-D leaf: no param twin), leaf for
    leaf; a rank's slices of the state are its runs (the payload's run
    marked on its node, ``BlockQuantized.shard``), and gathered back they
    are the whole state, bitwise."""
    from jax.sharding import Mesh

    from ray_lightning_tpu.core.module import TrainState as JaxTrainState
    from ray_lightning_tpu.ops import optim_quant as joq

    jmodule = JaxGPT(JaxGPTConfig(**{**CFG, "opt_state_dtype": "int8"}))
    jtree = jmodule.init_params(jax.random.PRNGKey(0))
    jstate = JaxTrainState.create(jtree, jmodule.configure_optimizers())
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    specs = jax_sharding.state_shardings_for_module(jmodule, jstate, mesh,
                                                    zero_stage=1)

    def quantized(state, spec_tree):
        nodes = jax.tree_util.tree_leaves(
            state.opt_state, is_leaf=lambda x: isinstance(
                x, joq.BlockQuantized))
        shs = jax.tree_util.tree_leaves(
            spec_tree.opt_state, is_leaf=lambda x: isinstance(
                x, joq.BlockQuantized))
        return sorted(
            (tuple(n.shape), n.sqrt_domain, _spec_dim(sq.spec),
             _spec_dim(ss.spec))
            for n, (sq, ss) in zip(
                [n for n in nodes if isinstance(n, joq.BlockQuantized)],
                [(s.q, s.scale) for s in shs
                 if isinstance(s, joq.BlockQuantized)]))

    want = quantized(jstate, specs)
    tree = params_from_jax(jax.tree.map(np.asarray, jtree), "cpu")
    m = ScaledGPT(GPTConfig(**{**CFG, "opt_state_dtype": "int8"}),
                  device="cpu")
    full = m.configure_optimizers().init(tree)
    plan = sharding.ZeroPlan(tree, 1, 0, 2)
    dims = plan.opt_dims(full, sharded=False)
    nodes = [bq for _, bq in sharding._quantized_nodes(full)]
    got = sorted((bq.shape, bq.sqrt_domain,
                  plan._codec_dim(bq, True), plan._codec_dim(bq, False))
                 for bq in nodes)
    assert want and got == want
    assert len(dims) == len(tree_leaves(full))
    parts = [sharding.ZeroPlan(tree, 1, r, 2).shard_opt_state(full)
             for r in (0, 1)]
    for i, (_, whole) in enumerate(sharding._quantized_nodes(full)):
        runs = [list(sharding._quantized_nodes(p))[i][1] for p in parts]
        c = whole.q.numel() // 2
        assert [bq.shard.start for bq in runs] == [0, c]
        assert torch.equal(torch.cat([bq.q for bq in runs]), whole.q)
        scale_dim = plan._codec_dim(whole, False)
        assert torch.equal(torch.cat([bq.scale for bq in runs])
                           if scale_dim == 0 else runs[1].scale, whole.scale)
        assert all(bq.shard.scale_sharded == (scale_dim == 0) for bq in runs)


@pytest.mark.parametrize("flavor", ["ray", "zero3"])
def test_lora_with_accumulation_on_two_ranks_equals_one(flavor, tmp_path,
                                                        time_limit):
    """LoRA under a strategy, two micro-batches an update: only the
    adapters sync and train (the frozen base's ``known_zeros`` skip the
    buckets, the reduce-scatter and the clip's norm); the base comes back
    bitwise its init and the adapters within the flavor tests' 5e-7 of
    the one-rank fit (their moments and accumulators likewise)."""
    cls, kw, mode, zero = FLAVORS[flavor]
    cfg = GPTConfig(**{**CFG, "lora_rank": 4})
    arrays = scaled_batches(CFG["vocab_size"], CFG["seq_len"], BATCH, STEPS,
                            seed=7)

    def fit(strategy):
        tr = Trainer(strategy, max_epochs=2, accumulate_grad_batches=2,
                     limit_val_batches=0, enable_checkpointing=False,
                     default_root_dir=str(tmp_path))
        tr.fit(ScaledGPT(cfg, device="cpu"), ArraysDataModule(arrays, BATCH))
        return tr

    two = fit(cls(num_workers=2, **kw, **WORKER))
    one = fit(LocalStrategy(device="cpu", mode=mode, zero_stage=zero))
    # 3 micro-batches an epoch: one full window and a flushed partial one.
    assert two.global_step == one.global_step == 4
    init = _flat_port(ScaledGPT(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0)))
    got, want = _flat_port(two.state.params), _flat_port(one.state.params)
    base = [k for k in want if "lora" not in k]
    for k in base:
        np.testing.assert_array_equal(got[k], init[k])
    adapters = [k for k in want if "lora" in k]
    assert adapters and max(float(np.abs(got[k] - want[k]).max())
                            for k in adapters) < 5e-7
    assert max(float(np.abs(got[k] - init[k]).max()) for k in adapters
               if k.endswith("_b")) > 1e-4
    assert _max_diff(_flat_port(two.state.opt_state),
                     _flat_port(one.state.opt_state)) < 5e-7


def test_zero3_resumes_a_one_rank_checkpoint(world, tmp_path, time_limit):
    """A checkpoint of a one-rank fit resumed on two ZeRO-3 ranks (the
    full state restored, then sliced) for a second epoch: within 5e-7 of
    the straight two-epoch fit on one rank."""
    dm = ArraysDataModule(world["arrays"], BATCH)

    def fit(strategy, epochs, resume=None, root="a"):
        tr = Trainer(strategy, max_epochs=epochs, limit_val_batches=0,
                     default_root_dir=str(tmp_path / root),
                     resume_from_checkpoint=resume)
        tr.fit(_port_module(world), dm)
        return tr

    first = fit(LocalStrategy(device="cpu"), 1, root="first")
    resumed = fit(RayShardedStrategy(num_workers=2, zero_stage=3, **WORKER),
                  2, resume=first.best_model_path, root="resumed")
    straight = fit(LocalStrategy(device="cpu"), 2, root="straight")
    assert resumed.global_step == straight.global_step == 2 * STEPS
    assert resumed.epochs_run == 2
    assert _max_diff(_flat_port(resumed.state.params),
                     _flat_port(straight.state.params)) < 5e-7
    assert _max_diff(_flat_port(resumed.state.opt_state),
                     _flat_port(straight.state.opt_state)) < 5e-7
