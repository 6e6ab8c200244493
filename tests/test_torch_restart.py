"""Restarts of the port's multi-GPU strategies held against the JAX
package: the restart checkpoints of the loop, the governor of
``TpuStrategy.run`` and elastic resume at another world, on the CPU.

The narrow GPT of the strategy tests (2 layers, d 64, f32 moments) with
the forged loss scales (``torch_dist_helpers.SCALES``), 2 batches of 8
rows an epoch, on two gloo ranks under ``RayShardedStrategy(zero_stage=3,
max_restarts=1)``.  The port counterparts of ``tests/test_fault_tolerance
.py`` and ``tests/test_elastic.py``:

* a fit whose rank 1 dies at epoch 1 (``torch_dist_helpers.CrashOnce``)
  restarts once and ends bitwise the uninterrupted fit (losses, params):
  the state and the callbacks' states ride the checkpoint, the rng is a
  function of (seed, micro-step) and a sum of two addends has one order;
* the JAX ``run_fit`` and the port's one-rank fit resume the port's
  two-rank directory at world 1 (accum re-derived 1 → 2) within the
  strategy tests' 2e-6 a step, with equal counters;
* the governor's paths that need no processes run against fakes of its
  attempt (``_run_once``), as the JAX package's own governor tests do;
  its pure functions equal the JAX package's on the same inputs.
"""

import os
import random
import signal
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as helpers
from ray_lightning_tpu.core import loop as jax_loop
from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.core.data import ArrayDataset as JaxArrayDataset
from ray_lightning_tpu.core.data import NumpyLoader as JaxNumpyLoader
from ray_lightning_tpu.core.data import TpuDataModule as JaxDataModule
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.parallel import strategies as jax_strategies
from ray_lightning_tpu_torch.cluster.actor import ActorDiedError, RemoteError
from ray_lightning_tpu_torch.core import loop as port_loop
from ray_lightning_tpu_torch.core.callbacks import ModelCheckpoint
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.models.gpt import GPTConfig
from ray_lightning_tpu_torch.parallel import strategies as port_strategies
from ray_lightning_tpu_torch.parallel.sharding import leaves_with_paths
from ray_lightning_tpu_torch.parallel.strategies import (
    LocalStrategy, RayShardedStrategy, RayStrategy,
)
from ray_lightning_tpu_torch.utils import sharded_ckpt as sc

CFG = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, seq_len=32,
           warmup_steps=2, mu_dtype="float32")
BATCH, EPOCHS, PER_EPOCH = 8, 3, 2
WORKER = dict(device="cpu", timeout_s=120.0,
              env_per_worker={"OMP_NUM_THREADS": "1"})
LIMIT_S = 300


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _limit():
    def expire(signum, frame):
        raise TimeoutError(f"multi-process fixture exceeded {LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    return old


def _flat(tree):
    return {"/".join(map(str, p)): t.detach().cpu()
            for p, t in leaves_with_paths(tree)}


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The crash-once fit (scratch restart directory) and the uninterrupted
    fit (an explicit ``restart_dir``, kept), from the same params and
    batches."""
    root = tmp_path_factory.mktemp("restart")
    tree = jax.tree.map(np.asarray, JaxGPT(JaxGPTConfig(**CFG)).init_params(
        jax.random.PRNGKey(3)))
    arrays = helpers.scaled_batches(CFG["vocab_size"], CFG["seq_len"], BATCH,
                                    PER_EPOCH, seed=5)

    def fit(crash, restart_dir=None):
        log, rec = helpers.LossLog(), helpers.EpochRecorder()
        cbs = [log, rec]
        if crash:
            cbs.append(helpers.CrashOnce(str(root / "crash-marker")))
        strategy = RayShardedStrategy(num_workers=2, zero_stage=3,
                                      max_restarts=1,
                                      restart_backoff_s=0.05, **WORKER)
        tr = Trainer(strategy, max_epochs=EPOCHS,
                     limit_train_batches=PER_EPOCH, limit_val_batches=0,
                     callbacks=cbs, enable_checkpointing=False,
                     log_every_n_steps=1, default_root_dir=str(root),
                     restart_dir=restart_dir)
        m = helpers.ScaledGPT(GPTConfig(**CFG), device="cpu")
        m.initial_params = params_from_jax(tree, "cpu")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tr.fit(m, helpers.ArraysDataModule(arrays, BATCH))
        return {"trainer": tr, "strategy": strategy, "losses": log.losses,
                "epochs": rec.epochs, "warnings": [str(x.message) for x in w]}

    old = _limit()
    try:
        crashed = fit(True)
        kept = str(root / "kept")
        straight = fit(False, restart_dir=kept)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    return {"root": root, "arrays": arrays, "crashed": crashed,
            "straight": straight, "kept": kept}


def test_crash_once_restart_is_bitwise_the_uninterrupted_fit(fits):
    """Rank 1 dies at epoch 1: one restart from epoch 0's checkpoint, the
    epoch recorder (its state rides the checkpoint) reads [0, 1, 2], the
    per-step losses and final params are bitwise the uninterrupted fit's,
    the events name the backoff and the restart, and the scratch
    directory is gone."""
    crashed, straight = fits["crashed"], fits["straight"]
    st = crashed["strategy"]
    assert st.restarts_used == 1 and straight["strategy"].restarts_used == 0
    assert crashed["epochs"] == straight["epochs"] == [0, 1, 2]
    assert len(crashed["losses"]) == EPOCHS * PER_EPOCH
    assert crashed["losses"] == straight["losses"]
    a = _flat(crashed["trainer"].state.params)
    b = _flat(straight["trainer"].state.params)
    assert all(torch.equal(a[k], b[k]) for k in b)
    a = _flat(crashed["trainer"].state.opt_state)
    b = _flat(straight["trainer"].state.opt_state)
    assert all(torch.equal(a[k], b[k]) for k in b)
    kinds = [e["kind"] for e in crashed["trainer"].recovery_events]
    assert kinds == ["backoff", "elastic_restart"]
    restart = crashed["trainer"].recovery_events[1]
    assert restart["ckpt"].endswith("restart-epoch-000000.ckpt")
    assert any("elastic restart 1/1" in w and "rank=1" in w
               for w in crashed["warnings"])
    assert crashed["trainer"].global_step == EPOCHS * PER_EPOCH
    assert not [d for d in os.listdir(fits["root"])
                if d.startswith(".rlt-restart-")]


def test_restart_checkpoints_are_sharded_per_rank(fits):
    """The kept directory holds the two newest checkpoints; each rank's
    file is under 0.75 of the two together (the JAX multi-worker test's
    bound: ZeRO-3 slices, no gather); the full reassembly equals the
    gathered state the trainer adopted; each rank's selective read takes
    about half the sharded bytes."""
    kept = fits["kept"]
    assert sorted(os.listdir(kept)) == ["restart-epoch-000001.ckpt",
                                        "restart-epoch-000002.ckpt"]
    tag = os.path.join(kept, "restart-epoch-000002.ckpt")
    sizes = [os.path.getsize(os.path.join(
        tag, f"shard-{r:05d}-of-00002.ckpt")) for r in range(2)]
    assert max(sizes) < 0.75 * sum(sizes)
    payload = sc.load_sharded(tag)
    assert payload["world_size"] == 2 and payload["accum"] == 1
    assert payload["epoch"] == 2 and payload["global_step"] == 6
    tr = fits["straight"]["trainer"]
    from ray_lightning_tpu_torch.models.convert import train_state_from_jax

    got = train_state_from_jax(payload["state"])
    a, b = _flat(got.params), _flat(tr.state.params)
    assert all(torch.equal(a[k], b[k]) for k in b)
    a, b = _flat(got.opt_state), _flat(tr.state.opt_state)
    assert all(torch.equal(a[k], b[k]) for k in b)
    full_bytes = sc.LOAD_STATS["bytes_read"]
    assert sc.verify_checkpoint(tag) == []
    # Each rank's own slices, as the next fit at world 2 reads them.
    from ray_lightning_tpu_torch.parallel.sharding import ZeroPlan

    for r in range(2):
        plan = ZeroPlan(got.params, 3, r, 2)
        from ray_lightning_tpu_torch.core.module import TrainState

        mine = TrainState(plan.shard_tree(got.params),
                          plan.shard_opt_state(got.opt_state), got.step)
        sc.load_sharded(tag, targets=sc.state_tree(mine, plan, r, 2))
        assert sc.LOAD_STATS["selective"]
        assert 0.4 * full_bytes < sc.LOAD_STATS["bytes_read"] \
            < 0.6 * full_bytes


class _JaxScaledGPT(JaxGPT):
    def training_step(self, params, batch, rng):
        loss, logs = super().training_step(params, batch, rng)
        return loss * jnp.mean(batch["scale"]), logs


class _JaxArrays(JaxDataModule):
    def __init__(self, arrays, batch_size):
        super().__init__()
        self.arrays, self.batch_size = arrays, batch_size

    def train_dataloader(self):
        return JaxNumpyLoader(JaxArrayDataset(**self.arrays),
                              batch_size=self.batch_size,
                              shard_index=self.shard_index,
                              num_shards=self.num_shards)


class _JaxLossLog(JaxCallback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, logs, batch_idx):
        self.losses.append(float(logs["train_loss"]))


def test_jax_and_the_port_resume_the_port_directory_at_one_rank(fits,
                                                                 tmp_path):
    """The oldest kept checkpoint (epoch 1, two ZeRO-3 ranks) resumed at
    world 1 by the JAX ``run_fit`` and by the port's ``LocalStrategy``:
    both re-derive accum 1 → 2 and warn, the port counts the resize and
    books its event; the resumed epoch's losses agree within 2e-6, and
    the counters are equal (2 micro-steps, 1 optimizer step)."""
    tag = os.path.join(fits["kept"], "restart-epoch-000001.ckpt")
    jlog = _JaxLossLog()
    cfg = jax_loop.FitConfig(max_epochs=EPOCHS, seed=0,
                             limit_train_batches=PER_EPOCH,
                             limit_val_batches=0, log_every_n_steps=1,
                             default_root_dir=str(tmp_path / "jax"),
                             resume_from_checkpoint=tag)
    with pytest.warns(UserWarning, match="elastic resume"):
        jres = jax_loop.run_fit(_JaxScaledGPT(JaxGPTConfig(**CFG)),
                                _JaxArrays(fits["arrays"], BATCH), cfg,
                                [jlog])
    log = helpers.LossLog()
    tr = Trainer(LocalStrategy(device="cpu"), max_epochs=EPOCHS,
                 limit_train_batches=PER_EPOCH, limit_val_batches=0,
                 callbacks=[log], enable_checkpointing=False,
                 log_every_n_steps=1, default_root_dir=str(tmp_path / "p"),
                 resume_from_checkpoint=tag)
    with pytest.warns(UserWarning, match="elastic resume: checkpoint from "
                      "world size 2 .accum 1. resuming on 1 with accum 2"):
        tr.fit(helpers.ScaledGPT(GPTConfig(**CFG), device="cpu"),
               helpers.ArraysDataModule(fits["arrays"], BATCH))
    # The port's LossLog resumed its state (epochs 0-1) from the file.
    resumed = log.losses[-PER_EPOCH:]
    assert len(jlog.losses) == PER_EPOCH
    np.testing.assert_allclose(resumed, jlog.losses, rtol=0, atol=2e-6)
    assert (tr.global_step, tr.micro_step) == (
        jres["global_step"], jres["micro_step"]) == (5, 6)
    assert tr.telemetry_report["counters"]["elastic_resizes"] == 1
    assert [(e["kind"], e["old_world"], e["new_world"])
            for e in tr.recovery_events] == [("resize", 2, 1)]


# ---------------------------------------------------------------------------
# The governor against fakes of its attempt, and its functions against JAX
# ---------------------------------------------------------------------------

def _governed(strategy, attempts, discover=None):
    """``strategy`` with no workers and ``attempts``, a list of what each
    attempt does (an exception to raise, or a package to return); returns
    the configs each attempt saw."""
    strategy._workers = [object()]
    strategy._respawn_workers = lambda: None
    strategy._kill_workers = lambda: None
    strategy._latest_restart_checkpoint = discover or (
        lambda d: {"path": None, "corrupt": []})
    seen = []

    def run_once(kind, module, dm, config, callbacks, params, ckpt_path):
        seen.append(config)
        step = attempts[len(seen) - 1]
        if isinstance(step, BaseException):
            raise step
        return step

    strategy._run_once = run_once
    return seen


def _config(tmp_path, **kw):
    return port_loop.FitConfig(max_epochs=1,
                               default_root_dir=str(tmp_path), **kw)


def test_budget_exhaustion_raises_with_the_note(tmp_path):
    """Failures past ``max_restarts`` in the window: the second death
    raises ``ActorDiedError`` with the budget note, one restart spent, the
    scratch directory removed."""
    s = RayStrategy(num_workers=2, max_restarts=1, restart_backoff_s=0.0,
                    **WORKER)
    seen = _governed(s, [ActorDiedError("death 1"),
                         ActorDiedError("death 2")])
    with pytest.raises(ActorDiedError, match="restart budget exhausted: 1 "
                       "failure.s. within 3600s"):
        s.run("fit", None, None, _config(tmp_path), [])
    assert s.restarts_used == 1 and len(seen) == 2
    scratch = seen[0].restart_dir
    assert os.path.basename(scratch).startswith(".rlt-restart-")
    assert len(os.path.basename(scratch)) == len(".rlt-restart-") + 8
    assert seen[0].restart_every_n_epochs == 1
    assert not os.path.exists(scratch)


def test_failures_outside_the_window_do_not_count(tmp_path, monkeypatch):
    """The budget is a sliding window: a second death 61 s after the
    first, with ``restart_window_s=60``, is restarted again (the first no
    longer counts against ``max_restarts=1``)."""
    clock = [1000.0]
    monkeypatch.setattr(port_strategies.time, "monotonic", lambda: clock[0])
    s = RayStrategy(num_workers=1, max_restarts=1, restart_window_s=60.0,
                    restart_backoff_s=0.0, **WORKER)

    class Later(ActorDiedError):
        def __init__(self, msg):
            clock[0] += 61.0
            super().__init__(msg)

    seen = _governed(s, [ActorDiedError("a"), None, {"rank": 0}])
    run_once = s._run_once

    def attempt(*a):
        if len(seen) == 1:
            seen.append(a[3])
            raise Later("b")
        return run_once(*a)

    s._run_once = attempt
    assert s.run("fit", None, None, _config(tmp_path), []) == {"rank": 0}
    assert s.restarts_used == 2


def test_user_exception_is_not_retried(tmp_path):
    """A ``RemoteError`` from user code is raised at once, the budget
    untouched (one real worker: the callback raises in its process)."""
    s = RayStrategy(num_workers=1, max_restarts=3, **WORKER)
    tr = Trainer(s, max_epochs=1, limit_train_batches=1,
                 enable_checkpointing=False, default_root_dir=str(tmp_path),
                 callbacks=[helpers.BadHook()])
    with pytest.raises(RemoteError, match="deterministic user bug"):
        tr.fit(helpers.ScaledGPT(GPTConfig(**CFG), device="cpu"),
               helpers.ArraysDataModule(helpers.scaled_batches(
                   256, 32, BATCH, 1, seed=5), BATCH))
    assert s.restarts_used == 0
    assert not [d for d in os.listdir(tmp_path)
                if d.startswith(".rlt-restart-")]


def test_no_checkpoint_restarts_from_scratch(tmp_path):
    """A death before any checkpoint exists: the next attempt starts over
    (no ``resume_from_checkpoint``), its event saying so."""
    s = RayStrategy(num_workers=2, max_restarts=1, restart_backoff_s=0.0,
                    **WORKER)
    seen = _governed(s, [ActorDiedError("early"), {"rank": 0}])
    s.run("fit", None, None, _config(tmp_path), [])
    assert s.restarts_used == 1
    assert seen[1].resume_from_checkpoint is None
    assert "resuming from scratch" in s.recovery_events[-1]["message"]


def test_corrupt_newest_checkpoint_falls_back(tmp_path):
    """Two restart checkpoints, the newest with a flipped byte: discovery
    (in the driver, the workers being fakes) walks back to the older one,
    with a ``ckpt_corrupt`` event and a warning."""
    rdir = tmp_path / "rs"
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    for epoch in (0, 1):
        tag = str(rdir / f"restart-epoch-{epoch:06d}.ckpt")
        sc.save_shard(tree, tag, 0, 1)
        sc.save_meta(tree, tag, 1, extra={"epoch": epoch})
        os.utime(os.path.join(tag, "META.ckpt"), (epoch + 1, epoch + 1))
    path = str(rdir / "restart-epoch-000001.ckpt" /
               "shard-00000-of-00001.ckpt")
    with open(path, "r+b") as f:
        f.seek(-3, 2)
        b = f.read(1)
        f.seek(-3, 2)
        f.write(bytes([b[0] ^ 0x80]))
    s = RayStrategy(num_workers=1, max_restarts=1, restart_backoff_s=0.0,
                    **WORKER)
    seen = _governed(s, [ActorDiedError("death"), {"rank": 0}],
                     discover=lambda d: port_strategies.
                     _remote_latest_restart_checkpoint(d))
    with pytest.warns(UserWarning, match="corrupt restart checkpoint"):
        s.run("fit", None, None, _config(tmp_path, restart_dir=str(rdir)),
              [])
    assert seen[1].resume_from_checkpoint == str(
        rdir / "restart-epoch-000000.ckpt")
    assert [e["kind"] for e in s.recovery_events] == [
        "ckpt_corrupt", "elastic_restart"]
    assert "checksum mismatch" in s.recovery_events[0]["message"]
    # A caller's restart_dir is kept.
    assert os.path.isdir(rdir)


def test_backoff_equals_jax():
    """``_backoff_delay`` draws what the JAX governor draws: base ·
    2^(streak-1), capped, times 1 + 0.25·U."""
    kw = dict(num_workers=1, max_restarts=3, restart_backoff_s=0.5,
              restart_backoff_max_s=3.0)
    port = RayStrategy(**kw, **WORKER)
    jax_s = jax_strategies.RayStrategy(**kw)
    for streak in range(1, 7):
        random.seed(streak)
        want = jax_s._backoff_delay(streak)
        random.seed(streak)
        assert port._backoff_delay(streak) == want
    assert RayStrategy(num_workers=1, restart_backoff_s=0.0, **WORKER
                       )._backoff_delay(3) == 0.0


def test_rederive_accum_and_resume_info_equal_jax(tmp_path):
    """``_rederive_accum`` and ``_elastic_resume_info`` (read from a META
    the port wrote) equal the JAX package's functions."""
    for args in [(4, 2, 2), (2, 2, 4), (2, 3, 2), (2, 1, 4), (3, 2, 2),
                 (1, 1, 0), (2, 1, 1), (8, 1, 3)]:
        assert port_loop._rederive_accum(*args) == \
            jax_loop._rederive_accum(*args), args
    tree = {"w": torch.zeros(4)}
    tags = {}
    for name, extra in [("a", {"world_size": 2, "accum": 2, "epoch": 0}),
                        ("b", {"epoch": 0}),
                        ("c", {"world_size": 3, "accum": 1, "epoch": 0})]:
        tags[name] = str(tmp_path / f"drain-step-{name}.ckpt")
        sc.save_shard(tree, tags[name], 0, 1)
        sc.save_meta(tree, tags[name], 1, extra=extra)
    for name in tags:
        for world, accum in [(1, 2), (2, 2), (2, 1), (3, 1), (4, 1)]:
            assert port_loop._elastic_resume_info(
                tags[name], world, accum) == jax_loop._elastic_resume_info(
                    tags[name], world, accum), (name, world, accum)


def test_governor_decisions_equal_jax(monkeypatch):
    """``_elastic_resize_decision`` over a capacity that moves, and the
    knobs' validation and env bus, as the JAX governor's."""
    cap = [4]
    kw = dict(num_workers=4, max_restarts=1, elastic_min_workers=2,
              elastic_capacity_fn=lambda: cap[0])
    port = RayStrategy(**kw, **WORKER)
    jax_s = jax_strategies.RayStrategy(**kw)
    assert port.world_size == jax_s.world_size == 4
    for c in (4, 3, 9, 1, 2, 0):
        cap[0] = c
        assert port._elastic_resize_decision() == \
            jax_s._elastic_resize_decision(), c
    assert RayStrategy(num_workers=4, max_restarts=1, **WORKER
                       )._elastic_resize_decision() == (None, False)
    for bad in [dict(elastic_min_workers=3), dict(elastic_min_workers=0),
                dict(max_restarts=-1), dict(restart_every_n_epochs=0),
                dict(restart_window_s=0.0), dict(restart_backoff_s=-1.0)]:
        with pytest.raises(ValueError) as pe:
            RayStrategy(num_workers=2, **bad, **WORKER)
        with pytest.raises(ValueError) as je:
            jax_strategies.RayStrategy(num_workers=2, **bad)
        assert str(pe.value) == str(je.value)
    monkeypatch.setenv("RLT_ELASTIC_MIN_WORKERS", "8")
    assert RayStrategy(num_workers=2, **WORKER).elastic_min_workers == \
        jax_strategies.RayStrategy(num_workers=2).elastic_min_workers == 2
    with pytest.raises(ValueError, match="restart_every_n_epochs"):
        Trainer(LocalStrategy(device="cpu"), restart_every_n_epochs=0)


def test_governor_shrinks_and_grows_as_jax(tmp_path):
    """A death with capacity 1 of 2: a budget-free shrink to one survivor
    (a ``resize`` event 2 → 1); the next death, capacity back at 2, is a
    restart that grows back (1 → 2): the worlds, counters and events the
    JAX governor takes on the same script."""
    def script(strategy_cls, died_cls, **extra):
        cap = [1]
        s = strategy_cls(num_workers=2, max_restarts=1,
                         restart_backoff_s=0.0, elastic_min_workers=1,
                         elastic_capacity_fn=lambda: cap[0], **extra)
        s._backend = object()
        s._respawn_workers = lambda: None
        s._kill_workers = lambda *a, **k: None
        s._latest_restart_checkpoint = lambda d: {"path": None,
                                                  "corrupt": []}
        worlds = []

        def run_once(*a, **k):
            worlds.append(s.active_workers)
            if len(worlds) == 1:
                raise died_cls("worker 1 lost")
            if len(worlds) == 2:
                cap[0] = 2
                raise died_cls("worker 0 died")
            return [{"rank": 0}]

        s._run_once = run_once
        s._workers = [object()]
        s.run("fit", None, None, port_loop.FitConfig(
            max_epochs=1, default_root_dir=str(tmp_path)) if
            strategy_cls is RayStrategy else jax_loop.FitConfig(
                max_epochs=1, default_root_dir=str(tmp_path)), [])
        kinds = [e["kind"] for e in s.recovery_events]
        resizes = [(e["old_world"], e["new_world"]) for e in
                   s.recovery_events if e["kind"] == "resize"]
        return worlds, s.restarts_used, s.resizes_used, kinds, resizes

    port = script(RayStrategy, ActorDiedError, **WORKER)
    from ray_lightning_tpu.cluster.actor import ActorDiedError as JaxDied

    want = script(jax_strategies.RayStrategy, JaxDied)
    assert port == want
    assert port[0] == [2, 1, 2] and port[4] == [(2, 1), (1, 2)]


def test_governor_flap_guard_as_jax(tmp_path):
    """Consecutive shrinks that resume from the same checkpoint: the third
    death raises with the flap-guard note, as in the JAX governor."""
    def script(strategy_cls, died_cls, cfg_cls, **extra):
        cap = [3]
        s = strategy_cls(num_workers=4, max_restarts=1,
                         elastic_min_workers=1,
                         elastic_capacity_fn=lambda: cap[0], **extra)
        s._backend = object()
        s._respawn_workers = lambda: None
        s._kill_workers = lambda *a, **k: None
        s._latest_restart_checkpoint = lambda d: {"path": "/same/ckpt",
                                                  "corrupt": []}
        attempt = [0]

        def run_once(*a, **k):
            attempt[0] += 1
            cap[0] = max(cap[0] - (attempt[0] > 1), 1)
            raise died_cls(f"death {attempt[0]}")

        s._run_once = run_once
        s._workers = [object()]
        with pytest.raises(died_cls, match="flap guard") as err:
            s.run("fit", None, None, cfg_cls(
                max_epochs=1, default_root_dir=str(tmp_path)), [])
        return attempt[0], s.resizes_used, s.restarts_used, str(err.value)

    from ray_lightning_tpu.cluster.actor import ActorDiedError as JaxDied

    port = script(RayStrategy, ActorDiedError, port_loop.FitConfig,
                  **WORKER)
    want = script(jax_strategies.RayStrategy, JaxDied, jax_loop.FitConfig)
    assert port == want and port[0] == 3


def test_model_checkpoint_verify_covers_both_formats(tmp_path, monkeypatch):
    """``ModelCheckpoint(verify=True)`` reads back through
    ``sharded_ckpt.verify_checkpoint`` (as the JAX callback does): a
    sound file passes, and a write whose bytes are corrupted on the way to
    disk raises naming the problem."""
    arrays = helpers.scaled_batches(256, 32, BATCH, 1, seed=5)
    seen = []
    real = sc.verify_checkpoint

    def spy(path):
        seen.append(path)
        return real(path)

    monkeypatch.setattr(sc, "verify_checkpoint", spy)
    ck = ModelCheckpoint(dirpath=str(tmp_path / "ok"), monitor=None,
                         verify=True)
    Trainer(LocalStrategy(device="cpu"), max_epochs=1, limit_val_batches=0,
            callbacks=[ck], default_root_dir=str(tmp_path)).fit(
        helpers.ScaledGPT(GPTConfig(**CFG), device="cpu"),
        helpers.ArraysDataModule(arrays, BATCH))
    assert seen == [ck.best_model_path] and real(ck.best_model_path) == []

    from ray_lightning_tpu_torch.utils import state_stream

    write = state_stream.state_stream_to_file

    def torn(stream, path):
        write(stream, path)
        with open(path, "r+b") as f:
            f.seek(-5, 2)
            f.write(b"\x00\x01\x02")

    monkeypatch.setattr(port_loop, "state_stream_to_file", torn)
    bad = ModelCheckpoint(dirpath=str(tmp_path / "bad"), monitor=None,
                          verify=True)
    with pytest.raises(RuntimeError, match="failed post-write verification"
                       ".*checksum mismatch"):
        Trainer(LocalStrategy(device="cpu"), max_epochs=1,
                limit_val_batches=0, callbacks=[bad],
                default_root_dir=str(tmp_path)).fit(
            helpers.ScaledGPT(GPTConfig(**CFG), device="cpu"),
            helpers.ArraysDataModule(arrays, BATCH))


# name -> (the writer's world, accum, opt_state_dtype and EF residual;
# the resuming rank's world and ZeRO stage, None: no plan).
RESUME_CASES = {
    "bare_to_wrapped": (4, 1, None, False, 2, 3),
    "wrapped_to_bare": (1, 2, None, False, 2, 3),
    "wrapped_to_bare_zero1": (1, 2, None, False, 2, 1),
    "int8_moments_to_zero3": (1, 1, "int8", False, 2, 3),
    "residual_dropped": (2, 1, None, True, 1, None),
}


def _like(template, tree):
    """``tree``'s dicts in ``template``'s key order."""
    if isinstance(template, dict):
        return {k: _like(v, tree[k]) for k, v in template.items()}
    return tree


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resize_resume_reads_selectively(tmp_path, case):
    """Each rank of an elastic resume reads the checkpoint through the
    selective reader whatever differs between the writer's state and its
    own (the accumulation wrapper, across accum 1; the moments' storage
    format; a residual on one side only), and ends with the state the
    full read, reconciled and sliced, gives: bitwise.  A ZeRO-3 writer's
    file is read about half by each of two ranks."""
    from ray_lightning_tpu_torch.core.module import TrainState
    from ray_lightning_tpu_torch.models.convert import train_state_from_jax
    from ray_lightning_tpu_torch.models.gpt import GPT
    from ray_lightning_tpu_torch.models.optim import multi_steps, tree_map
    from ray_lightning_tpu_torch.parallel.sharding import ZeroPlan
    from ray_lightning_tpu_torch.telemetry.runtime import Telemetry

    old_world, old_accum, opt_dtype, resid, world, stage = RESUME_CASES[case]
    gen = torch.Generator().manual_seed(7)

    def noisy(t):
        return (torch.randn(t.shape, generator=gen).to(t.dtype)
                if t.is_floating_point() else t)

    def tx_of(dtype, accum):
        tx = GPT(GPTConfig(**CFG, opt_state_dtype=dtype),
                 device="cpu").configure_optimizers()
        return multi_steps(tx, accum) if accum > 1 else tx

    params = GPT(GPTConfig(**CFG), device="cpu").init_params(
        torch.Generator().manual_seed(0))
    written = TrainState.create(params, tx_of(opt_dtype, old_accum))
    written = TrainState(written.params,
                         tree_map(noisy, written.opt_state), 3)
    tag = str(tmp_path / "restart-epoch-000000.ckpt")
    trees = []
    for r in range(old_world):
        plan = ZeroPlan(params, 3, r, old_world) if old_world > 1 else None
        mine = written if plan is None else TrainState(
            plan.shard_tree(params), plan.shard_opt_state(written.opt_state),
            written.step)
        row = torch.full((256,), float(r + 1)) if resid else None
        trees.append(sc.state_tree(mine, plan, r, old_world, residual=row))
        sc.save_shard(trees[-1], tag, r, old_world)
    sc.save_meta(trees[0], tag, old_world, extra={
        "epoch": 0, "global_step": 3, "micro_step": 3 * old_accum,
        "world_size": old_world, "accum": old_accum,
        "callback_metrics": {}, "callback_states": []})
    total = sum(os.path.getsize(os.path.join(tag, f)) for f in
                os.listdir(tag) if f.startswith("shard-"))

    info = port_loop._elastic_resume_info(tag, world, 1)
    accum = info["accum"] if info else 1
    tx = tx_of(None, accum)
    full = TrainState.create(params, tx)
    want = train_state_from_jax(sc.load_sharded(tag)["state"])
    want = TrainState(want.params, want.opt_state, want.step)
    want = port_loop._reconcile_multisteps(want, full)
    want = port_loop._reconcile_opt_state_format(want, full)

    class Dist:
        world_size = world

    for rank in range(world):
        Dist.rank = rank
        ctx = port_loop.LoopContext(port_loop.FitConfig(
            resume_from_checkpoint=tag), torch.device("cpu"),
            Dist() if world > 1 else None)
        ctx.telemetry = Telemetry.build("cheap")
        expect = want
        if stage is None:
            ctx.state = TrainState.create(params, tx)
        else:
            plan = ctx.zero_plan = ZeroPlan(params, stage, rank, world)
            shards = plan.shard_tree(params, own=True)
            ctx.state = TrainState(shards if stage == 3 else
                                   tree_map(torch.clone, params),
                                   tx.init(shards), 0)
            # (The plan's leaf order is the module's; a loaded tree's
            # dicts come in JAX's sorted order.)
            ordered = _like(params, want.params)
            expect = TrainState(
                plan.shard_tree(ordered) if stage == 3 else ordered,
                plan.shard_opt_state(want.opt_state), want.step)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            port_loop._resume(ctx, [], accum, None, info)
        assert sc.LOAD_STATS["selective"]
        if old_world > 1 and stage is not None:
            assert 0.4 * total < sc.LOAD_STATS["bytes_read"] < 0.6 * total
        assert ctx.state.step == 3 and ctx.global_step == 3
        for part in ("params", "opt_state"):
            a = _flat(getattr(ctx.state, part))
            b = _flat(getattr(expect, part))
            assert a.keys() == b.keys()
            for k in b:
                assert torch.equal(a[k], b[k].to(a[k].dtype)), (part, k)
        if resid:
            assert ctx.state.grad_residual is None
            assert any("does not survive" in str(x.message) for x in w)


def test_restart_invariants(tmp_path):
    """``torch_dist_helpers.restart_unit_checks`` (the checks
    ``chip_faults.py`` step 15 runs on copies of the port with a fault
    planted, each fault turning one False) all hold on the port as it
    is."""
    got = helpers.restart_unit_checks(str(tmp_path))
    assert got == {k: True for k in ("write_order", "walk_back",
                                     "selective_slices", "accum_rederived",
                                     "window", "ef_dropped")}
