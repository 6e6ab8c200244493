"""The port's callbacks held against the JAX package's (CPU, f32,
``GPTConfig.tiny()``): ``CSVLogger``, ``StochasticWeightAveraging``,
``ExponentialMovingAverage``, ``DeviceStatsCallback`` and
``ProfilerCallback``, each in the same two-epoch fit in both packages,
with megastep 1 and 4 (on the CPU a stride runs its steps eagerly).

Tolerances: CSV rows with the same keys and steps, the model's values
within 1e-5 (absolute, or relative for a perplexity; the telemetry's timings are the host's and are
not compared); SWA's and EMA's params within 1e-5 of JAX's (the fits'
own rule, ``test_torch_train.py``); the EMA under megastep against
stride-boundary snapshots of the same fit within rtol 1e-5 / atol 1e-6
(JAX ``tests/test_megastep.py::test_ema_parity``); the profiler's merged
windows equal JAX's.
"""

import csv
import json
import os

import jax
import numpy as np
import pytest
import torch

from ray_lightning_tpu.core import callbacks as jcb
from ray_lightning_tpu.core.trainer import Trainer as JaxTrainer
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.models.gpt import (
    SyntheticLMDataModule as JaxSyntheticLM,
)
from ray_lightning_tpu.parallel.strategies import (
    LocalStrategy as JaxLocalStrategy,
)
from ray_lightning_tpu_torch import core
from ray_lightning_tpu_torch.core import callbacks as tcb
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.models.gpt import (
    GPT, GPTConfig, SyntheticLMDataModule,
)
from ray_lightning_tpu_torch.models.optim import tree_map
from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy

TOL = 1e-5
EPOCHS, BATCHES, BATCH, SEED, LOG_EVERY = 2, 4, 8, 4, 2
DECAY = 0.9
# The telemetry's host timings differ run to run; the rest is the model's.
HOST_KEYS = {"step_time_ms", "data_wait_ms", "dispatch_ms", "device_step_ms",
             "examples_per_sec", "tokens_per_sec", "mfu", "recompiles",
             "epoch_time_s"}


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: under the suite's parallel workers torch's own
    threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _by_path(tree, path=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _by_path(v, f"{path}['{k}']").items()}
    return {path: np.asarray(tree.detach().cpu() if isinstance(
        tree, torch.Tensor) else tree, np.float32)}


def _close(got, want, **kw):
    a, b = _by_path(got), _by_path(want)
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], err_msg=k,
                                   **(kw or dict(rtol=0, atol=TOL)))


class _Snapshots:
    """Params at each stride boundary (a multiple of K optimizer steps),
    copied, in either package."""

    def __init__(self, k, copy):
        self.k, self.copy, self.at = k, copy, {}

    def on_train_batch_end(self, trainer, module, logs, batch_idx):
        if trainer.global_step % self.k == 0:
            self.at[trainer.global_step] = self.copy(trainer.state.params)


class _JaxSnap(_Snapshots, jcb.Callback):
    pass


class _PortSnap(_Snapshots, tcb.Callback):
    pass


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


class _AliasCheck(tcb.Callback):
    """After SWA and EMA in the list: whether their shadows share memory
    with the live params, at every batch end and epoch end."""

    def __init__(self, *holders):
        self.holders, self.checks, self.shared = holders, 0, []

    def _check(self, trainer):
        live = {t.data_ptr() for t in _leaves(trainer.state.params)}
        for cb in self.holders:
            for shadow in (getattr(cb, "ema_params", None),
                           getattr(cb, "_mean", None)):
                if shadow is not None:
                    self.checks += 1
                    if not live.isdisjoint(
                            t.data_ptr() for t in _leaves(shadow)):
                        self.shared.append((type(cb).__name__,
                                            trainer.global_step))

    def on_train_batch_end(self, trainer, module, logs, batch_idx):
        self._check(trainer)

    def on_train_epoch_end(self, trainer, module):
        self._check(trainer)


@pytest.fixture(scope="module", params=[1, 4], ids=["megastep1",
                                                     "megastep4"])
def fits(request, tmp_path_factory):
    k = request.param
    root = tmp_path_factory.mktemp(f"cb{k}")
    tree = jax.tree.map(np.asarray, JaxGPT(JaxGPTConfig.tiny()).init_params(
        jax.random.PRNGKey(3)))

    jcfg = JaxGPTConfig.tiny()
    jm = JaxGPT(jcfg)
    jm.initial_params = tree
    jcbs = {"csv": jcb.CSVLogger(), "swa": jcb.StochasticWeightAveraging(0),
            "ema": jcb.ExponentialMovingAverage(DECAY, swap_at_end=False),
            "dev": jcb.DeviceStatsCallback(log=False),
            "snap": _JaxSnap(k, jax.device_get)}
    jt = JaxTrainer(strategy=JaxLocalStrategy(), max_epochs=EPOCHS,
                    limit_val_batches=1, log_every_n_steps=LOG_EVERY,
                    megastep=k if k > 1 else "off",
                    enable_checkpointing=False,
                    default_root_dir=str(root / "jax"),
                    callbacks=list(jcbs.values()))
    jt.fit(jm, JaxSyntheticLM(jcfg, batch_size=BATCH, num_batches=BATCHES,
                              seed=SEED))

    cfg = GPTConfig.tiny()
    tm = GPT(cfg, device="cpu")
    tm.initial_params = params_from_jax(tree, "cpu")
    swa = core.StochasticWeightAveraging(0)
    ema = core.ExponentialMovingAverage(DECAY, swap_at_end=False)
    tcbs = {"csv": core.CSVLogger(), "swa": swa, "ema": ema,
            "dev": core.DeviceStatsCallback(log=False),
            "prof": core.ProfilerCallback(start_step=2, num_steps=2),
            "snap": _PortSnap(k, lambda p: tree_map(torch.clone, p)),
            "alias": _AliasCheck(swa, ema)}
    tr = Trainer(LocalStrategy(device="cpu"), max_epochs=EPOCHS,
                 limit_val_batches=1, log_every_n_steps=LOG_EVERY,
                 megastep=k if k > 1 else "off", enable_checkpointing=False,
                 default_root_dir=str(root / "port"),
                 callbacks=list(tcbs.values()))
    tr.fit(tm, SyntheticLMDataModule(cfg, batch_size=BATCH,
                                     num_batches=BATCHES, seed=SEED))
    return k, jt, jcbs, tr, tcbs


def test_csv_logger_rows_match_the_jax_logger(fits):
    k, _, jcbs, tr, tcbs = fits
    want, got = jcbs["csv"].rows, tcbs["csv"].rows
    # Rows on the log_every_n_steps grid (one per crossed boundary, a
    # stride crossing K/2 of them at once), each epoch end and each
    # validation epoch end.
    assert [(r["epoch"], r["step"]) for r in got] == [
        (r["epoch"], r["step"]) for r in want]
    assert len(got) == EPOCHS * (BATCHES // max(k, LOG_EVERY) + 2)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in set(w) - HOST_KEYS - {"epoch", "step"}:
            assert g[key] == pytest.approx(w[key], rel=TOL, abs=TOL), key
    path = tcbs["csv"].path
    assert path == os.path.join(tr.config.default_root_dir, "csv",
                                "metrics.csv")
    with open(path, newline="") as f:
        read = list(csv.DictReader(f))
    assert len(read) == len(got)
    assert [int(r["step"]) for r in read] == [r["step"] for r in got]
    # state_dict carries the rows.
    fresh = core.CSVLogger()
    fresh.load_state_dict(tcbs["csv"].state_dict())
    assert fresh.rows == got


def test_swa_and_ema_match_the_jax_callbacks(fits):
    _, jt, jcbs, tr, tcbs = fits
    # SWA: the mean of the epoch-end params replaced the trained ones.
    _close(tr.state.params, jax.device_get(jt.state.params))
    _close(tcbs["swa"]._mean, jax.device_get(jcbs["swa"]._mean))
    # EMA (kept, not swapped): the shadow, and its host copy.
    _close(tcbs["ema"].ema_params, jax.device_get(jcbs["ema"].ema_params))
    _close(tcbs["ema"].state_dict()["ema_params"],
           jax.device_get(jcbs["ema"].ema_params))


def test_ema_compounds_decay_over_a_stride(fits):
    """The shadow starts at the first stride boundary and blends
    ``decay**K`` with each later boundary's params, K = the megastep."""
    k, _, _, _, tcbs = fits
    snaps = tcbs["snap"].at
    steps = sorted(snaps)
    assert steps == list(range(k, EPOCHS * BATCHES + 1, k))
    expected = snaps[steps[0]]
    d = DECAY ** k
    for gs in steps[1:]:
        expected = tree_map(lambda e, p: e * d + p * (1.0 - d), expected,
                            snaps[gs])
    _close(tcbs["ema"].ema_params, expected, rtol=1e-5, atol=1e-6)


def test_swa_and_ema_copy_never_alias(fits):
    """At every hook of the fit, no shadow tensor shares memory with the
    live params (a captured stride writes into those)."""
    _, _, _, _, tcbs = fits
    assert tcbs["alias"].checks > 0
    assert tcbs["alias"].shared == []


def test_device_stats_records_wall_time_only_on_the_cpu(fits):
    _, _, _, tr, tcbs = fits
    dev = tcbs["dev"]
    assert len(dev.epoch_times) == EPOCHS and all(
        t > 0 for t in dev.epoch_times)
    assert dev.peak_memories == []
    assert set(dev.summary()) == {"avg_epoch_time_s"}
    assert "epoch_time_s" in tr.callback_metrics
    back = core.DeviceStatsCallback()
    back.load_state_dict(dev.state_dict())
    assert back.epoch_times == dev.epoch_times


def test_profiler_writes_a_chrome_trace_under_rank0(fits):
    k, _, _, tr, tcbs = fits
    prof = tcbs["prof"]
    assert prof.trace_dir == os.path.join(tr.config.default_root_dir,
                                          "profiler", "rank0")
    # The window opens at the first hook at or past step 2 and closes two
    # steps later (under megastep both land on a stride's end).
    assert len(prof.trace_paths) == 1
    start = max(2, k)
    assert prof.trace_paths[0].endswith(f"trace-step{start}.json")
    with open(prof.trace_paths[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert not prof._active
    prof.teardown(None, None, "fit")  # idempotent


@pytest.mark.parametrize("schedule", [
    [(2, 3), (4, 2)], [(0, 1), (1, 1), (5, 2)], [(6, 1), (1, 2), (3, 3)],
    None])
def test_profiler_merges_windows_as_jax_does(schedule):
    kw = {"schedule": schedule} if schedule else {"start_step": 4,
                                                  "num_steps": 2}
    assert (core.ProfilerCallback(**kw)._windows
            == jcb.ProfilerCallback(**kw)._windows)
    for bad in ([], [(1, 0)], [(-1, 2)]):
        for cls in (core.ProfilerCallback, jcb.ProfilerCallback):
            with pytest.raises(ValueError):
                cls(schedule=bad)


def test_profiler_skips_a_window_while_another_profiler_runs(tmp_path):
    """A window that would start inside an active profiler is skipped
    with a warning, and the fit goes on."""
    cfg = GPTConfig.tiny()
    prof = core.ProfilerCallback(start_step=1, num_steps=1)
    outer = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    outer.start()
    try:
        with pytest.warns(UserWarning, match="skipped"):
            Trainer(LocalStrategy(device="cpu"), max_steps=3,
                    limit_val_batches=0, enable_checkpointing=False,
                    default_root_dir=str(tmp_path), callbacks=[prof]).fit(
                GPT(cfg, device="cpu"),
                SyntheticLMDataModule(cfg, batch_size=2, num_batches=3))
    finally:
        outer.stop()
    assert prof.trace_paths == [] and not prof._active


def test_sync_point_crossed_is_the_jax_rule():
    from ray_lightning_tpu.fault.drain import sync_point_crossed

    for prev in range(0, 12):
        for step in range(prev, prev + 10):
            for every in (0, 1, 3, 4, 8):
                assert tcb.sync_point_crossed(prev, step, every) == (
                    sync_point_crossed(prev, step, every))
