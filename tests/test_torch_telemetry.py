"""The port's cheap telemetry tier held against the JAX package's (CPU).

``StepStats`` is fed the same records under one fake clock in both
packages and must give the same numbers (the same float arithmetic:
exact equality); a default fit carries the telemetry keys in
``callback_metrics`` (the same as the JAX fit's: ``test_torch_train.py``
and ``test_torch_megastep.py`` hold them against JAX fits),
``telemetry="off"`` none; with
``RLT_TELEMETRY_PEAK`` set, ``mfu`` is tokens/s × FLOPs per token ÷ peak
(relative 1e-12: one product and one quotient in double).
"""

import importlib

import numpy as np
import pytest

from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.telemetry.step_stats import StepStats as JaxStepStats
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models.gpt import (
    GPT, GPTConfig, SyntheticLMDataModule,
)
from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy
from ray_lightning_tpu_torch.telemetry import step_stats
from ray_lightning_tpu_torch.telemetry.runtime import TelemetryConfig
from ray_lightning_tpu_torch.telemetry.step_stats import (
    StepStats, flops_for_module, model_flops_per_token, peak_flops_per_chip,
)

jstats = importlib.import_module("ray_lightning_tpu.telemetry.step_stats")

TELEMETRY_KEYS = {"step_time_ms", "data_wait_ms", "dispatch_ms",
                  "device_step_ms", "examples_per_sec", "tokens_per_sec",
                  "mfu", "recompiles"}


def _port_fit(megastep="off", telemetry=None, steps=6):
    cfg = GPTConfig.tiny()
    tr = Trainer(LocalStrategy(device="cpu", telemetry=telemetry,
                               megastep=megastep),
                 max_steps=steps, limit_val_batches=0,
                 enable_checkpointing=False)
    tr.fit(GPT(cfg, device="cpu"),
           SyntheticLMDataModule(cfg, batch_size=8, num_batches=steps))
    return tr


@pytest.mark.parametrize("megastep", ["off", 4])
def test_cheap_tier_is_the_default(megastep):
    """6 steps (per step; or a stride of 4 and two singles).  The keys
    equal the JAX fit's: held against JAX fits of both loop shapes by
    ``test_torch_train.py::test_fit_matches_the_jax_fit_over_five_steps``
    and ``test_torch_megastep.py``; here, that they are the headline of
    the fit's own ``StepStats`` and what its report carries."""
    tr = _port_fit(megastep)
    keys = set(tr.callback_metrics) & TELEMETRY_KEYS
    assert {"step_time_ms", "data_wait_ms", "dispatch_ms",
            "examples_per_sec", "tokens_per_sec", "recompiles"} <= keys
    assert "mfu" not in keys  # no peak is known for the CPU
    report = tr.telemetry_report
    assert report["tier"] == "cheap"
    assert report["meta"]["megastep"] == (1 if megastep == "off" else 4)
    assert report["step_stats"]["steps"] == 6
    assert report["counters"]["train_dispatches"] == (
        6 if megastep == "off" else 3)
    # No CUDA graph is captured on the CPU.
    assert tr.callback_metrics["recompiles"] == 0.0
    assert tr.callback_metrics["tokens_per_sec"] == pytest.approx(
        tr.callback_metrics["examples_per_sec"] * GPTConfig.tiny().seq_len)


def test_mfu_is_tokens_per_second_times_flops_over_peak(monkeypatch):
    monkeypatch.setenv("RLT_TELEMETRY_PEAK", "1e12")
    tr = _port_fit()
    m = tr.callback_metrics
    flops = model_flops_per_token(GPTConfig.tiny())
    assert m["mfu"] == pytest.approx(m["tokens_per_sec"] * flops / 1e12,
                                     rel=1e-12)
    assert tr.telemetry_report["step_stats"]["mfu_basis"] == "analytic"


@pytest.mark.parametrize("how", ["knob", "env"])
def test_telemetry_off_leaves_no_keys(monkeypatch, how):
    if how == "env":
        monkeypatch.setenv("RLT_TELEMETRY", "off")
    tr = _port_fit(telemetry="off" if how == "knob" else None)
    assert not set(tr.callback_metrics) & TELEMETRY_KEYS
    assert tr.telemetry_report == {}
    assert "train_loss" in tr.callback_metrics


def test_config_coercion_and_refusals(monkeypatch):
    monkeypatch.setenv("RLT_TELEMETRY_SAMPLE", "7")
    assert TelemetryConfig.coerce(None) == TelemetryConfig("cheap", 7)
    assert TelemetryConfig.coerce({"tier": "off"}).tier == "off"
    assert TelemetryConfig.coerce({"sample_every": 3}).sample_every == 3
    with pytest.raises(NotImplementedError, match="spans"):
        TelemetryConfig.coerce("full")
    with pytest.raises(NotImplementedError, match="heartbeat_s"):
        TelemetryConfig.coerce({"heartbeat_s": 1.0})
    with pytest.raises(ValueError, match="tier"):
        TelemetryConfig.coerce("loud")
    with pytest.raises(TypeError):
        TelemetryConfig.coerce(3)


def test_peak_and_flops_lookup(monkeypatch):
    monkeypatch.delenv("RLT_TELEMETRY_PEAK", raising=False)
    assert peak_flops_per_chip("cpu") is None
    assert peak_flops_per_chip() is None
    monkeypatch.setenv("RLT_TELEMETRY_PEAK", "2.5e14")
    assert peak_flops_per_chip("cpu") == 2.5e14
    cfg = GPTConfig.tiny()
    jcfg = JaxGPTConfig.tiny()
    assert flops_for_module(GPT(cfg, device="cpu")) == \
        jstats.flops_for_module(JaxGPT(jcfg))
    assert flops_for_module(object()) == (None, None)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# Records: ("step", step_s, wait_s, disp_s, examples, compiled) or
# ("stride", stride_s, wait_s, disp_s, examples, k, compiled).
_RECORDS = {
    "per_step": [("step", 0.5, 0.01, 0.2, 8, True)]
    + [("step", 0.1 + 0.01 * i, 0.001 * i, 0.02, 8, False)
       for i in range(40)],
    "strides": [("stride", 2.0, 0.02, 0.5, 32, 4, True)]
    + [("stride", 0.3 + 0.02 * i, 0.003, 0.01, 32, 4, False)
       for i in range(12)]
    + [("step", 0.4, 0.0, 0.3, 8, True), ("step", 0.09, 0.0, 0.03, 8,
                                           False)],
    "singles_then_strides": [("step", 0.7, 0.0, 0.1, 8, True)]
    + [("step", 0.1, 0.0, 0.05, 8, False)] * 3
    + [("stride", 1.5, 0.0, 0.2, 64, 8, True)]
    + [("stride", 0.8, 0.001, 0.004, 64, 8, False)] * 5,
}


@pytest.mark.parametrize("records", sorted(_RECORDS))
def test_step_stats_matches_the_jax_step_stats(monkeypatch, records):
    clock = _Clock()
    monkeypatch.setattr(step_stats.time, "perf_counter", clock)
    monkeypatch.setattr(jstats.time, "perf_counter", clock)
    kw = dict(sample_every=8, flops_per_example=3.0e9,
              tokens_per_example=128, peak_flops=1e12)
    port, ref = StepStats(**kw), JaxStepStats(**kw)
    for rec in _RECORDS[records]:
        clock.t += rec[1]
        if rec[0] == "step":
            _, s, w, d, ex, comp = rec
            sampled = port.should_sample()
            assert sampled == ref.should_sample()
            for st in (port, ref):
                st.record_step(s, w, d, ex, sampled=sampled, compiled=comp)
        else:
            _, s, w, d, ex, k, comp = rec
            sampled = port.should_sample_stride(k)
            assert sampled == ref.should_sample_stride(k)
            for st in (port, ref):
                st.record_stride(s, w, d, ex, k, sampled=sampled,
                                 compiled=comp)
    got, want = port.headline(), ref.headline()
    got.pop("recompiles")
    want.pop("recompiles")
    assert got == want
    assert {"step_time_ms", "mfu", "tokens_per_sec"} <= set(got)
    skip = {"recompiles", "compile_total_s", "capture_total_s", "memory"}
    gs = {k: v for k, v in port.summary().items() if k not in skip}
    ws = {k: v for k, v in ref.summary().items() if k not in skip}
    assert gs == ws
    assert np.isfinite(gs["step_mean_ms"])


def _feed(st, records, clock):
    """``records`` into ``st`` under ``clock``, sampled where ``st``
    says."""
    for rec in records:
        clock.t += rec[1]
        if rec[0] == "step":
            _, s, w, d, ex, comp = rec
            st.record_step(s, w, d, ex, sampled=st.should_sample(),
                           compiled=comp)
        else:
            _, s, w, d, ex, k, comp = rec
            st.record_stride(s, w, d, ex, k,
                             sampled=st.should_sample_stride(k),
                             compiled=comp)


@pytest.mark.parametrize("records", sorted(_RECORDS))
def test_drain_books_the_wait_into_the_last_record(monkeypatch, records):
    """The epoch-end wait for the card is booked as if the last step or
    stride had lasted its wall plus the wait: the same numbers, exactly,
    min and max included."""
    clock = _Clock()
    monkeypatch.setattr(step_stats.time, "perf_counter", clock)
    kw = dict(sample_every=8, flops_per_example=3.0e9,
              tokens_per_example=128, peak_flops=1e12)
    wait = 0.75
    drained, ref = StepStats(**kw), StepStats(**kw)
    recs = _RECORDS[records]
    _feed(drained, recs, clock)
    clock.t += wait
    drained.record_drain(wait)
    clock.t = 100.0
    _feed(ref, recs[:-1] + [(recs[-1][0], recs[-1][1] + wait,
                             *recs[-1][2:])], clock)
    assert drained.headline() == ref.headline()
    assert drained.summary() == ref.summary()


def test_drain_after_a_compile_record_is_compile_time():
    st = StepStats(sample_every=8)
    st.record_stride(2.0, 0.0, 0.5, 32, 4)
    st.record_drain(0.25)
    assert st.compile_ms == pytest.approx(2250.0)
    assert "step_time_ms" not in st.headline()


def test_captures_count_as_recompiles():
    st = StepStats()
    st.record_capture(0.25)
    assert st.captures == 1
    assert st.summary()["capture_total_s"] == pytest.approx(0.25)
    assert st.summary()["recompiles"] == 1
    assert st.headline()["recompiles"] == 1.0
