"""The port's SLO and capacity plane and its exports held against the JAX
package (CPU).

``TimeSeriesStore``, ``SloEvaluator`` and ``CapacityOracle`` run the
scripts of the JAX package's ``tests/test_slo_capacity.py`` under one
fake clock on both sides, and their outputs must be equal (an alert's
wall-clock ``ts`` aside).  ``render_openmetrics`` must be byte-equal to
the JAX renderer's for the same snapshot.  The port engine's snapshots,
capacity blocks, alerts, time-series points and span export must be
valid under the JAX package's validators, and ``tools/rlt_top.py --once``
must render its ``serve-live.json``.
"""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from ray_lightning_tpu.serve.capacity import CapacityOracle as JaxOracle
from ray_lightning_tpu.serve.capacity import aggregate_fleet as jax_fleet
from ray_lightning_tpu.serve.metrics import ServeStats as JaxStats
from ray_lightning_tpu.telemetry.export_prom import (
    render_openmetrics as jax_render,
)
from ray_lightning_tpu.telemetry.schema import (
    validate_capacity_snapshot, validate_serve_snapshot, validate_slo_alert,
    validate_span_jsonl, validate_timeseries_point,
)
from ray_lightning_tpu.telemetry.slo import SloEvaluator as JaxSlo
from ray_lightning_tpu.telemetry.slo import SloSpec as JaxSpec
from ray_lightning_tpu.telemetry.slo import (
    default_serve_slos as jax_default_slos,
)
from ray_lightning_tpu.telemetry.timeseries import TimeSeriesStore as JaxStore
from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
from ray_lightning_tpu_torch.serve.capacity import (
    CapacityOracle, aggregate_fleet,
)
from ray_lightning_tpu_torch.serve.engine import ServeConfig, ServeEngine
from ray_lightning_tpu_torch.serve.metrics import ServeStats
from ray_lightning_tpu_torch.telemetry.export_prom import (
    PromExporter, render_openmetrics,
)
from ray_lightning_tpu_torch.telemetry.slo import (
    SloEvaluator, SloSpec, default_serve_slos,
)
from ray_lightning_tpu_torch.telemetry.timeseries import TimeSeriesStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny engines run on one CPU thread (the suite's workers would
    oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _no_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


# ---------------------------------------------------------------------------
# TimeSeriesStore
# ---------------------------------------------------------------------------

def _observe_script(name):
    """(name, value, kind, ts) observations of one JAX test's script."""
    if name == "bounded_ring":
        return [("g", float(i), "gauge", 1000.0 + i) for i in range(10)]
    if name == "last_write_wins":
        return [("g", 1.0, "gauge", 1000.0), ("g", 2.0, "gauge", 1000.5)]
    if name == "counter_reset":
        return [("c", v, "counter", 1000.0 + i)
                for i, v in enumerate((0.0, 10.0, 20.0, 5.0))]
    if name == "out_of_order":
        return [("g", 1.0, "gauge", 1005.0), ("g", 9.0, "gauge", 1001.0)]
    if name == "hist":
        return [("h", float(i), "hist", 1000.0 + i * 0.5)
                for i in range(10)]
    if name == "trend":
        return [("free", 100.0 - 10.0 * i, "gauge", 1000.0 + i)
                for i in range(5)]
    raise KeyError(name)


@pytest.mark.parametrize("script", ["bounded_ring", "last_write_wins",
                                    "counter_reset", "out_of_order", "hist",
                                    "trend"])
def test_time_series_store_equals_jax(script):
    stores = [cls(interval_s=1.0, capacity=4, clock=_Clock())
              for cls in (JaxStore, TimeSeriesStore)]
    for name, value, kind, ts in _observe_script(script):
        for store in stores:
            store.observe(name, value, kind=kind, ts=ts)

    def readings(store):
        out = {"points": store.points(), "names": store.names()}
        for name in store.names():
            kind = store.kind(name)
            out[name] = (
                store.last(name), store.series(name),
                store.series(name, 2.0), store.mean(name, 60.0),
                store.percentile(name, 50.0, 60.0),
                store.percentile(name, 100.0, 60.0),
                store.slope(name, 60.0), store.eta_to(name, 0.0, 60.0),
                store.eta_to(name, 200.0, 60.0),
                store.rate(name, 10.0) if kind == "counter" else None,
            )
        return out

    jax_out, port_out = (readings(s) for s in stores)
    assert port_out == jax_out
    for point in port_out["points"]:
        assert validate_timeseries_point(point, "port") == []


def test_time_series_store_refusals_and_dump(tmp_path):
    store = TimeSeriesStore(clock=_Clock())
    store.observe("x", 1.0)
    with pytest.raises(ValueError, match="is a gauge"):
        store.observe("x", 1.0, kind="counter")
    store.observe("x", 2.0, ts=1002.0)
    with pytest.raises(ValueError, match="wants a counter"):
        store.rate("x", 10.0)
    path = str(tmp_path / "ts.jsonl")
    assert store.dump_jsonl(path) == 2
    for line in open(path):
        assert validate_timeseries_point(json.loads(line), "dump") == []


# ---------------------------------------------------------------------------
# SloEvaluator
# ---------------------------------------------------------------------------

class _SloRig:
    """One package's store and evaluator on a fake clock, fed a counter
    pair per second (the JAX tests' rig)."""

    def __init__(self, store_cls, slo_cls, spec):
        self.clock = _Clock()
        self.store = store_cls(interval_s=1.0, clock=self.clock)
        self.emitted = []
        self.ev = slo_cls(self.store, [spec], clock=self.clock,
                          emit=self.emitted.append)
        self.totals = [0.0, 0.0]

    def tick(self, submitted=10.0, rejected=0.0, gauge=None):
        self.clock.t += 1.0
        self.totals[0] += submitted
        self.totals[1] += rejected
        self.store.observe("submitted", self.totals[0], kind="counter")
        self.store.observe("rejected", self.totals[1], kind="counter")
        if gauge is not None:
            self.store.observe("queue_wait_p50_ms", gauge)
        return self.ev.evaluate()


def _spec(spec_cls, mode):
    if mode == "ratio":
        return spec_cls(name="avail", target=0.5, mode="ratio",
                        bad="rejected", total="submitted",
                        windows=((2.0, 6.0, 1.0),))
    return spec_cls(name="wait", target=0.5, mode="threshold",
                    gauge="queue_wait_p50_ms", threshold=100.0,
                    windows=((2.0, 6.0, 1.0),))


SLO_SCRIPTS = {
    "fires_once_while_burning": ("ratio", [dict(rejected=10.0)] * 8),
    "fast_spike_stays_silent": ("ratio", [{}] * 7
                                + [dict(rejected=10.0)] * 2),
    "rearms_after_recovery": ("ratio", [dict(rejected=10.0)] * 8 + [{}] * 10
                              + [dict(rejected=10.0)] * 8),
    "threshold_counts_bins": ("threshold", [dict(gauge=500.0)] * 8),
    "threshold_mixed": ("threshold", [dict(gauge=50.0), dict(gauge=500.0)]
                        * 5),
}


@pytest.mark.parametrize("name", sorted(SLO_SCRIPTS))
def test_slo_evaluator_equals_jax(name):
    mode, ticks = SLO_SCRIPTS[name]
    rigs = [_SloRig(JaxStore, JaxSlo, _spec(JaxSpec, mode)),
            _SloRig(TimeSeriesStore, SloEvaluator, _spec(SloSpec, mode))]
    for kw in ticks:
        fired = [rig.tick(**kw) for rig in rigs]
        assert _no_ts(fired[1]) == _no_ts(fired[0])
        assert rigs[1].ev.snapshot() == rigs[0].ev.snapshot()
    assert rigs[1].ev.alerts_total == rigs[0].ev.alerts_total
    assert _no_ts(rigs[1].emitted) == _no_ts(rigs[0].emitted)
    for alert in rigs[1].emitted:
        assert validate_slo_alert(alert, "port") == []


def test_slo_spec_validation_and_defaults():
    with pytest.raises(ValueError, match="outside"):
        SloSpec(name="bad", target=1.5)
    with pytest.raises(ValueError, match="needs bad"):
        SloSpec(name="bad", target=0.9, mode="ratio")
    with pytest.raises(ValueError, match="needs gauge"):
        SloSpec(name="bad", target=0.9, mode="threshold")
    with pytest.raises(ValueError, match="unknown mode"):
        SloSpec(name="bad", target=0.9, mode="latency")
    with pytest.raises(ValueError, match="duplicate"):
        SloEvaluator(TimeSeriesStore(clock=_Clock()),
                     [_spec(SloSpec, "ratio")] * 2)
    assert [s.__dict__ for s in default_serve_slos(250.0)] == \
        [s.__dict__ for s in jax_default_slos(250.0)]


# ---------------------------------------------------------------------------
# CapacityOracle
# ---------------------------------------------------------------------------

C_US, H_US, ADMIT_US = 20000.0, 1000.0, 5000.0


def _tick_bins(busies, ticks=10, admitted=2):
    return [dict(gauges={"num_slots": 8.0, "slots_active": float(b)},
                 decode_steps=ticks, decode_us=ticks * (C_US + H_US * b),
                 tokens_out=ticks * b + admitted, admitted=admitted,
                 admit_us=admitted * ADMIT_US, submitted=admitted)
            for b in busies]


def _eta_bins():
    return [dict(gauges={"num_slots": 8.0, "slots_active": 2.0,
                         "blocks_free": 120.0 - 10.0 * i},
                 tokens_out=20, submitted=10, rejected=1) for i in range(6)]


ORACLE_SCRIPTS = {
    "tick_model": _tick_bins([1, 3, 5, 7, 2, 4, 6, 8, 1, 5, 3, 7]),
    "saturated": _tick_bins([8] * 10),
    "counter_reset": _tick_bins([1, 3, 5, 7, 2, 4]) + ["reset"]
    + _tick_bins([6, 8, 1, 5, 3, 7]),
    "gauge_fallback": [dict(gauges={"num_slots": 8.0,
                                    "slots_active": 2.0},
                            tokens_out=20, submitted=2)] * 6,
    "kv_eta_and_rejections": _eta_bins(),
    "fresh": [],
}


@pytest.mark.parametrize("name", sorted(ORACLE_SCRIPTS))
def test_capacity_oracle_equals_jax(name):
    sides = []
    for cls in (JaxOracle, CapacityOracle):
        clock = _Clock()
        oracle = cls(interval_s=1.0, window_s=60.0, clock=clock)
        counters = {}
        for step in ORACLE_SCRIPTS[name]:
            if step == "reset":
                counters = {}
                continue
            step = dict(step)
            gauges = step.pop("gauges", {})
            clock.t += 1.0
            for key, d in step.items():
                counters[key] = counters.get(key, 0) + d
            oracle.observe({"ts": clock.t, "counters": dict(counters),
                            "gauges": dict(gauges), "latency": {}},
                           recompiles=0)
        sides.append((oracle._tick_model(60.0), oracle.snapshot(60.0),
                      oracle.predict_saturation_rps(16, window_s=60.0)))
    assert sides[1] == sides[0]
    assert validate_capacity_snapshot(sides[1][1], "port") == []


def test_aggregate_fleet_equals_jax():
    blocks = [{"tokens_per_s": 100.0, "capacity_tokens_per_s": 200.0,
               "kv_exhaustion_eta_s": 30.0}, None,
              {"tokens_per_s": 50.0, "capacity_tokens_per_s": 100.0,
               "kv_exhaustion_eta_s": 12.0}]
    assert aggregate_fleet(blocks) == jax_fleet(blocks)
    assert aggregate_fleet([None, 3, "x"]) is None


def test_capacity_view_equals_jax():
    stats = [JaxStats(), ServeStats()]
    for s in stats:
        s.bump("tokens_out", 7)
        s.set_gauges(slots_active=2, queue_depth=1)
        for w in (0.001, 0.004, 0.002):
            s.note_admitted(w)
    views = [s.capacity_view() for s in stats]
    assert _no_ts([views[1]]) == _no_ts([views[0]])
    assert _no_ts([ServeStats().capacity_view()]) == \
        _no_ts([JaxStats().capacity_view()])


# ---------------------------------------------------------------------------
# OpenMetrics
# ---------------------------------------------------------------------------

def _rich_snapshot():
    """Every section the port renders: ranks and events, serve (gauges,
    counters with spec families, lora, prefix, latency, phases), its
    capacity block, and SLOs."""
    return {
        "ranks_reporting": 2, "aborted": False,
        "ranks": {"0": {"global_step": 5, "step_time_ms": 12.5,
                        "status": "ok", "age_s": 0.25},
                  "1": {"progress": 3, "status": "stalled",
                        "host_load": 1.5}},
        "serve": {
            "ts": 1000.0,
            "counters": {"submitted": 9, "completed": 6, "expired": 2,
                         "rejected": 1, "spec_drafted": 40,
                         "spec_accepted": 31, "spec_emitted": 37,
                         "spec_ticks": 10, "decode_us": 12345},
            "gauges": {"queue_depth": 1.0, "slots_active": 3.0,
                       "num_slots": 8.0, "blocks_free": 100.0,
                       "blocks_live": 20.0, "num_blocks": 121.0,
                       "spec_acceptance_rate": 0.775,
                       "lora_adapters_loaded": 2.0, "lora_slots_free": 1.0,
                       "lora_fairness_spread": 0.5},
            "latency": {"ttft": {"n": 6, "p50_ms": 10.5, "p99_ms": 20.25,
                                 "max_ms": 21.0},
                        "token": {"n": 40, "p50_ms": 1.5, "p99_ms": 3.0,
                                  "max_ms": 3.5}},
            "phases": {"queue_wait": {"n": 6, "p50_ms": 0.1, "p95_ms": 2.0},
                       "first_token": {"n": 6, "p50_ms": 0.3,
                                       "p95_ms": 0.5}},
            "adapters": {"t\"0": {"tokens_out": 10, "completed": 2},
                         "t1": {"tokens_out": 5, "completed": 1}},
            "prefix": {"hit_rate": 0.5, "lookups": 4, "hits": 2,
                       "blocks_claimed": 3, "blocks_inserted": 7,
                       "blocks_evicted": 1, "cached_blocks": 6},
            "capacity": {"type": "capacity_snapshot", "ts": 1000.0,
                         "window_s": 30.0, "tokens_per_s": 40.0,
                         "service_rate_per_slot": None,
                         "capacity_tokens_per_s": 80.0,
                         "headroom_tokens_per_s": 40.0,
                         "utilization": 0.5, "kv_exhaustion_eta_s": None,
                         "queue_wait_slope_ms_per_s": -0.25,
                         "queue_depth": 1.0, "rejection_rate": 0.0},
        },
        "slo": {"serve_availability": {"firing": True, "burn_rate": 3.2,
                                       "error_rate": 0.04, "target": 0.99,
                                       "alerts_total": 1},
                "serve_queue_wait": {"firing": False, "burn_rate": 0.0,
                                     "error_rate": 0.0, "target": 0.9,
                                     "alerts_total": 0}},
    }


@pytest.mark.parametrize("case", ["empty", "rich", "serve_only",
                                  "serve_without_capacity"])
def test_render_openmetrics_is_byte_equal_to_jax(case):
    snap = {} if case == "empty" else _rich_snapshot()
    if case == "serve_only":
        snap = {"serve": snap["serve"]}
    if case == "serve_without_capacity":
        snap = {"serve": {k: v for k, v in snap["serve"].items()
                          if k != "capacity"}}
    assert render_openmetrics(snap) == jax_render(snap)


# ---------------------------------------------------------------------------
# The port engine's exports
# ---------------------------------------------------------------------------

CFG = dict(vocab_size=128, n_layer=2, n_head=4, d_model=64, seq_len=64)


@pytest.fixture(scope="module")
def model():
    m = GPT(GPTConfig(**CFG), device="cpu")
    return m, m.init_params(torch.Generator().manual_seed(0))


def _adapter(seed):
    L, d, r = CFG["n_layer"], CFG["d_model"], 4
    rng = np.random.default_rng(seed)
    shapes = {"qkv_a": (L, d, r), "qkv_b": (L, r, 3 * d),
              "proj_a": (L, d, r), "proj_b": (L, r, d)}
    out = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
           for k, s in shapes.items()}
    out["scale"] = 1.0
    return out


def test_engine_exports_are_valid_and_render(model, tmp_path):
    """Plane on, tracing on, a tenant and the prefix cache: the
    snapshot, its capacity block, the SLO alerts, the store's points and
    the span export are valid under the JAX validators; the prom text is
    the JAX renderer's; one HTTP scrape serves it; ``rlt_top --once``
    renders the live file."""
    m, params = model
    port = None
    engine = ServeEngine(
        m, params,
        ServeConfig(num_slots=2, block_size=8, num_blocks=24,
                    max_adapters=2, adapter_rank=4, prefix_cache=True,
                    capacity=True, slo=True, ts_interval_s=0.1,
                    export_every_s=0.0,
                    slo_windows=((0.2, 0.4, 0.5),)),
        adapters={"t0": _adapter(1)}, device="cpu",
        telemetry_dir=str(tmp_path), prom_file=str(tmp_path / "m.prom"),
        prom_port=0, trace_dir=str(tmp_path), trace_name="t")
    try:
        port = engine._exporter.port
        for seed in range(4):
            engine.generate([seed + 1, 5, 9, 11], 4,
                            adapter="t0" if seed % 2 else None)
        assert engine.submit([1, 2], 3, deadline_s=-1.0).done() is False
        engine.step()
        counters = engine.stats.snapshot()["counters"]
        assert counters["decode_us"] > 0 and counters["admit_us"] > 0
        assert counters["expired"] == 1
        engine._maybe_export(force=True)
        snap = engine.snapshot()
        assert validate_serve_snapshot(snap, "port") == []
        assert set(snap["phases"]) == {"queue_wait", "prefill_compute",
                                       "first_token"}
        assert validate_capacity_snapshot(snap["capacity"], "port") == []
        for point in engine.capacity_oracle.store.points():
            assert validate_timeseries_point(point, "port") == []
        for alert in engine.slo_alerts:
            assert validate_slo_alert(alert, "port") == []
        payload = {"serve": snap, "slo": engine.slo_evaluator.snapshot()}
        text = render_openmetrics(payload)
        assert text == jax_render(payload)
        assert 'rlt_serve_requests_total{kind="expired"} 1' in text
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            scraped = r.read().decode()
        assert 'rlt_serve_requests_total{kind="completed"} 4' in scraped
        assert "rlt_capacity_" in scraped and "rlt_slo_burn_rate" in scraped
    finally:
        engine.stop()
    live = json.load(open(tmp_path / "serve-live.json"))
    assert set(live) == {"ts", "serve", "slo"}
    assert validate_serve_snapshot(live["serve"], "live") == []
    assert open(tmp_path / "m.prom").read().endswith("# EOF\n")
    lines = open(tmp_path / "trace-serve-t.jsonl").read().splitlines()
    assert validate_span_jsonl(lines, "spans") == []
    names = [json.loads(line)["name"] for line in lines]
    for phase in ("queue_wait", "prefill_compute", "first_token",
                  "request"):
        assert names.count(phase) >= 4, phase
    top = subprocess.run([sys.executable, "tools/rlt_top.py", "--once",
                          str(tmp_path)], cwd=REPO, capture_output=True,
                         text=True, timeout=60)
    assert top.returncode == 0, top.stderr
    for pane in ("serve:", "lora:", "phases:", "capacity:", "slo:"):
        assert pane in top.stdout, pane


def test_plane_off_carries_no_capacity_block_or_phases(model):
    m, params = model
    engine = ServeEngine(m, params, ServeConfig(num_slots=2, block_size=8),
                         device="cpu")
    engine.generate([1, 5, 9], 4)
    assert engine.capacity_oracle is None and engine.slo_evaluator is None
    assert engine.slo_alerts == []
    snap = engine.snapshot()
    assert "capacity" not in snap and "phases" not in snap
    assert validate_serve_snapshot(snap, "port") == []
    assert not engine.tracer.enabled and engine.tracer.events() == []


def test_prom_exporter_textfile_and_port(tmp_path):
    path = str(tmp_path / "sub" / "m.prom")
    exporter = PromExporter(textfile=path, port=0)
    try:
        exporter.update({"serve": _rich_snapshot()["serve"]})
        text = open(path).read()
        assert text == jax_render({"serve": _rich_snapshot()["serve"]})
        with urllib.request.urlopen(
                f"http://127.0.0.1:{exporter.port}/metrics",
                timeout=10) as r:
            assert r.read().decode() == text
    finally:
        exporter.close()
