"""The port's disaggregated serving plane held against the JAX package
(CPU, f32), at the JAX tests' size: vocab 128, 2 layers, 4 heads, d 64,
``num_slots=2``, ``block_size=8``, parameters converted from the JAX
pytree (block matrices scaled up so greedy streams vary), two rank-4
tenants.  Checked:

* the wire frames field for field against the JAX makers, valid under
  the JAX schema, and the KV payload codec across packages;
* ``RestartGovernor``, ``BrownoutLadder`` and ``Router`` against the JAX
  ones under one scripted clock and one scripted sequence of hellos,
  beats and requests over stub members: the same placements,
  rejections, failovers, snapshot and OpenMetrics lines;
* ``export_blocks`` / ``import_blocks`` round trips (f32 and bf16,
  bitwise), their refusals, and blocks moved across packages;
* handoff admission: a JAX prefill worker's frame admitted by the port's
  engine gives the JAX engine's stream; an import equals the local
  prefill (blocks and first token, bitwise); the ``shm`` form consumed
  and unlinked; the typed geometry ``invalid``; a torn payload on the
  failed feed; a handoff waiting for its tenant; migration adoption;
* the in-process fleet: the port's fleet, the port's monolith and the JAX
  fleet give equal greedy streams; hard failover and drain migration
  keep the streams (greedy and sampled) with zero lost requests, the
  drain with zero re-emitted tokens; the teardown sweeps.

The router units drive ``Router.poll(now=...)`` and the ladder's
injected clock, never sleeps.
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.cluster.queue import DriverQueue as JaxDriverQueue
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.serve.brownout import BrownoutLadder as JaxLadder
from ray_lightning_tpu.serve.client import ServeClient as JaxServeClient
from ray_lightning_tpu.serve.engine import ServeConfig as JaxServeConfig
from ray_lightning_tpu.serve.engine import ServeEngine as JaxServeEngine
from ray_lightning_tpu.serve.lora import encode_adapter as jax_encode_adapter
from ray_lightning_tpu.telemetry.export_prom import (
    render_openmetrics as jax_render,
)
from ray_lightning_tpu.telemetry.propagate import (
    root_context as jax_root_context,
)
from ray_lightning_tpu.telemetry.schema import (
    validate_router_snapshot, validate_serve_adapter_load,
    validate_serve_kv_handoff, validate_serve_migration,
    validate_serve_reply, validate_serve_request,
)
from ray_lightning_tpu_torch.cluster.queue import DriverQueue
from ray_lightning_tpu_torch.cluster.shm import segment_dir
from ray_lightning_tpu_torch.models.convert import (
    adapter_from_jax, params_from_jax,
)
from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
from ray_lightning_tpu_torch.mpmd.transfer import encode_tree
from ray_lightning_tpu_torch.serve import ServeClient, ServeConfig, ServeEngine
from ray_lightning_tpu_torch.serve.brownout import BrownoutLadder
from ray_lightning_tpu_torch.serve.dist import (
    PrefillRunner, RestartGovernor, Router, launch_inproc_fleet,
)
from ray_lightning_tpu_torch.serve.dist import handoff as port_handoff
from ray_lightning_tpu_torch.serve.kv_cache import (
    PagedKVCache, import_blocks,
)
from ray_lightning_tpu_torch.serve.lora import encode_adapter
from ray_lightning_tpu_torch.telemetry.export_prom import render_openmetrics
from ray_lightning_tpu_torch.telemetry.propagate import root_context

jax_handoff = importlib.import_module("ray_lightning_tpu.serve.dist.handoff")
jax_router = importlib.import_module("ray_lightning_tpu.serve.dist.router")
jkv = importlib.import_module("ray_lightning_tpu.serve.kv_cache")

CFG = dict(vocab_size=128, n_layer=2, n_head=4, d_model=64, seq_len=64)
RANK = 4
TENANTS = ("t0", "t1")
TIMEOUT = 60


class _ExactJaxOutbox(jax_handoff.MemberOutbox):
    """The JAX package's outbox with an exact ``pending``.  Its own reads
    0 while its thread holds a frame taken off the queue but not yet
    marked as sending, so ``Router.flush_outboxes`` can return before
    that frame reaches its queue, and a rig's ``collect`` then finds it
    one call late.  Here a frame counts from ``put`` until its send has
    returned or raised (the port's ``MemberOutbox.pending``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._count_lock = threading.Lock()
        self._unsettled = 0
        send = self._sender.put

        def counted_send(addr, item):
            try:
                return send(addr, item)
            finally:
                with self._count_lock:
                    self._unsettled -= 1

        self._sender.put = counted_send

    def put(self, item, on_sent=None):
        with self._count_lock:
            self._unsettled += 1
        try:
            super().put(item, on_sent=on_sent)
        except BaseException:
            with self._count_lock:
                self._unsettled -= 1
            raise

    @property
    def pending(self):
        return self._unsettled


@pytest.fixture(autouse=True)
def exact_jax_flush(monkeypatch):
    """Every JAX router of this file flushes exactly (``_ExactJaxOutbox``);
    the port's ``MemberOutbox`` counts the same way itself."""
    monkeypatch.setattr(jax_router, "MemberOutbox", _ExactJaxOutbox)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the fleets run several engines on threads, and
    under the suite's parallel workers torch's own threads oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompt(seed, length):
    rng = np.random.default_rng(seed)
    return rng.integers(1, CFG["vocab_size"], size=(length,)).tolist()


def _factors(seed):
    L, d = CFG["n_layer"], CFG["d_model"]
    rng = np.random.default_rng(seed)
    return {
        "qkv_a": (rng.standard_normal((L, d, RANK)) * 0.02).astype(np.float32),
        "qkv_b": (rng.standard_normal((L, RANK, 3 * d)) * 0.3).astype(
            np.float32),
        "proj_a": (rng.standard_normal((L, d, RANK)) * 0.02).astype(
            np.float32),
        "proj_b": (rng.standard_normal((L, RANK, d)) * 0.3).astype(
            np.float32),
        "scale": 2.0,
    }


@pytest.fixture(scope="module")
def world():
    jm = JaxGPT(JaxGPTConfig(**CFG, warmup_steps=1), attn_impl="xla")
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    for key in ("qkv_w", "proj_w", "mlp_in_w", "mlp_out_w"):
        tree["blocks"][key] = tree["blocks"][key] * 10.0
    adapters = {name: _factors(10 + i) for i, name in enumerate(TENANTS)}
    return dict(
        jm=jm, jp=jax.tree.map(jnp.asarray, tree), j_adapters=adapters,
        tm=GPT(GPTConfig(**CFG), device="cpu"),
        tp=params_from_jax(tree, "cpu"),
        t_adapters={k: adapter_from_jax(v, "cpu")
                    for k, v in adapters.items()},
    )


def _serve_cfg(**kw):
    cfg = dict(num_slots=2, block_size=8, max_adapters=2, adapter_rank=RANK)
    cfg.update(kw)
    return ServeConfig(**cfg)


def _engine(world, **kw):
    return ServeEngine(world["tm"], world["tp"], _serve_cfg(**kw),
                       adapters=world["t_adapters"], device="cpu")


def _monolith(world, reqs, max_new):
    """The port's monolith over ``reqs`` = [(prompt, temperature,
    adapter)], submitted in order (sample seeds = submission ordinals, as
    the router stamps them)."""
    eng = _engine(world)
    try:
        handles = [eng.submit(p, max_new, temperature=t, adapter=a)
                   for p, t, a in reqs]
        eng.run_until_idle()
        return [h.result(0) for h in handles]
    finally:
        eng.stop()


def _drain_queue(q, timeout=2.0):
    """What ``q`` holds, waiting up to ``timeout`` for a first item."""
    items = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            items.append(q.get(timeout=0.05))
        except Exception:  # noqa: BLE001 - queue.Empty of either package
            if items:
                return items
    return items


def _queued(q):
    """What ``q`` holds now (a put is acked once it is enqueued, so a
    flushed send is already here)."""
    items = []
    while True:
        try:
            items.append(q.get_nowait())
        except Exception:  # noqa: BLE001 - queue.Empty of either package
            return items


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

def _frames(h, ctx):
    """Every frame kind made by package ``h`` with the same arguments."""
    req = h.request_fields("rid1", [1, 2, 3], 8, reply=("127.0.0.1", 9),
                           sample_seed=3, temperature=0.5, top_k=4,
                           adapter="t0", priority=1, trace=ctx)
    plain = h.request_fields("rid1", [1, 2, 3], 8, reply=("127.0.0.1", 9),
                             sample_seed=3)
    return {
        "request": (req, validate_serve_request),
        "dispatch": (h.make_dispatch_item(req, ("127.0.0.1", 5), True),
                     None),
        "handoff_data": (h.make_handoff_item(plain, 8, data=b"x",
                                             trace=ctx),
                         validate_serve_kv_handoff),
        "handoff_shm": (h.make_handoff_item(plain, 8, shm="/dev/shm/y"),
                        validate_serve_kv_handoff),
        "adapter_load": (h.make_adapter_load_item("t0", 4, data=b"z"),
                         validate_serve_adapter_load),
        "hello": (h.make_hello_item("decode", "r0", ("h", 7), num_slots=2,
                                    max_queue=1, spec_k=0), None),
        "beat": (h.make_beat_item(
            "decode", "r0", done=[("a", "finished")], failed=[("b", "e")],
            snapshot={"gauges": {}}, recompiles=0, adapters=["t0"],
            closing=True, migrating=["c"]), None),
        "migration": (h.make_migration_item(
            plain, generated=[5, 6], cur_token=6, seq_len=4, data=b"kv",
            trace=ctx), validate_serve_migration),
        "cancel": (h.make_cancel_item("rid1"), None),
    }


def _strip_ts(item):
    """A frame without its wall-clock stamps (the beat's ``ts`` and the
    trace context's send time)."""
    out = {k: v for k, v in item.items() if k != "ts"}
    if isinstance(out.get("trace"), dict):
        out["trace"] = {k: v for k, v in out["trace"].items() if k != "ts"}
    for key in ("req",):
        if isinstance(out.get(key), dict):
            out[key] = _strip_ts(out[key])
    return out


@pytest.mark.parametrize("kind", ["request", "dispatch", "handoff_data",
                                  "handoff_shm", "adapter_load", "hello",
                                  "beat", "migration", "cancel"])
def test_frames_equal_jax_and_validate(kind):
    port = _frames(port_handoff, root_context("rid1"))[kind]
    ref = _frames(jax_handoff, jax_root_context("rid1"))[kind]
    assert _strip_ts(port[0]) == _strip_ts(ref[0])
    if port[1] is not None:
        assert port[1](port[0]) == [], port[0]


def test_one_payload_form_and_kv_codec_across_packages():
    req = port_handoff.request_fields("r", [1], 1, reply=("h", 1),
                                      sample_seed=0)
    for kw in ({}, {"data": b"x", "shm": "/y"}):
        with pytest.raises(ValueError, match="exactly one"):
            port_handoff.make_handoff_item(req, 8, **kw)
        with pytest.raises(ValueError, match="exactly one"):
            port_handoff.make_adapter_load_item("t", 4, **kw)
    rng = np.random.default_rng(0)
    kv = {k: rng.standard_normal((2, 3, 8, 4, 16)).astype(np.float32)
          for k in ("k", "v")}
    logits = rng.standard_normal((128,)).astype(np.float32)
    for enc, dec in ((jax_handoff.encode_kv_payload,
                      port_handoff.decode_kv_payload),
                     (port_handoff.encode_kv_payload,
                      jax_handoff.decode_kv_payload)):
        back = dec({"data": enc(kv, logits)})
        for k in ("k", "v"):
            np.testing.assert_array_equal(np.asarray(back["kv"][k]), kv[k])
        np.testing.assert_array_equal(np.asarray(back["logits"]), logits)


# ---------------------------------------------------------------------------
# Governor, ladder
# ---------------------------------------------------------------------------

def test_restart_governor_decisions_equal_jax():
    times = [0.0, 1.0, 2.0, 11.5, 12.0, 12.5, 30.0, 100.0]
    for budget, window in ((2, 10.0), (0, 10.0), (3, 5.0)):
        port = RestartGovernor(max_restarts=budget, window_s=window)
        ref = jax_router.RestartGovernor(max_restarts=budget,
                                         window_s=window)
        got = [port.permit(now=t) for t in times]
        assert got == [ref.permit(now=t) for t in times]
    assert got.count(True) >= 1
    with pytest.raises(ValueError):
        RestartGovernor(max_restarts=-1)


def test_brownout_ladder_decisions_equal_jax():
    """Levels and probe decisions step for step under one clock, over a
    utilization script that climbs, holds inside the exit margin and
    falls."""
    rng = np.random.default_rng(3)
    script = [0.9, 0.99, 0.99, 1.0, 1.0, 1.05, 0.94, 0.1, 0.5, 0.96, 0.0] \
        + rng.uniform(0.0, 1.1, size=40).tolist()
    clock = [0.0]
    port = BrownoutLadder(min_dwell_s=1.0, probe_every_s=5.0,
                          clock=lambda: clock[0])
    ref = JaxLadder(min_dwell_s=1.0, probe_every_s=5.0,
                    clock=lambda: clock[0])
    seen = set()
    for i, util in enumerate(script):
        clock[0] = 0.55 * i
        lvl = port.observe(util)
        assert lvl == ref.observe(util), i
        assert port.allow_probe() == ref.allow_probe(), i
        seen.add(lvl)
    assert seen == {0, 1, 2, 3}
    for bad in ({"enter": (0.9, 0.8, 1.0)}, {"exit_margin": 0.0},
                {"max_new_cap": 0}, {"enter": (0.5, 0.9)}):
        with pytest.raises(ValueError):
            BrownoutLadder(**bad)


# ---------------------------------------------------------------------------
# Router: the same script through both routers over stub members
# ---------------------------------------------------------------------------

class _Stub:
    def __init__(self, member_id):
        self.id = member_id
        self.alive = True
        self.killed = False

    def is_alive(self):
        return self.alive

    def kill(self):
        self.killed = True


CAPS = {"num_slots": 2, "max_queue": 1, "spec_k": 0, "max_prompt_len": 16,
        "max_model_len": 64, "block_size": 8, "max_adapters": 2}


class _Rig:
    """One package's router with stub members on real queues; every
    address is mapped back to a member name, so the two packages'
    records compare."""

    def __init__(self, pkg, lost_after_s=5.0, **router_kw):
        if pkg == "port":
            self.router_cls, self.queue_cls, self.h = (
                Router, DriverQueue, port_handoff)
            self.render, self.Governor = render_openmetrics, RestartGovernor
        else:
            self.router_cls, self.queue_cls, self.h = (
                jax_router.Router, JaxDriverQueue, jax_handoff)
            self.render = jax_render
            self.Governor = jax_router.RestartGovernor
        self.spawned = []
        self.router = self.router_cls(
            lost_after_s=lost_after_s, hello_grace_s=100.0,
            governor=self.Governor(max_restarts=1),
            prefill_factory=self._factory, migration_claim_s=3.0,
            **router_kw)
        self.queues, self.stubs, self.names = {}, {}, {}
        self.client = self.queue_cls()
        self.names[(self.client.handle.host,
                    self.client.handle.port)] = "client"

    def _factory(self):
        stub = _Stub(f"px{len(self.spawned)}")
        self.spawned.append(stub)
        return stub

    def member(self, role, mid, now, **caps):
        q = self.queue_cls()
        stub = _Stub(mid)
        (self.router.add_replica if role == "decode"
         else self.router.add_prefill)(stub)
        self.queues[mid], self.stubs[mid] = q, stub
        self.names[(q.handle.host, q.handle.port)] = mid
        # A put returns once the frame is enqueued: the poll sees it.
        self.router.beat_handle.put(self.h.make_hello_item(
            role, mid, (q.handle.host, q.handle.port), **{**CAPS, **caps}))
        self.router.poll(now=now)

    def beat(self, mid, now, role="decode", **kw):
        self.router.beat_handle.put(self.h.make_beat_item(role, mid, **kw))
        self.router.poll(now=now)

    def submit(self, rid, now, prompt=(1, 2, 3), **kw):
        item = {"type": "serve_request", "rid": rid, "prompt": list(prompt),
                "max_new_tokens": kw.pop("max_new_tokens", 4),
                "reply": [self.client.handle.host, self.client.handle.port],
                **kw}
        self.router.submit_request(item, now=now)

    def collect(self):
        """Every frame each member and the client received since the last
        call, addresses mapped to names and bulk payloads dropped."""
        assert self.router.flush_outboxes(10)
        out = {}
        for name, q in [("client", self.client)] + sorted(
                self.queues.items()):
            frames = []
            for item in _queued(q):
                item = dict(item)
                if "kv_to" in item:
                    item["kv_to"] = self.names[tuple(item["kv_to"])]
                if "req" in item:
                    item["req"] = dict(item["req"], reply=self.names[
                        tuple(item["req"]["reply"])])
                if "reply" in item:
                    item["reply"] = self.names[tuple(item["reply"])]
                item.pop("data", None)
                frames.append(item)
            out[name] = frames
        return out

    def snapshot(self):
        snap = self.router.snapshot()
        snap.pop("ts")
        for entry in snap["replicas"] + snap["workers"]:
            entry.pop("last_beat_age_s", None)
        return snap

    def close(self):
        self.router.stop()
        self.client.shutdown()
        for q in self.queues.values():
            q.shutdown()


def _router_script(rig, world, t):
    """Hellos, placements (least loaded, prefix affinity, adapters with
    their load frame ahead of the dispatch), typed rejections, done and
    failed beats, a worker death and respawn, a replica death with
    failover, a migration frame, a closing beat, on a clock scripted from
    ``t``.  Returns the records."""
    rec = []
    rig.member("decode", "r0", t)
    rig.member("decode", "r1", t)
    rig.member("prefill", "p0", t)
    rig.router.register_adapter("t0", world["j_adapters"]["t0"])
    rec.append(("ready", rig.collect(), rig.snapshot()))
    for i in range(3):
        rig.submit(f"q{i}", t, prompt=(1 + i, 2, 3))
    rig.submit("aff", t, prompt=(1, 2, 3))          # q0's prompt family
    rig.submit("ten", t, prompt=(9, 9), adapter="t0")
    rec.append(("placed", rig.collect(), dict(rig.router.counters)))
    rig.submit("big", t, prompt=tuple(range(40)))    # past the bucket
    rig.submit("spec", t, spec=2)                    # no draft replica
    rig.submit("ghost", t, adapter="nobody")
    rig.submit("long", t, max_new_tokens=100)        # past max_model_len
    rig.router.queue_handle().put({
        "type": "serve_request", "rid": "m1", "prompt": [1, 2],
        "max_new_tokens": None,
        "reply": [rig.client.handle.host, rig.client.handle.port]})
    rig.router.poll(now=t)
    rig.submit("fill", t)                            # the 6th seat
    rig.submit("over", t)                            # full: rejected
    rec.append(("rejections", rig.collect(), dict(rig.router.counters)))
    rig.beat("p0", t + 0.1, role="prefill", done=[("q0", "handoff")],
             failed=[("q1", "ConnectionError()")])
    rig.beat("r0", t + 0.2, done=[("q0", "finished")])
    rec.append(("beats", rig.collect(), rig.snapshot()))
    rig.stubs["p0"].alive = False
    rig.router.poll(now=t + 0.3)
    rec.append(("worker death", rig.collect(), rig.snapshot()))
    rig.stubs["r1"].alive = False
    rig.router.poll(now=t + 0.4)
    rec.append(("replica death", rig.collect(), rig.snapshot()))
    rig.member("decode", "r2", t + 0.5)
    rig.beat("r0", t + 0.6, migrating=["aff"])
    rig.router.beat_handle.put(rig.h.make_migration_item(
        rig.router._inflight["aff"].req, generated=[5], cur_token=5,
        seq_len=3, data=b"kv"))
    rig.router.poll(now=t + 0.7)
    rig.submit("late", t + 0.7)
    rig.beat("r0", t + 0.8, closing=True)
    rec.append(("drain", rig.collect(), rig.snapshot()))
    snap = rig.router.snapshot()
    assert validate_router_snapshot(snap) == [], snap
    rec.append(("prom", sorted(
        line for line in rig.render({"router": rig.snapshot()}).splitlines()
        if not line.startswith("rlt_serve_replica_last_beat")), None))
    return rec


def test_router_script_equals_jax(world):
    # The script's clock starts at the routers' own (``time.monotonic``),
    # read once for both packages: a router stamps a member's registration
    # with that clock, and the worker it respawns says no hello, so its
    # age at the script's later polls is the script's time less the
    # clock's.  From a fixed 1000.0 s, a host whose monotonic clock read
    # under ~900 s (freshly booted) saw the respawned worker 100 s
    # (``hello_grace_s``) overdue and declared it lost again, in both
    # packages alike.
    t = time.monotonic()
    rigs = {pkg: _Rig(pkg) for pkg in ("port", "jax")}
    try:
        got = {pkg: _router_script(rig, world, t)
               for pkg, rig in rigs.items()}
    finally:
        for rig in rigs.values():
            rig.close()
    port, ref = got["port"], got["jax"]
    assert [r[0] for r in port] == [r[0] for r in ref]
    for (label, frames, extra), (_, ref_frames, ref_extra) in zip(port, ref):
        assert frames == ref_frames, label
        assert extra == ref_extra, label
    placed = dict((r[0], r[1]) for r in port)["placed"]
    # Every placement went through the worker (with the replica it
    # names), the tenant's load frame ahead of its dispatch.
    kinds = [f["type"] for f in placed["p0"]]
    assert kinds.count("serve_prefill_dispatch") == 5
    assert kinds.index("serve_adapter_load") < [
        f.get("rid") for f in placed["p0"]].index("ten")
    counters = port[-2][2]["counters"]
    assert counters["failovers"] == 1 and counters["replica_deaths"] == 1
    assert counters["worker_deaths"] == 1
    assert counters["prefill_respawns"] == 1
    assert counters["migrations"] == 1 and counters["replica_drains"] == 1
    assert counters["invalid"] == 5 and counters["rejected"] == 1
    migrated = [f for f in dict((r[0], r[1]) for r in port)["drain"]["r2"]
                if f["type"] == "serve_migration"]
    assert [f["rid"] for f in migrated] == ["aff"]
    assert any(line.startswith('rlt_serve_router_total{kind="routed"}')
               for line in port[-1][1])


def _brownout_script(rig):
    """Beats whose capacity blocks climb the ladder, and at each level a
    best-effort request with ``spec`` and a long ``max_new_tokens`` plus
    a priority-1 one."""
    rec = []
    rig.member("decode", "r0", 0.0, spec_k=4)
    rig.member("decode", "r1", 0.0, spec_k=4)
    for i, util in enumerate((0.5, 0.9, 0.97, 1.0, 1.0, 1.0, 0.3, 0.0)):
        now = 2.5 * i
        cap = {"tokens_per_s": 100.0 * util, "capacity_tokens_per_s": 100.0,
               "kv_exhaustion_eta_s": 50.0 + i}
        for mid in ("r0", "r1"):
            rig.beat(mid, now, snapshot={"gauges": {}, "capacity": cap})
        rig.submit(f"be{i}", now, spec=2, max_new_tokens=40,
                   prompt=(1 + i, 2))
        rig.submit(f"pri{i}", now, priority=1, max_new_tokens=40,
                   prompt=(50 + i, 2))
        rig.beat("r0", now + 0.1, done=[(f"be{i}", "finished"),
                                        (f"pri{i}", "finished")])
        rig.beat("r1", now + 0.1, done=[(f"be{i}", "finished"),
                                        (f"pri{i}", "finished")])
        rec.append((i, rig.collect(), rig.snapshot()))
    rec.append(("prom", rig.render({"router": rig.snapshot()}).splitlines(),
                None))
    return rec


def test_router_brownout_equals_jax():
    """The brownout hook over ``aggregate_fleet``: the same levels, spec
    dropped, ``max_new_tokens`` capped and best-effort traffic shed (one
    half-open probe per window) as the JAX router, under one clock."""
    clock = [0.0]
    rigs = {"port": _Rig("port", brownout=BrownoutLadder(
                min_dwell_s=2.0, probe_every_s=6.0, max_new_cap=16,
                clock=lambda: clock[0])),
            "jax": _Rig("jax", brownout=JaxLadder(
                min_dwell_s=2.0, probe_every_s=6.0, max_new_cap=16,
                clock=lambda: clock[0]))}
    try:
        got = {pkg: _brownout_script(rig) for pkg, rig in rigs.items()}
    finally:
        for rig in rigs.values():
            rig.close()
    assert got["port"] == got["jax"]
    levels = [r[2]["brownout_level"] for r in got["port"][:-1]]
    assert max(levels) == 3 and levels[-1] < 3
    for _, _, snap in got["port"][:-1]:
        assert validate_router_snapshot(dict(snap, ts=0.0)) == []
    sent = [f for r in got["port"][:-1] for f in r[1]["r0"] + r[1]["r1"]]
    assert any(f.get("max_new_tokens") == 16 and f.get("spec") == 0
               for f in sent)
    shed = [f for r in got["port"][:-1] for f in r[1]["client"]
            if f.get("status") == "shed"]
    assert shed and all(f["rid"].startswith("be") for f in shed)
    assert any(line.startswith("rlt_capacity_fleet_utilization")
               for line in got["port"][-1][1])


def test_migration_claim_suppresses_beat_loss():
    """A ``migrating`` claim holds off beat-loss failover until it
    expires; then the silent replica fails over as any other.  Scripted
    on the poll clock."""
    rig = _Rig("port", lost_after_s=0.5)
    try:
        t = 0.0
        rig.member("decode", "r0", t)
        rig.member("decode", "r1", t)
        rig.submit("x", t)
        victim = rig.router._inflight["x"].replica
        survivor = "r1" if victim == "r0" else "r0"
        rig.beat(victim, t + 0.1, migrating=["x"])
        rig.beat(survivor, t + 2.0)       # victim silent past lost_after_s
        assert rig.router._replicas[victim].alive
        assert rig.router.counters["failovers"] == 0
        rig.beat(survivor, t + 3.2)       # the 3 s claim has expired
        assert not rig.router._replicas[victim].alive
        assert rig.router.counters["failovers"] == 1
        assert rig.router._inflight["x"].replica == survivor
    finally:
        rig.close()


# ---------------------------------------------------------------------------
# KV export / import
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_export_import_roundtrip_and_refusals(dtype):
    cfg = GPTConfig(**CFG)
    cache = PagedKVCache(cfg, 9, 4, dtype=dtype, device="cpu")
    pool = cache.init_pool()
    gen = torch.Generator().manual_seed(0)
    for key in ("k", "v"):
        pool[key][:, [3, 5]] = torch.randn(
            pool[key][:, [3, 5]].shape, generator=gen).to(dtype)
    exported = cache.export_blocks(pool, [3, 5])
    for key in ("k", "v"):
        assert isinstance(exported[key], np.ndarray)
        assert exported[key].dtype == np.float32  # bf16 rides as f32
        assert exported[key].shape == (2, 2, 4, 4, 16)
    dst = cache.init_pool()
    payload = {k: encode_tree(v) for k, v in exported.items()}
    from ray_lightning_tpu_torch.mpmd.transfer import decode_tree

    dst = import_blocks(dst, {k: decode_tree(v) for k, v in payload.items()},
                        [7, 1])
    for key in ("k", "v"):
        assert dst[key].dtype == dtype
        assert torch.equal(dst[key][:, [7, 1]], pool[key][:, [3, 5]])
        assert float(dst[key][:, 0].abs().max()) == 0.0  # trash untouched
    for bad in ([0], [9], [2, 0]):
        with pytest.raises(ValueError, match="ids outside"):
            cache.export_blocks(pool, bad)


def test_blocks_move_between_packages():
    """A JAX pool's export imported by the port gives the same blocks,
    and the port's export imported by JAX."""
    jcfg = JaxGPTConfig(**CFG, warmup_steps=1)
    jcache = jkv.PagedKVCache(jcfg, num_blocks=9, block_size=4)
    rng = np.random.default_rng(1)
    content = {k: rng.standard_normal((2, 2, 4, 4, 16)).astype(np.float32)
               for k in ("k", "v")}
    jpool = jcache.init_pool()
    jpool = {k: jpool[k].at[:, jnp.asarray([2, 6])].set(content[k])
             for k in jpool}
    exported = jcache.export_blocks(jpool, [2, 6])
    cache = PagedKVCache(GPTConfig(**CFG), 9, 4, device="cpu")
    pool = import_blocks(cache.init_pool(), exported, [5, 8])
    again = cache.export_blocks(pool, [5, 8])
    for k in ("k", "v"):
        np.testing.assert_array_equal(again[k], content[k])
    jback = jax.jit(jkv.import_blocks)(
        jcache.init_pool(), {k: jnp.asarray(v) for k, v in again.items()},
        jnp.asarray([1, 3], jnp.int32))
    for k in ("k", "v"):
        np.testing.assert_array_equal(
            np.asarray(jcache.export_blocks(jback, [1, 3])[k]), content[k])


# ---------------------------------------------------------------------------
# Handoff admission on one engine
# ---------------------------------------------------------------------------

def _req(rid, prompt, max_new, replies, seed=0, **kw):
    return port_handoff.request_fields(
        rid, prompt, max_new, reply=(replies.handle.host,
                                     replies.handle.port),
        sample_seed=seed, **kw)


def _worker(world, beats, **kw):
    return PrefillRunner("pw", world["tm"], world["tp"], _serve_cfg(),
                         beats.handle, beat_s=60.0, device="cpu", **kw)


def _dispatch(worker, req, engine, same_host=False):
    h = engine.queue_handle()
    worker._inbox.handle.put(port_handoff.make_dispatch_item(
        req, (h.host, h.port), same_host=same_host))
    assert worker.step(timeout=10)


def _wait_inbox(engine, n=1, timeout=10):
    deadline = time.monotonic() + timeout
    while engine._inbox._items.qsize() < n:
        assert time.monotonic() < deadline, "frame never reached the inbox"
        time.sleep(0.002)


def _done(replies, rid):
    for item in _drain_queue(replies, timeout=5):
        assert validate_serve_reply(item) == [], item
        if item["type"] == "serve_done" and item["rid"] == rid:
            return item
    raise AssertionError(f"no serve_done for {rid}")


def test_jax_worker_handoff_admitted_by_port_engine(world):
    """A JAX ``PrefillRunner``'s f32 frame for a tenant prompt, admitted
    by the port's engine: the JAX engine's greedy stream."""
    from ray_lightning_tpu.serve.dist.prefill import (
        PrefillRunner as JaxPrefillRunner,
    )

    prompt = _prompt(7, 11)
    jeng = JaxServeEngine(world["jm"], world["jp"], JaxServeConfig(
        num_slots=2, block_size=8, max_adapters=2, adapter_rank=RANK),
        adapters=world["j_adapters"])
    try:
        ref = jeng.generate(prompt, 10, adapter="t1")
    finally:
        jeng.stop()
    eng = _engine(world)
    replies, beats = DriverQueue(), JaxDriverQueue()
    jworker = JaxPrefillRunner("jw", world["jm"], world["jp"],
                               JaxServeConfig(num_slots=2, block_size=8,
                                              max_adapters=2,
                                              adapter_rank=RANK),
                               beats.handle, beat_s=60.0)
    seen = []
    orig = eng._handle_queue_request
    eng._handle_queue_request = lambda item: (seen.append(item),
                                              orig(item))[1]
    try:
        jworker._inbox.handle.put(jax_handoff.make_adapter_load_item(
            "t1", RANK, data=jax_encode_adapter(world["j_adapters"]["t1"])))
        assert jworker.step(timeout=10)
        h = eng.queue_handle()
        req = jax_handoff.request_fields(
            "jh", prompt, 10, reply=(replies.handle.host,
                                     replies.handle.port),
            sample_seed=0, adapter="t1")
        jworker._inbox.handle.put(jax_handoff.make_dispatch_item(
            req, (h.host, h.port)))
        assert jworker.step(timeout=10)
        _wait_inbox(eng)
        eng.run_until_idle()
        assert validate_serve_kv_handoff(seen[0]) == []
        assert _done(replies, "jh")["tokens"] == ref
        assert eng.stats.counters["kv_imports"] == 1
        assert eng.stats.counters["prefills"] == 0
    finally:
        jworker.close()
        beats.shutdown()
        eng.stop()
        replies.shutdown()


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_import_equals_local_prefill(world, temperature):
    """An imported admission writes the blocks and draws the first token
    the engine's own prefill would, bitwise, and the stream equals the
    monolith's; the worker launches its prefill through the tenant."""
    prompt = _prompt(3, 13)
    local = _engine(world)
    h_local = local.submit(prompt, 12, temperature=temperature,
                           adapter="t0", sample_seed=0)
    local.step()  # admission: the prefill and the first token
    imp = _engine(world)
    replies, beats = DriverQueue(), DriverQueue()
    worker = _worker(world, beats)
    try:
        worker.adapters.add("t0", world["t_adapters"]["t0"])
        _dispatch(worker, _req("h1", prompt, 12, replies,
                               temperature=temperature, adapter="t0"), imp)
        _wait_inbox(imp)
        imp.step()
        ids_l = local.scheduler._blocks[0][:2]
        ids_i = imp.scheduler._blocks[0][:2]
        for key in ("k", "v"):
            assert torch.equal(local._pool[key][:, ids_l],
                               imp._pool[key][:, ids_i])
        assert local.scheduler.slots[0].generated == \
            imp.scheduler.slots[0].generated
        local.run_until_idle()
        imp.run_until_idle()
        assert _done(replies, "h1")["tokens"] == h_local.result(0)
        assert imp.stats.counters["kv_imports"] == 1
        assert imp.stats.counters["prefills"] == 0
        assert worker.prefills == 1
    finally:
        worker.close()
        beats.shutdown()
        for e in (local, imp):
            e.stop()
        replies.shutdown()


def test_worker_prefix_cache_prefills_only_the_suffix(world):
    """A worker with the prefix cache claims a resident whole-block
    prefix and computes only the suffix; the handoff still covers the
    bucket, and the stream equals the monolith's."""
    head = _prompt(8, 16)
    prompts = [head + _prompt(9, 5), head + _prompt(10, 7)]
    ref = _monolith(world, [(p, 0.0, "t0") for p in prompts], 6)
    eng = _engine(world)
    replies, beats = DriverQueue(), DriverQueue()
    worker = PrefillRunner("pw", world["tm"], world["tp"],
                           _serve_cfg(prefix_cache=True), beats.handle,
                           beat_s=60.0, device="cpu")
    try:
        worker.adapters.add("t0", world["t_adapters"]["t0"])
        for i, p in enumerate(prompts):
            _dispatch(worker, _req(f"x{i}", p, 6, replies, seed=i,
                                   adapter="t0"), eng)
            _wait_inbox(eng)
            eng.run_until_idle()
            assert _done(replies, f"x{i}")["tokens"] == ref[i]
        assert worker.suffix_prefills == 1 and worker.prefills == 2
        assert eng.stats.counters["kv_imports"] == 2
    finally:
        worker.close()
        beats.shutdown()
        eng.stop()
        replies.shutdown()


def test_shm_handoff_consumed_and_unlinked(world):
    prompt = _prompt(4, 10)
    ref = _monolith(world, [(prompt, 0.0, None)], 8)[0]
    eng = _engine(world)
    replies, beats = DriverQueue(), DriverQueue()
    worker = _worker(world, beats, shm_threshold=0)
    try:
        _dispatch(worker, _req("s1", prompt, 8, replies), eng,
                  same_host=True)
        assert len(worker._live_segments) == 1
        path = worker._live_segments[0][0]
        assert os.path.exists(path)
        _wait_inbox(eng)
        eng.run_until_idle()
        assert _done(replies, "s1")["tokens"] == ref
        assert not os.path.exists(path)  # the consumer unlinked it
    finally:
        worker.close()
        beats.shutdown()
        eng.stop()
        replies.shutdown()
    import glob

    assert not [p for p in glob.glob(os.path.join(segment_dir(), "rlt-kv-*"))
                if f"-{os.getpid()}-" in p]


def test_geometry_mismatch_and_torn_payload(world):
    """Blocks that do not tile the replica's bucket: the typed
    ``invalid`` with JAX's text.  A torn payload: ``invalid`` on an
    engine, the failed feed on a replica (``report_handoff_failures``)."""
    cfg = GPTConfig(**CFG)
    eng = _engine(world)
    replies = DriverQueue()
    try:
        payload = port_handoff.encode_kv_payload(
            {k: np.zeros((2, 3, 8, 4, 16), np.float32) for k in ("k", "v")},
            np.zeros((cfg.vocab_size,), np.float32))
        frame = port_handoff.make_handoff_item(
            _req("bad", [1, 2, 3], 4, replies), bucket=24, data=payload)
        assert validate_serve_kv_handoff(frame) == []
        eng.queue_handle().put(frame)
        _wait_inbox(eng)
        eng.step()
        done = _done(replies, "bad")
        assert done["status"] == "invalid" and "geometry" in done["error"]
        assert eng.drain_done() == [("bad", "invalid")]
        torn = dict(frame, rid="torn", bucket=8, data=payload[:40],
                    req=_req("torn", [1, 2, 3], 4, replies))
        eng.queue_handle().put(torn)
        _wait_inbox(eng)
        eng.step()
        assert _done(replies, "torn")["status"] == "invalid"
        eng.report_handoff_failures = True
        eng.queue_handle().put(dict(torn, rid="torn2", req=_req(
            "torn2", [1, 2, 3], 4, replies)))
        _wait_inbox(eng)
        eng.step()
        failed = eng.drain_failed()
        assert [r for r, _ in failed] == ["torn2"]
        assert eng.drain_done() == [("torn", "invalid")]
        assert not _drain_queue(replies, timeout=0.3)
    finally:
        eng.stop()
        replies.shutdown()


def test_handoff_waits_for_its_tenant(world):
    """A handoff whose tenant's load frame has not landed is deferred,
    then admitted once the frame arrives (the payload unread till
    then)."""
    prompt = _prompt(5, 9)
    eng = ServeEngine(world["tm"], world["tp"], _serve_cfg(),
                      adapters={"t0": world["t_adapters"]["t0"]},
                      device="cpu")
    ref_eng = _engine(world)
    replies, beats = DriverQueue(), DriverQueue()
    worker = _worker(world, beats)
    try:
        ref = ref_eng.generate(prompt, 6, adapter="t1")
        worker.adapters.add("t1", world["t_adapters"]["t1"])
        _dispatch(worker, _req("w1", prompt, 6, replies, adapter="t1"), eng)
        _wait_inbox(eng)
        for _ in range(3):
            eng.step()
        assert len(eng._deferred_inbox) == 1
        eng.queue_handle().put(port_handoff.make_adapter_load_item(
            "t1", RANK, data=encode_adapter(world["t_adapters"]["t1"])))
        _wait_inbox(eng)
        eng.run_until_idle()
        assert _done(replies, "w1")["tokens"] == ref
        assert eng.stats.counters["kv_imports"] == 1
    finally:
        worker.close()
        beats.shutdown()
        eng.stop()
        ref_eng.stop()
        replies.shutdown()


def test_prefill_worker_closing_beat(world):
    """A planned stop flags the worker's last beat ``closing``; a hard
    kill sends no last beat."""
    for hard in (False, True):
        beats = DriverQueue()
        worker = PrefillRunner("pw", world["tm"], world["tp"], _serve_cfg(),
                               beats.handle, beat_s=0.05, device="cpu")
        worker.suppress_final = hard
        stop = threading.Event()
        thread = threading.Thread(target=worker.run, args=(stop.is_set,),
                                  daemon=True)
        thread.start()
        _drain_queue(beats, timeout=0.3)  # the hello and a beat
        stop.set()
        thread.join(timeout=10)
        items = [i for i in _drain_queue(beats, timeout=0.5)
                 if i.get("closing")]
        beats.shutdown()
        assert len(items) == (0 if hard else 1), hard


def test_migration_adopted_and_short_payload_falls_back(world):
    """A resident sequence exported mid-decode and adopted by another
    engine continues the monolith's stream with nothing re-emitted; a
    frame one block short falls back to recompute with the same seed."""
    prompt = _prompt(6, 12)
    ref = _monolith(world, [(prompt, 0.7, "t0")], 20)[0]
    for short in (False, True):
        src, dst = _engine(world), _engine(world)
        replies = DriverQueue()
        try:
            frames = []
            h = src.submit(prompt, 20, temperature=0.7, adapter="t0",
                           sample_seed=0,
                           on_token=lambda i, t: frames.append((i, t)))
            h.request._reply = (replies.handle.host, replies.handle.port)
            for _ in range(6):
                src.step()
            entry, = src.export_resident()
            assert entry["seq_len"] == len(prompt) + len(
                entry["generated"]) - 1
            kv = entry["kv"]
            if short:
                kv = {k: v[:, :-1] for k, v in kv.items()}
            item = port_handoff.make_migration_item(
                entry["req"], generated=entry["generated"],
                cur_token=entry["cur_token"], seq_len=entry["seq_len"],
                data=encode_tree({"kv": kv}))
            assert validate_serve_migration(item) == []
            dst.queue_handle().put(item)
            _wait_inbox(dst)
            dst.run_until_idle()
            done = _done(replies, entry["req"]["rid"])
            assert done["tokens"] == ref
            c = dst.stats.counters
            if short:
                assert c["migration_fallbacks"] == 1 and c["prefills"] == 1
            else:
                assert c["migrations_in"] == 1 and c.get("prefills") == 0
        finally:
            src.stop()
            dst.stop()
            replies.shutdown()


def test_adopted_sequence_preempted_recomputes(world):
    """A survivor short of blocks preempts the sequence it adopted last
    (the youngest) and recomputes it from its prompt with its seed: both
    streams still equal the monolith's."""
    pa, pb = _prompt(50, 30), _prompt(51, 8)
    ref_b = _monolith(world, [(pb, 0.7, "t0")], 16)[0]
    src, dst = _engine(world), _engine(world, num_blocks=9)
    replies = DriverQueue()
    victims = []
    preempt = dst.scheduler.preempt_youngest
    dst.scheduler.preempt_youngest = lambda **kw: (
        victims.append(preempt(**kw)) or victims[-1])
    try:
        ref_a = dst.generate(pa, 20)
        h = src.submit(pb, 16, temperature=0.7, adapter="t0",
                       sample_seed=0)
        h.request._reply = (replies.handle.host, replies.handle.port)
        for _ in range(3):
            src.step()
        entry, = src.export_resident()
        ha = dst.submit(pa, 20, sample_seed=1)
        dst.step()
        dst.queue_handle().put(port_handoff.make_migration_item(
            entry["req"], generated=entry["generated"],
            cur_token=entry["cur_token"], seq_len=entry["seq_len"],
            data=encode_tree({"kv": entry["kv"]})))
        _wait_inbox(dst)
        dst.run_until_idle()
        assert _done(replies, entry["req"]["rid"])["tokens"] == ref_b
        assert ha.result(0) == ref_a
        assert dst.stats.counters["migrations_in"] == 1
        assert victims and all(v.rid == entry["req"]["rid"]
                               for v in victims)
    finally:
        src.stop()
        dst.stop()
        replies.shutdown()


@pytest.mark.parametrize("feature", [dict(prefix_cache=True),
                                     dict(prefill_chunk=8)],
                         ids=["prefix_cache", "prefill_chunk"])
def test_handoff_admission_is_an_import_with_engine_features(world,
                                                             feature):
    """On a replica with the prefix cache or chunked prefill on, a
    handoff still imports its whole prompt: it claims no cached prefix
    and is never chunked, and its stream equals the local one."""
    prompt = _prompt(52, 13)
    imp = _engine(world, **feature)
    replies, beats = DriverQueue(), DriverQueue()
    worker = _worker(world, beats)
    try:
        ref = imp.generate(prompt, 6, adapter="t0")
        local = imp.stats.counters["prefills"]
        worker.adapters.add("t0", world["t_adapters"]["t0"])
        _dispatch(worker, _req("h1", prompt, 6, replies, adapter="t0"),
                  imp)
        _wait_inbox(imp)
        imp.run_until_idle()
        assert _done(replies, "h1")["tokens"] == ref
        c = imp.stats.counters
        assert (c.get("kv_imports", 0), c["prefills"]) == (1, local)
        if "prefix_cache" in feature:
            assert imp.prefix_cache.stats()["hits"] == 0
    finally:
        worker.close()
        beats.shutdown()
        imp.stop()
        replies.shutdown()


# ---------------------------------------------------------------------------
# The in-process fleet
# ---------------------------------------------------------------------------

FLEET_REQS = [(_prompt(20 + i, n), 0.0, a) for i, (n, a) in
              enumerate([(5, "t0"), (9, None), (12, "t1"), (3, None),
                         (14, "t0"), (7, "t1")])]


def _fleet(world, **kw):
    kw.setdefault("n_prefill", 1)
    return launch_inproc_fleet(
        world["tm"], world["tp"], _serve_cfg(), n_replicas=2,
        adapters=world["t_adapters"], device="cpu", **kw)


def test_fleet_parity_with_monolith_and_jax_fleet(world, tmp_path):
    """Greedy streams: the port's fleet = the port's monolith = the JAX
    in-process fleet; every admission a KV import; the router's exports
    valid."""
    from ray_lightning_tpu.serve.dist import (
        launch_inproc_fleet as jax_launch,
    )

    ref = _monolith(world, FLEET_REQS, 8)
    fleet = _fleet(world, telemetry_dir=str(tmp_path),
                   prom_file=str(tmp_path / "router.prom"),
                   export_every_s=0.0)
    client = ServeClient(fleet.queue_handle())
    try:
        rids = [client.submit(p, 8, temperature=t, adapter=a)
                for p, t, a in FLEET_REQS]
        out = [client.result(r, timeout=TIMEOUT) for r in rids]
        fleet.router.poll()
        snap = fleet.router.snapshot()
        live = (tmp_path / "router-live.json").read_text()
        prom = (tmp_path / "router.prom").read_text()
    finally:
        client.close()
        fleet.close()
    assert out == ref
    assert validate_router_snapshot(snap) == []
    assert snap["counters"]["prefill_dispatches"] == len(FLEET_REQS)
    assert snap["counters"]["adapter_loads_sent"] >= 2
    imports = sum(r.engine.stats.counters.get("kv_imports", 0)
                  for r in fleet.replicas)
    prefills = sum(r.engine.stats.counters["prefills"]
                   for r in fleet.replicas)
    assert (imports, prefills) == (len(FLEET_REQS), 0)
    assert fleet.workers[0].runner.prefills == len(FLEET_REQS)
    assert '"router"' in live
    assert 'rlt_serve_replica_inflight{replica="r0"}' in prom
    assert 'rlt_serve_router_total{kind="routed"}' in prom

    jfleet = jax_launch(world["jm"], world["jp"], JaxServeConfig(
        num_slots=2, block_size=8, max_adapters=2, adapter_rank=RANK),
        n_replicas=2, n_prefill=1, adapters=world["j_adapters"])
    jclient = JaxServeClient(jfleet.queue_handle())
    try:
        rids = [jclient.submit(p, 8, temperature=t, adapter=a)
                for p, t, a in FLEET_REQS]
        assert [jclient.result(r, timeout=120) for r in rids] == ref
    finally:
        jclient.close()
        jfleet.close()


def test_fleet_traces_every_leg(world, tmp_path):
    """With ``trace_dir`` every component exports its spans at teardown,
    valid under the JAX schema and linked by the request's trace id: the
    router's placement and root span, the worker's prefill and send, the
    replica's transfer, admission and first token."""
    from ray_lightning_tpu.telemetry.schema import validate_span_jsonl

    fleet = _fleet(world, trace_dir=str(tmp_path))
    client = ServeClient(fleet.queue_handle())
    try:
        prompt, _, adapter = FLEET_REQS[2]
        rid = client.submit(prompt, 4, adapter=adapter)
        client.result(rid, timeout=TIMEOUT)
        deadline = time.monotonic() + TIMEOUT
        while fleet.router.counters["completed"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        client.close()
        fleet.close()
    names = {}
    for path in sorted(tmp_path.glob("trace-*.jsonl")):
        lines = path.read_text().splitlines()
        assert validate_span_jsonl(lines) == [], path.name
        for line in lines:
            span = json.loads(line)
            if span.get("args", {}).get("trace_id") == rid:
                names.setdefault(path.name, set()).add(span["name"])
    assert names["trace-router.jsonl"] >= {"placement", "request"}
    assert names["trace-prefill-p0.jsonl"] >= {"prefill_compute",
                                               "handoff_send"}
    replica = {n for k, v in names.items() if k.startswith("trace-serve")
               for n in v}
    assert replica >= {"handoff_transfer", "queue_wait", "decode_admission",
                       "first_token"}


def _victim(fleet, client, rids, tokens=3):
    """The replica holding ``rids`` once each has streamed ``tokens``,
    its serve loop halted (so the kill lands mid-stream however fast the
    CPU decodes)."""
    deadline = time.monotonic() + TIMEOUT
    while time.monotonic() < deadline:
        tracks = [fleet.router._inflight.get(r) for r in rids]
        pends = [client._pending.get(r) for r in rids]
        if all(t is not None and t.replica is not None for t in tracks) \
                and all(p is not None and len(p.tokens) >= tokens
                        for p in pends):
            assert len({t.replica for t in tracks}) == 1, "prefix affinity"
            victim = next(r for r in fleet.replicas
                          if r.id == tracks[0].replica)
            victim.engine.halt_loop()
            return victim
        time.sleep(0.002)
    pytest.fail("requests never started streaming")


@pytest.mark.parametrize("hard", [True, False], ids=["failover", "drain"])
def test_fleet_kill_keeps_streams(world, hard):
    """Two streams (sampled and greedy) on one replica, which is killed
    mid-stream: a hard kill fails them over (recomputed, re-emitted
    tokens deduped), a planned drain migrates them (nothing re-emitted).
    Both streams equal the monolith's; no request is lost."""
    p = _prompt(40, 10)
    reqs = [(p, 0.7, "t0"), (p, 0.0, "t0")]
    ref = _monolith(world, reqs, 30)
    fleet = _fleet(world, n_prefill=0, lost_after_s=5.0)
    client = ServeClient(fleet.queue_handle())
    streams = [[], []]

    def stream(i):
        pr, t, a = reqs[i]
        for tok in client.stream(pr, 30, temperature=t, adapter=a,
                                 timeout=TIMEOUT):
            streams[i].append(tok)

    try:
        threads = []
        for i in range(2):
            th = threading.Thread(target=stream, args=(i,))
            th.start()
            threads.append(th)
            deadline = time.monotonic() + TIMEOUT
            while len(client._pending) < i + 1:  # submission order
                assert time.monotonic() < deadline
                time.sleep(0.001)
        rids = list(client._pending)
        victim = _victim(fleet, client, rids)
        victim.kill(hard=hard)
        for th in threads:
            th.join(TIMEOUT)
        assert not any(th.is_alive() for th in threads)
        c = dict(fleet.router.counters)
        mig = sum(r.engine.stats.counters.get("migrations_in", 0)
                  for r in fleet.replicas)
    finally:
        client.close()
        fleet.close()
    assert streams == ref
    if hard:
        assert c["failovers"] >= 1 and c["replica_deaths"] == 1
        assert client.re_emitted_tokens > 0
    else:
        assert c["migrations"] == 2 and mig == 2
        assert c["failovers"] == 0 and c["replica_deaths"] == 0
        assert client.re_emitted_tokens == 0


def test_teardowns_sweep_a_killed_producers_segments(world):
    """An ``rlt-kv`` segment of a producer killed with SIGKILL is gone
    after ``Router.stop()`` and after ``ServeEngine.stop()``."""
    code = (
        "import atexit, time\n"
        "from ray_lightning_tpu_torch.cluster.shm import SegmentStore\n"
        "store = SegmentStore(prefix='rlt-kv')\n"
        "atexit.unregister(store.unlink_all)\n"
        "print(store.put(b'x' * 2048), flush=True)\n"
        "time.sleep(60)\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for stop in ("router", "engine"):
        proc = subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE, text=True,
            cwd=repo, env=dict(os.environ, PYTHONPATH=repo))
        path = proc.stdout.readline().strip()
        assert os.path.exists(path)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        if stop == "router":
            Router(lost_after_s=60.0).stop()
        else:
            ServeEngine(world["tm"], world["tp"], _serve_cfg(max_adapters=0),
                        device="cpu").stop()
        assert not os.path.exists(path), stop
