"""The port's serving control plane held against the JAX package (CPU, f32).

One JAX GPT at test size (block matrices scaled up so greedy streams
vary), converted leaf for leaf into the port, and two rank-4 LoRA tenants
made with numpy.  Every drain here is deterministic: the engine is driven
with ``step()`` unless a test is about its serve thread.  Checked:

* greedy streams over the port's queue plane (``ServeClient`` over
  ``cluster/queue.py``) equal the port's in-process streams and the JAX
  engine's, exactly; backpressure, the ``max_model_len`` error and a
  malformed request come back as the JAX plane answers them;
* the wire both ways: a JAX ``ServeClient`` (cloudpickle) against the
  port's engine and the port's client (stdlib pickle) against the JAX
  engine, every frame valid under the JAX package's validators;
* the adapter codec across packages in both payload forms (factors
  bitwise, the scale kept), a JAX bf16 frame decoded without
  ``ml_dtypes``, and a tenant hot-loaded over the wire served like one
  loaded in-process;
* deadlines step for step against the JAX ``Scheduler``, a preempted
  request never expired, and the engine's expiry, cancel and loop-death
  paths over the queue.
"""

import dataclasses
import importlib
import os
import pickle
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.cluster.queue import QueueHandle as JaxQueueHandle
from ray_lightning_tpu.cluster.shm import SegmentStore as JaxSegmentStore
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.serve.client import RetryPolicy as JaxRetryPolicy
from ray_lightning_tpu.serve.client import ServeClient as JaxServeClient
from ray_lightning_tpu.serve.engine import ServeConfig as JaxServeConfig
from ray_lightning_tpu.serve.engine import ServeEngine as JaxServeEngine
from ray_lightning_tpu.serve.lora import decode_adapter as jax_decode_adapter
from ray_lightning_tpu.serve.lora import encode_adapter as jax_encode_adapter
from ray_lightning_tpu.telemetry.schema import (
    validate_serve_adapter_load, validate_serve_reply, validate_serve_request,
)
from ray_lightning_tpu_torch.cluster import shm
from ray_lightning_tpu_torch.cluster.queue import DriverQueue, QueueHandle
from ray_lightning_tpu_torch.models.convert import (
    adapter_from_jax, params_from_jax,
)
from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
from ray_lightning_tpu_torch.serve import (
    RetryPolicy, ServeClient, ServeConfig, ServeEngine, ServeRejected,
    decode_adapter, encode_adapter,
)
from ray_lightning_tpu_torch.serve.kv_cache import BlockAllocator
from ray_lightning_tpu_torch.serve.scheduler import (
    Request, RequestState, Scheduler,
)

jsched = importlib.import_module("ray_lightning_tpu.serve.scheduler")
jkv = importlib.import_module("ray_lightning_tpu.serve.kv_cache")
port_engine_mod = importlib.import_module("ray_lightning_tpu_torch.serve.engine")

CFG = dict(vocab_size=128, n_layer=2, n_head=4, d_model=64, seq_len=64)
RANK = 4
TENANTS = ("t0", "t1")
# Mixed tenants, more requests than slots.
REQUESTS = [(5, "t0"), (9, None), (12, "t1"), (3, None), (7, "t0")]
NEW = 8
TIMEOUT = 30


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny engines run on one CPU thread: under the suite's parallel
    workers torch's threads per worker oversubscribe the cores."""
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


def _jax_engine(world, **kw):
    cfg = dict(num_slots=2, block_size=8, max_adapters=3, adapter_rank=RANK)
    cfg.update(kw)
    return JaxServeEngine(world["jm"], world["jp"], JaxServeConfig(**cfg),
                          adapters=world["j_adapters"])


def _engine(world, adapters=True, **kw):
    cfg = dict(num_slots=2, block_size=8, max_adapters=3, adapter_rank=RANK)
    cfg.update(kw)
    return ServeEngine(world["tm"], world["tp"], ServeConfig(**cfg),
                       adapters=world["t_adapters"] if adapters else None,
                       device="cpu")


@pytest.fixture(scope="module")
def jax_tokens(world):
    """The JAX engine's greedy tokens for REQUESTS (in-process, once)."""
    engine = _jax_engine(world)
    handles = [engine.submit(_prompt(i, n), NEW, adapter=a)
               for i, (n, a) in enumerate(REQUESTS)]
    engine.run_until_idle()
    return [h.result(0) for h in handles]


def _drain(engine, done, timeout=TIMEOUT):
    """Step ``engine`` until ``done()``; replies land on the client's
    reader thread, so the predicate may need a few idle steps."""
    deadline = time.monotonic() + timeout
    while not done():
        assert time.monotonic() < deadline, "engine did not drain in time"
        if not engine.step():
            time.sleep(0.001)


def _settled(client, rids):
    return lambda: all(client._pending[r].done.is_set() for r in rids
                       if r in client._pending)


def _spy_replies(engine, sent):
    orig = engine._reply

    def spy(addr, item):
        sent.append(item)
        orig(addr, item)

    engine._reply = spy


# ---------------------------------------------------------------------------
# Streams over the queue plane
# ---------------------------------------------------------------------------

def test_queue_streams_equal_in_process_and_jax_engine(world, jax_tokens):
    engine = _engine(world)
    handles = [engine.submit(_prompt(i, n), NEW, adapter=a)
               for i, (n, a) in enumerate(REQUESTS)]
    engine.run_until_idle()
    in_process = [h.result(0) for h in handles]
    assert in_process == jax_tokens

    engine = _engine(world)
    client = ServeClient(engine.queue_handle())
    try:
        rids = [client.submit(_prompt(i, n), NEW, adapter=a)
                for i, (n, a) in enumerate(REQUESTS)]
        _drain(engine, _settled(client, rids))
        assert [client.result(r, TIMEOUT) for r in rids] == jax_tokens
        assert client.re_emitted_tokens == 0
    finally:
        engine.stop()
        client.close()


def test_backpressure_stream_and_max_model_len_over_queue(world,
                                                          jax_tokens):
    """TestClientPlane's counterpart: the third request of a two-deep
    queue comes back rejected; a stream through the started engine equals
    the in-process tokens; an oversized request is the typed ValueError."""
    engine = _engine(world, num_slots=1, max_queue=2)
    client = ServeClient(engine.queue_handle())
    try:
        p0, p1 = _prompt(0, 5), _prompt(1, 9)
        r0 = client.submit(p0, NEW, adapter="t0")
        r1 = client.submit(p1, NEW)
        r2 = client.submit([1], 2)
        _drain(engine, _settled(client, [r0, r1, r2]))
        assert client.result(r0, TIMEOUT) == jax_tokens[0]
        assert client.result(r1, TIMEOUT) == jax_tokens[1]
        with pytest.raises(ServeRejected, match="rejected"):
            client.result(r2, TIMEOUT)
        engine.start()
        assert list(client.stream(p1, NEW, timeout=TIMEOUT)) == \
            jax_tokens[1]
        with pytest.raises(ValueError, match="max_model_len"):
            client.generate([1] * 60, 10, timeout=TIMEOUT)
    finally:
        engine.stop()
        client.close()


@pytest.mark.parametrize("item,needle", [
    ({"type": "serve_request", "rid": "bad", "prompt": [1, 2],
      "max_new_tokens": None}, "int"),
    ({"type": "serve_request", "rid": "bad", "prompt": [1, 2],
      "max_new_tokens": 3, "adapter": "nobody"}, "unknown adapter"),
    ({"type": "serve_kv_handoff", "rid": "bad",
      "req": {"rid": "bad", "prompt": [1], "max_new_tokens": 1}},
     "'data'"),
    ({"type": "serve_migration", "rid": "bad",
      "req": {"rid": "bad", "prompt": [1], "max_new_tokens": 1}},
     "'data'"),
], ids=["bad_field", "unknown_adapter", "kv_handoff", "migration"])
def test_bad_frames_get_a_typed_invalid_reply(world, item, needle):
    """Once the reply address is known, a bad request gets
    ``serve_done(status="invalid")``, never a silent drop; a handoff or a
    migration frame with neither ``data`` nor a ``shm`` path gets the
    JAX engine's error for a handoff without a payload."""
    engine = _engine(world)
    replies = DriverQueue()
    try:
        addr = [replies.handle.host, replies.handle.port]
        frame = dict(item)
        if "req" in frame:
            frame["req"] = dict(frame["req"], reply=addr)
        else:
            frame["reply"] = addr
        engine.queue_handle().put(frame)
        engine.step()
        got = replies.get(timeout=TIMEOUT)
        assert validate_serve_reply(got) == []
        assert got["type"] == "serve_done" and got["status"] == "invalid"
        assert needle in got["error"]
        assert engine.drain_done() == [("bad", "invalid")]
    finally:
        replies.shutdown()
        engine.stop()


def _spy_inbox(engine, seen):
    orig = engine._handle_queue_request

    def spy(item):
        seen.append(item)
        return orig(item)

    engine._handle_queue_request = spy


def test_jax_client_against_the_port_engine(world, jax_tokens):
    """A JAX ``ServeClient`` (cloudpickle frames, a JAX reply queue)
    through the port's inbox: tokens equal the JAX engine's, every frame
    each way valid under the JAX schema."""
    engine = _engine(world)
    seen, sent = [], []
    _spy_inbox(engine, seen)
    _spy_replies(engine, sent)
    h = engine.queue_handle()
    client = JaxServeClient(JaxQueueHandle(h.host, h.port),
                            retry=JaxRetryPolicy(max_attempts=1))
    try:
        rids = [client.submit(_prompt(i, n), NEW, adapter=a)
                for i, (n, a) in enumerate(REQUESTS)]
        _drain(engine, lambda: all(client._pending[r].done.is_set()
                                   for r in rids))
        assert [client.result(r, TIMEOUT) for r in rids] == jax_tokens
    finally:
        engine.stop()
        client.close()
    assert len(seen) == len(REQUESTS)
    for item in seen:
        assert validate_serve_request(item) == [], item
    assert sum(i["type"] == "serve_token" for i in sent) == \
        NEW * len(REQUESTS)
    for item in sent:
        assert validate_serve_reply(item) == [], item


def test_port_client_against_the_jax_engine(world, jax_tokens):
    """The port's ``ServeClient`` (stdlib pickle) through the JAX
    engine's inbox, and a wire-loaded tenant there: tokens equal, every
    frame valid."""
    engine = _jax_engine(world)
    sent = []
    _spy_replies(engine, sent)
    h = engine.queue_handle()
    client = ServeClient(QueueHandle(h.host, h.port),
                         retry=RetryPolicy(max_attempts=1))
    frames = []
    put = client._inbox.put

    def spy_put(item):
        frames.append(item)
        put(item)

    client._inbox.put = spy_put
    try:
        load = {"type": "serve_adapter_load", "name": "wire", "rank": RANK,
                "data": encode_adapter(world["j_adapters"]["t1"])}
        assert validate_serve_adapter_load(load) == []
        client._inbox.put(load)
        rids = [client.submit(_prompt(i, n), NEW,
                              adapter="wire" if a == "t1" else a)
                for i, (n, a) in enumerate(REQUESTS)]
        _drain(engine, lambda: all(client._pending[r].done.is_set()
                                   for r in rids))
        assert [client.result(r, TIMEOUT) for r in rids] == jax_tokens
    finally:
        engine.stop()
        client.close()
    for item in frames[1:]:
        assert validate_serve_request(item) == [], item
    for item in sent:
        assert validate_serve_reply(item) == [], item


# ---------------------------------------------------------------------------
# The adapter codec and the segment store across packages
# ---------------------------------------------------------------------------

def _frame(encode, adapter, form, store, name="x"):
    blob = encode(adapter)
    item = {"type": "serve_adapter_load", "name": name, "rank": RANK}
    if form == "data":
        item["data"] = blob
    else:
        item["shm"] = store.put(blob)
    assert validate_serve_adapter_load(item) == []
    return item


@pytest.mark.parametrize("form", ["data", "shm"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_adapter_codec_across_packages(world, direction, form):
    adapter = world["j_adapters"]["t0"]
    if direction == "jax_to_port":
        item = _frame(jax_encode_adapter, adapter, form,
                      JaxSegmentStore("rlt-seg"))
        got = decode_adapter(item)
    else:
        item = _frame(encode_adapter, world["t_adapters"]["t0"], form,
                      shm.SegmentStore("rlt-seg"))
        got = jax_decode_adapter(item)
    for key in ("qkv_a", "qkv_b", "proj_a", "proj_b"):
        a = np.asarray(got[key])
        assert a.dtype == np.float32 and a.shape == adapter[key].shape
        assert a.tobytes() == adapter[key].tobytes(), key
    assert got["scale"] == adapter["scale"] == 2.0
    if form == "shm":
        assert not os.path.exists(item["shm"])  # read once, unlinked


def test_jax_bf16_adapter_frame_decodes_without_ml_dtypes(world):
    """A JAX sender's bf16 factors (``ml_dtypes.bfloat16`` leaves) decode
    to ``torch.bfloat16`` tensors bit for bit, and serve like the same
    factors passed in-process."""
    bf16 = {k: (jnp.asarray(v, jnp.bfloat16) if k != "scale" else v)
            for k, v in world["j_adapters"]["t0"].items()}
    item = {"type": "serve_adapter_load", "name": "b", "rank": RANK,
            "data": jax_encode_adapter(bf16)}
    got = decode_adapter(dict(item))
    for key in ("qkv_a", "qkv_b", "proj_a", "proj_b"):
        assert got[key].dtype == torch.bfloat16
        want = np.asarray(bf16[key]).view(np.uint16)
        assert np.array_equal(got[key].view(torch.int16).numpy()
                              .view(np.uint16), want), key
    assert got["scale"] == 2.0

    upcast = {k: (np.asarray(v, np.float32) if k != "scale" else v)
              for k, v in bf16.items()}
    wire = _engine(world)
    wire._handle_queue_request(item)
    ref = _engine(world, adapters=False)
    ref.add_adapter("b", upcast)
    p = _prompt(3, 7)
    assert wire.generate(p, NEW, adapter="b") == \
        ref.generate(p, NEW, adapter="b")


def test_other_ml_dtypes_leaves_are_a_typed_error():
    import ml_dtypes

    from ray_lightning_tpu_torch.mpmd.transfer import decode_tree

    blob = pickle.dumps({"x": np.zeros(3, ml_dtypes.float8_e4m3fn)})
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        decode_tree(blob)


@pytest.mark.parametrize("form", ["data", "shm"])
def test_tenant_hot_loaded_over_the_wire_serves_like_jax(world, jax_tokens,
                                                         form):
    """``t1`` arrives as a JAX ``serve_adapter_load`` frame into an
    engine that had only ``t0``; the mixed batch then equals the JAX
    engine's tokens, and replacing the tenant while it serves is
    refused."""
    engine = ServeEngine(
        world["tm"], world["tp"],
        ServeConfig(num_slots=2, block_size=8, max_adapters=3,
                    adapter_rank=RANK),
        adapters={"t0": world["t_adapters"]["t0"]}, device="cpu")
    client = ServeClient(engine.queue_handle())
    try:
        client._inbox.put(_frame(jax_encode_adapter,
                                 world["j_adapters"]["t1"], form,
                                 JaxSegmentStore("rlt-seg"), name="t1"))
        engine.step()
        assert engine.adapter_names() == ["t0", "t1"]
        rids = [client.submit(_prompt(i, n), NEW, adapter=a)
                for i, (n, a) in enumerate(REQUESTS)]
        engine.step()  # admitted: t1 is in use now
        client._inbox.put(_frame(jax_encode_adapter,
                                 world["j_adapters"]["t0"], "data", None,
                                 name="t1"))
        _drain(engine, _settled(client, rids))
        assert [client.result(r, TIMEOUT) for r in rids] == jax_tokens
        assert engine.snapshot()["counters"]["adapter_loads"] == 1
    finally:
        engine.stop()
        client.close()


def test_segments_cross_package_and_corruption_is_caught(tmp_path):
    from ray_lightning_tpu import native

    payload = os.urandom(5000)
    mine = str(tmp_path / "mine")
    shm.write_segment(mine, payload)
    assert native.read_segment(mine) == payload
    theirs = str(tmp_path / "theirs")
    native.write_segment(theirs, payload)
    assert shm.read_segment(theirs) == payload
    raw = bytearray(open(theirs, "rb").read())
    raw[-1] ^= 1
    open(theirs, "wb").write(bytes(raw))
    with pytest.raises(shm.SegmentError, match="checksum"):
        shm.read_segment(theirs)


def test_queue_handle_drops_a_replayed_seq_and_fails_after_shutdown():
    q = DriverQueue()
    h = q.handle
    h.put({"n": 1})
    # A replay of seq 1 (its ack lost) is acked and not enqueued again.
    h._seq -= 1
    h.put({"n": 1})
    h.put({"n": 2})
    assert q.get(timeout=5) == {"n": 1}
    assert q.get(timeout=5) == {"n": 2}
    assert q.empty()
    copy = pickle.loads(pickle.dumps(h))
    assert (copy.host, copy.port) == (h.host, h.port)
    assert copy._client_id != h._client_id
    q.shutdown()
    with pytest.raises((OSError, ConnectionError)):
        h.put({"n": 3})
    h.close()


def test_retry_policy_reads_the_jax_package_env(monkeypatch):
    monkeypatch.setenv("RLT_RETRY_MAX", "5")
    monkeypatch.setenv("RLT_RETRY_BACKOFF_S", "0.2")
    monkeypatch.setenv("RLT_HEDGE", "1")
    assert dataclasses.asdict(RetryPolicy.from_env()) == \
        dataclasses.asdict(JaxRetryPolicy.from_env())


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------

PAIRS = ((jsched.Scheduler, jsched.Request, jkv.BlockAllocator),
         (Scheduler, Request, BlockAllocator))


def _run_deadlines(S, R, BA, script):
    """Replay ``script`` on one package's scheduler; returns what each
    poll admitted and expired, and the final states."""
    s = S(2, BA(9), block_size=4, max_blocks_per_seq=4, buckets=[4, 8, 16],
          max_queue=8)
    reqs = {}
    trace = []
    for op, *args in script:
        if op == "submit":
            rid, arrival, deadline = args
            req = R(rid=rid, prompt=[1, 2, 3], max_new_tokens=3,
                    deadline_s=deadline)
            req.arrival_t = arrival
            reqs[rid] = req
            s.submit(req)
        elif op == "poll":
            admissions, expired = s.poll(now=args[0])
            trace.append(([(slot, r.rid, b) for slot, r, b in admissions],
                          [r.rid for r in expired]))
        elif op == "token":
            slot = next(i for i, r in enumerate(s.slots)
                        if r is not None and r.rid == args[0])
            s.append_token(slot, 7, now=args[1])
        elif op == "preempt":
            trace.append(("preempted", s.preempt_youngest().rid))
        elif op == "finish":
            slot = next(i for i, r in enumerate(s.slots)
                        if r is not None and r.rid == args[0])
            s.finish(slot, now=args[1])
    states = {rid: (r.state.value, r.done_reason, r.preemptions)
              for rid, r in reqs.items()}
    return trace, states


DEADLINE_SCRIPTS = {
    "expires_queued": [("submit", "late", 100.0, 0.5), ("poll", 101.0)],
    "admitted_in_time": [("submit", "a", 100.0, 0.5), ("poll", 100.4),
                         ("token", "a", 100.5), ("finish", "a", 101.0)],
    "boundary_is_not_expiry": [("submit", "a", 100.0, 0.5),
                               ("poll", 100.5)],
    "queued_behind_full_slots": [
        ("submit", "x", 0.0, None), ("submit", "y", 0.0, None),
        ("submit", "d1", 0.0, 1.0), ("submit", "d2", 0.5, 1.0),
        ("poll", 0.1), ("finish", "x", 1.2), ("poll", 1.2),
        ("finish", "y", 2.0), ("poll", 2.0)],
    # test_preempted_request_survives_deadline_on_requeue's case.
    "preempted_survives_requeue": [
        ("submit", "a", 100.0, 0.5), ("poll", 100.1), ("token", "a", 100.2),
        ("preempt",), ("poll", 200.0)],
    "preempted_beside_a_fresh_late_one": [
        ("submit", "a", 100.0, None), ("submit", "b", 100.0, 0.5),
        ("poll", 100.1), ("token", "a", 100.2), ("token", "b", 100.2),
        ("submit", "c", 100.3, 0.1), ("preempt",), ("poll", 150.0)],
}


@pytest.mark.parametrize("name", sorted(DEADLINE_SCRIPTS))
def test_deadlines_step_for_step_against_the_jax_scheduler(name):
    script = DEADLINE_SCRIPTS[name]
    jax_run, port_run = (_run_deadlines(*pair, script) for pair in PAIRS)
    assert port_run == jax_run
    _, states = port_run
    for rid, (state, reason, preemptions) in states.items():
        if preemptions:
            assert state != RequestState.EXPIRED.value, rid
        if state == "expired":
            assert reason == "expired"


def test_engine_expires_a_queued_request_over_the_queue(world):
    """A deadlined request queued behind a full slot comes back expired:
    the reply, the handle, the counter and the OpenMetrics line agree."""
    engine = ServeEngine(world["tm"], world["tp"],
                         ServeConfig(num_slots=1, block_size=8),
                         device="cpu")
    client = ServeClient(engine.queue_handle())
    try:
        r0 = client.submit(_prompt(0, 5), NEW)
        r1 = client.submit(_prompt(1, 5), NEW, deadline_s=1e-6)
        h2 = engine.submit(_prompt(2, 5), NEW, deadline_s=1e-6)
        _drain(engine, _settled(client, [r0, r1]))
        assert len(client.result(r0, TIMEOUT)) == NEW
        with pytest.raises(ServeRejected, match="expired"):
            client.result(r1, TIMEOUT)
        with pytest.raises(ServeRejected, match="expired"):
            h2.result(TIMEOUT)
        snap = engine.snapshot()
        assert snap["counters"]["expired"] == 2
        from ray_lightning_tpu_torch.telemetry.export_prom import (
            render_openmetrics,
        )

        assert 'rlt_serve_requests_total{kind="expired"} 2' in \
            render_openmetrics({"serve": snap})
    finally:
        engine.stop()
        client.close()


# ---------------------------------------------------------------------------
# Cancel, re-emission, loop death, grad mode
# ---------------------------------------------------------------------------

def test_cancel_frame_mid_stream_frees_the_slot(world, jax_tokens):
    engine = _engine(world, adapters=False).start()
    client = ServeClient(engine.queue_handle())
    free = engine.cache.allocator.free_blocks
    try:
        p = _prompt(1, 9)
        stream = client.stream(p, 50, timeout=TIMEOUT)
        got = [next(stream) for _ in range(3)]
        (rid,) = list(client._pending)
        client._inbox.put({"type": "serve_cancel", "rid": rid})
        with pytest.raises(ServeRejected, match="cancelled"):
            got.extend(stream)
        assert 3 <= len(got) < 50
        assert got[:NEW] == jax_tokens[1][:len(got)]
        deadline = time.monotonic() + TIMEOUT
        while engine.cache.allocator.free_blocks != free:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert (rid, "cancelled") in engine.drain_done()
    finally:
        engine.stop()
        client.close()


def test_client_sees_each_index_once_across_preemptions(world):
    """An undersized pool preempts (recompute from index 0); each stream
    still yields every index once and equals the preemption-free run."""
    prompts = [_prompt(20 + i, 8) for i in range(3)]
    ref = _engine(world, adapters=False, num_slots=3)
    want = [ref.generate(p, 20) for p in prompts]
    engine = _engine(world, adapters=False, num_slots=3, num_blocks=9)
    client = ServeClient(engine.queue_handle())
    try:
        gens = [client.stream(p, 20, timeout=TIMEOUT) for p in prompts]

        out = [None] * 3

        def consume(i):
            out[i] = list(gens[i])

        threads = [threading.Thread(target=consume, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + TIMEOUT
        while len(client._pending) < 3:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        _drain(engine, lambda: not any(t.is_alive() for t in threads))
        assert out == want
        assert engine.snapshot()["counters"]["preempted"] >= 1
        assert client.re_emitted_tokens > 0
    finally:
        engine.stop()
        client.close()


def test_serve_loop_death_fails_pending_loudly(world, monkeypatch):
    """An exception escaping ``step()`` on the serve thread fails every
    pending handle with the chained error, answers queue clients with
    ``status="error"`` and refuses new submits."""
    engine = _engine(world, adapters=False)

    def boom(*a, **k):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(port_engine_mod, "paged_decode_step", boom)
    client = ServeClient(engine.queue_handle())
    engine.start()
    try:
        h = engine.submit([1, 2, 3], 4)
        with pytest.raises(RuntimeError, match="engine died"):
            h.result(timeout=TIMEOUT)
        with pytest.raises(RuntimeError, match="dead"):
            engine.submit([1, 2, 3], 4)
        assert isinstance(h.error, RuntimeError)
    finally:
        engine.stop()
        client.close()

    engine = _engine(world, adapters=False)
    client = ServeClient(engine.queue_handle())
    try:
        rid = client.submit([1, 2, 3], 4)
        engine.start()
        with pytest.raises(RuntimeError, match="engine died"):
            client.result(rid, TIMEOUT)
    finally:
        engine.stop()
        client.close()


def test_serve_thread_serves_with_grad_off(world, jax_tokens):
    """Grad mode is per thread: params that require grad serve the same
    tokens from the serve thread, and nothing the engine keeps requires
    grad afterwards."""
    params = {k: ({kk: vv.clone().requires_grad_(True)
                   for kk, vv in v.items()} if isinstance(v, dict)
                  else v.clone().requires_grad_(True))
              for k, v in world["tp"].items()}
    engine = ServeEngine(world["tm"], params,
                         ServeConfig(num_slots=2, block_size=8),
                         device="cpu").start()
    client = ServeClient(engine.queue_handle())
    try:
        assert client.generate(_prompt(1, 9), NEW, timeout=TIMEOUT) == \
            jax_tokens[1]
        assert not any(t.requires_grad for t in engine._pool.values())
    finally:
        engine.stop()
        client.close()
