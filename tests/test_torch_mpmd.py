"""The port's pipeline plane (``ray_lightning_tpu_torch/mpmd``,
``parallel/strategies.py::MpmdStrategy``) held against the JAX package's
(``ray_lightning_tpu/mpmd``) on the CPU.

* plan and schedule: stage bounds, every instruction stream of the
  shapes ``tests/test_mpmd.py`` uses (and the deadlock the simulation
  finds), and the bubble accounting, equal to JAX's;
* the wire: codec payloads byte-identical to JAX's in every encoding,
  each package decoding the other's; the mailbox, the TCP inbox, shm
  routing, the chunked send against a throttled reader, and a torn
  quantized segment poisoning the mailbox;
* ``make_block_stage``: the output and every gradient within 1e-5;
* the in-process fit in five flavors against one JAX in-process fit
  (losses, ``wte`` and ``head_w`` within 1e-5), and the int8 wire
  against the f32 wire at JAX's tolerance;
* the actor plane: ``Trainer.fit`` with ``MpmdStrategy`` on CPU workers
  against the same JAX fit, its report and live snapshot (checked by the
  JAX schema); a stage killed at step 2 restarting step-exactly;
  checkpoint discovery and the JAX reader on a port-written stage
  checkpoint; the strategy's refusals, with JAX's messages.

The tiny GPT of ``tests/test_mpmd.py`` (vocab 32, d 16, 2 heads, seq 8,
f32), 4 layers for the fits.
"""

import json
import os
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as helpers
import torch_multi_fits as mf
from ray_lightning_tpu.mpmd import schedule as jsched
from ray_lightning_tpu.mpmd import transfer as jxfer
from ray_lightning_tpu.mpmd.plan import StagePlan as JaxStagePlan
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.mpmd import schedule as sched
from ray_lightning_tpu_torch.mpmd import transfer as xfer
from ray_lightning_tpu_torch.mpmd.plan import StagePlan

TINY = dict(vocab_size=32, n_head=2, d_model=16, seq_len=8, warmup_steps=2)
WORKER_ENV = {"OMP_NUM_THREADS": "1"}
FIT_STEPS = 4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Plan and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers,n_stages", [(7, 3), (5, 4), (8, 4),
                                               (4, 1)])
def test_stage_plan_bounds_equal_jax(n_layers, n_stages):
    got, want = (StagePlan.split(n_layers, n_stages),
                 JaxStagePlan.split(n_layers, n_stages))
    assert got.boundaries == want.boundaries
    for s in range(n_stages):
        assert got.stage_bounds(s) == want.stage_bounds(s)
        assert got.stage_layers(s) == want.stage_layers(s)
    with pytest.raises(ValueError, match="out of range"):
        got.stage_bounds(n_stages)
    tree = {"w": torch.arange(n_layers)}
    start, stop = want.stage_bounds(n_stages - 1)
    assert got.slice_stacked(tree, n_stages - 1)["w"].tolist() == list(
        range(start, stop))


def _port_gpt(n_layer=2, precision="f32"):
    from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig

    return GPT(GPTConfig(n_layer=n_layer, **TINY), device="cpu",
               precision=precision)


def _jax_gpt(n_layer=2):
    from ray_lightning_tpu.models.gpt import GPT, GPTConfig

    module = GPT(GPTConfig(n_layer=n_layer, **TINY), attn_impl="xla")
    module.precision = "f32"
    return module


def _full(n_layer):
    """Untied initial params with numpy leaves, both packages' fits
    starting from them (the port's init: JAX's costs seconds here)."""
    from ray_lightning_tpu_torch.mpmd.plan import _gpt_untie

    return jax.tree.map(lambda t: t.numpy(), _gpt_untie(
        _port_gpt(n_layer).init_params(torch.Generator().manual_seed(0))))


def test_gpt_spec_split_assemble_and_an_untied_copy():
    from ray_lightning_tpu_torch.mpmd.plan import _gpt_untie, gpt_mpmd_spec

    module = _port_gpt()
    spec = gpt_mpmd_spec(module)
    tied = module.init_params(torch.Generator().manual_seed(0))
    full = _gpt_untie(tied)
    # A copy, never the same tensor: an aliased head would be updated by
    # two stages.
    assert torch.equal(full["head_w"], tied["wte"])
    assert full["head_w"].data_ptr() != tied["wte"].data_ptr()
    plan = StagePlan.split(spec.n_layers, 2)
    parts = [spec.split_params(full, plan, p) for p in range(2)]
    assert "wte" in parts[0] and "wte" not in parts[1]
    assert "head_w" in parts[1] and "head_w" not in parts[0]
    rebuilt = spec.assemble_params(parts, plan)
    for key in ("wte", "wpe", "ln_f_g", "ln_f_b", "head_w"):
        assert torch.equal(rebuilt[key], full[key])
    for key, leaf in full["blocks"].items():
        assert torch.equal(rebuilt["blocks"][key], leaf)


def test_resolve_spec_rejects_unknown_module():
    from ray_lightning_tpu_torch.mpmd.plan import resolve_mpmd_spec

    with pytest.raises(TypeError, match="mpmd_spec"):
        resolve_mpmd_spec(object())


STREAM_SHAPES = [(name, p, m, 1) for name in ("gpipe", "1f1b")
                 for p, m in ((1, 4), (2, 8), (4, 3), (4, 8))] + [
    ("1f1b", 2, 8, 2), ("1f1b", 2, 8, 4), ("1f1b", 3, 8, 2),
    ("1f1b", 2, 4, 2), ("1f1b", 2, 1, 2)]


@pytest.mark.parametrize("name,p,m,v", STREAM_SHAPES)
def test_streams_equal_jax(name, p, m, v):
    got = sched.build_streams(name, p, m, interleave=v)
    want = jsched.build_streams(name, p, m, interleave=v)
    assert [[repr(i) for i in s] for s in got] == [
        [repr(i) for i in s] for s in want]
    assert [[(i.op, i.mb, i.chunk) for i in s] for s in got] == [
        [(i.op, i.mb, i.chunk) for i in s] for s in want]
    assert sched.validate_streams(got, m, interleave=v) == []
    assert sched.simulate_streams(got, transfer_s=0.1, interleave=v) == \
        jsched.simulate_streams(want, transfer_s=0.1, interleave=v)
    for stage in range(p):
        if v == 1:
            assert [repr(i) for i in sched.build_schedule(
                name, stage, p, m)] == [repr(i) for i in
                                        jsched.build_schedule(
                                            name, stage, p, m)]


def test_simulate_detects_the_deadlock_jax_detects():
    def streams(mod):
        return [
            [mod.Instr("RECV_GRAD", 0), mod.Instr(mod.FWD, 0),
             mod.Instr("SEND_ACT", 0), mod.Instr(mod.BWD, 0),
             mod.Instr("UPDATE")],
            [mod.Instr("RECV_ACT", 0), mod.Instr(mod.FWD, 0),
             mod.Instr(mod.BWD, 0), mod.Instr("SEND_GRAD", 0),
             mod.Instr("UPDATE")],
        ]

    messages = []
    for mod in (sched, jsched):
        with pytest.raises(RuntimeError, match="deadlock") as err:
            mod.simulate_streams(streams(mod))
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_schedule_refusals_equal_jax():
    for call, match in (
            (lambda m: m.build_streams("zigzag", 2, 4),
             "unknown pipeline schedule"),
            (lambda m: m.build_streams("gpipe", 2, 4, interleave=2),
             "requires the '1f1b'"),
            (lambda m: m.build_schedule("gpipe", 0, 2, 0), "n_micro")):
        msgs = []
        for mod in (sched, jsched):
            with pytest.raises(ValueError, match=match) as err:
                call(mod)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_bubble_accounting_equals_jax():
    timeline = [
        {"op": sched.FWD, "mb": 0, "t0": 0.0, "t1": 0.7, "blocked_s": 0.0},
        {"op": "RECV_GRAD", "mb": 0, "t0": 0.7, "t1": 1.5,
         "blocked_s": 0.8},
        {"op": sched.BWD, "mb": 0, "t0": 1.5, "t1": 2.0, "blocked_s": 0.0},
        {"op": "UPDATE", "mb": -1, "t0": 2.0, "t1": 2.3, "blocked_s": 0.0},
    ]
    got = sched.bubble_from_timeline(timeline)
    assert got == jsched.bubble_from_timeline(timeline)
    assert got["bubble_fraction"] == pytest.approx(0.4)
    assert sched.bubble_from_timeline([]) == jsched.bubble_from_timeline([])
    per_worker = [{"FWD": 1.0, "BWD": 2.0}, {"FWD": 3.0}, {"FWD": 2.0}]
    assert sched.pool_op_costs(per_worker) == \
        jsched.pool_op_costs(per_worker)
    stats = [
        {"bubble_fraction": 0.1, "stage_occupancy": 0.9, "busy_s": 1.0},
        {"bubble_fraction": 0.3, "stage_occupancy": 0.7, "busy_s": 1.5},
    ]
    assert sched.fleet_pipeline_stats(stats) == \
        jsched.fleet_pipeline_stats(stats)
    assert sched.fleet_pipeline_stats([]) == jsched.fleet_pipeline_stats([])
    for name, p, m, v, costs in (
            ("1f1b", 2, 8, 2, {"FWD": 0.5, "BWD": 1.0, "SEND": 0.05}),
            ("gpipe", 2, 8, 1, {"FWD": 1.0, "BWD": 2.0, "SEND": 0.05}),
            ("1f1b", 4, 3, 1, {"FWD": 0.2, "BWD": 0.3})):
        assert sched.measured_schedule_bubble(name, p, m, v, costs) == \
            jsched.measured_schedule_bubble(name, p, m, v, costs)


# ---------------------------------------------------------------------------
# The wire
# ---------------------------------------------------------------------------

def test_wire_dtype_config_coerce_as_jax(monkeypatch):
    monkeypatch.delenv("RLT_MPMD_WIRE_DTYPE", raising=False)
    assert not xfer.WireDtypeConfig.coerce(None).active
    monkeypatch.setenv("RLT_MPMD_WIRE_DTYPE", "int8")
    cfg = xfer.WireDtypeConfig.coerce(None)
    assert (cfg.act, cfg.grad, cfg.active) == ("int8", "int8", True)
    for value in ("act:bf16,grad:int8", {"act": "bf16"}, "", "bf16"):
        assert xfer.WireDtypeConfig.coerce(value).enc == \
            jxfer.WireDtypeConfig.coerce(value).enc
    for bad, exc, match in (("int4", ValueError, "expected one of"),
                            ({"activations": "int8"}, ValueError,
                             "unknown keys"),
                            (7, TypeError, "mode string")):
        for mod in (xfer, jxfer):
            with pytest.raises(exc, match=match):
                mod.WireDtypeConfig.coerce(bad)


def _wire_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"h": rng.standard_normal((4, 300)).astype(np.float32),
            "idx": np.arange(5, dtype=np.int32),
            "a": [rng.standard_normal(7).astype(np.float32), None]}


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8",
                                  "act:bf16,grad:int8"])
def test_wire_payloads_byte_identical_to_jax(mode):
    """The same numpy tree through both codecs: the same bytes, the same
    accounting (the EF residual threaded through three sends of a slot),
    and each package decodes the other's payload."""
    tree = _wire_tree()
    got_codec = xfer.WireCodec(xfer.WireDtypeConfig.coerce(mode))
    want_codec = jxfer.WireCodec(jxfer.WireDtypeConfig.coerce(mode))
    for step, kind in enumerate(("act", "grad", "grad", "grad")):
        got = got_codec.encode_payload(kind, step, 1, 0, tree)
        want = want_codec.encode_payload(kind, step, 1, 0, tree)
        assert got == want, (mode, kind, step)
        assert got_codec.bytes_full_width == want_codec.bytes_full_width
        back_j = jxfer.decode_tree(got)
        back_t = xfer.decode_tree(want)
        for a, b in ((back_j["h"], back_t["h"]),
                     (back_j["a"][0], back_t["a"][0]),
                     (back_j["idx"], back_t["idx"])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert xfer.encode_tree(tree) == jxfer.encode_tree(tree)


def test_bf16_tensor_leaves_on_the_wire():
    """A ``torch.bfloat16`` leaf rides as the JAX package's
    ``ml_dtypes.bfloat16`` array (JAX decodes it).  The f32 and bf16
    lanes ship it raw with JAX's bytes and count it at its own 2 bytes,
    as the JAX codec does; an int8 lane quantizes it (the port's
    departure), about 2x fewer bytes than the raw leaf."""
    import ml_dtypes

    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(0)
                    ).bfloat16()
    as_jax = np.asarray(x.float().numpy().astype(ml_dtypes.bfloat16))
    plain = xfer.encode_tree({"x": x})
    assert plain == jxfer.encode_tree({"x": as_jax})
    back = xfer.decode_tree(plain)["x"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, x)
    for mode in ("f32", "bf16"):
        got_codec = xfer.WireCodec(xfer.WireDtypeConfig.coerce(mode))
        want_codec = jxfer.WireCodec(jxfer.WireDtypeConfig.coerce(mode))
        for kind in ("act", "grad"):
            got = got_codec.encode_payload(kind, 0, 0, 0, {"x": x})
            assert got == want_codec.encode_payload(kind, 0, 0, 0,
                                                    {"x": as_jax}), mode
        assert got_codec.bytes_full_width == \
            want_codec.bytes_full_width == 2 * x.numel() * 2
    codec = xfer.WireCodec(xfer.WireDtypeConfig.coerce("int8"))
    payload = codec.encode_payload("act", 0, 0, 0, {"x": x})
    got = xfer.decode_tree(payload)["x"]
    assert got.dtype == torch.bfloat16
    amax = x.float().abs().reshape(-1, 256).max(dim=1).values
    err = (got.float() - x.float()).abs().reshape(-1, 256).max(dim=1).values
    assert bool((err <= amax / 254.0 + amax / 128.0).all())
    assert codec.bytes_full_width == x.numel() * 2
    assert codec.bytes_full_width / len(payload) >= 1.9


def test_wire_codec_roundtrip_ratio_and_ef():
    rng = np.random.default_rng(0)
    tree = {"h": rng.standard_normal((64, 256)).astype(np.float32),
            "idx": np.arange(32, dtype=np.int32)}
    codec = xfer.WireCodec(xfer.WireDtypeConfig.coerce("int8"))
    payload = codec.encode_payload("act", 0, 0, 0, tree)
    back = xfer.decode_tree(payload)
    assert back["h"].dtype == np.float32
    np.testing.assert_array_equal(back["idx"], tree["idx"])
    amax = np.abs(tree["h"]).reshape(-1, 256).max(axis=1)
    err = np.abs(back["h"] - tree["h"]).reshape(-1, 256).max(axis=1)
    assert (err <= amax / 254.0 + 1e-7).all()
    assert codec.bytes_full_width / len(payload) >= 3.5
    g = rng.standard_normal(4096).astype(np.float32)
    ef = xfer.WireCodec(xfer.WireDtypeConfig.coerce("int8"))
    outs = [xfer.decode_tree(ef.encode_payload("grad", s, 0, 0, g))
            for s in range(8)]
    single = np.abs(outs[0] - g).mean()
    averaged = np.abs(np.mean(outs, axis=0) - g).mean()
    assert averaged < single / 4
    out = xfer.decode_tree(ef.encode_payload("grad", 9, 0, 0, g[:1024]))
    assert out.shape == (1024,)


def test_mailbox_rendezvous_timeout_and_poison():
    box = xfer.Mailbox()

    def deliver_later():
        time.sleep(0.15)
        box.deliver(("act", 0, 1, 0), {"x": 1})

    threading.Thread(target=deliver_later).start()
    payload, blocked = box.recv(("act", 0, 1, 0), timeout=5.0)
    assert payload == {"x": 1} and blocked >= 0.1
    with pytest.raises(TimeoutError, match="peer stage"):
        box.recv(("act", 0, 0, 0), timeout=0.1)
    box.fail(RuntimeError("peer died"))
    with pytest.raises(RuntimeError, match="transfer lane failed"):
        box.recv(("act", 0, 0, 0), timeout=1.0)


def test_inbox_queue_channel_roundtrip_tcp_and_shm():
    from ray_lightning_tpu_torch.cluster.shm import segment_dir

    inbox = xfer.StageInbox()
    try:
        chan = xfer.QueueChannel(inbox.handle, same_host=False)
        tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}
        chan.send("act", 2, 1, tree, chunk=1)
        got, _ = inbox.mailbox.recv(("act", 2, 1, 1), timeout=10.0)
        np.testing.assert_array_equal(got["a"], tree["a"])
        assert chan.bytes_sent > 0 and chan.shm_sends == 0
        chan.close()
        chan = xfer.QueueChannel(inbox.handle, same_host=True,
                                 shm_threshold=64)
        tree = {"a": torch.ones(64, 64)}
        chan.send("grad", 0, 3, tree)
        got, _ = inbox.mailbox.recv(("grad", 0, 3, 0), timeout=10.0)
        np.testing.assert_array_equal(got["a"], tree["a"].numpy())
        assert chan.shm_sends == 1
        # The consumer unlinks the segment after the read.
        time.sleep(0.1)
        assert [e for e in os.listdir(segment_dir())
                if e.startswith(f"rlt-seg-{os.getpid()}-")] == []
        chan.close()
    finally:
        inbox.close()


def test_local_channel_chunk_keys_and_full_width_stats():
    box = xfer.Mailbox()
    chan = xfer.LocalChannel(box)
    chan.send("act", 1, 2, {"x": np.float32(3.0)}, chunk=1)
    assert not box.ready(("act", 1, 2, 0))
    got, _ = box.recv(("act", 1, 2, 1), timeout=1.0)
    assert float(got["x"]) == 3.0
    stats = chan.xfer_stats()
    assert stats["enc"] == "act:f32,grad:f32"
    assert stats["bytes_sent"] == stats["bytes_full_width"]


def test_chunked_send_survives_throttled_reader(monkeypatch):
    """A slow consumer that would trip one whole-payload timeout does not
    trip the per-chunk budgets of the lane's queue sends."""
    from ray_lightning_tpu_torch.cluster import queue as queue_mod

    monkeypatch.setattr(queue_mod, "_ACK_TIMEOUT_S", 0.2)
    chunk = 64 << 10
    payload = os.urandom(6 * chunk)
    a, b = socket.socketpair()
    a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 32 << 10)
    b.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 32 << 10)
    got = []

    def slow_reader():
        while sum(len(c) for c in got) < len(payload):
            data = b.recv(16 << 10)
            if not data:
                return
            got.append(data)
            time.sleep(0.02)

    t = threading.Thread(target=slow_reader)
    t.start()
    try:
        assert queue_mod._send_timeout_s(chunk) < 0.3
        queue_mod._sendall_chunked(a, payload, chunk_bytes=chunk)
    finally:
        t.join(timeout=30)
        a.close()
        b.close()
    assert b"".join(got) == payload


def test_torn_quantized_segment_poisons_the_mailbox(monkeypatch):
    """A quantized payload's segment torn between write and read fails
    loudly at the inbox (its mailbox poisoned), never dequantizing
    garbage into an activation."""
    from ray_lightning_tpu_torch.cluster.shm import SegmentStore

    put = SegmentStore.put

    def torn_put(self, data):
        path = put(self, data)
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))
        return path

    monkeypatch.setattr(SegmentStore, "put", torn_put)
    inbox = xfer.StageInbox()
    chan = xfer.QueueChannel(
        inbox.handle, same_host=True, shm_threshold=0,
        codec=xfer.WireCodec(xfer.WireDtypeConfig.coerce("int8")))
    try:
        chan.send("act", 0, 0, {"h": np.ones((64, 256), np.float32)})
        with pytest.raises(RuntimeError, match="transfer lane failed"):
            inbox.mailbox.recv(("act", 0, 0, 0), timeout=20.0)
        assert chan.shm_sends == 1
    finally:
        chan.close()
        inbox.close()


# ---------------------------------------------------------------------------
# The block stage
# ---------------------------------------------------------------------------

def test_make_block_stage_matches_jax(jax_fit):
    """Output and every gradient (the stacked blocks' and the input's) of
    ``sum(out · cot)`` within 1e-5 of JAX's, f32, 2 layers (the first two
    of the in-process fit's initial blocks)."""
    from ray_lightning_tpu.models.gpt import make_block_stage as jax_stage
    from ray_lightning_tpu_torch.models.gpt import make_block_stage

    module = _jax_gpt(2)
    blocks = {k: v[:2] for k, v in jax_fit["full"]["blocks"].items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 16)).astype(np.float32)
    cot = rng.standard_normal((2, 8, 16)).astype(np.float32)

    @jax.jit
    def both(blocks, x, cot):
        out, vjp = jax.vjp(jax_stage(module.config), blocks, x)
        return out, vjp(cot)

    out, (want_blocks, want_x) = both(blocks, jnp.asarray(x),
                                      jnp.asarray(cot))
    tb = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in blocks.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    got = make_block_stage(_port_gpt(2).config)(tb, tx)
    got.backward(torch.from_numpy(cot))
    assert np.abs(got.detach().numpy() - np.asarray(out)).max() < 1e-5
    assert np.abs(tx.grad.numpy() - np.asarray(want_x)).max() < 1e-5
    for k, v in want_blocks.items():
        assert np.abs(tb[k].grad.numpy() - np.asarray(v)).max() < 1e-5, k


def test_make_block_stage_refusals_equal_jax():
    import dataclasses

    from ray_lightning_tpu.models.gpt import GPTConfig as JaxConfig
    from ray_lightning_tpu.models.gpt import make_block_stage as jax_stage
    from ray_lightning_tpu_torch.models.gpt import GPTConfig
    from ray_lightning_tpu_torch.models.gpt import make_block_stage

    for kw in ({"n_experts": 2}, {"lora_rank": 4}):
        msgs = []
        for cls, fn in ((GPTConfig, make_block_stage),
                        (JaxConfig, jax_stage)):
            cfg = dataclasses.replace(cls(n_layer=2, **TINY), **kw)
            with pytest.raises(ValueError) as err:
                fn(cfg)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# The in-process fit
# ---------------------------------------------------------------------------

def _fit_batches(steps=FIT_STEPS, seed=7):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, TINY["vocab_size"],
                                    (8, TINY["seq_len"] + 1)
                                    ).astype(np.int32)}
            for _ in range(steps)]


def _jax_inproc_fit():
    from ray_lightning_tpu.mpmd.inproc import run_inproc_pipeline_fit
    from ray_lightning_tpu.mpmd.plan import gpt_mpmd_spec

    full = _full(4)
    data = _fit_batches()
    spec = gpt_mpmd_spec(_jax_gpt(4))
    res = run_inproc_pipeline_fit(
        spec, full, spec.tx_factory, lambda s: data[s], FIT_STEPS,
        n_workers=2, n_micro=4, schedule="1f1b")
    return {"full": full, "data": data, "losses": list(res["losses"]),
            "params": jax.tree.map(np.asarray, res["params"]),
            "final_step": int(res["final_step"])}


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    """One JAX in-process fit: 4 layers, P = 2, M = 4, 1F1B, the full
    untied params it started from and its batches."""
    return mf.shared_once(tmp_path_factory, "jax-mpmd-inproc-fit",
                          _jax_inproc_fit)


def _close(got_losses, got_params, want):
    np.testing.assert_allclose(got_losses, want["losses"], rtol=0,
                               atol=1e-5)
    for key in ("wte", "head_w"):
        np.testing.assert_allclose(np.asarray(got_params[key]),
                                   want["params"][key], rtol=0, atol=1e-5)


@pytest.mark.parametrize("schedule,workers,micro,interleave", [
    ("gpipe", 2, 4, 1), ("1f1b", 2, 4, 1), ("1f1b", 2, 4, 2),
    ("gpipe", 1, 4, 1), ("gpipe", 2, 1, 1)])
def test_inproc_flavors_match_the_jax_fit(jax_fit, schedule, workers,
                                          micro, interleave):
    from ray_lightning_tpu_torch.mpmd.inproc import run_inproc_pipeline_fit
    from ray_lightning_tpu_torch.mpmd.plan import gpt_mpmd_spec

    spec = gpt_mpmd_spec(_port_gpt(4))
    data = jax_fit["data"]
    res = run_inproc_pipeline_fit(
        spec, params_from_jax(jax_fit["full"], "cpu"), spec.tx_factory,
        lambda s: data[s], FIT_STEPS, n_workers=workers, n_micro=micro,
        schedule=schedule, interleave=interleave, devices="cpu")
    _close(res["losses"], res["params"], jax_fit)
    assert res["final_step"] == jax_fit["final_step"] == FIT_STEPS
    assert all(0 <= s["bubble_fraction"] <= 1
               for s in res["per_stage_stats"])


def test_inproc_trace_export_stitches_each_step_across_stages(jax_fit,
                                                             tmp_path):
    """With ``trace_dir`` each stage exports its instruction spans; the
    embed stage mints a step's trace id and the other stage adopts it
    from the frames, so every step's spans on both stages share one id
    (the step spans' parents are the embed stage's root)."""
    from ray_lightning_tpu_torch.mpmd.inproc import run_inproc_pipeline_fit
    from ray_lightning_tpu_torch.mpmd.plan import gpt_mpmd_spec

    spec = gpt_mpmd_spec(_port_gpt(4))
    data = jax_fit["data"]
    run_inproc_pipeline_fit(
        spec, params_from_jax(jax_fit["full"], "cpu"), spec.tx_factory,
        lambda s: data[s], 2, n_workers=2, n_micro=4, devices="cpu",
        trace_dir=str(tmp_path))
    by_stage = {}
    for k in range(2):
        with open(tmp_path / f"trace-mpmd-stage{k}.jsonl") as f:
            by_stage[k] = [json.loads(line) for line in f]
    steps = {k: {r["args"]["step"]: r["args"]["trace_id"]
                 for r in spans if r["name"] in ("mpmd_step",
                                                 "mpmd_stage_step")}
             for k, spans in by_stage.items()}
    assert steps[0] == steps[1] and len(steps[0]) == 2
    assert len(set(steps[0].values())) == 2
    ops = {r["name"] for r in by_stage[1]}
    assert {"fwd", "bwd", "recv_act", "send_grad", "update"} <= ops
    root = next(r for r in by_stage[1] if r["name"] == "mpmd_stage_step")
    assert root["args"]["span_id"].endswith(".w1")


def test_inproc_int8_wire_against_the_f32_wire():
    """The int8 wire against the port's own f32 wire at JAX's tolerance
    (``tests/test_grad_overlap.py``'s setup: vocab 256, 4 layers, d 64,
    seq 64, 4 steps), >= 3x fewer bytes; the mixed wire >= 1.8x."""
    from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
    from ray_lightning_tpu_torch.mpmd.inproc import run_inproc_pipeline_fit
    from ray_lightning_tpu_torch.mpmd.plan import _gpt_untie, gpt_mpmd_spec

    cfg = GPTConfig(vocab_size=256, n_layer=4, n_head=4, d_model=64,
                    seq_len=64, warmup_steps=2)
    module = GPT(cfg, device="cpu")
    spec = gpt_mpmd_spec(module)
    full = _gpt_untie(module.init_params(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(11)
    data = [{"tokens": rng.integers(0, 256, (8, 65)).astype(np.int32)}
            for _ in range(4)]

    def run(wire):
        return run_inproc_pipeline_fit(
            spec, full, spec.tx_factory, lambda s: data[s], 4, n_workers=2,
            n_micro=4, schedule="1f1b", wire_dtype=wire, devices="cpu")

    ref = run(None)
    assert all(x["wire_ratio"] == 1.0 for x in ref["xfer"])
    q = run("int8")
    np.testing.assert_allclose(q["losses"], ref["losses"], rtol=2e-3,
                               atol=1e-4)
    sent = sum(x["bytes_sent"] for x in q["xfer"])
    fullw = sum(x["bytes_full_width"] for x in q["xfer"])
    assert fullw / sent >= 3.0
    assert all(x["enc"] == "act:int8,grad:int8" for x in q["xfer"])
    mixed = run("act:bf16,grad:int8")
    np.testing.assert_allclose(mixed["losses"], ref["losses"], rtol=2e-3,
                               atol=1e-4)
    assert fullw / sum(x["bytes_sent"] for x in mixed["xfer"]) >= 1.8


def test_split_micro_batches_rejects_ragged():
    from ray_lightning_tpu_torch.mpmd.inproc import split_micro_batches

    with pytest.raises(ValueError, match="not divisible"):
        split_micro_batches({"tokens": np.zeros((7, 4))}, 2)


# ---------------------------------------------------------------------------
# The actor plane
# ---------------------------------------------------------------------------

def _actor_fit(root, data, full, workers, **strategy_kw):
    """A ``Trainer.fit`` through an ``MpmdStrategy`` over ``workers``'s
    two stage workers (a fresh worker's first call pays its imports);
    the fit's teardown leaves them to ``workers``."""
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.parallel.strategies import MpmdStrategy

    module = _port_gpt(4)
    module.initial_params = params_from_jax(full, "cpu")
    strategy = MpmdStrategy(num_stages=2, devices_per_stage=1,
                            schedule="1f1b", num_microbatches=4,
                            env_per_worker=WORKER_ENV, **strategy_kw)
    strategy._backend, strategy._workers = workers._backend, list(
        workers._workers)
    strategy.teardown = lambda: None
    trainer = Trainer(strategy=strategy, max_steps=FIT_STEPS,
                      default_root_dir=str(root), enable_checkpointing=False)
    dm = helpers.ArraysDataModule(
        {"tokens": np.concatenate([b["tokens"] for b in data])},
        batch_size=8)
    trainer.fit(module, dm)
    return strategy, trainer


@pytest.fixture(scope="module")
def stage_workers():
    """Two CPU stage workers the module's actor-plane fits share."""
    from ray_lightning_tpu_torch.parallel.strategies import MpmdStrategy

    own = MpmdStrategy(num_stages=2, devices_per_stage=1,
                       env_per_worker=WORKER_ENV)
    own.setup()
    yield own
    own.teardown()


@pytest.fixture(scope="module")
def actor_fit(jax_fit, stage_workers, tmp_path_factory):
    root = tmp_path_factory.mktemp("mpmd-actor")
    strategy, trainer = _actor_fit(root, jax_fit["data"], jax_fit["full"],
                                   stage_workers)
    return root, strategy, trainer


def test_mpmd_strategy_fit_matches_the_jax_fit(jax_fit, actor_fit):
    from ray_lightning_tpu.telemetry.schema import validate_mpmd_snapshot

    root, strategy, trainer = actor_fit
    report = strategy.mpmd_report
    assert trainer.global_step == FIT_STEPS
    _close(report["losses"], trainer.params, jax_fit)
    assert trainer.state.opt_state is None
    assert report["schedule"] == "1f1b"
    assert 0 <= report["bubble_fraction"] <= 1
    assert 0 <= report["stage_occupancy"] <= 1
    assert "FWD" in report["op_costs_ms"]
    assert report["xfer"]["wire_ratio"] == 1.0
    assert trainer.callback_metrics["train_loss"] == report["losses"][-1]
    with open(os.path.join(root, "telemetry", "mpmd-live.json")) as f:
        doc = json.load(f)
    assert validate_mpmd_snapshot(doc["mpmd"]) == []


def test_stage_kill_restarts_step_exactly(jax_fit, actor_fit,
                                          stage_workers, tmp_path):
    """Stage 1 killed at the start of step 2: one restart, resumed from
    the step-2 checkpoints, the losses after it equal to the
    uninterrupted fit's.  The kill is an init hook: run here in the
    shared workers, and by the strategy in those it respawns."""
    marker = str(tmp_path / "crash-marker")
    crash = helpers.CrashStageOnce(marker, stage=1, step=2)
    for w in stage_workers._workers:
        w.execute(crash)
    strategy, trainer = _actor_fit(
        tmp_path / "crash", jax_fit["data"], jax_fit["full"],
        stage_workers, max_restarts=1, restart_backoff_s=0.1,
        init_hook=crash)
    assert trainer.global_step == FIT_STEPS
    assert strategy.restarts_used == 1
    assert [e["kind"] for e in strategy.recovery_events] == [
        "backoff", "elastic_restart"]
    resumed = strategy.mpmd_report["losses"]
    clean = actor_fit[1].mpmd_report["losses"]
    assert resumed == clean[-len(resumed):] and len(resumed) == 2
    with open(marker + ".resumed") as f:
        assert [int(line.split()[0]) for line in f] == [2, 3]


def _write_stage_ckpt(directory, step, stage):
    from ray_lightning_tpu_torch.mpmd.stage import stage_ckpt_name
    from ray_lightning_tpu_torch.utils.state_stream import (
        state_stream_to_file, to_state_stream,
    )

    path = directory / stage_ckpt_name(step, stage)
    state_stream_to_file(to_state_stream(
        {"state": {"x": torch.zeros(2)}, "step": step}), str(path))
    return path


def test_latest_mpmd_checkpoint_walks_back(tmp_path):
    from ray_lightning_tpu_torch.mpmd.worker import latest_mpmd_checkpoint

    assert latest_mpmd_checkpoint(str(tmp_path), 2)["path"] is None
    assert latest_mpmd_checkpoint(None, 2)["path"] is None
    # Step 2 complete; step 3 lacks stage 1; step 4's stage 0 is corrupt.
    for stage in (0, 1):
        _write_stage_ckpt(tmp_path, 2, stage)
    _write_stage_ckpt(tmp_path, 3, 0)
    for stage in (0, 1):
        _write_stage_ckpt(tmp_path, 4, stage)
    bad = tmp_path / "mpmd-step00000004-stage0.ckpt"
    blob = bytearray(bad.read_bytes())
    blob[len(blob) // 2] ^= 0x01
    bad.write_bytes(bytes(blob))
    info = latest_mpmd_checkpoint(str(tmp_path), 2)
    assert info["path"].endswith("mpmd-step00000002")
    assert any("stage0" in c["path"] for c in info["corrupt"])


def test_port_stage_checkpoint_reads_in_jax(tmp_path, jax_fit):
    """A stage checkpoint the port writes decodes with the JAX reader to
    the same arrays (params, moments, counts, step) and resumes in the
    port bitwise."""
    from ray_lightning_tpu.utils.state_stream import (
        load_state_stream as jax_load, state_stream_from_file as jax_read,
    )
    from ray_lightning_tpu_torch.mpmd.inproc import split_micro_batches
    from ray_lightning_tpu_torch.mpmd.plan import gpt_mpmd_spec
    from ray_lightning_tpu_torch.mpmd.stage import StageRunner

    spec = gpt_mpmd_spec(_port_gpt(4))
    runner = StageRunner(spec, StagePlan.split(4, 1), 0, 1, "gpipe", 4,
                         spec.tx_factory(), device="cpu")
    runner.init_state(params_from_jax(jax_fit["full"], "cpu"))
    micro = split_micro_batches(jax_fit["data"][0], 4)
    runner.run_fit(1, lambda s: micro, restart_dir=str(tmp_path))
    path = tmp_path / "mpmd-step00000001-stage0.ckpt"
    payload = jax_load(jax_read(str(path)))
    assert int(payload["step"]) == 1
    state = payload["state"]
    assert int(state.step) == 1
    adam = state.opt_state[0]
    assert int(adam.count) == 1 and int(state.opt_state[2].count) == 1
    chunk = runner.state.params["chunks"][0]
    mu = runner.state.opt_state["mu"]["chunks"][0]
    for key in ("wte", "head_w"):
        np.testing.assert_array_equal(
            np.asarray(state.params["chunks"][0][key]), chunk[key].numpy())
        np.testing.assert_array_equal(
            np.asarray(adam.mu["chunks"][0][key]).astype(np.float32),
            mu[key].float().numpy())
    np.testing.assert_array_equal(
        np.asarray(state.params["chunks"][0]["blocks"]["qkv_w"]),
        chunk["blocks"]["qkv_w"].numpy())
    other = StageRunner(spec, StagePlan.split(4, 1), 0, 1, "gpipe", 4,
                        spec.tx_factory(), device="cpu")
    assert other.load_checkpoint(str(tmp_path / "mpmd-step00000001")) == 1
    a = runner.run_fit(2, lambda s: micro, start_step=1)["losses"]
    b = other.run_fit(2, lambda s: micro, start_step=1)["losses"]
    assert a[-1] == b[-1]


def test_mpmd_strategy_refusals_equal_jax():
    from ray_lightning_tpu.parallel.strategies import (
        MpmdStrategy as JaxMpmdStrategy,
    )
    from ray_lightning_tpu_torch.parallel.strategies import MpmdStrategy

    for kw, exc, match in (
            ({"schedule": "zigzag"}, ValueError, "unknown schedule"),
            ({"schedule": "gpipe", "interleave": 2}, ValueError,
             "requires schedule='1f1b'"),
            ({"num_stages": 1, "interleave": 2}, ValueError,
             "needs num_stages >= 2"),
            ({"num_microbatches": 0}, ValueError, "num_microbatches"),
            ({"ckpt_every_n_steps": 0}, ValueError, "ckpt_every_n_steps"),
            ({"num_stages": 0}, ValueError, "num_stages"),
            ({"wire_dtype": "int4"}, ValueError, "expected one of"),
            ({"devices_per_stage": 1, "elastic_min_workers": 1},
             ValueError, "cannot resize elastically")):
        msgs = []
        for cls in (MpmdStrategy, JaxMpmdStrategy):
            with pytest.raises(exc, match=match) as err:
                cls(**kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], kw
    strategy = MpmdStrategy(num_stages=2, devices_per_stage=1)
    with pytest.raises(NotImplementedError, match="fit only"):
        strategy.run("validation", None, None, None, [])
    with pytest.raises(NotImplementedError, match="Queue 1 item 4b"):
        MpmdStrategy(num_stages=2, devices_per_stage=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices_per_stage=1"):
            MpmdStrategy(num_stages=2)


def test_render_openmetrics_mpmd_block_equals_jax():
    from ray_lightning_tpu.telemetry.export_prom import (
        render_openmetrics as jax_render,
    )
    from ray_lightning_tpu_torch.telemetry.export_prom import (
        render_openmetrics,
    )

    beat = {"type": "mpmd_stage", "stage": 0, "step": 5,
            "bubble_fraction": 0.125, "stage_occupancy": 0.875,
            "busy_s": 0.2, "blocked_s": 0.01, "loss": 3.5}
    snapshot = {"ranks_reporting": 0, "ranks": {},
                "mpmd": {"schedule": "1f1b", "interleave": 2,
                         "n_micro": 8, "n_stages": 2,
                         "stages": [beat, {**beat, "stage": 1}]}}
    text = render_openmetrics(snapshot)
    assert text == jax_render(snapshot)
    assert 'rlt_mpmd_stage_bubble_fraction{stage="0"} 0.125' in text
