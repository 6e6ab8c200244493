"""The port's host plane for multi-process training: process actors, the
local backend and its object store, the result pump, the worker session,
the environment bus and the fleet merge of telemetry, held against the
JAX package where it has the same function.  Actors run stdlib callables
(``os.getenv``, ``time.sleep``, ``int``), which pickle by reference."""

import os
import re
import signal
import time
from concurrent.futures import Future

import pytest

from ray_lightning_tpu.telemetry import aggregate as jax_aggregate
from ray_lightning_tpu_torch import session, util
from ray_lightning_tpu_torch.cluster import backend as backend_mod
from ray_lightning_tpu_torch.cluster.actor import (
    ActorDiedError, ProcessActor, RemoteError, build_child_env,
)
from ray_lightning_tpu_torch.cluster.queue import DriverQueue
from ray_lightning_tpu_torch.parallel import env_bus
from ray_lightning_tpu_torch.parallel.strategies import RayStrategy
from ray_lightning_tpu_torch.telemetry import aggregate

LIMIT_S = 120


@pytest.fixture
def time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"actor test exceeded {LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture
def actor(time_limit):
    a = ProcessActor(name="probe", env={"RLT_PROBE_VAR": "set"})
    yield a
    a.kill()


def test_actor_runs_calls_with_its_env_and_answers_control(actor):
    assert actor.execute(os.getenv, "RLT_PROBE_VAR") == "set"
    actor.set_env_vars({"RLT_PROBE_VAR": "changed"})
    assert actor.execute(os.getenv, "RLT_PROBE_VAR") == "changed"
    assert actor.execute(os.getpid) != os.getpid()
    # The control lane answers while a call is running, and its stack dump
    # shows the call.
    busy = actor.submit(time.sleep, 1.5)
    time.sleep(0.3)
    t0 = time.monotonic()
    assert actor.control("ping")["pid"] == actor.execute.__self__._proc.pid
    stacks = actor.dump_stacks()["stacks"]
    assert time.monotonic() - t0 < 1.0 and not busy.done()
    assert any("call_worker" in s for s in stacks.values())
    busy.result(timeout=10)
    info = actor.get_device_info()
    assert info["platform"] in ("cpu", "gpu") and info["pid"] > 0


def test_remote_exception_carries_its_traceback(actor):
    with pytest.raises(RemoteError) as err:
        actor.execute(int, "not a number")
    assert err.value.actor_name == "probe"
    assert "Traceback" in err.value.remote_traceback
    assert "invalid literal for int()" in str(err.value)
    assert actor.execute(int, "7") == 7  # the actor lives on


def test_actor_killed_mid_call_fails_its_future_not_hangs(actor):
    fut = actor.submit(time.sleep, 30)
    time.sleep(0.2)
    actor._proc.kill()
    t0 = time.monotonic()
    with pytest.raises(ActorDiedError, match="died before answering") as err:
        fut.result(timeout=20)
    assert time.monotonic() - t0 < 10
    assert err.value.exit_code == -signal.SIGKILL
    assert not actor.is_alive()
    with pytest.raises(ActorDiedError, match="not alive"):
        actor.submit(os.getpid)
    err.value.enrich(rank=3, note="probe")
    assert "rank=3" in str(err.value) and "probe" in str(err.value)


def test_child_env_carries_the_import_path():
    env = build_child_env({"X_OVERRIDE": "1"})
    assert env["X_OVERRIDE"] == "1"
    path = env["PYTHONPATH"].split(os.pathsep)
    assert os.getcwd() in path or any(os.path.samefile(p, os.getcwd())
                                      for p in path if os.path.isdir(p))


def test_object_store_by_value_and_by_segment(time_limit):
    be = backend_mod.LocalBackend(min_segment_bytes=1024)
    try:
        small = be.put({"a": 1})
        big = be.put(b"x" * 4096)
        assert small._segment_path is None and small.get() == {"a": 1}
        assert big._segment_path is not None and big.nbytes > 4096
        a = be.create_actor("reader")
        # Each reader unpickles its own copy; the segment path crossed.
        assert a.execute(len, big.get()) == 4096
        seg = big._segment_path
        big.release()
        big.release()
        assert not os.path.exists(seg)
    finally:
        be.shutdown()
    assert isinstance(backend_mod.get_backend(None), backend_mod.LocalBackend)
    assert backend_mod.get_backend(be) is be
    for name in ("remote", "ray"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            backend_mod.get_backend(name)
    with pytest.raises(ValueError, match="Unknown cluster backend"):
        backend_mod.get_backend("slurm")


_RAN = []


def _thunk():
    """A queue item the driver runs in its own context (by reference)."""
    _RAN.append("thunk")


def test_process_results_pumps_thunks_and_fails_fast():
    q = DriverQueue()
    try:
        ran = _RAN
        ran.clear()
        q.handle.put({"type": "metrics", "rank": 0})
        q.handle.put(_thunk)
        done, hung = Future(), Future()
        done.set_result("r0")
        hung.set_exception(RuntimeError("rank 1 failed"))
        with pytest.raises(RuntimeError, match="rank 1 failed"):
            util.process_results([done, hung], q, poll_interval_s=0.01)
        assert ran == ["thunk"]
        assert q.empty()
        ok = Future()
        ok.set_result(5)
        assert util.process_results([done, ok], q) == ["r0", 5]
    finally:
        q.shutdown()


def test_session_lifecycle():
    q = DriverQueue()
    try:
        assert not session.is_session_enabled()
        with pytest.raises(ValueError, match="No TpuTrainingSession"):
            session.get_actor_rank()
        session.init_session(rank=3, queue=q.handle, num_workers=4)
        try:
            with pytest.raises(ValueError, match="already active"):
                session.init_session(rank=0)
            assert session.get_actor_rank() == 3
            session.put_queue({"type": "x"})
            assert q.get(timeout=5) == {"type": "x"}
        finally:
            session.shutdown_session()
        session.init_session(rank=0)
        try:
            with pytest.raises(ValueError, match="No queue"):
                session.put_queue(1)
        finally:
            session.shutdown_session()
    finally:
        q.shutdown()


def test_env_bus_registers_every_knob_the_port_reads(monkeypatch):
    """Every ``RLT_*`` name the port reads is registered (the JAX lint
    rule RLT005's contract), and a driver-side forwarded knob reaches the
    strategy's worker environment."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        env_bus.__file__)))
    read = set()
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                text = open(os.path.join(dirpath, name)).read()
                read |= set(re.findall(
                    r"(?:environ\.get|getenv|environ\[)\(?\s*[\"'](RLT_\w+)",
                    text))
    assert "RLT_MEGASTEP" in read and "RLT_TELEMETRY" in read
    assert read <= set(env_bus.registered_names()), read - set(
        env_bus.registered_names())
    assert set(env_bus.forwarded_vars()) == {
        "RLT_TELEMETRY", "RLT_TELEMETRY_SAMPLE", "RLT_TELEMETRY_PEAK",
        "RLT_MEGASTEP", "RLT_GRAD_COMM", "RLT_GRAD_BUCKET_MB",
        "RLT_GRAD_BLOCK", "RLT_GRAD_DCN_ONLY", "RLT_GRAD_OVERLAP",
        "RLT_UPDATE_SHARDING"}
    monkeypatch.setenv("RLT_MEGASTEP", "off")
    monkeypatch.setenv("RLT_BACKEND", "local")
    s = RayStrategy(num_workers=1, device="cpu",
                    env_per_worker={"RLT_TELEMETRY": "off"})
    assert s.env_per_worker["RLT_MEGASTEP"] == "off"
    assert s.env_per_worker["RLT_TELEMETRY"] == "off"
    assert "RLT_BACKEND" not in s.env_per_worker


def test_fleet_merge_equals_jax():
    snaps = [
        {"rank": 1, "tier": "cheap", "step_stats": {"step_mean_ms": 12.0,
                                                    "mfu": 0.4},
         "counters": {"train_dispatches": 3, "checkpoint_writes": 0},
         "meta": {"megastep": 1}},
        {"rank": 0, "tier": "cheap", "step_stats": {"step_mean_ms": 10.0,
                                                    "mfu": 0.5,
                                                    "mfu_basis": "analytic"},
         "counters": {"train_dispatches": 3, "checkpoint_writes": 1},
         "meta": {"megastep": 1}},
        {},
    ]
    got = aggregate.merge_snapshots(snaps)
    assert got == jax_aggregate.merge_snapshots(snaps)
    assert got["world_size"] == 2
    assert got["counters"]["checkpoint_writes"]["sum"] == 1.0
    assert aggregate.merge_snapshots([]) == {}


def test_strategy_workers_report_their_devices(time_limit):
    """``setup`` spawns the workers (``init_hook`` on each), each reports
    its own devices, ``teardown`` kills them."""
    s = RayStrategy(num_workers=2, device="cpu", init_hook=os.getpid)
    s.setup()
    try:
        info = s.get_worker_device_info()
        assert len(info) == 2 and len({i["pid"] for i in info}) == 2
        assert all(i["platform"] in ("cpu", "gpu") for i in info)
        workers = list(s._workers)
    finally:
        s.teardown()
    assert s._workers == [] and not any(w.is_alive() for w in workers)
