"""Decode replicas and the in-process fleet, as in
``ray_lightning_tpu/serve/dist/replica.py`` (its in-process half).

A decode replica is one :class:`~ray_lightning_tpu_torch.serve.engine.
ServeEngine` plus the fleet plumbing: a hello that registers its inbox
and capabilities with the router, and a periodic beat with its live
``ServeStats`` snapshot, its terminal ``(rid, status)`` feed and its
failed handoffs.  :class:`InprocReplica` and :class:`InprocPrefill` run
the members on threads of the calling process (beats and handoffs still
cross real TCP loopback); ``kill(hard=True)`` stands in for an abrupt
death, ``kill()`` for a planned drain, which live-migrates the resident
sequences.  :func:`launch_inproc_fleet` wires N replicas, M prefill
workers and a started router into a :class:`ServeFleet` with one
``close()``.  Every member of an in-process fleet serves on the same
device.  The JAX package's actor fleet (one process per member) waits
for the port's actor and drain planes.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_lightning_tpu_torch.serve.dist.handoff import (
    make_beat_item, make_hello_item, make_migration_item,
)
from ray_lightning_tpu_torch.serve.dist.router import Router

__all__ = [
    "DecodeReplicaRunner",
    "InprocReplica",
    "InprocPrefill",
    "ServeFleet",
    "launch_inproc_fleet",
]


class DecodeReplicaRunner:
    """The replica side around one engine: a hello, then beats until
    stopped.  The engine's serve thread does the work."""

    def __init__(self, replica_id: str, engine, beat_handle,
                 beat_s: float = 0.25):
        self.replica_id = replica_id
        self.engine = engine
        self._beat_handle = beat_handle
        self.beat_s = beat_s
        self.suppress_final = False  # a hard kill sends no last beat
        self._last = 0.0
        # A torn or vanished handoff payload is reported on the beat (the
        # router re-routes the prefill), not answered "invalid".
        engine.report_handoff_failures = True

    def hello(self) -> None:
        engine = self.engine
        handle = engine.queue_handle()
        self._beat_handle.put(make_hello_item(
            "decode", self.replica_id, (handle.host, handle.port),
            num_slots=engine.config.num_slots,
            max_queue=engine.config.max_queue,
            spec_k=engine.spec_k,
            max_prompt_len=engine.max_prompt_len,
            max_model_len=engine.max_model_len,
            block_size=engine.config.block_size,
            max_adapters=engine.config.max_adapters,
        ))

    def publish_beat(self, closing: bool = False,
                     migrating: Optional[List[str]] = None) -> None:
        engine = self.engine
        self._beat_handle.put(make_beat_item(
            "decode", self.replica_id,
            done=engine.drain_done(),
            failed=engine.drain_failed(),
            snapshot=engine.snapshot(),
            # The eager server captures no CUDA graph: the port's
            # recompile count (as the engine's capacity plane books it).
            recompiles=0,
            adapters=(engine.adapter_names()
                      if engine.adapters is not None else None),
            closing=closing, migrating=migrating,
        ))

    def run(self, stop=None) -> None:
        """Beat until ``stop()`` is true, then stop the engine (which
        sweeps stale ``rlt-kv`` segments) and publish the last feed.  On
        a planned drain (no hard kill) the resident sequences are first
        live-migrated to survivors the router picks."""
        self.hello()
        self.engine.start()
        try:
            while not (stop() if stop is not None else False):
                time.sleep(min(self.beat_s, 0.05))
                self._maybe_beat()
        finally:
            if not self.suppress_final:
                try:
                    self._migrate_out()
                except (OSError, ConnectionError):
                    pass  # the router is gone: recompute failover
            self.engine.stop()
            if not self.suppress_final:
                try:
                    self.publish_beat(closing=True)
                except (OSError, ConnectionError):
                    pass  # the router is gone

    def _migrate_out(self) -> bool:
        """A planned drain's live migration: halt the serve loop, claim
        the resident rids on the beat lane (the router holds off
        beat-loss failover for them), then send each resident sequence's
        k/v and position as a ``serve_migration`` frame on the same
        ordered lane, ahead of the closing beat."""
        from ray_lightning_tpu_torch.mpmd.transfer import encode_tree

        engine = self.engine
        engine.halt_loop()
        rids = [
            r.rid for slot, r in enumerate(engine.scheduler.slots)
            if r is not None and slot not in engine._chunk_jobs
            and r.generated
        ]
        if not rids:
            return False
        # The claim goes first: it refreshes the beat and registers the
        # claim, so a slow export cannot race the death path.
        self.publish_beat(migrating=rids)
        sent = 0
        for entry in engine.export_resident():
            self._beat_handle.put(make_migration_item(
                entry["req"], generated=entry["generated"],
                cur_token=entry["cur_token"], seq_len=entry["seq_len"],
                data=encode_tree({"kv": entry["kv"]}),
            ))
            sent += 1
        return sent > 0

    def _maybe_beat(self) -> None:
        now = time.monotonic()
        if now - self._last < self.beat_s:
            return
        self._last = now
        try:
            self.publish_beat()
        except (OSError, ConnectionError):
            pass  # the router is restarting or gone; the feeds wait


class InprocReplica:
    """A decode replica on threads of this process (the engine's serve
    thread and a beat thread).  ``kill(hard=True)`` halts the serve loop
    wherever it is, makes the inbox refuse and stops the beats: what the
    router sees of a killed process."""

    role = "decode"

    def __init__(self, replica_id: str, engine, beat_handle,
                 beat_s: float = 0.2):
        self.id = replica_id
        self.engine = engine
        self._runner = DecodeReplicaRunner(replica_id, engine, beat_handle,
                                           beat_s=beat_s)
        self._stop = threading.Event()
        self._dead = False
        self._thread = threading.Thread(
            target=self._runner.run, args=(self._stop.is_set,),
            name=f"rlt-serve-{replica_id}", daemon=True,
        )
        self._thread.start()

    def is_alive(self) -> bool:
        return not self._dead and self._thread.is_alive()

    def kill(self, hard: bool = False) -> None:
        if self._dead:
            return
        self._runner.suppress_final = hard
        if hard:
            self._dead = True
            self.engine._stop.set()
            if self.engine._inbox is not None:
                self.engine._inbox.shutdown()
            self._stop.set()
        else:
            # A planned drain reads alive until its migration and closing
            # beat are sent: dead first would race the router's liveness
            # sweep into a failover mid-drain.
            self._stop.set()
            self._thread.join(timeout=30)
            self._dead = True


class InprocPrefill:
    """A prefill worker on a thread of this process."""

    role = "prefill"

    def __init__(self, worker_id: str, module, params, serve_cfg,
                 beat_handle, beat_s: float = 0.2,
                 trace_dir: Optional[str] = None, device=None):
        from ray_lightning_tpu_torch.serve.dist.prefill import PrefillRunner

        self.id = worker_id
        self.runner = PrefillRunner(
            worker_id, module, params, serve_cfg, beat_handle,
            beat_s=beat_s, trace_dir=trace_dir, device=device,
        )
        self._stop = threading.Event()
        self._dead = False
        self._thread = threading.Thread(
            target=self.runner.run, args=(self._stop.is_set,),
            name=f"rlt-serve-{worker_id}", daemon=True,
        )
        self._thread.start()

    def is_alive(self) -> bool:
        return not self._dead and self._thread.is_alive()

    def kill(self, hard: bool = False) -> None:
        if self._dead:
            return
        self._dead = True
        self.runner.suppress_final = hard
        if hard:
            self.runner._inbox.shutdown()
        self._stop.set()
        if not hard:
            self._thread.join(timeout=30)


class ServeFleet:
    """Router, replicas and workers with one teardown."""

    def __init__(self, router: Router, replicas: List[Any],
                 workers: List[Any]):
        self.router = router
        self.replicas = replicas
        self.workers = workers

    def queue_handle(self):
        return self.router.queue_handle()

    def register_adapter(self, name: str, adapter: Dict[str, Any]) -> None:
        """Register one LoRA tenant fleet-wide; members load it when a
        request for it is first placed on them."""
        self.router.register_adapter(name, adapter)

    def close(self) -> None:
        # The router first: a planned teardown must not read as member
        # deaths (failovers and respawns on the way down).
        self.router.stop()
        for member in self.workers + self.replicas:
            try:
                member.kill()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass


def _cfg_kwargs(serve_cfg) -> Dict[str, Any]:
    """A ``ServeConfig`` as keyword arguments: each member builds its
    own."""
    from dataclasses import asdict

    kw = asdict(serve_cfg)
    if kw.get("prefill_buckets") is not None:
        kw["prefill_buckets"] = list(kw["prefill_buckets"])
    return kw


def launch_inproc_fleet(module, params, serve_cfg, *, n_replicas: int = 2,
                        n_prefill: int = 0, draft_module=None,
                        draft_params=None, beat_s: float = 0.1,
                        lost_after_s: float = 1.0,
                        trace_dir: Optional[str] = None,
                        adapters: Optional[Dict[str, Any]] = None,
                        device=None, **router_kwargs) -> ServeFleet:
    """N engines and M prefill workers on threads of this process behind a
    started router, every one on ``device`` (None = ``"cuda"``).
    ``adapters`` registers LoRA tenants with the router
    (``serve_cfg.max_adapters`` sizes every member's pool; members load
    them on first placement); ``trace_dir`` turns on request tracing
    fleet-wide; ``router_kwargs`` go to :class:`Router`
    (``telemetry_dir``, ``prom_file``, ...)."""
    from ray_lightning_tpu_torch.serve.engine import ServeConfig, ServeEngine

    router = Router(lost_after_s=lost_after_s, trace_dir=trace_dir,
                    **router_kwargs)
    for name, adapter in (adapters or {}).items():
        router.register_adapter(name, adapter)

    def make_engine(name):
        return ServeEngine(
            module, params, ServeConfig(**_cfg_kwargs(serve_cfg)),
            device=device, draft_module=draft_module,
            draft_params=draft_params, trace_dir=trace_dir,
            trace_name=name,
        )

    replicas = [
        InprocReplica(f"r{i}", make_engine(f"r{i}"), router.beat_handle,
                      beat_s=beat_s)
        for i in range(n_replicas)
    ]
    workers = [
        InprocPrefill(f"p{i}", module, params, serve_cfg,
                      router.beat_handle, beat_s=beat_s,
                      trace_dir=trace_dir, device=device)
        for i in range(n_prefill)
    ]
    if n_prefill:
        router._prefill_factory = lambda: InprocPrefill(
            f"p{uuid.uuid4().hex[:6]}", module, params, serve_cfg,
            router.beat_handle, beat_s=beat_s, trace_dir=trace_dir,
            device=device,
        )
    for r in replicas:
        router.add_replica(r)
    for w in workers:
        router.add_prefill(w)
    router.start()
    router.wait_ready(timeout=60)
    return ServeFleet(router, replicas, workers)
