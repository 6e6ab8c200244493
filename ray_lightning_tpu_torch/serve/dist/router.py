"""Load-aware router of the disaggregated serving fleet, as in
``ray_lightning_tpu/serve/dist/router.py``.

One router fronts N decode replicas and M prefill workers.  Clients talk
to it as to a single engine: the same ``serve_request`` frames on
:meth:`Router.queue_handle`, and the token stream comes straight from the
replica that serves the request to the client's reply queue (the router
sits on the submission path only).  Host logic throughout:

* **admission** — every routed request is tracked until a replica beat
  reports it terminal, so a replica's load is the router's own count.
  When every live replica holds ``num_slots + max_queue``, a submission
  gets the typed ``rejected`` reply, as from one engine;
* **placement** — least loaded by in-flight count (free blocks from the
  last beat's ``ServeStats`` snapshot break ties), with stickiness: a
  re-routed request keeps its replica, ``spec > 0`` goes only to
  draft-capable replicas, ``adapter=`` only to pool-capable members
  (those holding the tenant first; otherwise the registered blob is sent
  down the member's ordered inbox lane ahead of the dispatch), and a
  prompt family follows the replica that served it last (prefix
  affinity);
* **prefill dispatch** — with prefill workers, a request goes first to
  the least busy worker (``serve_prefill_dispatch``), which prefills the
  prompt and hands its k/v straight to the chosen replica
  (``serve_kv_handoff``).  No workers = direct submission;
* **fault tolerance** — liveness is beat-based (``lost_after_s`` without
  a beat, or the member's handle reports it dead).  A dead decode
  replica fails over: its in-flight requests go to survivors, which
  recompute them with the router-stamped ``sample_seed``, so the
  re-emitted stream is the same at any temperature and the client
  dedups it by token index.  A dead prefill worker is respawned under
  the sliding-window :class:`RestartGovernor` and its prompts
  re-dispatched.  A planned drain (a ``closing`` beat, after the
  replica's live migration frames on the same lane) re-places only what
  was not migrated.  Every death sweeps stale ``rlt-kv`` segments.

Sends are asynchronous: each destination (member inbox or client reply
queue) gets a :class:`~.handoff.MemberOutbox`, so the control plane never
blocks on a wedged host; a failed or full outbox takes the same death
path a failed send would.  :meth:`snapshot` is the JAX package's
``validate_router_snapshot`` shape, exported as ``router-live.json`` and
as the per-replica ``rlt_serve_*`` OpenMetrics family.  With
``trace_dir`` the router records the ``placement``, ``failover``,
``migration`` and root ``request`` spans (the trace id is the rid).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ray_lightning_tpu_torch.serve.dist.handoff import (
    MemberOutbox, make_cancel_item, make_dispatch_item, request_fields,
)
from ray_lightning_tpu_torch.telemetry.propagate import (
    child_context, root_context, trace_args,
)

__all__ = ["Router", "RestartGovernor"]

log = logging.getLogger(__name__)


class RestartGovernor:
    """Sliding-window restart budget (the strategy layer's restart
    governance, serve-shaped): at most ``max_restarts`` permits per
    trailing ``window_s``.  A worker that dies once a day respawns
    forever; a crash-looping one exhausts the window and stays down —
    loudly, via the router's ``prefill_respawns_denied`` counter."""

    def __init__(self, max_restarts: int = 3, window_s: float = 3600.0):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0: {max_restarts}")
        self.max_restarts = max_restarts
        self.window_s = window_s
        self._attempts: List[float] = []

    def permit(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        self._attempts = [t for t in self._attempts
                          if now - t < self.window_s]
        if len(self._attempts) >= self.max_restarts:
            return False
        self._attempts.append(now)
        return True


class _Member:
    """Router-side record of one fleet member (decode replica or
    prefill worker)."""

    def __init__(self, handle, role: str):
        self.handle = handle
        self.role = role
        self.id: str = handle.id
        self.inbox: Optional[Tuple[str, int]] = None
        self.caps: Dict[str, Any] = {}
        self.registered_t = time.monotonic()
        self.last_beat: Optional[float] = None
        self.snapshot: Dict[str, Any] = {}
        self.recompiles: Optional[int] = None
        # LoRA tenants this member holds: beat-advertised truth,
        # optimistically extended when the router sends a load frame
        # (the next beat confirms or corrects it).
        self.adapters: Set[str] = set()
        self.alive = True
        # Live-migration claim: a draining replica's ``migrating`` beat
        # names the rid set whose KV export is in flight.  Until the
        # claim expires (or every claimed rid's migration frame lands),
        # beat-loss failover is SUPPRESSED for this member — the
        # device->host gather of a full KV cache can exceed
        # ``lost_after_s``, and declaring the exporter dead mid-export
        # would race a recompute failover against the incoming
        # migration frames for the same rids.
        self.migrating_until: float = 0.0
        self.migrating_rids: Set[str] = set()

    def beat_age_s(self, now: float) -> float:
        return now - (self.last_beat
                      if self.last_beat is not None else self.registered_t)


class _Track:
    """One routed request until a terminal status comes back."""

    __slots__ = ("req", "replica", "worker", "resubmits", "t0",
                 "t_wall", "trace", "hedge_replica")

    def __init__(self, req: Dict[str, Any], t0: float):
        self.req = req
        self.replica: Optional[str] = None
        self.worker: Optional[str] = None
        self.resubmits = 0
        self.t0 = t0
        self.t_wall = time.time()
        self.trace = None  # the request's root TraceContext (tracing on)
        # Second placement of the SAME rid/seed on a different replica
        # (client-triggered hedge against a tail-latency straggler).
        # First terminal report wins; the other placement gets a
        # serve_cancel.  Also the hot spare: if the primary dies, the
        # hedge placement is promoted instead of a recompute failover.
        self.hedge_replica: Optional[str] = None


class Router:
    """The disaggregated fleet's front door (see module docstring)."""

    def __init__(
        self,
        *,
        lost_after_s: float = 2.0,
        hello_grace_s: float = 120.0,
        governor: Optional[RestartGovernor] = None,
        prefill_factory: Optional[Callable[[], Any]] = None,
        telemetry_dir: Optional[str] = None,
        trace_dir: Optional[str] = None,
        prom_file: Optional[str] = None,
        prom_port: Optional[int] = None,
        export_every_s: float = 1.0,
        poll_interval_s: float = 0.02,
        headroom_routing: Optional[bool] = None,
        migration_claim_s: float = 30.0,
        brownout=None,
    ):
        from ray_lightning_tpu_torch.cluster.queue import DriverQueue

        # Heartbeat-lost threshold: a replica whose beats stop for this
        # long is declared dead and failed over.  The hello grace covers
        # member startup (actor spawn + model build) before first beat.
        self.lost_after_s = lost_after_s
        self.hello_grace_s = hello_grace_s
        self.governor = governor or RestartGovernor()
        self._prefill_factory = prefill_factory
        self._beats = DriverQueue()
        self._requests = DriverQueue()
        # Fleet/request state shared between the poll thread,
        # submitters, and outbox error callbacks.
        self._replicas: Dict[str, _Member] = {}  # guarded by self._lock
        self._workers: Dict[str, _Member] = {}   # guarded by self._lock
        self._inflight: Dict[str, _Track] = {}   # guarded by self._lock
        # Failover re-submissions that found every candidate saturated:
        # retried each poll — a failed-over request is never dropped.
        self._retry: deque = deque()             # guarded by self._lock
        self.counters: Dict[str, int] = {
            "routed": 0, "completed": 0, "rejected": 0, "expired": 0,
            "invalid": 0, "failovers": 0, "failed_over_requests": 0,
            "prefill_dispatches": 0, "direct_submits": 0,
            "replica_deaths": 0, "worker_deaths": 0,
            "replica_drains": 0, "worker_drains": 0,
            "prefill_respawns": 0, "prefill_respawns_denied": 0,
            "adapter_loads_sent": 0, "prefix_affinity_hits": 0,
            "migrations": 0, "migration_reroutes": 0,
            "hedges": 0, "hedge_cancels": 0,
            "shed": 0, "cancelled": 0,
        }
        # Prefix-affinity map: (adapter, leading-token) key -> the
        # replica that last served a prompt with that prefix, so
        # shared-prefix traffic lands where the resident chain lives
        # (the replica-side PrefixIndex turns the affinity into claimed
        # blocks).  Bounded LRU — placement metadata, never
        # correctness: a stale or evicted entry just means one cold
        # prefill.  guarded by self._lock
        self._prefix_sticky: "OrderedDict[Any, str]" = OrderedDict()
        # Multi-tenant LoRA registry: name -> {"rank", "data"} (the
        # encode_adapter blob, encoded ONCE at registration) — the
        # source the router hot-loads members from on demand.
        self._adapters: Dict[str, Dict[str, Any]] = {}  # guarded by self._lock
        # Staleness of the last dead replica's final beat at detection —
        # the failover-latency component the router can observe.
        self.last_failover_detect_s: Optional[float] = None
        self._seed_counter = 0
        # One MemberOutbox per destination address (member inboxes AND
        # client reply queues): all wire writes leave the lock.  Idle
        # lanes are reaped (clients come and go; re-creation on the
        # next send is one TCP connect) and _closing gates creation
        # during stop().
        # guarded by self._lock
        self._outboxes: Dict[Tuple[str, int], MemberOutbox] = {}
        self._outbox_idle_s = 120.0
        self._closing = False                    # guarded by self._lock
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._poll_interval_s = poll_interval_s
        self._export_every_s = export_every_s
        self._last_export = 0.0
        self._live_path = None
        self._trace_path = None
        self._exporter = None
        if telemetry_dir:
            import os

            os.makedirs(telemetry_dir, exist_ok=True)
            self._live_path = f"{telemetry_dir}/router-live.json"
        if trace_dir:
            import os

            os.makedirs(trace_dir, exist_ok=True)
            self._trace_path = f"{trace_dir}/trace-router.jsonl"
        from ray_lightning_tpu_torch.telemetry.spans import SpanTracer

        # Wall-clock spans (time.time starts), stitched with the members'
        # exports by epoch.  Off without trace_dir, and then no frame
        # carries a trace context.
        self.tracer = SpanTracer(
            enabled=self._trace_path is not None, maxlen=16384, rank=0,
        )
        if prom_file or prom_port is not None:
            from ray_lightning_tpu_torch.telemetry.export_prom import (
                PromExporter,
            )

            self._exporter = PromExporter(textfile=prom_file,
                                          port=prom_port)
        # Headroom-aware placement tie-break (capacity plane): between
        # equally-assigned candidates, prefer the replica whose
        # headroom oracle reports the most tokens/s slack — measured
        # throughput beats the raw free-block proxy once beats carry
        # capacity blocks.  OFF by default; the flag (or
        # RLT_HEADROOM_ROUTING=1) only REORDERS ties, it never admits
        # or rejects, so routing stays correct if beats lack the block.
        if headroom_routing is None:
            import os

            headroom_routing = \
                os.environ.get("RLT_HEADROOM_ROUTING", "0") == "1"
        self._headroom_routing = bool(headroom_routing)
        # How long a ``migrating`` beat claim suppresses beat-loss
        # failover for the draining replica (the export of a full KV
        # residency can take many seconds; an expired claim falls back
        # to recompute failover for whatever never arrived).
        self.migration_claim_s = migration_claim_s
        # Overload brownout ladder (capacity plane -> admission):
        # OFF unless passed explicitly or RLT_BROWNOUT=1.  When on,
        # fleet utilization from beat capacity blocks drives staged
        # degradation in submit_request — spec off, max_new capped,
        # then priority-class shedding with a half-open recovery probe.
        if brownout is None:
            import os

            if os.environ.get("RLT_BROWNOUT", "0") == "1":
                from ray_lightning_tpu_torch.serve.brownout import (
                    BrownoutLadder,
                )

                brownout = BrownoutLadder()
        self.brownout = brownout
        self._brownout_last_level = 0
        # Fleet trend store, created on the first beat carrying a
        # capacity block: per-replica tokens_out counters and headroom
        # gauges.  None until a capacity-plane member reports.
        self.timeseries = None                   # guarded by self._lock

    # -- fleet membership ----------------------------------------------------
    @property
    def beat_handle(self):
        """Picklable handle members publish hellos/beats to."""
        return self._beats.handle

    def queue_handle(self):
        """Picklable submission handle for :class:`ServeClient` — the
        router speaks the engine's wire dialect."""
        return self._requests.handle

    def add_replica(self, handle) -> None:
        with self._lock:
            self._replicas[handle.id] = _Member(handle, "decode")

    def add_prefill(self, handle) -> None:
        with self._lock:
            self._workers[handle.id] = _Member(handle, "prefill")

    def register_adapter(self, name: str, adapter: Dict[str, Any]) -> None:
        """Register one tenant's LoRA adapter with the fleet: the
        factors are encoded ONCE (``serve/lora.py::encode_adapter``)
        and kept host-side; members are hot-loaded lazily, at the
        moment a request for the tenant is placed on one that does not
        yet hold it.  Registration is cheap and does not touch any
        member — a registered-but-idle tenant costs the fleet nothing
        until its first request.

        Re-registering an existing name updates the ROUTER's blob only:
        members already advertising the tenant keep their loaded
        factors (the engines refuse live replacement anyway — see
        ``ServeEngine.add_adapter``).  To roll a tenant's factors,
        drain the tenant, remove it on the members, then register the
        new version."""
        from ray_lightning_tpu_torch.serve.lora import encode_adapter

        name = str(name)
        rank = int(adapter["qkv_a"].shape[-1])
        data = encode_adapter(adapter)
        with self._lock:
            self._adapters[name] = {"rank": rank, "data": data}

    def wait_ready(self, timeout: float = 120.0) -> None:
        """Block until every registered member has hello'd its inbox."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.poll()
            with self._lock:
                members = (list(self._replicas.values())
                           + list(self._workers.values()))
                if members and all(m.inbox is not None for m in members
                                   if m.alive):
                    return
            time.sleep(0.02)
        raise TimeoutError(
            "serve fleet members did not register within "
            f"{timeout}s (actor startup wedged?)"
        )

    # -- the poll loop -------------------------------------------------------
    def poll(self, now: Optional[float] = None) -> None:
        """One control-plane iteration: drain member beats, drain
        client submissions, detect deaths (failover/respawn), retry
        deferred failovers, refresh exports."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._drain_beats(now)
            self._update_brownout(now)
            self._drain_requests(now)
            self._check_liveness(now)
            self._drain_retry(now)
            self._maybe_export()
        self._reap_idle_outboxes(now)

    def start(self) -> "Router":
        if self._thread is not None:
            raise RuntimeError("router already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="rlt-serve-router", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll()
            except Exception:  # noqa: BLE001 - the control plane must
                # survive a bad frame; the failure mode to avoid is a
                # silently dead router stranding every client
                log.warning("router poll raised", exc_info=True)
            time.sleep(self._poll_interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._beats.shutdown()
        self._requests.shutdown()
        # Flag-then-snapshot under the lock: a concurrent outbox-error
        # death path re-routing through _put must not register a fresh
        # outbox AFTER the clear (its thread would leak).
        with self._lock:
            self._closing = True
            boxes = list(self._outboxes.values())
            self._outboxes.clear()
        for box in boxes:
            box.close()
        if self._exporter is not None:
            self._exporter.close()
        if self._trace_path is not None and self.tracer.events():
            try:
                self.tracer.export_jsonl(self._trace_path)
            except OSError:
                pass  # a full disk must not fail the teardown
        self._sweep_segments()

    # -- beats ---------------------------------------------------------------
    def _member(self, role: str,
                member_id: str) -> Optional[_Member]:  # under self._lock
        pool = self._replicas if role == "decode" else self._workers
        return pool.get(member_id)

    def _drain_beats(self, now: float) -> None:  # under self._lock
        import queue as _pyqueue

        while True:
            try:
                item = self._beats.get_nowait()
            except _pyqueue.Empty:
                return
            if not isinstance(item, dict):
                continue
            kind = item.get("type")
            if kind == "serve_replica_hello":
                m = self._member(str(item.get("role")), str(item.get("id")))
                if m is not None:
                    m.inbox = (item["inbox"][0], int(item["inbox"][1]))
                    m.caps = {k: v for k, v in item.items()
                              if k not in ("type", "role", "id", "inbox")}
                    m.last_beat = now
            elif kind == "serve_replica_beat":
                self._ingest_beat(item, now)
            elif kind == "serve_migration":
                # Live-KV migration frames ride the ordered beat lane
                # (FIFO per connection: claim beat -> migration frames
                # -> closing beat), so every migrated rid is retargeted
                # BEFORE the closing beat re-places the leftovers.
                self._on_migration(item, now)

    def _ingest_beat(self, item: Dict[str, Any],
                     now: float) -> None:  # under self._lock
        m = self._member(str(item.get("role")), str(item.get("id")))
        if m is None:
            return
        m.last_beat = now
        if "snapshot" in item:
            m.snapshot = item["snapshot"]
            cap = m.snapshot.get("capacity") \
                if isinstance(m.snapshot, dict) else None
            if isinstance(cap, dict):
                if self.timeseries is None:
                    from ray_lightning_tpu_torch.telemetry.timeseries import (
                        TimeSeriesStore,
                    )

                    self.timeseries = TimeSeriesStore(
                        interval_s=1.0, capacity=600,
                    )
                counters = m.snapshot.get("counters", {})
                self.timeseries.observe(
                    f"{m.id}.tokens_out",
                    counters.get("tokens_out", 0), kind="counter",
                )
                head = cap.get("headroom_tokens_per_s")
                if isinstance(head, (int, float)):
                    self.timeseries.observe(
                        f"{m.id}.headroom_tokens_per_s", head,
                        kind="gauge",
                    )
        if "recompiles" in item:
            m.recompiles = int(item["recompiles"])
        if "adapters" in item:
            # Beat-advertised truth replaces the optimistic set — a
            # member that dropped a load frame (restart, full pool)
            # stops being preferred for that tenant within one beat.
            m.adapters = {str(a) for a in item["adapters"]}
        if "migrating" in item:
            # A drain's export claim: suppress beat-loss failover for
            # this member while the gather runs (see _is_lost) and
            # remember which rids are promised — each arriving
            # migration frame checks one off.
            m.migrating_rids = {str(r) for r in item["migrating"]}
            m.migrating_until = now + self.migration_claim_s
        for rid, status in item.get("done", []):
            if m.role == "decode":
                self._complete(str(rid), str(status), source=m.id)
            else:
                track = self._inflight.get(str(rid))
                if track is not None and track.worker == m.id:
                    track.worker = None  # handoff landed; replica owns it
        for rid, err in item.get("failed", []):
            track = self._inflight.get(str(rid))
            # Ownership guard (mirrors the done-loop above): a stale
            # failure report from a member this rid was already routed
            # AWAY from must not yank the request off its healthy new
            # placement.  Prefill workers report undeliverable
            # handoffs; decode replicas report handoffs they could not
            # ADMIT (torn frame, injected read fault) — both re-route
            # away from the replica that was supposed to decode.
            if track is None:
                continue
            if track.worker == m.id or (m.role == "decode"
                                        and track.replica == m.id):
                self._on_handoff_failure(str(rid), str(err), now)
        if item.get("closing") and m.alive:
            self._on_member_closing(m, now)

    def _complete(self, rid: str, status: str,
                  source: Optional[str] = None) -> None:  # under self._lock
        track = self._inflight.pop(rid, None)
        if track is None:
            return
        key = status if status in ("rejected", "expired", "invalid",
                                   "cancelled") \
            else "completed"
        self.counters[key] += 1
        if track.hedge_replica is not None and status != "cancelled":
            # First terminal report wins the hedged pair; the OTHER
            # placement gets a serve_cancel so it stops burning slots
            # (its own later "cancelled" done lands after the pop and
            # is a no-op).  The client deduplicates both token streams
            # by index — same rid, same fleet seed, identical tokens.
            loser_id = track.replica if source == track.hedge_replica \
                else track.hedge_replica
            loser = self._replicas.get(loser_id) \
                if loser_id is not None else None
            if loser is not None and loser.alive \
                    and loser.inbox is not None:
                try:
                    self._put(loser.inbox, make_cancel_item(rid))
                    self.counters["hedge_cancels"] += 1
                except (OSError, ConnectionError):
                    pass  # loser is dying; its death path cleans up
        if track.trace is not None:
            # The root span anchors the whole trace: every downstream
            # span's parent chain terminates at <rid>.root.
            self.tracer.record(
                "request", track.t_wall,
                max(0.0, time.time() - track.t_wall),
                args=trace_args(track.trace, rid=rid, status=status,
                                resubmits=track.resubmits),
            )

    def _on_member_closing(self, m: _Member,
                           now: float) -> None:  # under self._lock
        """Planned member drain (the ``closing`` flag on a final beat —
        an operator scale-down, NOT a crash): stop routing to it and
        re-place its remaining work, without burning failure counters,
        respawn budget, or a spurious ``failovers`` increment in the
        telemetry surface.  The member's own teardown (engine stop +
        segment sweep) is the operator's — no reap here."""
        m.alive = False
        # Rids the drain's live migration already retargeted have
        # track.replica pointing at their survivor (migration frames
        # ride the same ordered lane, AHEAD of this closing beat) — the
        # selector below naturally skips them.  What's left is the
        # un-migratable tail: queued or mid-chunked-prefill requests,
        # and exports the fault plane blackholed.
        remaining = [rid for rid, t in self._inflight.items()
                     if (t.replica if m.role == "decode" else t.worker)
                     == m.id]
        log.info("serve %s %s draining (planned) — re-placing %d "
                 "request(s)", m.role, m.id, len(remaining))
        self.counters["replica_drains" if m.role == "decode"
                      else "worker_drains"] += 1
        for rid in remaining:
            track = self._inflight[rid]
            track.worker = None
            if m.role == "decode":
                track.replica = None
                if track.hedge_replica is not None \
                        and track.hedge_replica != m.id:
                    # The hedge placement is already decoding this rid
                    # elsewhere — promote it, skip the recompute.
                    track.replica, track.hedge_replica = \
                        track.hedge_replica, None
                    continue
                track.hedge_replica = None
            track.resubmits += 1
            self._route(rid, track, now,
                        exclude={m.id} if m.role == "decode"
                        else frozenset(),
                        must_place=True)
        if m.role == "decode":
            for t in self._inflight.values():
                if t.hedge_replica == m.id:
                    t.hedge_replica = None  # primary still live
        self._sweep_segments()

    def _on_handoff_failure(self, rid: str, err: str,
                            now: float) -> None:  # under self._lock
        """A prefill worker could not deliver to the chosen replica —
        trust the signal and re-route AWAY from it (if that replica is
        healthy, losing one placement is cheap; if it is dying, beats
        will confirm shortly)."""
        track = self._inflight.get(rid)
        if track is None:
            return
        exclude = {track.replica} if track.replica else set()
        track.worker = None
        track.replica = None
        track.resubmits += 1
        self._route(rid, track, now, exclude=exclude, must_place=True)

    # -- live-KV migration ---------------------------------------------------
    def _on_migration(self, item: Dict[str, Any],
                      now: float) -> None:  # under self._lock
        """One ``serve_migration`` frame from a draining replica: pick
        a survivor, forward the frame (KV blocks + scheduler position +
        the original request fields ride inside), retarget the track.
        The survivor resumes decode mid-sequence — zero recomputed
        prefill, and the fleet-wide seed + position-keyed sampler keep
        the continued stream bitwise-identical at any temperature.  No
        viable survivor (or a failed adapter ensure) falls back to the
        recompute-failover path the crash plane already exercises."""
        rid = str(item.get("rid"))
        track = self._inflight.get(rid)
        source = track.replica if track is not None else None
        # Check the rid off its source's claim set either way — a frame
        # that landed is a promise kept, even if the track is gone.
        for m in self._replicas.values():
            m.migrating_rids.discard(rid)
            if not m.migrating_rids and m.migrating_until:
                # Every promised frame arrived: release the failover
                # suppression early instead of waiting out the claim.
                m.migrating_until = 0.0
        if track is None:
            log.debug("migration frame for unknown rid %s dropped", rid)
            return
        req = item.get("req") or {}
        adapter = req.get("adapter")
        survivors = [
            m for m in self._replicas.values()
            if m.alive and m.inbox is not None and m.id != source
            and self._assigned(m.id) < (m.caps.get("num_slots", 1)
                                        + m.caps.get("max_queue", 0))
        ]
        if adapter is not None:
            survivors = [
                m for m in survivors
                if m.caps.get("max_adapters", 0) > 0
                and (adapter in m.adapters or adapter in self._adapters)
            ]
        target = min(
            survivors,
            key=lambda m: (self._assigned(m.id),
                           -self._blocks_free(m), m.id),
        ) if survivors else None
        if target is not None and adapter is not None:
            try:
                self._ensure_adapter(target, adapter)
            except (OSError, ConnectionError):
                self._on_replica_death(target, now)
                target = None
        if target is not None:
            try:
                self._put(target.inbox, item)
            except (OSError, ConnectionError):
                self._on_replica_death(target, now)
                target = None
        if target is None:
            # Recompute fallback: re-route through the normal failover
            # path (prefill replays from token 0 on a survivor; the
            # client dedups the re-emitted indices).
            self.counters["migration_reroutes"] += 1
            track.worker = None
            track.replica = None
            track.resubmits += 1
            self._route(rid, track, now,
                        exclude={source} if source else frozenset(),
                        must_place=True)
            return
        track.replica = target.id
        track.worker = None
        self.counters["migrations"] += 1
        if track.trace is not None:
            self.tracer.record(
                "migration", time.time(), 0.0,
                args=trace_args(
                    child_context(track.trace), rid=rid,
                    from_replica=source, to_replica=target.id,
                ),
            )

    # -- client submissions --------------------------------------------------
    def _drain_requests(self, now: float) -> None:  # under self._lock
        import queue as _pyqueue

        while True:
            try:
                item = self._requests.get_nowait()
            except _pyqueue.Empty:
                return
            try:
                self.submit_request(item, now=now)
            except Exception as e:  # noqa: BLE001 - a bad request must
                # never take the router down; when the reply address is
                # recoverable the client gets the engine's typed
                # "invalid" reply instead of blocking to its timeout
                log.warning("router: malformed request: %s", e)
                try:
                    rid = str(item.get("rid"))
                    reply = tuple(item["reply"])
                except Exception:  # noqa: BLE001 - nothing to tell
                    continue
                self.counters["invalid"] += 1
                self._reply(reply, {
                    "type": "serve_done", "rid": rid,
                    "status": "invalid", "error": str(e), "tokens": [],
                })

    def submit_request(self, item: Dict[str, Any],
                       now: Optional[float] = None) -> str:
        """Admit one ``serve_request`` wire item: stamp the fleet-wide
        sampling seed, validate against the fleet geometry, place it.
        Returns the rid; rejection/invalid outcomes reply to the
        client's queue exactly as a single engine would."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if not isinstance(item, dict) \
                    or item.get("type") != "serve_request":
                raise ValueError("not a serve_request item")
            rid = str(item["rid"])
            reply = tuple(item["reply"])
            existing = self._inflight.get(rid)
            if existing is not None:
                # Re-submission of a rid the fleet already tracks: a
                # hedge marker places a DUPLICATE on another replica
                # (same seed — the client dedups both streams by token
                # index); anything else is a client retry racing its
                # own in-flight request and is dropped silently.
                if item.get("hedge"):
                    self._hedge(rid, existing, now)
                return rid
            seed = item.get("sample_seed")
            if seed is None:
                # The fleet-wide sampling-stream identity: stamped HERE
                # (not per engine) so a failover re-submission to any
                # replica replays the identical token stream.
                seed = self._seed_counter
                self._seed_counter += 1
            # Trace identity: the rid IS the trace_id, stamped once
            # here — every hop (prefill, handoff, decode, failover
            # re-submission, preemption replay) shares it.
            ctx = root_context(rid) if self.tracer.enabled else None
            req = request_fields(
                rid, item["prompt"], int(item["max_new_tokens"]),
                reply=reply, sample_seed=seed,
                temperature=float(item.get("temperature", 0.0)),
                eos_token_id=item.get("eos_token_id"),
                top_k=item.get("top_k"),
                spec=item.get("spec"),
                adapter=item.get("adapter"),
                deadline_s=item.get("deadline_s"),
                priority=int(item.get("priority") or 0),
                trace=ctx,
            )
            problem = self._validate(req)
            if problem is not None:
                self.counters["invalid"] += 1
                self._reply(reply, {
                    "type": "serve_done", "rid": rid, "status": "invalid",
                    "error": problem, "tokens": [],
                })
                return rid
            if self.brownout is not None and self.brownout.level > 0:
                # Staged overload degradation (ladder levels, each
                # subsuming the previous): 1 = drop speculative draft
                # lanes (spec FLOPs are the cheapest capacity to
                # reclaim), 2 = cap response length, 3 = shed
                # best-effort traffic (priority < 1) with a typed
                # retryable reply — except the half-open probe the
                # ladder lets through to sense recovery.
                lvl = self.brownout.level
                if req.get("spec"):
                    req["spec"] = 0
                if lvl >= 2:
                    cap = int(self.brownout.max_new_cap)
                    if req["max_new_tokens"] > cap:
                        req["max_new_tokens"] = cap
                if lvl >= 3 and int(req.get("priority") or 0) < 1 \
                        and not self.brownout.allow_probe(now):
                    self.counters["shed"] += 1
                    self._reply(reply, {
                        "type": "serve_done", "rid": rid,
                        "status": "shed", "reason": "brownout",
                        "tokens": [],
                    })
                    return rid
            track = _Track(req, now)
            track.trace = ctx
            self._inflight[rid] = track
            self.counters["routed"] += 1
            self._route(rid, track, now)
            return rid

    def _validate(self,
                  req: Dict[str, Any]) -> Optional[str]:  # under self._lock
        """Cheap fleet-geometry validation so prefill workers never see
        a prompt they cannot bucket (the engines re-validate anyway)."""
        if not req["prompt"]:
            return "prompt must contain at least one token"
        if req["max_new_tokens"] < 1:
            return "max_new_tokens must be >= 1"
        # Live replicas only: a dead member's (possibly smaller) limits
        # must not keep rejecting prompts the surviving fleet serves.
        caps = [m.caps for m in self._replicas.values()
                if m.caps and m.alive]
        if caps:
            max_prompt = min(c.get("max_prompt_len", 1 << 30)
                             for c in caps)
            max_len = min(c.get("max_model_len", 1 << 30) for c in caps)
            if len(req["prompt"]) > max_prompt:
                return (f"prompt ({len(req['prompt'])}) exceeds the "
                        f"fleet's largest prefill bucket ({max_prompt})")
            if len(req["prompt"]) + req["max_new_tokens"] > max_len:
                return (f"prompt + max_new_tokens exceeds the fleet's "
                        f"max_model_len ({max_len})")
        adapter = req.get("adapter")
        if adapter is not None and adapter not in self._adapters \
                and not any(adapter in m.adapters
                            for m in self._replicas.values() if m.alive):
            # Typed, synchronous: an unknown tenant must never fall
            # back silently to the base model on some replica.
            return (f"unknown adapter {adapter!r} — register it with "
                    f"Router.register_adapter (or hot-load a replica) "
                    f"first")
        return None

    def _hedge(self, rid: str, track: _Track,
               now: float) -> None:  # under self._lock
        """Place a DUPLICATE of an in-flight request on a second
        replica (client-triggered tail-latency hedge).  Same rid, same
        fleet-wide seed: both replicas emit the identical stream, the
        client dedups by token index, the first terminal report wins
        and the loser is cancelled (see _complete).  Hedging is
        best-effort — no spare capacity, an unplaced primary, or an
        existing hedge all make this a silent no-op (the primary
        placement is untouched either way)."""
        if track.hedge_replica is not None or track.replica is None:
            return
        req = track.req
        candidates = [
            m for m in self._replicas.values()
            if m.alive and m.inbox is not None and m.id != track.replica
            and self._assigned(m.id) < (m.caps.get("num_slots", 1)
                                        + m.caps.get("max_queue", 0))
        ]
        if req.get("spec"):
            candidates = [m for m in candidates
                          if m.caps.get("spec_k", 0) > 0]
        adapter = req.get("adapter")
        if adapter is not None:
            candidates = [
                m for m in candidates
                if m.caps.get("max_adapters", 0) > 0
                and (adapter in m.adapters or adapter in self._adapters)
            ]
        if not candidates:
            return
        target = min(
            candidates,
            key=lambda m: (self._assigned(m.id),
                           -self._blocks_free(m), m.id),
        )
        try:
            if adapter is not None:
                self._ensure_adapter(target, adapter)
            # Direct submission only: a hedge exists to beat a
            # straggler, re-running disaggregated prefill for it would
            # put the duplicate behind the same worker queue that may
            # be the straggle's cause.
            self._put(target.inbox, dict(req))
        except (OSError, ConnectionError):
            self._on_replica_death(target, now)
            return
        track.hedge_replica = target.id
        self.counters["hedges"] += 1

    def _update_brownout(self, now: float) -> None:  # under self._lock
        """Feed the brownout ladder the fleet's beat-aggregated
        utilization (no capacity blocks -> no signal -> ladder stays
        where it is; it only moves on evidence)."""
        if self.brownout is None:
            return
        blocks = [
            m.snapshot.get("capacity") for m in self._replicas.values()
            if m.alive and isinstance(m.snapshot, dict)
            and isinstance(m.snapshot.get("capacity"), dict)
        ]
        if not blocks:
            return
        from ray_lightning_tpu_torch.serve.capacity import aggregate_fleet

        fleet = aggregate_fleet(blocks)
        util = fleet.get("utilization") if fleet else None
        if not isinstance(util, (int, float)):
            return
        level = self.brownout.observe(float(util), now)
        if level != self._brownout_last_level:
            log.warning(
                "serve brownout level %d -> %d (fleet utilization "
                "%.2f)", self._brownout_last_level, level, util,
            )
            self._brownout_last_level = level

    # -- placement -----------------------------------------------------------
    def _assigned(self, replica_id: str) -> int:  # under self._lock
        # Hedge placements occupy a slot on their replica exactly like
        # primaries — capacity accounting must see both.
        return sum(1 for t in self._inflight.values()
                   if replica_id in (t.replica, t.hedge_replica))

    def _pending(self, worker_id: str) -> int:  # under self._lock
        return sum(1 for t in self._inflight.values()
                   if t.worker == worker_id)

    def _blocks_free(self, m: _Member) -> float:
        gauges = m.snapshot.get("gauges", {}) if m.snapshot else {}
        return float(gauges.get("blocks_free", 0.0))

    def _headroom(self, m: _Member) -> float:
        """Oracle-reported tokens/s slack from the member's last beat
        (0.0 when the member runs without the capacity plane)."""
        cap = m.snapshot.get("capacity") if m.snapshot else None
        if isinstance(cap, dict):
            head = cap.get("headroom_tokens_per_s")
            if isinstance(head, (int, float)):
                return float(head)
        return 0.0

    # Leading tokens hashed into the affinity key: enough to
    # distinguish system-prompt/template families, cheap enough to
    # compute per route.
    _PREFIX_KEY_TOKENS = 64
    _PREFIX_STICKY_CAP = 4096

    # under self._lock
    def _prefix_key(self, req: Dict[str, Any]) -> Optional[Any]:
        prompt = req.get("prompt")
        if not isinstance(prompt, list) or not prompt:
            return None
        return (req.get("adapter"),
                hash(tuple(prompt[: self._PREFIX_KEY_TOKENS])))

    # under self._lock
    def _note_prefix_sticky(self, key: Any, replica_id: str) -> None:
        self._prefix_sticky[key] = replica_id
        self._prefix_sticky.move_to_end(key)
        while len(self._prefix_sticky) > self._PREFIX_STICKY_CAP:
            self._prefix_sticky.popitem(last=False)

    # under self._lock
    def _route(self, rid: str, track: _Track, now: float,
               exclude: Set[str] = frozenset(),
               must_place: bool = False) -> None:
        """Pick a replica (and a prefill worker when any are live) for
        ``rid``.  ``must_place`` marks failover/re-route submissions:
        instead of a typed rejection they park on the retry queue until
        capacity frees up — a request the fleet already accepted is
        never lost to a transient squeeze."""
        req = track.req
        if track.resubmits > 16:
            # Re-route budget: a legitimate failover chain burns one
            # resubmit per member death — far below this bound.  What
            # does hit it is a PERSISTENT per-request failure loop
            # (e.g. a member whose adapter pool is full raises on every
            # hot-load, the dispatch fails, the failed feed re-routes,
            # the next beat erases the optimistic adapters entry,
            # repeat) — without the bound that loop re-ships the blob
            # forever while the client blocks to its timeout.
            self._finish_unroutable(
                rid, track, "error",
                f"re-route budget exhausted after {track.resubmits} "
                f"attempts (persistent placement failure — check "
                f"member capacity, e.g. ServeConfig.max_adapters vs "
                f"registered tenants)",
            )
            return
        live = [m for m in self._replicas.values()
                if m.alive and m.inbox is not None and m.id not in exclude]
        spec = req.get("spec")
        if spec is not None and spec > 0:
            capable = [m for m in live if m.caps.get("spec_k", 0) > 0]
            if not capable:
                # A draft-less engine would fail the request as
                # "invalid" — never send a spec request there.  No
                # capable replica in the FLEET: terminal invalid.
                # Capable but not currently routable (excluded after a
                # transient handoff failure, or not hello'd yet): an
                # already-accepted request parks until it is, a fresh
                # one gets the typed retryable rejection.
                if any(m.caps.get("spec_k", 0) > 0
                       for m in self._replicas.values() if m.alive):
                    if must_place:
                        self._park(rid)
                    else:
                        self._finish_unroutable(
                            rid, track, "rejected",
                            "draft-capable replica temporarily "
                            "unavailable",
                        )
                else:
                    self._finish_unroutable(
                        rid, track, "invalid",
                        "spec > 0 but no draft-capable replica in "
                        "the fleet",
                    )
                return
            live = capable
        adapter = req.get("adapter")
        if adapter is not None:
            # Pool-capable replicas only; a pool-less engine would fail
            # the request as "invalid" (its submit raises on adapter=).
            # When the router holds the registered blob any capable
            # replica is loadable on demand; otherwise only members
            # already advertising the tenant can serve it.
            capable = [m for m in live if m.caps.get("max_adapters", 0) > 0]
            if adapter not in self._adapters:
                capable = [m for m in capable if adapter in m.adapters]
            if not capable:
                fleet_capable = any(
                    m.caps.get("max_adapters", 0) > 0
                    for m in self._replicas.values() if m.alive
                )
                if fleet_capable and adapter in self._adapters:
                    if must_place:
                        self._park(rid)
                    else:
                        self._finish_unroutable(
                            rid, track, "rejected",
                            "adapter-capable replica temporarily "
                            "unavailable",
                        )
                else:
                    self._finish_unroutable(
                        rid, track, "invalid",
                        f"adapter {adapter!r}: no adapter-capable "
                        f"replica holds it and no registered blob to "
                        f"hot-load from",
                    )
                return
            live = capable
        if not live:
            if must_place and any(m.alive for m in self._replicas.values()):
                self._park(rid)
                return
            self._finish_unroutable(
                rid, track,
                "error" if must_place else "rejected",
                "no live decode replica",
            )
            return
        candidates = [
            m for m in live
            if self._assigned(m.id) < (m.caps.get("num_slots", 1)
                                       + m.caps.get("max_queue", 0))
        ]
        if not candidates:
            if must_place:
                self._park(rid)
                return
            self.counters["rejected"] += 1
            self._inflight.pop(rid, None)
            self._reply(tuple(req["reply"]), {
                "type": "serve_done", "rid": rid, "status": "rejected",
                "reason": "rejected", "tokens": [],
            })
            return
        # Stickiness: a request already bound to a live replica (spec
        # drafts mid-re-route after a prefill hiccup) stays there — its
        # draft cache and its queue position are warm.
        target = next((m for m in candidates if m.id == track.replica),
                      None)
        pkey = self._prefix_key(req)
        if target is None:
            # Prefix affinity: prefer the replica that last served this
            # prompt family (its PrefixIndex holds the chain — the claim
            # turns the placement into skipped prefill FLOPs), behind
            # adapter residency (wrong-adapter placement costs a blob
            # ship, worse than a cold prefill) and ahead of load
            # balance (a cache hit is cheaper than an even spread).
            # Affinity never QUEUES, though: once the warm replica's
            # slots are full, waiting behind it costs more than a cold
            # prefill on an idle one — drop the pull and let the
            # least-loaded term place the request.
            sticky = self._prefix_sticky.get(pkey) \
                if pkey is not None else None
            if sticky is not None:
                sm = next((m for m in candidates if m.id == sticky),
                          None)
                if sm is None or (self._assigned(sm.id)
                                  >= sm.caps.get("num_slots", 1)):
                    sticky = None
            if self._headroom_routing:
                # Capacity-plane tie-break: oracle-measured tokens/s
                # slack ranks ahead of the free-block proxy (members
                # without a capacity block score 0 slack and fall
                # through to the proxy unchanged).
                target = min(
                    candidates,
                    key=lambda m: (adapter is not None
                                   and adapter not in m.adapters,
                                   sticky is not None
                                   and m.id != sticky,
                                   self._assigned(m.id),
                                   -self._headroom(m),
                                   -self._blocks_free(m), m.id),
                )
            else:
                target = min(
                    candidates,
                    key=lambda m: (adapter is not None
                                   and adapter not in m.adapters,
                                   sticky is not None
                                   and m.id != sticky,
                                   self._assigned(m.id),
                                   -self._blocks_free(m), m.id),
                )
            if sticky is not None and target.id == sticky:
                self.counters["prefix_affinity_hits"] += 1
        if pkey is not None:
            self._note_prefix_sticky(pkey, target.id)
        track.replica = target.id
        workers = [w for w in self._workers.values()
                   if w.alive and w.inbox is not None]
        if adapter is not None:
            # A tenant's prompt must be prefilled THROUGH its adapter —
            # a pool-less worker would hand off base-model KV, and a
            # pool-capable worker the router cannot hot-load (tenant
            # loaded member-side only, never registered here) must
            # already HOLD the factors.  No usable worker = direct
            # submission (the replica prefills through its own pool).
            workers = [w for w in workers
                       if w.caps.get("max_adapters", 0) > 0
                       and (adapter in self._adapters
                            or adapter in w.adapters)]
        if adapter is not None:
            # The decode replica needs the factors resident whichever
            # path the prompt takes (handoff admission decodes through
            # them).  A dead replica outbox here is a REPLICA incident:
            # its death path re-routes this rid (track.replica is set).
            try:
                self._ensure_adapter(target, adapter)
            except (OSError, ConnectionError):
                self._on_replica_death(target, now)
                return
        if workers:
            worker = min(workers,
                         key=lambda w: (adapter is not None
                                        and adapter not in w.adapters,
                                        self._pending(w.id), w.id))
            try:
                if adapter is not None:
                    self._ensure_adapter(worker, adapter)
                # tmpfs zero-copy only when the worker and the replica
                # advertise the same host; otherwise the payload rides
                # inline bytes over the (chunk-sending) queue.
                self._put(worker.inbox, make_dispatch_item(
                    req, target.inbox,
                    same_host=worker.inbox[0] == target.inbox[0]),
                    on_sent=self._placement_cb(track, rid, worker.id,
                                               target.id))
                track.worker = worker.id
                self.counters["prefill_dispatches"] += 1
                return
            except (OSError, ConnectionError):
                self._on_worker_death(worker, now)
                # fall through to direct submission this once
        try:
            self._put(target.inbox, req,
                      on_sent=self._placement_cb(track, rid, None,
                                                 target.id))
            self.counters["direct_submits"] += 1
        except (OSError, ConnectionError):
            self._on_replica_death(target, now)

    def _ensure_adapter(self, m: _Member,
                        name: str) -> None:  # under self._lock
        """Hot-load ``name`` onto ``m`` unless it already holds it: a
        ``serve_adapter_load`` frame down the member's ordered inbox
        lane, so the factors always land BEFORE the dispatch that
        references them.  The optimistic set-add keeps one tenant's
        burst from re-shipping the blob every placement; the member's
        next beat is the correcting truth."""
        if name in m.adapters:
            return
        from ray_lightning_tpu_torch.serve.dist.handoff import (
            make_adapter_load_item,
        )

        entry = self._adapters.get(name)
        if entry is None:
            # Beat-advertised-only tenant (loaded member-side, never
            # registered with the router) placed on a non-holder —
            # placement filters should prevent this; if one slips
            # through, the member's own typed "unknown adapter" reply
            # is the failure surface, not a router crash.
            log.warning(
                "no registered blob to hot-load adapter %r onto %s %s",
                name, m.role, m.id,
            )
            return
        self._put(m.inbox, make_adapter_load_item(
            name, entry["rank"], data=entry["data"],
        ))
        m.adapters.add(name)
        self.counters["adapter_loads_sent"] += 1

    def _placement_cb(self, track: _Track, rid: str,
                      worker_id: Optional[str], replica_id: str):
        """The ``placement`` span recorder, fired by the outbox thread
        AFTER the dispatch frame hit the wire — so the span measures
        route decision + outbox queue + connect + send, the real
        dispatch latency a client's TTFT pays."""
        if not self.tracer.enabled or track.trace is None:
            return None
        t0 = time.time()
        ctx = child_context(track.trace)
        resubmit = track.resubmits

        def on_sent(_enqueue_ts: float) -> None:
            args = trace_args(ctx, rid=rid, replica=replica_id,
                              resubmit=resubmit)
            if worker_id is not None:
                args["worker"] = worker_id
            self.tracer.record(
                "placement", t0, max(0.0, time.time() - t0), args=args
            )

        return on_sent

    def _park(self, rid: str) -> None:  # under self._lock
        if rid not in self._retry:
            self._retry.append(rid)

    # under self._lock
    def _finish_unroutable(self, rid: str, track: _Track, status: str,
                           error: str) -> None:
        self._inflight.pop(rid, None)
        self.counters["invalid" if status == "invalid" else "rejected"] \
            += 1
        done: Dict[str, Any] = {
            "type": "serve_done", "rid": rid, "status": status,
            "tokens": [],
        }
        if status == "rejected":
            done["reason"] = "rejected"
        else:
            done["error"] = error
        self._reply(tuple(track.req["reply"]), done)

    def _drain_retry(self, now: float) -> None:  # under self._lock
        pending, self._retry = list(self._retry), deque()
        for rid in pending:
            track = self._inflight.get(rid)
            if track is None:
                continue
            track.replica = None
            self._route(rid, track, now, must_place=True)

    # -- liveness / failover -------------------------------------------------
    def _check_liveness(self, now: float) -> None:  # under self._lock
        for m in list(self._replicas.values()):
            if m.alive and self._is_lost(m, now):
                self._on_replica_death(m, now)
        for w in list(self._workers.values()):
            if w.alive and self._is_lost(w, now):
                self._on_worker_death(w, now)

    def _is_lost(self, m: _Member, now: float) -> bool:
        try:
            if not m.handle.is_alive():
                return True
        except Exception:  # noqa: BLE001 - a broken handle IS dead
            return True
        if now < m.migrating_until:
            # A drain's migration-export claim is in flight: the
            # device->host KV gather can silence beats for longer than
            # lost_after_s, and declaring the exporter dead here would
            # race a recompute failover against migration frames
            # already on the wire for the SAME rids — double-placing
            # every resident request.  The claim is bounded
            # (migration_claim_s): a replica that dies mid-export just
            # fails over a little later, and loses nothing the crash
            # path wouldn't have lost anyway.
            return False
        grace = self.lost_after_s if m.last_beat is not None \
            else self.hello_grace_s
        return m.beat_age_s(now) > grace

    def _on_replica_death(self, m: _Member,
                          now: float) -> None:  # under self._lock
        """Serving-side fault tolerance: fail the dead replica's
        in-flight requests over to survivors.  Re-submission rides the
        engines' recompute-preemption path — tokens re-emit from index
        0 with the SAME router-stamped sample seed, clients dedup on
        index, so the stream is bitwise-continuous and nothing is
        lost."""
        if not m.alive:
            return
        m.alive = False
        self.counters["replica_deaths"] += 1
        self.last_failover_detect_s = m.beat_age_s(now)
        victims = [rid for rid, t in self._inflight.items()
                   if t.replica == m.id]
        log.warning(
            "serve replica %s lost (last beat %.1fs ago) — failing over "
            "%d in-flight request(s)", m.id, m.beat_age_s(now),
            len(victims),
        )
        if victims:
            self.counters["failovers"] += 1
            self.counters["failed_over_requests"] += len(victims)
        for rid in victims:
            track = self._inflight[rid]
            if track.hedge_replica is not None \
                    and track.hedge_replica != m.id:
                # Hot-spare promotion: the hedge placement is already
                # decoding this rid with the same seed — no recompute
                # failover needed, just retarget the track.
                track.replica, track.hedge_replica = \
                    track.hedge_replica, None
                continue
            track.replica = None
            track.worker = None
            track.hedge_replica = None
            track.resubmits += 1
            if track.trace is not None:
                # The failover hop is a first-class span LINKED under
                # the request root: anyone reading the stitched trace
                # sees that this request moved replicas, and why.
                self.tracer.record(
                    "failover", time.time(), 0.0,
                    args=trace_args(
                        child_context(track.trace), rid=rid,
                        from_replica=m.id, reason="replica_lost",
                        resubmit=track.resubmits,
                    ),
                )
            self._route(rid, track, now, exclude={m.id}, must_place=True)
        for t in self._inflight.values():
            if t.hedge_replica == m.id:
                t.hedge_replica = None  # primary placement still live
        self._reap(m)

    def _on_worker_death(self, w: _Member,
                         now: float) -> None:  # under self._lock
        if not w.alive:
            return
        w.alive = False
        self.counters["worker_deaths"] += 1
        pending = [rid for rid, t in self._inflight.items()
                   if t.worker == w.id]
        log.warning(
            "serve prefill worker %s lost — re-dispatching %d pending "
            "prompt(s)", w.id, len(pending),
        )
        for rid in pending:
            track = self._inflight[rid]
            track.worker = None
            track.resubmits += 1
            self._route(rid, track, now, must_place=True)
        if self._prefill_factory is not None:
            if self.governor.permit(now):
                try:
                    self.add_prefill(self._prefill_factory())
                    self.counters["prefill_respawns"] += 1
                except Exception:  # noqa: BLE001 - a failed respawn
                    # must not take the router down; the governor slot
                    # is burnt either way (that is the point)
                    log.warning("prefill respawn failed", exc_info=True)
            else:
                self.counters["prefill_respawns_denied"] += 1
                log.warning(
                    "prefill worker %s NOT respawned: restart window "
                    "exhausted (%d per %.0fs)", w.id,
                    self.governor.max_restarts, self.governor.window_s,
                )
        self._reap(w)

    def _reap(self, m: _Member) -> None:
        """Best-effort corpse cleanup OFF the control-plane thread: the
        member is already marked dead and unrouted, and ``kill()`` on a
        false-positive death (process alive, beats merely stalled) can
        block tens of seconds in a drain/join — under the router lock
        that would freeze every client of the fleet."""
        def kill_quietly():
            try:
                m.handle.kill()
            except Exception:  # noqa: BLE001 - reaping is best-effort,
                # but a swallowed kill failure would hide a
                # leaked member process from the operator entirely.
                log.debug("reap of %s %s failed", m.role, m.id,
                          exc_info=True)

        threading.Thread(target=kill_quietly, name="rlt-router-reap",
                         daemon=True).start()
        self._sweep_segments()

    def _sweep_segments(self) -> None:
        """Dead prefill handoffs (producer pid gone, never consumed)
        must not leak tmpfs — mirrored by ``ServeEngine.stop``."""
        try:
            from ray_lightning_tpu_torch.cluster.shm import (
                sweep_stale_segments,
            )

            sweep_stale_segments("rlt-kv")
        except Exception:  # noqa: BLE001 - janitorial, never raises out
            pass

    # -- wire helpers --------------------------------------------------------
    def _outbox(self,
                addr: Tuple[str, int]) -> MemberOutbox:  # under self._lock
        if self._closing:
            raise ConnectionError("router is stopping")
        addr = (addr[0], int(addr[1]))
        box = self._outboxes.get(addr)
        if box is None or box._dead:
            if box is not None:
                box.close(drain_s=0.0)
            # The error callback is bound to the BOX identity (late,
            # below) — a stale failure report must never tear down a
            # healthy replacement lane at the same address.
            box = MemberOutbox(addr)
            box._on_error = (
                lambda e, b=box: self._on_outbox_error(b, e)
            )
            self._outboxes[addr] = box
        return box

    def _reap_idle_outboxes(self, now: float) -> None:
        """Close send lanes that have been idle past the threshold —
        one thread + socket per DISTINCT client reply address must not
        accumulate over a long-lived router's lifetime.  Victims are
        collected under the lock but closed outside it (close joins
        the lane thread)."""
        with self._lock:
            victims = [
                addr for addr, box in self._outboxes.items()
                if not box.pending
                and now - box.last_used > self._outbox_idle_s
            ]
            boxes = [self._outboxes.pop(a) for a in victims]
        for box in boxes:
            box.close(drain_s=0.0)

    def _put(self, addr: Tuple[str, int], item: Dict[str, Any],
             on_sent=None) -> None:
        self._outbox(addr).put(item, on_sent=on_sent)

    def flush_outboxes(self, timeout: float = 5.0) -> bool:
        """Wait until every live outbox has drained to the wire (tests
        and planned teardowns want the async sends LANDED, not merely
        enqueued).  Returns False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                busy = any(box.pending and not box._dead
                           for box in self._outboxes.values())
            if not busy:
                return True
            time.sleep(0.005)
        return False

    def _on_outbox_error(self, failed_box: MemberOutbox,
                         exc: BaseException) -> None:
        """An async send failed (reported by the outbox thread).  Map
        the address back to whichever member currently advertises it
        and run the SAME death path a synchronous send failure used to
        take; a client reply address just drops its outbox (the client
        went away).  Only the FAILED box is unregistered — a healthy
        replacement lane already installed at the same address (a _put
        raced this callback) keeps its queued frames."""
        now = time.monotonic()
        addr = failed_box.addr
        victim = None
        with self._lock:
            if self._outboxes.get(addr) is failed_box:
                self._outboxes.pop(addr, None)
            for m in list(self._replicas.values()):
                if m.alive and m.inbox == addr:
                    victim = m
                    break
            else:
                for w in list(self._workers.values()):
                    if w.alive and w.inbox == addr:
                        victim = w
                        break
        failed_box.close(drain_s=0.0)  # self-join-safe (dead: no join)
        if victim is not None:
            log.warning("outbox to %s %s failed: %r", victim.role,
                        victim.id, exc)
            with self._lock:
                if victim.role == "decode":
                    self._on_replica_death(victim, now)
                else:
                    self._on_worker_death(victim, now)

    def _reply(self, addr: Tuple[str, int], item: Dict[str, Any]) -> None:
        try:
            self._put(addr, item)
        except (OSError, ConnectionError):
            pass  # client went away; nothing to tell it

    # -- telemetry -----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The router's live snapshot (schema:
        ``telemetry/schema.py::validate_router_snapshot``)."""
        now = time.monotonic()
        with self._lock:
            replicas = []
            cap_blocks = []
            for m in self._replicas.values():
                gauges = (m.snapshot.get("gauges", {})
                          if m.snapshot else {})
                entry: Dict[str, Any] = {
                    "id": m.id,
                    "alive": bool(m.alive),
                    "inflight": self._assigned(m.id),
                    "last_beat_age_s": (
                        round(now - m.last_beat, 3)
                        if m.last_beat is not None else None
                    ),
                }
                for key in ("slots_active", "num_slots", "queue_depth",
                            "blocks_free", "num_blocks",
                            "spec_acceptance_rate",
                            "prefix_cache_hit_rate"):
                    if key in gauges:
                        entry[key] = float(gauges[key])
                if m.recompiles is not None:
                    entry["recompiles"] = m.recompiles
                if m.caps.get("max_adapters", 0) > 0:
                    entry["adapters"] = len(m.adapters)
                cap = (m.snapshot.get("capacity")
                       if m.snapshot else None)
                if isinstance(cap, dict):
                    cap_blocks.append(cap)
                    for key in ("headroom_tokens_per_s",
                                "utilization", "kv_exhaustion_eta_s"):
                        if key in cap:
                            entry[key] = cap[key]
                replicas.append(entry)
            workers = []
            for w in self._workers.values():
                wentry: Dict[str, Any] = {
                    "id": w.id,
                    "alive": bool(w.alive),
                    "pending": self._pending(w.id),
                    "last_beat_age_s": (
                        round(now - w.last_beat, 3)
                        if w.last_beat is not None else None
                    ),
                }
                if w.caps.get("max_adapters", 0) > 0:
                    wentry["adapters"] = len(w.adapters)
                workers.append(wentry)
            out = {
                "ts": time.time(),
                "counters": dict(self.counters),
                "replicas": replicas,
                "workers": workers,
            }
            if self.brownout is not None:
                out["brownout_level"] = int(self.brownout.level)
            if cap_blocks:
                from ray_lightning_tpu_torch.serve.capacity import (
                    aggregate_fleet,
                )

                fleet = aggregate_fleet(cap_blocks)
                if fleet is not None:
                    out["capacity"] = fleet
            return out

    def _maybe_export(self) -> None:
        if self._exporter is None and self._live_path is None:
            return
        now = time.monotonic()
        if now - self._last_export < self._export_every_s:
            return
        self._last_export = now
        snap = self.snapshot()
        if self._exporter is not None:
            self._exporter.update({"router": snap})
        if self._live_path is not None:
            import json
            import os

            tmp = self._live_path + ".tmp"
            try:
                with open(tmp, "w") as f:
                    json.dump({"ts": snap["ts"], "router": snap}, f)
                os.replace(tmp, self._live_path)
            except OSError:
                pass  # a full disk must not take the router down
