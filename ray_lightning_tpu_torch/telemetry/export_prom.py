"""OpenMetrics export of the live snapshot, as in
``ray_lightning_tpu/telemetry/export_prom.py``.

Two transports: a **textfile** rendered and atomically replaced on every
refresh (the node-exporter textfile-collector pattern), and a
**localhost HTTP** server (port 0 = ephemeral) on a daemon thread that
serves the latest render at ``/metrics``.  The renderer is a pure
function (snapshot dict -> text).  Stdlib only.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

__all__ = ["render_openmetrics", "PromExporter"]

_PREFIX = "rlt"


def _esc(value: Any) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"')


def render_openmetrics(snapshot: Dict[str, Any]) -> str:
    """Render a live snapshot as OpenMetrics text: the fleet and rank
    gauges, then the ``serve`` block with its ``capacity`` block, the
    ``slo`` block, the ``router`` block with its fleet ``capacity``
    block, and the ``mpmd`` block (the pipeline plane's live snapshot).
    The JAX renderer's monitor event counts and its ``programs`` block
    are not rendered here (their modules are not ported); without them
    the text is the JAX renderer's byte for byte."""
    lines = []

    def gauge(name: str, help_: str, samples) -> None:
        samples = list(samples)
        if not samples:
            return
        lines.append(f"# TYPE {_PREFIX}_{name} gauge")
        lines.append(f"# HELP {_PREFIX}_{name} {help_}")
        for labels, value in samples:
            label_s = ",".join(
                f'{k}="{_esc(v)}"' for k, v in sorted(labels.items())
            )
            label_s = "{" + label_s + "}" if label_s else ""
            lines.append(f"{_PREFIX}_{name}{label_s} {value}")

    gauge("fleet_ranks", "ranks that have reported a heartbeat",
          [({}, snapshot.get("ranks_reporting", 0))])
    gauge("monitor_aborted", "1 if the monitor aborted the fit",
          [({}, int(bool(snapshot.get("aborted"))))])
    ranks = snapshot.get("ranks", {})
    per_rank = [
        ("rank_global_step", "optimizer steps completed", "global_step"),
        ("rank_progress", "loop progress counter", "progress"),
        ("rank_heartbeat_age_seconds", "seconds since last heartbeat",
         "age_s"),
        ("rank_step_time_ms", "mean step wall time", "step_time_ms"),
        ("rank_data_wait_ms", "mean input-pipeline wait", "data_wait_ms"),
        ("rank_examples_per_sec", "training throughput",
         "examples_per_sec"),
        ("rank_host_load", "1-minute load average of the rank's host",
         "host_load"),
    ]
    for metric, help_, key in per_rank:
        gauge(metric, help_, (
            ({"rank": rank}, beat[key])
            for rank, beat in sorted(ranks.items())
            if isinstance(beat.get(key), (int, float))
        ))
    status_order = ("ok", "stalled", "lost", "crashed", "done")
    gauge("rank_status", "rank state (one-hot over status label)", (
        ({"rank": rank, "status": status}, int(beat.get("status") == status))
        for rank, beat in sorted(ranks.items())
        for status in status_order
    ))
    serve = snapshot.get("serve")
    if serve:
        lines.extend(_render_serve(serve))
        capacity = serve.get("capacity")
        if capacity:
            lines.extend(_render_capacity(capacity))
    slo = snapshot.get("slo")
    if slo:
        lines.extend(_render_slo(slo))
    router = snapshot.get("router")
    if router:
        lines.extend(_render_router(router))
        fleet = router.get("capacity")
        if fleet:
            lines.extend(_render_fleet_capacity(fleet))
    mpmd = snapshot.get("mpmd")
    if mpmd:
        lines.extend(_render_mpmd(mpmd))
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def _render_mpmd(mpmd: Dict[str, Any]) -> list:
    """The pipeline plane's section (``mpmd-live.json``'s shape):
    per-stage occupancy and bubble gauges and the pipeline's shape."""
    lines = []
    for name, help_, key in (
        ("mpmd_stages", "pipeline stage workers", "n_stages"),
        ("mpmd_microbatches", "micro-batches per optimizer step",
         "n_micro"),
        ("mpmd_interleave", "model chunks per stage worker",
         "interleave"),
    ):
        if key in mpmd:
            lines.append(f"# TYPE {_PREFIX}_{name} gauge")
            lines.append(f"# HELP {_PREFIX}_{name} {help_}")
            lines.append(f"{_PREFIX}_{name} {mpmd[key]}")
    stages = mpmd.get("stages", [])
    for metric, help_, key in (
        ("mpmd_stage_step", "last completed optimizer step", "step"),
        ("mpmd_stage_bubble_fraction",
         "idle fraction of the stage's pipeline wall", "bubble_fraction"),
        ("mpmd_stage_occupancy",
         "compute fraction of the stage's pipeline wall",
         "stage_occupancy"),
        ("mpmd_stage_loss", "last micro-batch-mean loss (loss stage)",
         "loss"),
        ("mpmd_trace_busy_seconds",
         "per-step stage compute seconds (trace decomposition)",
         "busy_s"),
        ("mpmd_trace_blocked_seconds",
         "per-step stage blocked-recv seconds (trace decomposition)",
         "blocked_s"),
    ):
        samples = [
            (item.get("stage"), item[key])
            for item in stages
            if isinstance(item.get(key), (int, float))
        ]
        if not samples:
            continue
        lines.append(f"# TYPE {_PREFIX}_{metric} gauge")
        lines.append(f"# HELP {_PREFIX}_{metric} {help_}")
        for stage, value in samples:
            lines.append(
                f'{_PREFIX}_{metric}{{stage="{_esc(stage)}"}} {value}'
            )
    return lines


def _render_capacity(capacity: Dict[str, Any]) -> list:
    """The headroom oracle's section (``capacity_snapshot`` shape —
    ``telemetry/schema.py::validate_capacity_snapshot``).  Nullable
    fields (the oracle refuses to guess before it has a measured
    per-slot service rate) are simply omitted."""
    lines = []
    metrics = [
        ("capacity_tokens_per_sec", "measured emitted tokens/s over "
         "the oracle window", "tokens_per_s"),
        ("capacity_ceiling_tokens_per_sec", "predicted saturation "
         "throughput (per-slot service rate x num_slots)",
         "capacity_tokens_per_s"),
        ("capacity_headroom_tokens_per_sec", "tokens/s slack below "
         "the predicted ceiling", "headroom_tokens_per_s"),
        ("capacity_utilization", "load as a fraction of the ceiling",
         "utilization"),
        ("capacity_service_rate_per_slot", "measured tokens/s per "
         "busy decode slot", "service_rate_per_slot"),
        ("capacity_kv_exhaustion_eta_seconds", "free-block trend "
         "extrapolated to pool exhaustion", "kv_exhaustion_eta_s"),
        ("capacity_queue_wait_slope_ms_per_sec", "queue-wait p50 "
         "trend over the window", "queue_wait_slope_ms_per_s"),
        ("capacity_rejection_rate", "rejected/submitted rate over "
         "the window", "rejection_rate"),
    ]
    for metric, help_, key in metrics:
        value = capacity.get(key)
        if not isinstance(value, (int, float)):
            continue
        lines.append(f"# TYPE {_PREFIX}_{metric} gauge")
        lines.append(f"# HELP {_PREFIX}_{metric} {help_}")
        lines.append(f"{_PREFIX}_{metric} {value}")
    return lines


def _render_fleet_capacity(fleet: Dict[str, Any]) -> list:
    """The router's fleet-wide capacity roll-up
    (``serve/capacity.py::aggregate_fleet``)."""
    lines = []
    metrics = [
        ("capacity_fleet_replicas_reporting", "members whose beats "
         "carry a capacity block", "replicas_reporting"),
        ("capacity_fleet_tokens_per_sec", "fleet emitted tokens/s",
         "tokens_per_s"),
        ("capacity_fleet_ceiling_tokens_per_sec", "fleet predicted "
         "saturation throughput", "capacity_tokens_per_s"),
        ("capacity_fleet_headroom_tokens_per_sec", "fleet tokens/s "
         "slack", "headroom_tokens_per_s"),
        ("capacity_fleet_utilization", "fleet load as a fraction of "
         "its ceiling", "utilization"),
        ("capacity_fleet_kv_exhaustion_eta_seconds", "worst member "
         "KV-exhaustion ETA", "kv_exhaustion_eta_s"),
    ]
    for metric, help_, key in metrics:
        value = fleet.get(key)
        if not isinstance(value, (int, float)):
            continue
        lines.append(f"# TYPE {_PREFIX}_{metric} gauge")
        lines.append(f"# HELP {_PREFIX}_{metric} {help_}")
        lines.append(f"{_PREFIX}_{metric} {value}")
    return lines


def _render_slo(slo: Dict[str, Any]) -> list:
    """The burn-rate evaluator's section
    (``telemetry/slo.py::SloEvaluator.snapshot`` shape): per-objective
    burn/error/firing gauges plus the lifetime alert counter."""
    lines = []
    per_slo = [
        ("slo_burn_rate", "error-budget burn multiple (worst window "
         "pair's floor)", "burn_rate"),
        ("slo_error_rate", "error rate over the slow window",
         "error_rate"),
        ("slo_target", "the objective", "target"),
    ]
    for metric, help_, key in per_slo:
        samples = [
            (name, state[key]) for name, state in sorted(slo.items())
            if isinstance(state.get(key), (int, float))
        ]
        if not samples:
            continue
        lines.append(f"# TYPE {_PREFIX}_{metric} gauge")
        lines.append(f"# HELP {_PREFIX}_{metric} {help_}")
        for name, value in samples:
            lines.append(
                f'{_PREFIX}_{metric}{{slo="{_esc(name)}"}} {value}'
            )
    lines.append(f"# TYPE {_PREFIX}_slo_firing gauge")
    lines.append(
        f"# HELP {_PREFIX}_slo_firing 1 while both burn windows "
        f"exceed the pair threshold"
    )
    for name, state in sorted(slo.items()):
        lines.append(
            f'{_PREFIX}_slo_firing{{slo="{_esc(name)}"}} '
            f'{int(bool(state.get("firing")))}'
        )
    lines.append(f"# TYPE {_PREFIX}_slo_alerts counter")
    lines.append(
        f"# HELP {_PREFIX}_slo_alerts slo_alert events emitted"
    )
    for name, state in sorted(slo.items()):
        n = state.get("alerts_total", 0)
        lines.append(
            f'{_PREFIX}_slo_alerts_total{{slo="{_esc(name)}"}} {n}'
        )
    return lines


def _render_serve(serve: Dict[str, Any]) -> list:
    """The serving plane's SLO section (``ServeStats.snapshot`` shape —
    ``telemetry/schema.py::validate_serve_snapshot``): admission/slot
    gauges, request counters by state, and TTFT / per-token latency
    percentiles."""
    lines = []
    gauges = serve.get("gauges", {})
    for name, help_ in (
        ("queue_depth", "requests waiting for admission"),
        ("slots_active", "decode slots in flight"),
        ("num_slots", "decode program width"),
        ("blocks_free", "free KV-cache blocks"),
        ("blocks_live", "allocated KV-cache blocks"),
        ("num_blocks", "KV-cache pool size in blocks"),
    ):
        if name in gauges:
            lines.append(f"# TYPE {_PREFIX}_serve_{name} gauge")
            lines.append(f"# HELP {_PREFIX}_serve_{name} {help_}")
            lines.append(f"{_PREFIX}_serve_{name} {gauges[name]}")
    counters = serve.get("counters", {})
    spec_tokens = {
        kind: counters[f"spec_{kind}"]
        for kind in ("drafted", "accepted", "emitted")
        if f"spec_{kind}" in counters
    }
    if counters:
        lines.append(f"# TYPE {_PREFIX}_serve_requests counter")
        lines.append(
            f"# HELP {_PREFIX}_serve_requests serve events by kind"
        )
        for kind in sorted(counters):
            if kind.startswith("spec_") and not kind == "spec_ticks":
                continue  # the rlt_serve_spec_* family below
            lines.append(
                f'{_PREFIX}_serve_requests_total'
                f'{{kind="{_esc(kind)}"}} {counters[kind]}'
            )
    # Speculative decoding (engines with a draft model): token-level
    # draft/accept/emit accounting + the derived SLO gauges.
    if spec_tokens:
        lines.append(f"# TYPE {_PREFIX}_serve_spec_tokens counter")
        lines.append(
            f"# HELP {_PREFIX}_serve_spec_tokens speculative tokens "
            f"by stage (drafted -> accepted -> emitted)"
        )
        for kind, value in sorted(spec_tokens.items()):
            lines.append(
                f'{_PREFIX}_serve_spec_tokens_total'
                f'{{kind="{_esc(kind)}"}} {value}'
            )
    for name, help_ in (
        ("spec_acceptance_rate",
         "accepted / drafted over the engine lifetime"),
        ("spec_goodput_tokens_per_sec",
         "client-visible emitted tokens per second"),
        ("lora_adapters_loaded",
         "LoRA tenants resident in the adapter pool"),
        ("lora_slots_free", "free adapter-pool slots"),
        ("lora_fairness_spread",
         "min/max lifetime tokens across LoRA tenants with traffic "
         "(1.0 = perfectly fair)"),
    ):
        if name in gauges:
            lines.append(f"# TYPE {_PREFIX}_serve_{name} gauge")
            lines.append(f"# HELP {_PREFIX}_serve_{name} {help_}")
            lines.append(f"{_PREFIX}_serve_{name} {gauges[name]}")
    # Multi-tenant LoRA (engines with an adapter pool): per-tenant
    # token/completion accounting — the fairness-spread decomposition.
    adapters = serve.get("adapters", {})
    if adapters:
        lines.append(f"# TYPE {_PREFIX}_serve_lora_tokens counter")
        lines.append(
            f"# HELP {_PREFIX}_serve_lora_tokens emitted tokens per "
            f"LoRA tenant"
        )
        for name in sorted(adapters):
            lines.append(
                f'{_PREFIX}_serve_lora_tokens_total'
                f'{{adapter="{_esc(name)}"}} '
                f"{adapters[name].get('tokens_out', 0)}"
            )
        lines.append(f"# TYPE {_PREFIX}_serve_lora_completed counter")
        lines.append(
            f"# HELP {_PREFIX}_serve_lora_completed completed requests "
            f"per LoRA tenant"
        )
        for name in sorted(adapters):
            lines.append(
                f'{_PREFIX}_serve_lora_completed_total'
                f'{{adapter="{_esc(name)}"}} '
                f"{adapters[name].get('completed', 0)}"
            )
    # Prefix-aware KV reuse (engines with a prefix cache): the block
    # accounting families plus the derived hit-rate/residency gauges.
    prefix = serve.get("prefix")
    if prefix:
        lines.append(f"# TYPE {_PREFIX}_serve_prefix_requests counter")
        lines.append(
            f"# HELP {_PREFIX}_serve_prefix_requests prefix-cache "
            f"lookups and whole-block hits at admission"
        )
        for kind in ("lookup", "hit"):
            lines.append(
                f'{_PREFIX}_serve_prefix_requests_total'
                f'{{kind="{_esc(kind)}"}} '
                f"{prefix.get(kind + 's', 0)}"
            )
        lines.append(f"# TYPE {_PREFIX}_serve_prefix_blocks counter")
        lines.append(
            f"# HELP {_PREFIX}_serve_prefix_blocks KV blocks through "
            f"the prefix cache by event (claimed = prefill skipped)"
        )
        for kind in ("claimed", "inserted", "evicted"):
            lines.append(
                f'{_PREFIX}_serve_prefix_blocks_total'
                f'{{kind="{_esc(kind)}"}} '
                f"{prefix.get('blocks_' + kind, 0)}"
            )
        for name, help_ in (
            ("hit_rate",
             "admissions claiming at least one resident block"),
            ("cached_blocks", "KV blocks resident in the prefix cache"),
        ):
            if name in prefix:
                lines.append(
                    f"# TYPE {_PREFIX}_serve_prefix_{name} gauge"
                )
                lines.append(
                    f"# HELP {_PREFIX}_serve_prefix_{name} {help_}"
                )
                lines.append(
                    f"{_PREFIX}_serve_prefix_{name} {prefix[name]}"
                )
    latency = serve.get("latency", {})
    for family, summary in sorted(latency.items()):
        metric = f"serve_{family}_latency_ms"
        lines.append(f"# TYPE {_PREFIX}_{metric} gauge")
        lines.append(
            f"# HELP {_PREFIX}_{metric} {family} latency percentiles "
            f"over the recent window"
        )
        for q in ("p50_ms", "p99_ms", "max_ms"):
            if q in summary:
                lines.append(
                    f'{_PREFIX}_{metric}{{quantile="{q[:-3]}"}} '
                    f"{summary[q]}"
                )
    # Distributed-tracing critical-path phases (tracing engines only):
    # the per-phase percentile family the TTFT decomposition reads.
    phases = serve.get("phases", {})
    if phases:
        metric = "serve_phase_latency_ms"
        lines.append(f"# TYPE {_PREFIX}_{metric} gauge")
        lines.append(
            f"# HELP {_PREFIX}_{metric} critical-path phase latency "
            f"percentiles (queue_wait/placement/prefill_compute/"
            f"handoff_transfer/decode_admission/first_token)"
        )
        for phase, summary in sorted(phases.items()):
            for q in ("p50_ms", "p95_ms"):
                if q in summary:
                    lines.append(
                        f'{_PREFIX}_{metric}{{phase="{_esc(phase)}",'
                        f'quantile="{q[:-3]}"}} {summary[q]}'
                    )
    return lines


def _render_router(router: Dict[str, Any]) -> list:
    """The disaggregated fleet's section (``router-live.json`` shape —
    ``telemetry/schema.py::validate_router_snapshot``): the
    ``rlt_serve_*`` family grown PER-REPLICA labels — occupancy,
    in-flight, block pool, per-replica spec acceptance — plus the
    router's own counters (routed/failovers/deaths/respawns) and
    prefill-worker gauges."""
    lines = []
    per_replica = [
        ("serve_replica_alive", "1 if the replica is serving", "alive"),
        ("serve_replica_inflight",
         "requests the router holds in flight on this replica",
         "inflight"),
        ("serve_replica_slots_active", "decode slots in flight",
         "slots_active"),
        ("serve_replica_num_slots", "decode program width", "num_slots"),
        ("serve_replica_queue_depth", "requests waiting for admission",
         "queue_depth"),
        ("serve_replica_blocks_free", "free KV-cache blocks",
         "blocks_free"),
        ("serve_replica_spec_acceptance_rate",
         "accepted / drafted on this replica", "spec_acceptance_rate"),
        ("serve_replica_prefix_cache_hit_rate",
         "prefix-cache hit rate on this replica",
         "prefix_cache_hit_rate"),
        ("serve_replica_recompiles",
         "compile events observed in the replica process",
         "recompiles"),
    ]
    replicas = router.get("replicas", [])
    for metric, help_, key in per_replica:
        samples = []
        for entry in replicas:
            value = entry.get(key)
            if key == "alive":
                value = int(bool(value))
            if isinstance(value, (int, float)) \
                    and not isinstance(value, bool):
                samples.append((entry.get("id"), value))
        if not samples:
            continue
        lines.append(f"# TYPE {_PREFIX}_{metric} gauge")
        lines.append(f"# HELP {_PREFIX}_{metric} {help_}")
        for replica, value in samples:
            lines.append(
                f'{_PREFIX}_{metric}{{replica="{_esc(replica)}"}} {value}'
            )
    workers = router.get("workers", [])
    samples = [
        (w.get("id"), int(bool(w.get("alive"))), w.get("pending", 0))
        for w in workers
    ]
    if samples:
        for metric, help_, idx in (
            ("serve_prefill_alive", "1 if the prefill worker is up", 1),
            ("serve_prefill_pending",
             "prompts dispatched and not yet handed off", 2),
        ):
            lines.append(f"# TYPE {_PREFIX}_{metric} gauge")
            lines.append(f"# HELP {_PREFIX}_{metric} {help_}")
            for row in samples:
                lines.append(
                    f'{_PREFIX}_{metric}{{worker="{_esc(row[0])}"}} '
                    f"{row[idx]}"
                )
    counters = router.get("counters", {})
    if counters:
        lines.append(f"# TYPE {_PREFIX}_serve_router counter")
        lines.append(
            f"# HELP {_PREFIX}_serve_router router events by kind "
            f"(routed, failovers, deaths, respawns)"
        )
        for kind in sorted(counters):
            lines.append(
                f'{_PREFIX}_serve_router_total{{kind="{_esc(kind)}"}} '
                f"{counters[kind]}"
            )
    return lines


class PromExporter:
    """Textfile writer + optional localhost /metrics server."""

    def __init__(self, textfile: Optional[str] = None,
                 port: Optional[int] = None):
        self.textfile = textfile
        self._text = "# EOF\n"
        self._server = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None
        if port is not None:
            self._start_server(port)

    def _start_server(self, port: int) -> None:
        import http.server

        exporter = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib naming
                if self.path not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = exporter._text.encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "application/openmetrics-text; version=1.0.0; "
                    "charset=utf-8",
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-scrape stderr
                pass

        try:
            self._server = http.server.ThreadingHTTPServer(
                ("127.0.0.1", port), Handler
            )
        except OSError:
            self._server = None  # port taken: textfile still works
            return
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="rlt-prom",
            daemon=True,
        )
        self._thread.start()

    def update(self, snapshot: Dict[str, Any]) -> None:
        self._text = render_openmetrics(snapshot)
        if self.textfile:
            try:
                parent = os.path.dirname(self.textfile)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                tmp = self.textfile + ".tmp"
                with open(tmp, "w") as f:
                    f.write(self._text)
                os.replace(tmp, self.textfile)
            except OSError:
                pass  # a full disk must not take the fit down

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        self._thread = None
