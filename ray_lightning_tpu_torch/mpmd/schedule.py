"""Pipeline schedules as explicit per-worker instruction streams, as in
``ray_lightning_tpu/mpmd/schedule.py`` (pure Python, copied: the port
imports nothing of the JAX package).

Each stage worker executes a flat list of :class:`Instr` per optimizer
step — no data-dependent control flow, so the stream is inspectable,
testable and simulatable without running a model:

* ``FWD(mb)`` / ``BWD(mb)`` — compute on micro-batch ``mb`` (``chunk``
  selects the worker's model chunk under interleaving);
* ``RECV_ACT``/``SEND_ACT`` — activation handoff along the stage ring;
* ``RECV_GRAD``/``SEND_GRAD`` — activation-gradient handoff backwards;
* ``UPDATE`` — apply the accumulated (micro-batch-mean) gradients.

Schedules:

* **gpipe** — all forwards, then all backwards.  Peak activation stash
  per stage = M micro-batches.
* **1f1b** — warmup forwards, steady one-forward-one-backward, cooldown
  (PipeDream-flush).  Same theoretical bubble as GPipe —
  ``(P-1)/(M+P-1)`` — but peak stash only ``min(P-p, M)``.
* **1f1b interleaved** (``interleave=v > 1``) — each worker hosts ``v``
  model chunks, so the virtual pipeline is ``v*P`` stages deep while
  fill/drain still costs only ``P`` hops of latency per round (bubble ≈
  ``(P-1)/(v*M)``).  Streams come from a deterministic greedy
  list-scheduler over the virtual-stage dependency DAG (backward-first
  priority) and are proven deadlock-free by :func:`simulate_streams`:
  completability of a fixed per-worker total order under blocking recvs
  is timing-independent, so one successful simulation certifies the
  stream at any execution speed.

Global stage ``g`` of a ``(P workers, v chunks)`` layout lives on
worker ``g % P`` as chunk ``g // P``; activations hop along the worker
ring (the ``P-1 → 0`` wrap carries chunk-boundary handoffs under
interleaving).

``bubble_from_timeline`` turns a worker's recorded execution timeline
into the ``bubble_fraction`` / ``stage_occupancy`` metric family:
``busy`` = time inside FWD/BWD compute, ``blocked`` = time stalled in a
RECV wait, ``bubble_fraction = 1 - busy / wall`` over the span from the
first instruction start to the UPDATE start.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Instr",
    "FWD",
    "BWD",
    "RECV_ACT",
    "SEND_ACT",
    "RECV_GRAD",
    "SEND_GRAD",
    "UPDATE",
    "SCHEDULES",
    "gpipe_schedule",
    "one_f_one_b_schedule",
    "interleaved_streams",
    "build_schedule",
    "build_streams",
    "validate_streams",
    "simulate_streams",
    "bubble_from_timeline",
    "pool_op_costs",
    "measured_schedule_bubble",
    "fleet_pipeline_stats",
]

FWD = "FWD"
BWD = "BWD"
RECV_ACT = "RECV_ACT"
SEND_ACT = "SEND_ACT"
RECV_GRAD = "RECV_GRAD"
SEND_GRAD = "SEND_GRAD"
UPDATE = "UPDATE"

_COMPUTE_OPS = (FWD, BWD)
_RECV_OPS = (RECV_ACT, RECV_GRAD)

SCHEDULES = ("gpipe", "1f1b")


@dataclasses.dataclass(frozen=True)
class Instr:
    """One scheduled operation; ``mb`` is the micro-batch index (-1 for
    UPDATE), ``chunk`` the executing worker's model chunk."""

    op: str
    mb: int = -1
    chunk: int = 0

    def __repr__(self):
        if self.mb < 0:
            return self.op
        tag = f"{self.op}({self.mb})"
        return f"{tag}@c{self.chunk}" if self.chunk else tag


def _check_shape(stage: int, n_stages: int, n_micro: int) -> None:
    if not 0 <= stage < n_stages:
        raise ValueError(f"stage {stage} out of range for P={n_stages}")
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")


def _fwd_group(stage: int, n_stages: int, mb: int) -> List[Instr]:
    group = []
    if stage > 0:
        group.append(Instr(RECV_ACT, mb))
    group.append(Instr(FWD, mb))
    if stage < n_stages - 1:
        group.append(Instr(SEND_ACT, mb))
    return group


def _bwd_group(stage: int, n_stages: int, mb: int) -> List[Instr]:
    group = []
    if stage < n_stages - 1:
        group.append(Instr(RECV_GRAD, mb))
    group.append(Instr(BWD, mb))
    if stage > 0:
        group.append(Instr(SEND_GRAD, mb))
    return group


def gpipe_schedule(stage: int, n_stages: int, n_micro: int) -> List[Instr]:
    """All forwards, then all backwards, then the update."""
    _check_shape(stage, n_stages, n_micro)
    stream: List[Instr] = []
    for mb in range(n_micro):
        stream += _fwd_group(stage, n_stages, mb)
    for mb in range(n_micro):
        stream += _bwd_group(stage, n_stages, mb)
    stream.append(Instr(UPDATE))
    return stream


def one_f_one_b_schedule(
    stage: int, n_stages: int, n_micro: int
) -> List[Instr]:
    """Plain (non-interleaved) 1F1B: warmup forwards, steady
    one-forward-one-backward, cooldown backwards."""
    _check_shape(stage, n_stages, n_micro)
    warmup = min(n_stages - 1 - stage, n_micro)
    stream: List[Instr] = []
    for mb in range(warmup):
        stream += _fwd_group(stage, n_stages, mb)
    for i in range(n_micro - warmup):
        stream += _fwd_group(stage, n_stages, warmup + i)
        stream += _bwd_group(stage, n_stages, i)
    for mb in range(n_micro - warmup, n_micro):
        stream += _bwd_group(stage, n_stages, mb)
    stream.append(Instr(UPDATE))
    return stream


def build_schedule(
    name: str, stage: int, n_stages: int, n_micro: int
) -> List[Instr]:
    """One worker's non-interleaved stream (chunk 0 throughout)."""
    if name == "gpipe":
        return gpipe_schedule(stage, n_stages, n_micro)
    if name == "1f1b":
        return one_f_one_b_schedule(stage, n_stages, n_micro)
    raise ValueError(
        f"unknown pipeline schedule {name!r} (expected one of {SCHEDULES})"
    )


# ---------------------------------------------------------------------------
# Interleaved 1F1B: greedy list-scheduled per-worker streams
# ---------------------------------------------------------------------------

def _stage_of(worker: int, chunk: int, n_workers: int) -> int:
    return chunk * n_workers + worker


def interleaved_streams(
    n_workers: int,
    n_micro: int,
    interleave: int,
    fwd_cost: float = 1.0,
    bwd_cost: float = 2.0,
    transfer_cost: float = 0.1,
) -> List[List[Instr]]:
    """Per-worker streams for 1F1B-interleaved over ``interleave``
    model chunks per worker.

    Deterministic greedy list-scheduling over the virtual-stage DAG:
    whenever a worker is free it runs the highest-priority node whose
    inputs have (virtually) arrived — backwards before forwards (the
    1F1B stash discipline), ``P``-micro-batch groups cycling through
    chunks (the Megatron interleave rhythm).  The cost model only
    shapes the ORDER; correctness never depends on it (the emitted
    streams are validated structurally and by simulation).
    """
    if interleave < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    n_stages = n_workers * interleave

    def worker_of(g: int) -> int:
        return g % n_workers

    def chunk_of(g: int) -> int:
        return g // n_workers

    def deps(node) -> List[Tuple]:
        g, op, mb = node
        if op == FWD:
            return [(g - 1, FWD, mb)] if g > 0 else []
        d = [(g, FWD, mb)]
        if g < n_stages - 1:
            d.append((g + 1, BWD, mb))
        return d

    finish: Dict[Tuple, float] = {}
    clock = [0.0] * n_workers
    orders: List[List[Tuple]] = [[] for _ in range(n_workers)]
    unscheduled = {
        (g, op, mb)
        for g in range(n_stages)
        for op in (FWD, BWD)
        for mb in range(n_micro)
    }

    def avail_time(node) -> float:
        t = 0.0
        for d in deps(node):
            td = finish[d]
            if worker_of(d[0]) != worker_of(node[0]):
                td += transfer_cost
            t = max(t, td)
        return t

    def priority(node) -> Tuple:
        g, op, mb = node
        c = chunk_of(g)
        if op == BWD:
            return (0, mb // n_workers, -c, mb)
        return (1, mb // n_workers, c, mb)

    while unscheduled:
        progressed = False
        for w in sorted(range(n_workers), key=lambda w: clock[w]):
            cands = [
                n for n in unscheduled
                if worker_of(n[0]) == w
                and all(d in finish for d in deps(n))
            ]
            if not cands:
                continue
            runnable = [
                n for n in cands if avail_time(n) <= clock[w] + 1e-12
            ]
            if runnable:
                node = min(runnable, key=priority)
            else:
                node = min(
                    cands, key=lambda n: (avail_time(n),) + priority(n)
                )
            start = max(clock[w], avail_time(node))
            dur = fwd_cost if node[1] == FWD else bwd_cost
            finish[node] = start + dur
            clock[w] = start + dur
            orders[w].append(node)
            unscheduled.discard(node)
            progressed = True
        if not progressed:  # pragma: no cover - DAG always has a source
            raise RuntimeError("interleaved scheduler wedged")

    streams: List[List[Instr]] = []
    for w, order in enumerate(orders):
        stream: List[Instr] = []
        for g, op, mb in order:
            c = chunk_of(g)
            if op == FWD:
                if g > 0:
                    stream.append(Instr(RECV_ACT, mb, c))
                stream.append(Instr(FWD, mb, c))
                if g < n_stages - 1:
                    stream.append(Instr(SEND_ACT, mb, c))
            else:
                if g < n_stages - 1:
                    stream.append(Instr(RECV_GRAD, mb, c))
                stream.append(Instr(BWD, mb, c))
                if g > 0:
                    stream.append(Instr(SEND_GRAD, mb, c))
        stream.append(Instr(UPDATE))
        streams.append(stream)
    return streams


def build_streams(
    name: str,
    n_workers: int,
    n_micro: int,
    interleave: int = 1,
) -> List[List[Instr]]:
    """Per-worker streams for a whole pipeline.  ``interleave > 1``
    is a 1f1b-only capability (an interleaved GPipe would inherit the
    deep-pipe transfer count without the bubble win)."""
    if interleave > 1:
        if name != "1f1b":
            raise ValueError(
                f"interleave={interleave} requires the '1f1b' schedule, "
                f"got {name!r}"
            )
        return interleaved_streams(n_workers, n_micro, interleave)
    return [
        build_schedule(name, p, n_workers, n_micro)
        for p in range(n_workers)
    ]


# ---------------------------------------------------------------------------
# Structural validation / deadlock simulation
# ---------------------------------------------------------------------------

def _peer_chunk(op: str, worker: int, chunk: int, n_workers: int) -> int:
    """Receiver chunk of a SEND (the wire key's chunk coordinate)."""
    g = _stage_of(worker, chunk, n_workers)
    return (g + 1) // n_workers if op == SEND_ACT else (
        (g - 1) // n_workers
    )


def validate_streams(
    streams: Sequence[Sequence[Instr]],
    n_micro: int,
    interleave: int = 1,
) -> List[str]:
    """Structural problems of a per-worker stream ensemble (empty =
    OK): per-(chunk, mb) op coverage, matching SEND/RECV pairs along
    the worker ring, and the dataflow orderings."""
    problems: List[str] = []
    n_workers = len(streams)
    n_stages = n_workers * interleave
    for p, stream in enumerate(streams):
        fwd = sorted((i.chunk, i.mb) for i in stream if i.op == FWD)
        bwd = sorted((i.chunk, i.mb) for i in stream if i.op == BWD)
        want = sorted(
            (c, mb) for c in range(interleave) for mb in range(n_micro)
        )
        if fwd != want:
            problems.append(f"worker {p}: FWD coverage {fwd}")
        if bwd != want:
            problems.append(f"worker {p}: BWD coverage {bwd}")
        if [i for i in stream if i.op == UPDATE] != [Instr(UPDATE)]:
            problems.append(f"worker {p}: exactly one UPDATE required")
        if stream[-1].op != UPDATE:
            problems.append(f"worker {p}: UPDATE must be last")
        pos = {(i.op, i.mb, i.chunk): n for n, i in enumerate(stream)}
        far = 1 << 30
        for c in range(interleave):
            g = _stage_of(p, c, n_workers)
            for mb in range(n_micro):
                if (g > 0
                        and pos.get((RECV_ACT, mb, c), far)
                        > pos[(FWD, mb, c)]):
                    problems.append(
                        f"worker {p}: FWD({mb})@c{c} before its recv"
                    )
                if (g < n_stages - 1
                        and pos.get((RECV_GRAD, mb, c), far)
                        > pos[(BWD, mb, c)]):
                    problems.append(
                        f"worker {p}: BWD({mb})@c{c} before its recv"
                    )
                if pos[(BWD, mb, c)] < pos[(FWD, mb, c)]:
                    problems.append(
                        f"worker {p}: BWD({mb})@c{c} before FWD"
                    )
        # Ring pairing: every SEND must have the matching RECV on the
        # peer worker, keyed by the receiver's chunk.
        for op, recv_op, step in ((SEND_ACT, RECV_ACT, 1),
                                  (SEND_GRAD, RECV_GRAD, -1)):
            peer = (p + step) % n_workers
            sends = {
                (i.mb, _peer_chunk(op, p, i.chunk, n_workers))
                for i in stream if i.op == op
            }
            recvs = {
                (i.mb, i.chunk)
                for i in streams[peer] if i.op == recv_op
            }
            # Subset, not equality: in a 2-worker ring the peer's recv
            # set also contains keys owned by its OTHER neighbor.
            if not sends <= recvs:
                problems.append(
                    f"worker {p} {op} -> {peer}: unmatched "
                    f"{sorted(sends - recvs)[:4]}"
                )
    return problems


def simulate_streams(
    streams: Sequence[Sequence[Instr]],
    cost: Optional[Dict[str, float]] = None,
    transfer_s: float = 0.0,
    interleave: int = 1,
) -> Dict[str, Any]:
    """Execute the ensemble under blocking-recv semantics on a virtual
    clock.  Raises ``RuntimeError`` on deadlock; returns per-worker
    ``{"finish", "busy", "idle"}``, the makespan, and the ensemble
    ``bubble_fraction`` — the analytic companion of the measured
    bubble (tests pin schedule shape with it; deadlock-freedom proven
    here holds for real execution at any speed)."""
    cost = dict(cost or {})
    f = cost.get(FWD, 1.0)
    b = cost.get(BWD, 2.0)
    send = cost.get(SEND_ACT, cost.get(SEND_GRAD, 0.0))
    n_workers = len(streams)
    pc = [0] * n_workers
    clock = [0.0] * n_workers
    busy = [0.0] * n_workers
    # (receiver_worker, recv_op, mb, receiver_chunk) -> availability.
    arrivals: Dict[Tuple, float] = {}
    total = sum(len(s) for s in streams)
    done = 0
    while done < total:
        progressed = False
        for p, stream in enumerate(streams):
            while pc[p] < len(stream):
                instr = stream[pc[p]]
                if instr.op in _RECV_OPS:
                    key = (p, instr.op, instr.mb, instr.chunk)
                    if key not in arrivals:
                        break  # blocked: payload not produced yet
                    clock[p] = max(clock[p], arrivals.pop(key))
                elif instr.op in _COMPUTE_OPS:
                    dur = f if instr.op == FWD else b
                    clock[p] += dur
                    busy[p] += dur
                elif instr.op in (SEND_ACT, SEND_GRAD):
                    clock[p] += send
                    step = 1 if instr.op == SEND_ACT else -1
                    peer = (p + step) % n_workers
                    recv_op = (
                        RECV_ACT if instr.op == SEND_ACT else RECV_GRAD
                    )
                    key = (
                        peer, recv_op, instr.mb,
                        _peer_chunk(instr.op, p, instr.chunk, n_workers),
                    )
                    arrivals[key] = clock[p] + transfer_s
                pc[p] += 1
                done += 1
                progressed = True
        if not progressed and done < total:
            stuck = {
                p: repr(streams[p][pc[p]])
                for p in range(n_workers)
                if pc[p] < len(streams[p])
            }
            raise RuntimeError(f"schedule deadlock; blocked at {stuck}")
    makespan = max(clock)
    total_busy = sum(busy)
    return {
        "makespan": makespan,
        "bubble_fraction": (
            1.0 - total_busy / (n_workers * makespan) if makespan else 0.0
        ),
        "stages": [
            {
                "finish": clock[p],
                "busy": busy[p],
                "idle": makespan - busy[p],
            }
            for p in range(n_workers)
        ],
    }


# ---------------------------------------------------------------------------
# Measured bubble accounting
# ---------------------------------------------------------------------------

def bubble_from_timeline(
    timeline: Sequence[Dict[str, Any]]
) -> Dict[str, float]:
    """One worker's pipeline-efficiency summary from its recorded
    execution timeline (``StageRunner`` appends one record per executed
    instruction: ``{"op", "mb", "t0", "t1", "blocked_s"}``).

    ``wall`` spans first instruction start → UPDATE start (the UPDATE
    itself is optimizer work, not pipeline bubble); ``busy`` sums
    FWD/BWD durations; ``blocked`` sums recv stalls.  ``bubble_fraction
    = 1 - busy/wall`` — idle from ANY cause (recv stalls, send
    serialization, host dispatch) counts as bubble, matching how lost
    throughput is actually experienced.
    """
    if not timeline:
        return {
            "bubble_fraction": 0.0,
            "stage_occupancy": 0.0,
            "busy_s": 0.0,
            "blocked_s": 0.0,
            "wall_s": 0.0,
        }
    t_first = min(r["t0"] for r in timeline)
    updates = [r["t0"] for r in timeline if r["op"] == UPDATE]
    t_last = max(updates) if updates else max(r["t1"] for r in timeline)
    busy = sum(
        r["t1"] - r["t0"]
        for r in timeline
        if r["op"] in _COMPUTE_OPS and r["t0"] < t_last
    )
    blocked = sum(
        float(r.get("blocked_s", 0.0))
        for r in timeline
        if r["op"] in _RECV_OPS
    )
    wall = max(t_last - t_first, 1e-9)
    occupancy = min(busy / wall, 1.0)
    return {
        "bubble_fraction": max(1.0 - occupancy, 0.0),
        "stage_occupancy": occupancy,
        "busy_s": busy,
        "blocked_s": blocked,
        "wall_s": wall,
    }


def pool_op_costs(
    per_worker: Sequence[Dict[str, float]]
) -> Dict[str, float]:
    """Fleet per-op costs: median across workers of each worker's
    median (stages run the same layer math, so pooling is fair)."""
    pooled: Dict[str, List[float]] = {}
    for costs in per_worker:
        for op, dur in costs.items():
            pooled.setdefault(op, []).append(float(dur))
    return {
        op: sorted(durs)[len(durs) // 2] for op, durs in pooled.items()
    }


def measured_schedule_bubble(
    name: str,
    n_workers: int,
    n_micro: int,
    interleave: int,
    op_costs: Dict[str, float],
) -> float:
    """The schedule's bubble fraction at MEASURED operation costs.

    Wall-clock bubble on a contended host measures the machine as much
    as the schedule (two stage processes time-slicing two cores read as
    bubble).  This decomposition keeps both halves honest: per-op costs
    (median FWD/BWD/SEND durations, ``StageRunner.op_costs``) come
    from the real run, and the schedule's idle structure at those costs
    comes from the deterministic dataflow simulation — the same
    methodology the MPMD papers use for bubble decomposition.  Transfer
    latency is approximated by the measured send cost (the copy to the
    host + serialize ≈ deserialize + the copy to the peer's device).
    """
    send = float(op_costs.get("SEND", 0.0))
    sim = simulate_streams(
        build_streams(name, n_workers, n_micro, interleave),
        cost={
            FWD: float(op_costs.get("FWD", 1.0)),
            BWD: float(op_costs.get("BWD", 2.0)),
            SEND_ACT: send,
        },
        transfer_s=send,
        interleave=interleave,
    )
    return float(sim["bubble_fraction"])


def fleet_pipeline_stats(
    per_stage: Sequence[Dict[str, float]]
) -> Dict[str, float]:
    """Fleet aggregate of per-worker summaries: mean bubble/occupancy
    and the stage skew (max-min busy time — the load-balance signal)."""
    if not per_stage:
        return {
            "bubble_fraction": 0.0,
            "stage_occupancy": 0.0,
            "stage_skew_ms": 0.0,
        }
    bubbles = [s["bubble_fraction"] for s in per_stage]
    occs = [s["stage_occupancy"] for s in per_stage]
    busys = [s["busy_s"] for s in per_stage]
    return {
        "bubble_fraction": sum(bubbles) / len(bubbles),
        "stage_occupancy": sum(occs) / len(occs),
        "stage_skew_ms": (max(busys) - min(busys)) * 1e3,
    }
