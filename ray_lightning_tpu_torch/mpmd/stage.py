"""StageRunner: one pipeline worker, its own programs on its own device
(``ray_lightning_tpu/mpmd/stage.py``).

A runner holds its stage's parameters on one explicit device, builds
per-chunk forward and backward programs from the model's
:class:`~.plan.MpmdSpec`, and walks an explicit :mod:`~.schedule`
instruction stream: receiving activations from the previous worker,
sending to the next, accumulating f32 gradients, and applying the
optimizer at ``UPDATE``.

Under interleaving a worker hosts ``v`` model chunks (global stage ``g =
chunk * P + worker``), each with its programs and gradient accumulator;
one combined update covers all chunks (AdamW is elementwise, so that
equals the one-program fit).  The update divides the accumulators by
``n_micro`` (the micro-batch mean).

Backward follows the JaxPP recompute shape: ``FWD`` stashes only the
chunk's input activation per in-flight micro-batch; ``BWD`` re-runs the
chunk forward with the input set to require grad and calls
``torch.autograd.grad`` against the received ``dy`` — about a third more
chunk FLOPs for a P-times smaller stash, and forward and backward stay
separately schedulable.  The four cases of a chunk's programs are the
JAX ``_build_programs``'s: first and last (the whole model, loss and
grads), first (embed + run, grads against ``dy``), last (run + loss,
grads and ``dx``) and middle (grads and ``dx`` against ``dy``).

The runner is transport- and process-agnostic: given a
:class:`~.transfer.Mailbox` and a ring-channel pair it runs as a thread
in one process (the in-process fit), in a stage worker process (the
strategy), or alone with no transport (``P = 1``).  Every instruction
lands in a timeline record; per-step summaries
(:func:`~.schedule.bubble_from_timeline`) are the ``bubble_fraction`` /
``stage_occupancy`` family.  Compute instructions end with the device
synchronised, so their times are the device's.

Checkpoints: ``mpmd-step<N>-stage<P>.ckpt`` (``STAGE_CKPT_RE``), an
``RLTCKPT1`` stream (``utils/state_stream.py``) of ``{"state": the JAX
stage's TrainState, "step": N}`` that either package reads.
"""

from __future__ import annotations

import os
import re
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from ray_lightning_tpu_torch.models.optim import (
    tree_leaves, tree_map, tree_unflatten,
)
from ray_lightning_tpu_torch.mpmd import schedule as sched
from ray_lightning_tpu_torch.mpmd.plan import MpmdSpec, StagePlan

__all__ = ["StageRunner", "stage_ckpt_name", "STAGE_CKPT_RE"]

# mpmd-step<N>-stage<P>.ckpt — one crc-framed checkpoint per worker per
# retained optimizer step.
STAGE_CKPT_RE = re.compile(
    r"^mpmd-step(?P<step>\d+)-stage(?P<stage>\d+)\.ckpt$"
)


def stage_ckpt_name(step: int, worker: int) -> str:
    return f"mpmd-step{step:08d}-stage{worker}.ckpt"


def _grad(out, leaves, grad_output=None):
    """``torch.autograd.grad`` of ``out`` against ``leaves``, a zero
    where a leaf does not reach ``out``."""
    grads = torch.autograd.grad(
        out, leaves, grad_outputs=grad_output, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, grads)]


class StageRunner:
    """Execute one worker's instruction stream on its own device."""

    def __init__(
        self,
        spec: MpmdSpec,
        plan: StagePlan,
        worker: int,
        n_workers: int,
        schedule: str,
        n_micro: int,
        tx,
        interleave: int = 1,
        device=None,
        mailbox=None,
        send_next=None,
        send_prev=None,
        recv_timeout_s: float = 120.0,
        keep_ckpts: int = 2,
        trace_dir: Optional[str] = None,
    ):
        from ray_lightning_tpu_torch.device import resolve_device

        if plan.n_stages != n_workers * interleave:
            raise ValueError(
                f"plan has {plan.n_stages} stages; {n_workers} workers x "
                f"interleave {interleave} needs {n_workers * interleave}"
            )
        self.spec = spec
        self.plan = plan
        self.worker = worker
        self.n_workers = n_workers
        self.interleave = interleave
        self.schedule_name = schedule
        self.n_micro = n_micro
        self.tx = tx
        self.device = resolve_device(device)
        self.mailbox = mailbox
        self.send_next = send_next
        self.send_prev = send_prev
        self.recv_timeout_s = recv_timeout_s
        self.keep_ckpts = keep_ckpts
        self.n_stages = plan.n_stages
        # Global stage ids hosted here, by chunk.
        self.stages = [c * n_workers + worker for c in range(interleave)]
        self.hosts_embed = 0 in self.stages
        self.hosts_loss = (self.n_stages - 1) in self.stages
        self.needs_batches = self.hosts_embed or self.hosts_loss
        needs_recv = any(g > 0 for g in self.stages)
        needs_send = any(g < self.n_stages - 1 for g in self.stages)
        if (needs_recv or needs_send) and mailbox is None:
            raise ValueError(f"worker {worker} needs a mailbox")
        if needs_send and send_next is None:
            raise ValueError(f"worker {worker} needs a send_next channel")
        if needs_recv and send_prev is None:
            raise ValueError(f"worker {worker} needs a send_prev channel")
        self.stream = sched.build_streams(
            schedule, n_workers, n_micro, interleave)[worker]
        self.state = None
        self.step_summaries: List[Dict[str, float]] = []
        self.losses: List[float] = []
        # Per-op durations of the steps after the first (the first carries
        # every allocation's warm-up): the measured-cost bubble's inputs.
        self._op_durs: Dict[str, List[float]] = {}
        self._steps_run = 0
        self._acc: Optional[List[Any]] = None
        # Distributed tracing: the embed worker mints each step's trace
        # identity and stamps it on its SEND frames; downstream workers
        # adopt it from their first traced RECV.  Exported as
        # trace-mpmd-stage<k>.jsonl at fit end.
        import uuid

        from ray_lightning_tpu_torch.telemetry.spans import SpanTracer

        self._trace_dir = trace_dir
        self._trace_run = uuid.uuid4().hex[:8]
        self.tracer = SpanTracer(enabled=trace_dir is not None,
                                 maxlen=65536, rank=worker)

    # -- the chunks' programs -------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fwd(self, c: int, params, x=None, batch=None):
        """Chunk ``c``'s forward without a graph: the loss (a chunk
        holding the last stage) or the activation to send."""
        spec, g = self.spec, self.stages[c]
        first, last = g == 0, g == self.n_stages - 1
        with torch.no_grad():
            if first:
                x = spec.embed_fn(params, batch)
            y = spec.stage_fn(params["blocks"], x)
            if last:
                return spec.loss_fn(params, y, batch)[0]
            return y

    def _bwd(self, c: int, params, x=None, batch=None, dy=None):
        """Chunk ``c``'s backward: the forward re-run with a graph, then
        ``(dparams, dx)`` (``dx`` None on the first stage)."""
        spec, g = self.spec, self.stages[c]
        first, last = g == 0, g == self.n_stages - 1
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        with torch.enable_grad():
            if first:
                x_in = spec.embed_fn(p, batch)
            else:
                x_in = x.detach().requires_grad_(True)
                leaves = leaves + [x_in]
            y = spec.stage_fn(p["blocks"], x_in)
            if last:
                grads = _grad(spec.loss_fn(p, y, batch)[0], leaves)
            else:
                grads = _grad(y, leaves, dy.to(y.dtype))
        if first:
            return tree_unflatten(params, grads), None
        return tree_unflatten(params, grads[:-1]), grads[-1]

    # -- placement ------------------------------------------------------------
    def _placed(self, tree):
        """A received tree or a raw batch on this worker's device."""
        return tree_map(
            lambda a: torch.as_tensor(a).to(self.device), tree)

    # -- state ----------------------------------------------------------------
    def init_state(self, full_params) -> None:
        """Cut this worker's chunk params out of a full param tree (owned
        copies on the device) and build the optimizer state; every worker
        starts from the same full tree, so the stages agree on boundary
        shapes without communicating."""
        from ray_lightning_tpu_torch.core.module import TrainState

        chunks = [self.spec.split_params(full_params, self.plan, g)
                  for g in self.stages]
        chunks = tree_map(
            lambda a: torch.as_tensor(a).detach().to(
                self.device, dtype=torch.float32, copy=True), chunks)
        self.state = TrainState.create({"chunks": chunks}, self.tx)
        self._reset_acc()

    def load_state(self, state) -> None:
        """Adopt a TrainState (the resume path) on this device."""
        from ray_lightning_tpu_torch.core.module import TrainState

        self.state = TrainState(
            tree_map(lambda a: a.to(self.device), state.params),
            tree_map(lambda a: a.to(self.device), state.opt_state),
            int(state.step))
        self._reset_acc()

    def _reset_acc(self) -> None:
        self._acc = [tree_map(torch.zeros_like, p)
                     for p in self.state.params["chunks"]]

    def chunk_params_host(self) -> List[Any]:
        """Per-chunk host param trees (ordered by this worker's chunk
        index; the strategy reassembles across workers)."""
        return [tree_map(lambda a: a.detach().cpu(), p)
                for p in self.state.params["chunks"]]

    # -- checkpoints ----------------------------------------------------------
    def write_checkpoint(self, restart_dir: str, step: int) -> str:
        from ray_lightning_tpu_torch.models.convert import stage_state_to_jax
        from ray_lightning_tpu_torch.utils.state_stream import (
            state_stream_to_file, to_state_stream,
        )

        os.makedirs(restart_dir, exist_ok=True)
        path = os.path.join(restart_dir, stage_ckpt_name(step, self.worker))
        state_stream_to_file(
            to_state_stream({"state": stage_state_to_jax(self.state),
                             "step": step}), path)
        self._prune_checkpoints(restart_dir)
        return path

    def _prune_checkpoints(self, restart_dir: str) -> None:
        """Keep the newest ``keep_ckpts`` steps of this worker (the
        fallback past a corrupt newest needs one older survivor)."""
        mine = []
        try:
            entries = os.listdir(restart_dir)
        except OSError:
            return
        for entry in entries:
            m = STAGE_CKPT_RE.match(entry)
            if m and int(m.group("stage")) == self.worker:
                mine.append((int(m.group("step")), entry))
        for _, entry in sorted(mine)[:-self.keep_ckpts]:
            try:
                os.unlink(os.path.join(restart_dir, entry))
            except OSError:
                pass

    def load_checkpoint(self, prefix: str) -> int:
        """Load ``<prefix>-stage<k>.ckpt`` (the resume prefix of
        :func:`~.worker.latest_mpmd_checkpoint`); the optimizer step to
        resume from."""
        from ray_lightning_tpu_torch.models.convert import (
            stage_state_from_jax,
        )
        from ray_lightning_tpu_torch.utils.state_stream import (
            load_state_stream, state_stream_from_file,
        )

        path = f"{prefix}-stage{self.worker}.ckpt"
        payload = load_state_stream(state_stream_from_file(path))
        self.load_state(stage_state_from_jax(payload["state"]))
        return int(payload["step"])

    # -- execution ------------------------------------------------------------
    def run_fit(
        self,
        steps: int,
        micro_batches_for: Callable[[int], Optional[List[Any]]],
        start_step: int = 0,
        restart_dir: Optional[str] = None,
        ckpt_every: int = 1,
        on_step: Optional[Callable[[int, Dict[str, Any]], None]] = None,
    ) -> Dict[str, Any]:
        """Drive optimizer steps ``start_step .. steps-1`` of the stream.
        ``micro_batches_for(step)``: this worker's micro-batches (embed and
        loss workers) or None; ``on_step(step, logs)`` runs at each
        step's end."""
        if self.state is None:
            raise RuntimeError("init_state/load_state must run first")
        try:
            for step in range(start_step, steps):
                logs = self._run_opt_step(step, micro_batches_for(step))
                if self.hosts_loss:
                    self.losses.append(float(logs.get("loss", float("nan"))))
                if (restart_dir is not None
                        and (step + 1) % max(ckpt_every, 1) == 0):
                    self.write_checkpoint(restart_dir, step + 1)
                if on_step is not None:
                    on_step(step, logs)
        finally:
            self.export_trace()
        return {
            "losses": self.losses,
            "step_summaries": self.step_summaries,
            "stats": self.fit_stats(),
        }

    def export_trace(self) -> Optional[str]:
        """Write this worker's span JSONL (a crash exits through here too,
        so partial timelines still stitch)."""
        if self._trace_dir is None or not self.tracer.events():
            return None
        path = os.path.join(self._trace_dir,
                            f"trace-mpmd-stage{self.worker}.jsonl")
        try:
            os.makedirs(self._trace_dir, exist_ok=True)
            self.tracer.export_jsonl(path)
        except OSError:
            return None
        return path

    def _run_opt_step(self, step: int, micro: Optional[List[Any]]
                      ) -> Dict[str, Any]:
        if self.needs_batches:
            if micro is None or len(micro) != self.n_micro:
                raise ValueError(
                    f"worker {self.worker} needs {self.n_micro} "
                    f"micro-batches at step {step}, got "
                    f"{None if micro is None else len(micro)}"
                )
            micro = [self._placed(m) for m in micro]
        timeline: List[Dict[str, Any]] = []
        stash_x: Dict[Any, Any] = {}
        stash_y: Dict[Any, Any] = {}
        stash_dy: Dict[Any, Any] = {}
        stash_dx: Dict[Any, Any] = {}
        mb_losses: List[float] = []
        n_workers = self.n_workers
        chunks = self.state.params["chunks"]
        # The step's distributed-trace context: minted here on the embed
        # worker, adopted from the first traced RECV elsewhere.
        step_ctx = None
        if self.tracer.enabled and self.hosts_embed:
            from ray_lightning_tpu_torch.telemetry.propagate import (
                root_context,
            )

            step_ctx = root_context(f"mpmd-{self._trace_run}-s{step}")

        for instr in self.stream:
            op, mb, c = instr.op, instr.mb, instr.chunk
            blocked = 0.0
            t0 = time.perf_counter()
            if op == sched.RECV_ACT:
                tree, blocked, w_trace = self.mailbox.recv_traced(
                    ("act", step, mb, c), timeout=self.recv_timeout_s)
                if step_ctx is None:
                    step_ctx = self._adopt_trace(w_trace)
                stash_x[(c, mb)] = self._placed(tree)
            elif op == sched.RECV_GRAD:
                tree, blocked, w_trace = self.mailbox.recv_traced(
                    ("grad", step, mb, c), timeout=self.recv_timeout_s)
                if step_ctx is None:
                    step_ctx = self._adopt_trace(w_trace)
                stash_dy[(c, mb)] = self._placed(tree)
            elif op == sched.FWD:
                g = self.stages[c]
                first, last = g == 0, g == self.n_stages - 1
                batch = micro[mb] if (first or last) else None
                out = self._fwd(c, chunks[c], x=stash_x.get((c, mb)),
                                batch=batch)
                if last:
                    mb_losses.append(float(out))
                else:
                    self._sync()
                    stash_y[(c, mb)] = out
            elif op == sched.SEND_ACT:
                y = stash_y.pop((c, mb))
                g = self.stages[c]
                self.send_next.send("act", step, mb, y,
                                    chunk=(g + 1) // n_workers,
                                    trace=step_ctx)
            elif op == sched.BWD:
                g = self.stages[c]
                first, last = g == 0, g == self.n_stages - 1
                batch = micro[mb] if (first or last) else None
                dp, dx = self._bwd(
                    c, chunks[c],
                    x=None if first else stash_x.pop((c, mb)),
                    batch=batch,
                    dy=None if last else stash_dy.pop((c, mb)))
                if dx is not None:
                    stash_dx[(c, mb)] = dx
                with torch.no_grad():
                    for a, d in zip(tree_leaves(self._acc[c]),
                                    tree_leaves(dp)):
                        a.add_(d)
                self._sync()
            elif op == sched.SEND_GRAD:
                dx = stash_dx.pop((c, mb))
                g = self.stages[c]
                self.send_prev.send("grad", step, mb, dx,
                                    chunk=(g - 1) // n_workers,
                                    trace=step_ctx)
            elif op == sched.UPDATE:
                n = float(self.n_micro)
                grads = {"chunks": [tree_map(lambda a: a / n, acc)
                                    for acc in self._acc]}
                self.state = self.state.apply_gradients(grads, self.tx)
                chunks = self.state.params["chunks"]
                self._reset_acc()
                self._sync()
            t1 = time.perf_counter()
            timeline.append({"op": op, "mb": mb, "t0": t0, "t1": t1,
                             "blocked_s": blocked})
            if step_ctx is not None:
                from ray_lightning_tpu_torch.telemetry.propagate import (
                    child_context, trace_args,
                )

                self.tracer.record(
                    op.lower(), time.time() - (t1 - t0), t1 - t0,
                    args=trace_args(
                        child_context(step_ctx), step=step, mb=mb,
                        stage=self.stages[c], worker=self.worker,
                        blocked_s=round(blocked, 6)))
            if self._steps_run > 0 and op in (
                    sched.FWD, sched.BWD, sched.SEND_ACT, sched.SEND_GRAD,
                    sched.RECV_ACT, sched.RECV_GRAD):
                key = ("SEND" if op.startswith("SEND") else
                       "RECV" if op.startswith("RECV") else op)
                self._op_durs.setdefault(key, []).append(t1 - t0)
        self._steps_run += 1
        summary = sched.bubble_from_timeline(timeline)
        # The whole step's seconds, the UPDATE included.
        summary["step_s"] = timeline[-1]["t1"] - timeline[0]["t0"]
        summary["step"] = step
        self.step_summaries.append(summary)
        if step_ctx is not None and timeline:
            from ray_lightning_tpu_torch.telemetry.propagate import (
                trace_args,
            )

            dur = timeline[-1]["t1"] - timeline[0]["t0"]
            self.tracer.record(
                "mpmd_step" if self.hosts_embed else "mpmd_stage_step",
                time.time() - dur, dur,
                args=trace_args(
                    step_ctx, step=step, worker=self.worker,
                    busy_s=round(summary.get("busy_s", 0.0), 6),
                    blocked_s=round(summary.get("blocked_s", 0.0), 6),
                    bubble_fraction=round(
                        summary.get("bubble_fraction", 0.0), 6)))
        logs: Dict[str, Any] = dict(summary)
        if self.hosts_loss and mb_losses:
            logs["loss"] = float(sum(mb_losses) / len(mb_losses))
        return logs

    def _adopt_trace(self, envelope) -> Optional[Any]:
        """Adopt the step's trace identity from an upstream frame: this
        worker's step span id is derived (``<trace_id>.w<worker>``,
        parent the embed worker's root), so the fleet agrees without a
        registry."""
        if not self.tracer.enabled or not envelope:
            return None
        from ray_lightning_tpu_torch.telemetry.propagate import (
            TraceContext, extract,
        )

        ctx = extract({"trace": envelope})
        if ctx is None:
            return None
        return TraceContext(ctx.trace_id, f"{ctx.trace_id}.w{self.worker}",
                            ctx.root_span_id)

    def op_costs(self) -> Dict[str, float]:
        """Median per-op durations (seconds) of the steps after the
        first: FWD, BWD, SEND and RECV (the first three are the inputs of
        :func:`~.schedule.measured_schedule_bubble`)."""
        out = {}
        for op, durs in self._op_durs.items():
            if durs:
                s = sorted(durs)
                n = len(s)
                out[op] = float(s[n // 2] if n % 2 else
                                (s[n // 2 - 1] + s[n // 2]) / 2)
        return out

    def xfer_stats(self) -> Dict[str, Any]:
        """Wire accounting over this worker's SEND channels; ``wire_ratio``
        is full-width bytes / encoded bytes (1.0: the codec is off)."""
        agg: Dict[str, Any] = {
            "bytes_sent": 0, "bytes_full_width": 0, "wire_ratio": 1.0,
        }
        enc = None
        for ch in (self.send_next, self.send_prev):
            stats = getattr(ch, "xfer_stats", None)
            if stats is None:
                continue
            s = stats()
            agg["bytes_sent"] += int(s.get("bytes_sent", 0))
            agg["bytes_full_width"] += int(s.get("bytes_full_width", 0))
            if s.get("enc"):
                enc = s["enc"]
            if "shm_sends" in s:
                agg["shm_sends"] = agg.get("shm_sends", 0) + int(
                    s["shm_sends"])
        if agg["bytes_sent"] > 0:
            agg["wire_ratio"] = agg["bytes_full_width"] / agg["bytes_sent"]
        if enc is not None:
            agg["enc"] = enc
        return agg

    def fit_stats(self) -> Dict[str, float]:
        """Steady-state worker summary (the JAX keys and ``step_s``, a
        step's seconds with its UPDATE): the first optimizer step is left
        out when later steps exist."""
        window = (self.step_summaries[1:] if len(self.step_summaries) > 1
                  else self.step_summaries)
        keys = ("bubble_fraction", "stage_occupancy", "busy_s",
                "blocked_s", "wall_s", "step_s")
        if not window:
            return dict.fromkeys(keys, 0.0)
        return {k: float(sum(s[k] for s in window) / len(window))
                for k in keys}
