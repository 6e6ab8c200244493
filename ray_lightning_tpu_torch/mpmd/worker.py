"""The stage worker's entry points and checkpoint discovery
(``ray_lightning_tpu/mpmd/worker.py``).

One worker process (``cluster/actor.py``) a pipeline stage: the strategy
first asks each worker to open its transfer inbox
(:func:`_remote_create_inbox`, whose address goes to its ring
neighbours), then submits :func:`_stage_execute_remote`, which puts the
stage on its device, splits the model and drives the
:class:`~.stage.StageRunner` through the fit.  Everything here is top
level, shipped to the workers by reference.

Restart discovery (:func:`latest_mpmd_checkpoint`) resumes at the newest
optimizer step for which every stage has a crc-verified checkpoint: the
stages must agree on the step.  The JAX worker's chaos hooks
(``fault/inject``) and drain plane (``fault/drain``) are ROADMAP Queue 1
item 6.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from ray_lightning_tpu_torch.mpmd.stage import STAGE_CKPT_RE, StageRunner
from ray_lightning_tpu_torch.mpmd.transfer import (
    QueueChannel, StageInbox, WireCodec, WireDtypeConfig,
)

__all__ = ["latest_mpmd_checkpoint", "_remote_create_inbox",
           "_stage_execute_remote"]

# The worker process's live inbox (module-global: it must outlive the
# _remote_create_inbox call and be found by _stage_execute_remote).
_INBOX: Optional[StageInbox] = None


def _remote_create_inbox() -> Tuple[str, int]:
    """Open (or re-open) this worker's transfer inbox on the loopback; the
    (host, port) its neighbours dial.  Each fit attempt gets a fresh lane
    (a respawned peer must never read a dead attempt's frames).  Lanes
    across hosts wait for a backend that spans hosts (ROADMAP Queue 1
    item 6)."""
    global _INBOX
    if _INBOX is not None:
        _INBOX.close()
    _INBOX = StageInbox(host="127.0.0.1")
    handle = _INBOX.handle
    return handle.host, handle.port


def _collect_batches(datamodule, config,
                     max_needed: Optional[int] = None) -> List[Any]:
    """The deterministic batch sequence every batch-consuming stage
    replays (the embed and loss workers build the shipped datamodule
    from the same seed); ``max_needed`` (the resolved step count) bounds
    the buffer."""
    datamodule.setup("fit")
    loader = datamodule.train_dataloader()
    limit = getattr(config, "limit_train_batches", -1)
    batches: List[Any] = []
    for i, batch in enumerate(loader):
        if limit is not None and 0 <= limit <= i:
            break
        if max_needed is not None and len(batches) >= max_needed:
            break
        batches.append(batch)
    if not batches:
        raise ValueError("train dataloader yielded no batches")
    return batches


def _resolve_steps(config, n_batches: int) -> int:
    max_steps = getattr(config, "max_steps", -1)
    if max_steps and max_steps > 0:
        return max_steps
    return n_batches * max(getattr(config, "max_epochs", 1), 1)


def _stage_execute_remote(task_ref, worker_rank: int, queue_handle,
                          prev_addr: Optional[Tuple[str, int]],
                          next_addr: Optional[Tuple[str, int]]
                          ) -> Dict[str, Any]:
    """Run one stage worker's whole fit in its process."""
    from ray_lightning_tpu_torch.cluster.queue import QueueHandle
    from ray_lightning_tpu_torch.core.loop import _initial_params
    from ray_lightning_tpu_torch.mpmd.inproc import split_micro_batches
    from ray_lightning_tpu_torch.mpmd.plan import (
        StagePlan, resolve_mpmd_spec,
    )
    from ray_lightning_tpu_torch.parallel.strategies import (
        _place_module, _worker_device,
    )

    task = task_ref.get()
    n_workers = task["n_workers"]
    interleave = task["interleave"]
    n_micro = task["n_micro"]
    config = task["config"]
    # Stage p on card p % cards (stages beyond the count share cards).
    device = _worker_device(task["device"], worker_rank)
    module = task["module"]
    _place_module(module, device)
    spec = resolve_mpmd_spec(module)
    plan = StagePlan.split(spec.n_layers, n_workers * interleave)

    tx_factory = task.get("tx_factory") or spec.tx_factory
    tx = tx_factory() if tx_factory is not None else (
        module.configure_optimizers())

    # coerce(None) reads the forwarded RLT_MPMD_WIRE_DTYPE.
    wire_cfg = WireDtypeConfig.coerce(task.get("wire_dtype"))

    def channel(addr):
        if addr is None:
            return None
        return QueueChannel(
            QueueHandle(addr[0], addr[1]),
            same_host=task.get("same_host", False),
            # One codec a channel: the int8 residuals are the sender's.
            codec=WireCodec(wire_cfg) if wire_cfg.active else None)

    send_next = channel(next_addr)
    send_prev = channel(prev_addr)
    runner = StageRunner(
        spec, plan, worker_rank, n_workers, task["schedule"], n_micro, tx,
        interleave=interleave, device=device,
        mailbox=None if _INBOX is None else _INBOX.mailbox,
        send_next=send_next, send_prev=send_prev,
        recv_timeout_s=task.get("recv_timeout_s", 120.0),
        trace_dir=task.get("trace_dir"))

    start_step = 0
    resume_prefix = task.get("resume_prefix")
    if resume_prefix:
        start_step = runner.load_checkpoint(resume_prefix)
    else:
        runner.init_state(_initial_params(module, device, config.seed))

    batches = None
    if runner.needs_batches:
        batches = _collect_batches(task["datamodule"], config,
                                   max_needed=task.get("steps"))
    steps = task.get("steps")  # the strategy's (max_steps) when set
    if steps is None:
        if batches is None:
            raise ValueError(
                f"interior stage worker {worker_rank} cannot derive the "
                "step count from data it never loads; set "
                "Trainer(max_steps=...) for pipelines deeper than 2 "
                "workers")
        steps = _resolve_steps(config, len(batches))

    micro_cache: Dict[int, List[Any]] = {}

    def micro_for(step: int):
        if batches is None:
            return None
        if step not in micro_cache:
            micro_cache.clear()  # one step in flight at a time
            micro_cache[step] = split_micro_batches(
                batches[step % len(batches)], n_micro)
        return micro_cache[step]

    def on_step(step: int, logs: Dict[str, Any]) -> None:
        item = {
            "type": "mpmd_stage",
            "stage": worker_rank,
            "step": step,
            "bubble_fraction": float(logs.get("bubble_fraction", 0.0)),
            "stage_occupancy": float(logs.get("stage_occupancy", 0.0)),
            "busy_s": float(logs.get("busy_s", 0.0)),
            "blocked_s": float(logs.get("blocked_s", 0.0)),
        }
        if "loss" in logs:
            item["loss"] = float(logs["loss"])
        try:
            queue_handle.put(item)
        except Exception:  # noqa: BLE001 - telemetry must not kill a fit
            pass

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        runner.run_fit(steps, micro_for, start_step=start_step,
                       restart_dir=task.get("restart_dir"),
                       ckpt_every=task.get("ckpt_every", 1),
                       on_step=on_step)
    finally:
        for ch in (send_next, send_prev):
            if ch is not None:
                try:
                    ch.close()
                except Exception:  # noqa: BLE001 - teardown best-effort
                    pass

    last_logs: Dict[str, float] = {}
    if runner.hosts_loss and runner.losses:
        last_logs = {"loss": runner.losses[-1],
                     "train_loss": runner.losses[-1]}
    return {
        "rank": worker_rank,
        "chunks": runner.chunk_params_host(),
        "losses": list(runner.losses),
        "stats": runner.fit_stats(),
        "op_costs": runner.op_costs(),
        "xfer": runner.xfer_stats(),
        "final_step": int(runner.state.step),
        "callback_metrics": last_logs,
        "hosts_loss": runner.hosts_loss,
        "steps": steps,
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
    }


def latest_mpmd_checkpoint(restart_dir: Optional[str], n_workers: int
                           ) -> Dict[str, Any]:
    """The newest optimizer step with a complete, crc-verified set of
    stage checkpoints (one file a stage worker): ``{"path": the resume
    prefix or None, "corrupt": [{"path", "problems"}, ...]}``.  Steps
    with a missing or corrupt member are walked past (and the corrupt
    ones reported)."""
    corrupt: List[Dict[str, Any]] = []
    if restart_dir is None:
        return {"path": None, "corrupt": corrupt}
    try:
        entries = os.listdir(restart_dir)
    except OSError:
        return {"path": None, "corrupt": corrupt}
    by_step: Dict[int, Dict[int, str]] = {}
    for entry in entries:
        m = STAGE_CKPT_RE.match(entry)
        if m:
            by_step.setdefault(int(m.group("step")), {})[
                int(m.group("stage"))] = os.path.join(restart_dir, entry)
    from ray_lightning_tpu_torch.utils.state_stream import verify_stream_file

    for step in sorted(by_step, reverse=True):
        members = by_step[step]
        if set(members) != set(range(n_workers)):
            continue  # an incomplete set (a stage died mid-write)
        problems = []
        for _, path in sorted(members.items()):
            errs = verify_stream_file(path)
            if errs:
                problems.append({"path": path, "problems": errs[:3]})
        if problems:
            corrupt.extend(problems)
            continue
        return {"path": os.path.join(restart_dir, f"mpmd-step{step:08d}"),
                "corrupt": corrupt}
    return {"path": None, "corrupt": corrupt}
