"""The in-process pipeline: every stage worker a thread of one process
(``ray_lightning_tpu/mpmd/inproc.py``).

Worker ``p`` gets its own device, its own :class:`~.stage.StageRunner`
and a :class:`~.transfer.LocalChannel` pair along the worker ring.  The
runners are transport-agnostic, so this is the code path of the stage
worker processes with only the wire differing: the fast parity harness
of the tests.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.models.optim import tree_leaves, tree_map
from ray_lightning_tpu_torch.mpmd.plan import MpmdSpec, StagePlan
from ray_lightning_tpu_torch.mpmd.stage import StageRunner
from ray_lightning_tpu_torch.mpmd.transfer import (
    LocalChannel, Mailbox, WireCodec, WireDtypeConfig,
)

__all__ = ["split_micro_batches", "run_inproc_pipeline_fit"]


def split_micro_batches(batch: Any, n_micro: int) -> List[Any]:
    """Row-split one full batch tree (numpy arrays or tensors) into
    ``n_micro`` equal micro-batches (ragged counts raise: a smaller last
    micro-batch would break the mean-of-means gradient)."""
    leaves = tree_leaves(batch)
    if not leaves:
        raise ValueError("empty batch")
    rows = leaves[0].shape[0]
    if rows % n_micro:
        raise ValueError(
            f"batch of {rows} rows not divisible into {n_micro} "
            "micro-batches"
        )
    mb = rows // n_micro
    return [tree_map(lambda a, i=i: a[i * mb:(i + 1) * mb], batch)
            for i in range(n_micro)]


def run_inproc_pipeline_fit(
    spec: MpmdSpec,
    full_params: Any,
    tx_factory: Callable[[], Any],
    batches: Callable[[int], Any],
    steps: int,
    n_workers: int,
    n_micro: int,
    schedule: str = "1f1b",
    interleave: int = 1,
    devices=None,
    recv_timeout_s: float = 120.0,
    trace_dir: Optional[str] = None,
    wire_dtype: Any = None,
) -> Dict[str, Any]:
    """A whole pipeline fit with the stage workers as threads: the loss
    worker's per-step losses, each worker's steady-state stats, wire
    accounting and op costs, and the reassembled final params (host
    tensors).  ``devices``: one device for every worker or a list of one
    a worker (None: the card)."""
    plan = StagePlan.split(spec.n_layers, n_workers * interleave)
    if devices is None or isinstance(devices, (str, torch.device)):
        devices = [devices] * n_workers
    if len(devices) != n_workers:
        raise ValueError(f"{len(devices)} devices for {n_workers} workers")
    wire_cfg = WireDtypeConfig.coerce(wire_dtype)

    def _codec() -> Optional[WireCodec]:
        # One codec a channel: the int8 residuals are the sender's, keyed
        # by micro-batch slot.
        return WireCodec(wire_cfg) if wire_cfg.active else None

    mailboxes = [Mailbox() for _ in range(n_workers)]
    runners: List[StageRunner] = []
    for p in range(n_workers):
        runners.append(StageRunner(
            spec, plan, p, n_workers, schedule, n_micro, tx_factory(),
            interleave=interleave, device=devices[p],
            mailbox=mailboxes[p],
            send_next=LocalChannel(mailboxes[(p + 1) % n_workers],
                                   codec=_codec()),
            send_prev=LocalChannel(mailboxes[(p - 1) % n_workers],
                                   codec=_codec()),
            recv_timeout_s=recv_timeout_s, trace_dir=trace_dir,
        ))
        runners[p].init_state(full_params)

    # Every step's micro-batches split once, so the embed and loss
    # workers consume the same rows.
    step_micro = {s: split_micro_batches(
        tree_map(np.asarray, batches(s)), n_micro) for s in range(steps)}

    errors: List[BaseException] = []
    lock = threading.Lock()

    def drive(runner: StageRunner) -> None:
        try:
            if runner.device.type == "cuda":
                torch.cuda.set_device(runner.device)
            runner.run_fit(
                steps,
                lambda s: step_micro[s] if runner.needs_batches else None)
        except BaseException as e:  # noqa: BLE001 - joined below
            with lock:
                errors.append(e)
            # Unblock the peers waiting on this worker's sends.
            for box in mailboxes:
                box.fail(e)

    threads = [threading.Thread(target=drive, args=(r,),
                                name=f"rlt-mpmd-w{r.worker}", daemon=True)
               for r in runners]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]

    # Global stage g lives on worker g % P as chunk g // P.
    parts = [runners[g % n_workers].chunk_params_host()[g // n_workers]
             for g in range(plan.n_stages)]
    loss_worker = runners[(plan.n_stages - 1) % n_workers]
    return {
        "losses": loss_worker.losses,
        "per_stage_stats": [r.fit_stats() for r in runners],
        "xfer": [r.xfer_stats() for r in runners],
        "step_summaries": [r.step_summaries for r in runners],
        "op_costs": [r.op_costs() for r in runners],
        "params": spec.assemble_params(parts, plan),
        "final_step": int(loss_worker.state.step),
    }
