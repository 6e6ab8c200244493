"""Continuous batcher: admission queue, slot table, preemption policy.

The host-side control plane of the serving engine, as in
``ray_lightning_tpu/serve/scheduler.py``.  The unit of scheduling is the
**slot** — one of ``num_slots`` rows of the fixed-width decode step.
Between decode steps the scheduler:

1. **admits** queued requests while a free slot and enough blocks for the
   request's prefill bucket exist (join on arrival: a request never waits
   for the running batch to drain), granting slots fairly across tenants;
2. **grows** active sequences one block at a time as they cross block
   boundaries.  When the pool is dry, the YOUNGEST active request is
   preempted (recompute: blocks freed, request requeued at the FRONT) —
   latency already invested in older requests is never thrown away for a
   newcomer;
3. **finishes** requests, freeing their blocks at once.

Everything here mutates small numpy arrays (block tables, sequence
lengths, sampling settings, adapter slots) that the engine hands to each
step as tensors; admission and eviction never change a shape.
"""

from __future__ import annotations

import enum
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_lightning_tpu_torch.serve.kv_cache import (
    TRASH_BLOCK, BlockAllocator,
)

__all__ = ["Request", "RequestState", "Scheduler", "default_buckets",
           "derive_geometry"]

# Deficit-round-robin "no grant yet" marker (None is a real key: the
# base model).
_RR_NEVER = object()


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    REJECTED = "rejected"   # admission-queue backpressure


@dataclass
class Request:
    """One generation request and its runtime state."""

    rid: str
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    eos_token_id: Optional[int] = None
    # Top-k truncation for temperature sampling (None/0 = off).
    top_k: Optional[int] = None
    # Multi-tenant LoRA: the adapter (tenant) this request decodes
    # through (None = the shared base model).
    adapter: Optional[str] = None
    # Called with (token_index, token_id) as tokens stream out; after a
    # preemption the engine re-emits from index 0 — consumers dedup on
    # the index.
    on_token: Optional[Callable[[int, int], None]] = None

    # -- runtime (scheduler-owned) ------------------------------------------
    state: RequestState = RequestState.QUEUED
    arrival_t: float = field(default_factory=time.monotonic)
    admitted_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finished_t: Optional[float] = None
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    preemptions: int = 0
    # Admission ordinal — the preemption victim ordering key.
    _seq_no: int = -1
    # The request's sampling-stream identity: None = the submission
    # ordinal, assigned once at submit and kept across preemption
    # requeues, so a recompute replays the same per-position draws.
    sample_seed: Optional[int] = None
    # The adapter's pool slot (engine-set at submit; 0 = the null/base
    # slot), stable across requeues: the engine refuses to remove an
    # adapter a queued or active request holds.
    _adapter_slot: int = 0

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done_reason(self) -> Optional[str]:
        if self.state is RequestState.FINISHED:
            return "eos" if (
                self.eos_token_id is not None
                and self.generated
                and self.generated[-1] == self.eos_token_id
            ) else "length"
        if self.state is RequestState.REJECTED:
            return self.state.value
        return None


def default_buckets(block_size: int, max_prompt_len: int) -> List[int]:
    """Power-of-two block counts: ``block_size * (1, 2, 4, ...)`` up to
    the first bucket covering ``max_prompt_len`` — a handful of prefill
    shapes covers every prompt with at most 2x padding."""
    buckets = []
    b = block_size
    while True:
        buckets.append(b)
        if b >= max_prompt_len:
            return buckets
        b *= 2


def derive_geometry(serve_cfg, model_cfg) -> Tuple[int, List[int]]:
    """``(max_model_len, retained prefill buckets)`` of a serve config
    over a model config.  A bucket longer than ``max_model_len`` cannot
    run (the prefill indexes the positional table at ``[0, T)``), so the
    longest retained bucket bounds the admissible prompt length."""
    max_model_len = serve_cfg.max_model_len or model_cfg.seq_len
    buckets = list(serve_cfg.prefill_buckets or default_buckets(
        serve_cfg.block_size, max(1, max_model_len - 1)
    ))
    buckets = sorted(b for b in buckets if b <= max_model_len)
    if not buckets:
        raise ValueError(
            f"no prefill bucket fits max_model_len {max_model_len} "
            f"(block_size {serve_cfg.block_size} too large? smallest "
            f"bucket is one block)"
        )
    return max_model_len, buckets


class Scheduler:
    """Slot table + admission queue + block accounting.

    The engine drives it: :meth:`poll` between decode steps returns the
    admissions to prefill; :meth:`append_token`, :meth:`finish`,
    :meth:`grow` and :meth:`preempt_youngest` mutate per-slot state as
    tokens land.
    """

    def __init__(
        self,
        num_slots: int,
        allocator: BlockAllocator,
        block_size: int,
        max_blocks_per_seq: int,
        buckets: Sequence[int],
        max_queue: int = 64,
        max_queue_per_adapter: Optional[int] = None,
    ):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        for b in buckets:
            if b % block_size:
                raise ValueError(
                    f"prefill bucket {b} is not a multiple of the "
                    f"block size {block_size}"
                )
        self.num_slots = num_slots
        self.allocator = allocator
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.buckets = sorted(buckets)
        self.max_queue = max_queue
        # Per-tenant admission-queue bound: one tenant's burst must not
        # consume the whole shared queue (None = shared bound only).
        self.max_queue_per_adapter = max_queue_per_adapter
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * num_slots
        # Per-slot allocated physical blocks, in logical order.
        self._blocks: List[List[int]] = [[] for _ in range(num_slots)]
        # The decode step's inputs (value-only mutation).
        self.block_tables = np.full(
            (num_slots, max_blocks_per_seq), TRASH_BLOCK, np.int32
        )
        self.seq_lens = np.zeros((num_slots,), np.int32)
        self.temperatures = np.zeros((num_slots,), np.float32)
        self.top_ks = np.zeros((num_slots,), np.int32)
        self.sample_seeds = np.zeros((num_slots,), np.int32)
        # Each slot's adapter-pool slot (0 = the null/base adapter —
        # inactive slots gather a zero delta).
        self.adapter_slots = np.zeros((num_slots,), np.int32)
        self._admit_counter = 0
        self._submit_counter = 0
        # Fairness state: the adapter key granted the LAST slot (deficit
        # round robin with a unit quantum cycles grants across tenants
        # with queued work, starting after this key).
        self._rr_last: object = _RR_NEVER

    # -- queue side ----------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def active_slots(self) -> int:
        return sum(r is not None for r in self.slots)

    def has_work(self) -> bool:
        return bool(self.queue) or self.active_slots > 0

    def queued_for(self, adapter: Optional[str]) -> int:
        """Queued requests for one adapter key (None = base model)."""
        return sum(1 for r in self.queue if r.adapter == adapter)

    def references_adapter(self, name: str) -> bool:
        """True while any queued or active request decodes through
        ``name`` — the engine's remove/replace-adapter guard."""
        return any(r.adapter == name for r in self.queue) or any(
            r is not None and r.adapter == name for r in self.slots
        )

    def submit(self, req: Request) -> bool:
        """Enqueue, or reject (backpressure) when the shared queue — or
        the request's per-adapter bound — is full.  Rejection is
        synchronous and typed; the client decides whether to retry."""
        if len(self.queue) >= self.max_queue:
            req.state = RequestState.REJECTED
            return False
        if (self.max_queue_per_adapter is not None
                and self.queued_for(req.adapter)
                >= self.max_queue_per_adapter):
            req.state = RequestState.REJECTED
            return False
        req.state = RequestState.QUEUED
        if req.sample_seed is None:
            req.sample_seed = self._submit_counter
        self._submit_counter += 1
        self.queue.append(req)
        return True

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest prefill "
            f"bucket {self.buckets[-1]}"
        )

    # -- between-steps poll --------------------------------------------------
    def poll(self, now: Optional[float] = None
             ) -> List[Tuple[int, Request, int]]:
        """Admit while a slot and the bucket's blocks are free.  Returns
        ``(slot, request, bucket_len)`` per admission, with blocks
        allocated and the slot row populated — the engine only has to
        run the bucket's prefill."""
        now = time.monotonic() if now is None else now
        admissions: List[Tuple[int, Request, int]] = []
        while self.queue:
            slot = next(
                (i for i, r in enumerate(self.slots) if r is None), None
            )
            if slot is None:
                break
            pick = self._next_grant_index()
            req = self.queue[pick]
            bucket = self.bucket_for(req.prompt_len)
            ids = self.allocator.alloc(bucket // self.block_size)
            if ids is None:
                break  # pool dry: wait for evictions, keep grant order
            del self.queue[pick]
            if not req.preemptions:
                # Only rotation grants move the fairness pointer: a
                # preempted request rides the priority lane, and letting
                # it move _rr_last would skip the tenants in between.
                self._rr_last = req.adapter
            req.state = RequestState.RUNNING
            req.slot = slot
            req.admitted_t = now
            req.generated = []
            req._seq_no = self._admit_counter
            self._admit_counter += 1
            self.slots[slot] = req
            self._blocks[slot] = ids
            row = self.block_tables[slot]
            row[:] = TRASH_BLOCK
            row[: len(ids)] = ids
            self.seq_lens[slot] = req.prompt_len
            self.temperatures[slot] = req.temperature
            self.top_ks[slot] = req.top_k or 0
            self.sample_seeds[slot] = req.sample_seed
            self.adapter_slots[slot] = req._adapter_slot
            admissions.append((slot, req, bucket))
        return admissions

    def _next_grant_index(self) -> int:
        """Queue index of the next slot grant.

        Priority 1 — preempted requests, in queue order (latency already
        invested is never thrown away).  Priority 2 — round robin over
        the adapter keys with queued work, FIFO within a key: the grant
        goes to the first key cyclically after the last granted one, so
        one tenant's burst cannot monopolize slot turnover.  Single-key
        traffic reduces to FIFO."""
        for i, r in enumerate(self.queue):
            if r.preemptions:
                return i
        first_idx: Dict[Optional[str], int] = {}
        for i, r in enumerate(self.queue):
            if r.adapter not in first_idx:
                first_idx[r.adapter] = i
        if len(first_idx) == 1:
            return next(iter(first_idx.values()))

        def keypos(k: Optional[str]) -> Tuple[bool, str]:
            # Canonical cyclic order: base (None) first, then names.
            return (k is not None, k or "")

        order = sorted(first_idx, key=keypos)
        if self._rr_last is not _RR_NEVER:
            last = keypos(self._rr_last)
            for k in order:
                if keypos(k) > last:
                    return first_idx[k]
        return first_idx[order[0]]

    # -- per-step slot transitions ------------------------------------------
    def append_token(self, slot: int, token: int,
                     now: Optional[float] = None) -> bool:
        """Record one generated token for ``slot``; returns True when
        the request just finished (eos or length)."""
        now = time.monotonic() if now is None else now
        req = self.slots[slot]
        if req is None:
            raise RuntimeError(f"append_token on empty slot {slot}")
        if req.first_token_t is None:
            req.first_token_t = now
        idx = len(req.generated)
        req.generated.append(token)
        if req.on_token is not None:
            try:
                req.on_token(idx, token)
            except Exception:  # noqa: BLE001 - a raising stream consumer
                # must never take the serve loop down with it
                logging.getLogger(__name__).warning(
                    "serve: on_token callback raised for %s", req.rid,
                    exc_info=True,
                )
        return (
            len(req.generated) >= req.max_new_tokens
            or (req.eos_token_id is not None and token == req.eos_token_id)
        )

    def needs_block(self, slot: int) -> bool:
        """True when the next decode write (position ``seq_lens[slot]``)
        crosses into an unallocated block."""
        return (int(self.seq_lens[slot]) // self.block_size
                >= len(self._blocks[slot]))

    def grow(self, slot: int) -> bool:
        """Allocate the next block for ``slot``.  False = pool dry."""
        if len(self._blocks[slot]) >= self.max_blocks_per_seq:
            raise RuntimeError(
                f"slot {slot} exceeded max_blocks_per_seq "
                f"{self.max_blocks_per_seq} — engine admission bound bug"
            )
        ids = self.allocator.alloc(1)
        if ids is None:
            return False
        self._blocks[slot].extend(ids)
        self.block_tables[slot, len(self._blocks[slot]) - 1] = ids[0]
        return True

    def preempt_youngest(self, protect: Optional[int] = None
                         ) -> Optional[Request]:
        """Evict the most recently admitted active request (recompute
        preemption): free its blocks, requeue it at the FRONT.  Returns
        the victim, or None when no slot other than ``protect`` is
        evictable."""
        victims = [
            (req._seq_no, slot)
            for slot, req in enumerate(self.slots)
            if req is not None and slot != protect
        ]
        if not victims:
            return None
        _, slot = max(victims)
        req = self.slots[slot]
        self._release(slot)
        req.state = RequestState.QUEUED
        req.slot = None
        req.preemptions += 1
        req.generated = []
        req.first_token_t = None
        self.queue.appendleft(req)
        return req

    def cancel(self, rid: str) -> Optional[Request]:
        """Drop ``rid`` wherever it is — queued (removed) or active (slot
        released, blocks freed).  Returns the request, or None when the
        rid is unknown here."""
        for i, r in enumerate(self.queue):
            if r.rid == rid:
                del self.queue[i]
                r.slot = None
                return r
        for slot, r in enumerate(self.slots):
            if r is not None and r.rid == rid:
                self._release(slot)
                r.slot = None
                return r
        return None

    def finish(self, slot: int, now: Optional[float] = None) -> Request:
        now = time.monotonic() if now is None else now
        req = self.slots[slot]
        if req is None:
            raise RuntimeError(f"finish on empty slot {slot}")
        req.state = RequestState.FINISHED
        req.finished_t = now
        req.slot = None
        self._release(slot)
        return req

    def _release(self, slot: int) -> None:
        self.allocator.free(self._blocks[slot])
        self._blocks[slot] = []
        self.slots[slot] = None
        self.block_tables[slot, :] = TRASH_BLOCK
        self.seq_lens[slot] = 0
        self.temperatures[slot] = 0.0
        self.top_ks[slot] = 0
        self.sample_seeds[slot] = 0
        self.adapter_slots[slot] = 0

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "queue_depth": self.queue_depth,
            "slots_active": self.active_slots,
            "num_slots": self.num_slots,
            "blocks_free": self.allocator.free_blocks,
            "blocks_live": self.allocator.live_blocks,
            "num_blocks": self.allocator.num_blocks,
        }
