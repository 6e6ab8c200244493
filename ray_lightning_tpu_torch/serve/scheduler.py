"""Continuous batcher: admission queue, slot table, preemption policy.

The host-side control plane of the serving engine, as in
``ray_lightning_tpu/serve/scheduler.py``.  The unit of scheduling is the
**slot** — one of ``num_slots`` rows of the fixed-width decode step.
Between decode steps the scheduler:

0. **expires** queued requests whose deadline passed before they were
   ever admitted (``deadline_s`` is a time-to-first-token bound at
   admission: a preempted request requeued has met it already);
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

The engine wires three hooks for the prefix cache and chunked prefill:
``claim_fn`` (shared-prefix blocks retained for a request at admission),
``reclaim`` (evict resident chains when the pool runs dry, before any
running request is preempted) and ``chunk_width`` (prompts whose uncovered
suffix is wider take exact block coverage instead of a prefill bucket).
Speculative ticks cover a multi-token window (:meth:`Scheduler.cover`) and
roll it back to what was emitted (:meth:`Scheduler.truncate_slot_to`).
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
    TRASH_BLOCK, BlockAllocator, extend_block_coverage, truncate_to,
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
    EXPIRED = "expired"     # deadline passed while queued
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
    # Speculative decoding: drafted tokens a tick for this request (None =
    # the engine's spec_k, 0 = plain decode, K = at most K).
    spec: Optional[int] = None
    # Multi-tenant LoRA: the adapter (tenant) this request decodes
    # through (None = the shared base model).
    adapter: Optional[str] = None
    # Seconds from arrival the first token must land by (a bound at
    # admission; None = no deadline).
    deadline_s: Optional[float] = None
    # Brownout shed class of a routed fleet: 0 sheds first, >= 1 keeps
    # its seat (carried for the router; the engine does not read it).
    priority: int = 0
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
    # The request's trace context (telemetry/propagate.TraceContext), set
    # once at submit and kept across preemption requeues, so a
    # recompute's spans land in the same trace.
    trace: Optional[object] = None
    # The adapter's pool slot (engine-set at submit; 0 = the null/base
    # slot), stable across requeues: the engine refuses to remove an
    # adapter a queued or active request holds.
    _adapter_slot: int = 0
    # Prompt tokens covered by a prefix-cache claim at the current
    # admission (0 = none), derived anew at each admission.
    claimed_tokens: int = 0
    # A prefill worker's decoded KV payload (engine-set at submit,
    # serve/dist), dropped at its import admission: a requeued request
    # recomputes from its prompt.
    _handoff: Optional[dict] = field(default=None, repr=False)

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
        if self.state in (RequestState.EXPIRED, RequestState.REJECTED):
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
        # Speculative decoding: the draft cache's frontier per slot (the
        # draft pool shares the block tables, valid through position
        # draft_lens - 1).  Trails seq_lens by at most one, never leads.
        self.draft_lens = np.zeros((num_slots,), np.int32)
        # Each slot's adapter-pool slot (0 = the null/base adapter —
        # inactive slots gather a zero delta).
        self.adapter_slots = np.zeros((num_slots,), np.int32)
        self._admit_counter = 0
        self._submit_counter = 0
        # Prefix cache and chunked prefill (engine-wired; None = off).
        self.claim_fn: Optional[Callable[[Request], List[int]]] = None
        self.reclaim: Optional[Callable[[int], int]] = None
        self.chunk_width: Optional[int] = None
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
             ) -> Tuple[List[Tuple[int, Request, int]], List[Request]]:
        """Expire, then admit while a slot and the blocks are free.
        Returns ``(admissions, expired)``: ``(slot, request, bucket_len)``
        per admission, with blocks allocated and the slot row populated —
        the engine only has to run the prefill — and the requests whose
        deadline passed in the queue.  A request with a claimed prefix or
        a suffix wider than ``chunk_width`` takes exact coverage
        (``bucket_len`` 0): its suffix runs through the engine's chunk
        step, which needs no bucket-shaped blocks, so prompts past the
        largest bucket admit too."""
        now = time.monotonic() if now is None else now
        expired: List[Request] = []
        fresh: Deque[Request] = deque()
        while self.queue:
            req = self.queue.popleft()
            # A preempted request was admitted and streamed: its deadline
            # is met, and expiring it would throw away the latency the
            # front requeue protects.
            if (req.deadline_s is not None
                    and req.preemptions == 0
                    and now - req.arrival_t > req.deadline_s):
                req.state = RequestState.EXPIRED
                req.finished_t = now
                expired.append(req)
            else:
                fresh.append(req)
        self.queue = fresh

        admissions: List[Tuple[int, Request, int]] = []
        while self.queue:
            slot = next(
                (i for i, r in enumerate(self.slots) if r is None), None
            )
            if slot is None:
                break
            pick = self._next_grant_index()
            req = self.queue[pick]
            claimed: List[int] = []
            if self.claim_fn is not None:
                claimed = self.claim_fn(req)
            c_tokens = len(claimed) * self.block_size
            # A handoff imports the whole prompt into private blocks:
            # never chunked (and never claimed: the engine's claim hook).
            chunked = (self.chunk_width is not None
                       and req._handoff is None
                       and (req.prompt_len - c_tokens > self.chunk_width
                            or req.prompt_len > self.buckets[-1]))
            if claimed or chunked:
                bucket = 0
                need = -(-req.prompt_len // self.block_size) - len(claimed)
            else:
                bucket = self.bucket_for(req.prompt_len)
                need = bucket // self.block_size
            ids = self._alloc(need)
            if ids is None:
                if claimed:
                    self.allocator.free(claimed)  # drop the claim
                break  # pool dry: wait for evictions, keep grant order
            ids = claimed + ids
            req.claimed_tokens = c_tokens
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
            self.draft_lens[slot] = req.prompt_len
            self.adapter_slots[slot] = req._adapter_slot
            admissions.append((slot, req, bucket))
        return admissions, expired

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

    def needs_block(self, slot: int, upto_pos: Optional[int] = None
                    ) -> bool:
        """True when a write at ``upto_pos`` (default: the next decode
        write, ``seq_lens[slot]``) crosses into an unallocated block."""
        pos = int(self.seq_lens[slot]) if upto_pos is None else int(upto_pos)
        return pos // self.block_size >= len(self._blocks[slot])

    def _alloc(self, n: int) -> Optional[List[int]]:
        """:meth:`BlockAllocator.alloc`, retried once after asking the
        prefix cache (when wired) to evict resident blocks: dropping a
        cached chain is always cheaper than preempting a request."""
        ids = self.allocator.alloc(n)
        if ids is None and self.reclaim is not None:
            self.reclaim(n - self.allocator.free_blocks)
            ids = self.allocator.alloc(n)
        return ids

    def grow(self, slot: int) -> bool:
        """Allocate the next block for ``slot``.  False = pool dry."""
        if len(self._blocks[slot]) >= self.max_blocks_per_seq:
            raise RuntimeError(
                f"slot {slot} exceeded max_blocks_per_seq "
                f"{self.max_blocks_per_seq} — engine admission bound bug"
            )
        ids = self._alloc(1)
        if ids is None:
            return False
        self._blocks[slot].extend(ids)
        self.block_tables[slot, len(self._blocks[slot]) - 1] = ids[0]
        return True

    def append_tokens(self, slot: int, tokens: Sequence[int],
                      now: Optional[float] = None) -> Tuple[int, bool]:
        """Record a speculative tick's tokens for ``slot`` (the accepted
        drafts and the target's own token), stopping at eos or
        ``max_new_tokens``; returns ``(n_emitted, done)``.  ``on_token``
        fires per token with its stream index, as on the one-token
        path."""
        req = self.slots[slot]
        if req is None:
            raise RuntimeError(f"append_tokens on empty slot {slot}")
        emitted = 0
        for tok in tokens:
            if len(req.generated) >= req.max_new_tokens:
                return emitted, True
            done = self.append_token(slot, int(tok), now=now)
            emitted += 1
            if done:
                return emitted, True
        return emitted, len(req.generated) >= req.max_new_tokens

    def truncate_slot_to(self, slot: int, n_tokens: int) -> int:
        """Roll the slot's coverage back to ``n_tokens`` positions (the
        frontier after a speculative tick): ``seq_lens`` becomes
        ``n_tokens`` and the blocks past it go back to the pool.  Returns
        the blocks freed."""
        freed = truncate_to(self.allocator, self._blocks[slot],
                            self.block_tables[slot], n_tokens,
                            self.block_size)
        self.seq_lens[slot] = n_tokens
        self.draft_lens[slot] = min(int(self.draft_lens[slot]), n_tokens)
        return freed

    def cover(self, slot: int, upto_pos: int) -> bool:
        """Allocate until position ``upto_pos`` is writable, all or
        nothing (the multi-block :meth:`grow`).  False = pool dry."""
        if upto_pos // self.block_size >= self.max_blocks_per_seq:
            raise RuntimeError(
                f"slot {slot} coverage request past max_blocks_per_seq "
                f"{self.max_blocks_per_seq} — engine width-cap bug"
            )
        args = (self.allocator, self._blocks[slot], self.block_tables[slot],
                upto_pos, self.block_size)
        ok = extend_block_coverage(*args)
        if not ok and self.reclaim is not None:
            need = (upto_pos // self.block_size) + 1 \
                - len(self._blocks[slot])
            self.reclaim(need - self.allocator.free_blocks)
            ok = extend_block_coverage(*args)
        return ok

    def cow_slot(self, slot: int, upto_block: int
                 ) -> Optional[Tuple[List[int], List[int]]]:
        """Copy-on-write bookkeeping: every shared block (refcount > 1)
        among the slot's first ``upto_block`` blocks is swapped for a
        fresh private one, and the references on the originals dropped.
        Returns ``(src_ids, dst_ids)`` for :func:`kv_cache.copy_blocks`
        (empty lists: nothing shared), or ``None`` when the pool cannot
        cover the copies (nothing changed).  The admission claim cap keeps
        every write past the shared blocks, so serving never needs it;
        it is the escape hatch for a path that must write below."""
        blocks = self._blocks[slot]
        shared = [i for i in range(min(upto_block, len(blocks)))
                  if self.allocator.is_shared(blocks[i])]
        if not shared:
            return [], []
        fresh = self._alloc(len(shared))
        if fresh is None:
            return None
        src = [blocks[i] for i in shared]
        for i, dst in zip(shared, fresh):
            blocks[i] = dst
            self.block_tables[slot, i] = dst
        self.allocator.free(src)
        return src, fresh

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

    def adopt(self, req: Request, ids: List[int], seq_len: int,
              now: Optional[float] = None) -> Optional[int]:
        """Seat a request that is already decoding (a live migration's
        import) in a free slot: ``ids`` are blocks the caller allocated
        from this scheduler's pool and scattered the imported k/v into,
        ``seq_len`` the cache positions they hold.  The slot is filled as
        :meth:`poll` fills one, minus the queue and claim bookkeeping the
        request paid on the replica it left.  Returns the slot, or None
        when none is free (the caller falls back to recompute)."""
        now = time.monotonic() if now is None else now
        slot = next((i for i, r in enumerate(self.slots) if r is None),
                    None)
        if slot is None:
            return None
        req.state = RequestState.RUNNING
        req.slot = slot
        if req.admitted_t is None:
            req.admitted_t = now
        if req.first_token_t is None and req.generated:
            req.first_token_t = now
        req._seq_no = self._admit_counter
        self._admit_counter += 1
        self.slots[slot] = req
        self._blocks[slot] = list(ids)
        row = self.block_tables[slot]
        row[:] = TRASH_BLOCK
        row[: len(ids)] = ids
        self.seq_lens[slot] = seq_len
        self.temperatures[slot] = req.temperature
        self.top_ks[slot] = req.top_k or 0
        self.sample_seeds[slot] = req.sample_seed
        self.draft_lens[slot] = seq_len
        self.adapter_slots[slot] = req._adapter_slot
        return slot

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
        self.draft_lens[slot] = 0
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
