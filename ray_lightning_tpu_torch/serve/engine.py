"""The serve loop: continuous batching over a paged KV cache, with
multi-tenant LoRA.

As in ``ray_lightning_tpu/serve/engine.py``, the engine runs two step
families with fixed shapes: one bucket-padded prefill per admitted prompt
(a handful of bucket lengths) and one fixed-width decode step over the
``num_slots`` slot set.  Join on arrival, evict on finish, growth and
preemption all happen host-side between steps by changing the steps'
integer inputs (block tables, sequence lengths, current tokens, adapter
slots), never a shape.  With an adapter pool, every step applies each
row's own tenant through the BGMV kernel (``ops/lora.py``) at the qkv and
proj projections of every layer.

Three features ride the same steps, each off by default:

* **speculative decoding** (``spec_k`` with a ``draft_module``/
  ``draft_params`` pair, ``serve/draft.py``): each tick the draft
  proposes up to ``spec_k`` tokens a slot (``spec_k + 1`` draft decode
  steps chained on the device), the target scores every slot's window in
  one :func:`paged_verify_step` and the host keeps each slot's longest
  agreeing prefix plus the target's own token, then rolls both caches
  back to what was emitted;
* **chunked prefill** (``prefill_chunk``): a prompt whose uncovered
  suffix is wider than the chunk is prefilled one chunk per step,
  between decode ticks, so resident slots never stall behind it, and
  prompts past the largest bucket admit;
* **the prefix cache** (``prefix_cache``): prompts' full blocks stay
  resident in a :class:`PrefixIndex` after their requests finish; a new
  request claims its longest shared whole-block prefix (refcounts, no
  device work) and prefills only the rest.

An int8 tree (``models/quant.py``) is dequantized once at build, and every
weight cast to the compute dtype once (:func:`prepare_params`).

The engine is single-threaded over the device: drive it with
:meth:`step` / :meth:`run_until_idle`, or :meth:`generate` for one
request.  :meth:`submit` is thread-safe.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.models.generate import _reject_unmerged_lora
from ray_lightning_tpu_torch.serve.kv_cache import (
    TRASH_BLOCK, PagedKVCache, PrefixIndex, paged_decode_step, paged_prefill,
    paged_verify_step, prepare_params, sample_tokens,
)
from ray_lightning_tpu_torch.serve.lora import AdapterPool
from ray_lightning_tpu_torch.serve.metrics import ServeStats
from ray_lightning_tpu_torch.serve.scheduler import (
    Request, Scheduler, derive_geometry,
)

__all__ = ["ServeConfig", "ServeEngine", "ServeHandle", "ServeRejected"]


def accepted_drafts(drafts, target) -> int:
    """The length of the longest prefix of ``drafts`` that the target's
    own tokens at the same window positions (``target``) agree with."""
    n = 0
    while n < len(drafts) and drafts[n] == target[n]:
        n += 1
    return n


class ServeRejected(RuntimeError):
    """Admission backpressure: the queue is full.  Typed so clients can
    retry with backoff without string matching."""


@dataclass(frozen=True)
class ServeConfig:
    """Serving knobs (the slice of the JAX package's ``ServeConfig`` that
    the port serves)."""

    # Decode width: concurrent sequences in flight.
    num_slots: int = 8
    # Tokens per KV block.
    block_size: int = 16
    # Physical blocks in the pool (block 0 is the trash block).  None =
    # every slot at max_model_len plus one admission's worth of headroom —
    # preemption-free at full width.
    num_blocks: Optional[int] = None
    # Longest prompt+generation the engine admits.  None = the model's
    # positional table (cfg.seq_len).
    max_model_len: Optional[int] = None
    # Prefill bucket lengths (multiples of block_size).  None =
    # power-of-two block counts up to max_model_len.
    prefill_buckets: Optional[Sequence[int]] = None
    # Admission-queue bound: submissions beyond it are rejected at once.
    max_queue: int = 64
    # Multi-tenant LoRA: capacity of the resident adapter pool (0 = no
    # pool) and the rank every loaded adapter must have.
    max_adapters: int = 0
    adapter_rank: int = 0
    # Per-tenant admission bound (None = the shared max_queue only).
    max_queue_per_adapter: Optional[int] = None
    # Speculative decoding: drafted tokens a tick when a draft model is
    # loaded (the verify window is spec_k + 1 wide).  Needs draft_module/
    # draft_params; a request's ``spec=`` lowers it (0 = plain decode).
    spec_k: int = 0
    # Prefix cache: prompts' full blocks stay resident after their
    # requests, and a new request prefills only past its longest shared
    # whole-block prefix (kv_cache.PrefixIndex).
    prefix_cache: bool = False
    # Chunked prefill width (tokens, a multiple of block_size): a prompt
    # whose uncovered suffix is wider is prefilled one chunk per step,
    # between decode ticks, and prompts past the largest bucket admit (up
    # to max_model_len).  None = whole-prompt bucketed prefill only.
    prefill_chunk: Optional[int] = None
    # Seed of the temperature>0 sampling streams.
    seed: int = 0


class ServeHandle:
    """Host-side future for one request."""

    def __init__(self, rid: str, request: Request):
        self.rid = rid
        self.request = request
        self._done = threading.Event()

    @property
    def status(self) -> str:
        return self.request.state.value

    @property
    def tokens(self) -> List[int]:
        return list(self.request.generated)

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Generated tokens (prompt excluded).  Raises
        :class:`ServeRejected` on backpressure, ``TimeoutError`` when the
        request did not finish in time."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.rid} not finished within {timeout}s "
                f"(state={self.status})"
            )
        if self.request.done_reason == "rejected":
            raise ServeRejected(f"request {self.rid} rejected")
        return list(self.request.generated)


@dataclass
class _PrefillJob:
    """One chunked prefill in flight: the request, its own block-table
    row (the scheduler's row stays trashed until the last chunk lands)
    and the first prompt position not yet written."""

    req: Request
    row: np.ndarray
    next_pos: int


class ServeEngine:
    """Continuous-batching inference engine for one GPT module.

    Args:
        module: the ``GPT`` (its config and precision).
        params: a lora-free parameter tree, float or int8
            (``quantize_decode_params``); prepared once on ``device``.
        adapters: ``{name: adapter}`` loaded into the pool at build
            (needs ``config.max_adapters > 0``).
        device: where to serve; ``None`` means ``"cuda"`` (raises without
            a card).
        draft_module/draft_params: the draft model of speculative
            decoding (needs ``config.spec_k >= 1``; same vocabulary).
    """

    def __init__(self, module, params: Dict[str, Any],
                 config: Optional[ServeConfig] = None,
                 adapters: Optional[Dict[str, dict]] = None,
                 device=None, draft_module=None, draft_params=None):
        self.device = resolve_device(device)
        self.module = module
        self.cfg = module.config
        self.config = cfg = config or ServeConfig()
        _reject_unmerged_lora(params)
        self._c = module._compute_dtype()
        self.params = prepare_params(params, self._c, self.device)
        if (draft_module is None) != (draft_params is None):
            raise ValueError("draft_module and draft_params come as a pair")
        if cfg.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {cfg.spec_k}")
        if cfg.spec_k > 0 and draft_module is None:
            raise ValueError(
                "spec_k > 0 needs a draft model: pass draft_module/"
                "draft_params (serve/draft.py builds one from the "
                "target)"
            )
        if draft_module is not None and cfg.spec_k < 1:
            raise ValueError(
                "a draft model without spec_k >= 1 would never be "
                "consulted — set ServeConfig(spec_k=K)"
            )
        self.adapters: Optional[AdapterPool] = None
        if cfg.max_adapters > 0:
            if cfg.adapter_rank < 1:
                raise ValueError(
                    "max_adapters > 0 needs adapter_rank >= 1 (the "
                    "stacked-buffer rank every adapter shares)"
                )
            self.adapters = AdapterPool(
                self.cfg, cfg.max_adapters, cfg.adapter_rank,
                dtype=self._c, device=self.device, impl="kernel",
            )
            for name, adapter in (adapters or {}).items():
                self.adapters.add(name, adapter)
        elif adapters:
            raise ValueError(
                "adapters= passed but ServeConfig.max_adapters is 0 — "
                "size the pool (max_adapters/adapter_rank) to serve "
                "multi-tenant LoRA"
            )
        self._lora_impl = "kernel" if self.adapters is None \
            else self.adapters.impl
        self.draft_module = draft_module
        self.draft_params = None
        if draft_module is not None:
            if draft_module.config.vocab_size != self.cfg.vocab_size:
                raise ValueError(
                    f"draft vocab ({draft_module.config.vocab_size}) != "
                    f"target vocab ({self.cfg.vocab_size}) — drafted "
                    f"tokens would not be target tokens"
                )
            _reject_unmerged_lora(draft_params)
            self._draft_c = draft_module._compute_dtype()
            self.draft_params = prepare_params(draft_params, self._draft_c,
                                               self.device)
        self.spec_k = cfg.spec_k if draft_module is not None else 0
        if (cfg.max_model_len or 0) > self.cfg.seq_len:
            raise ValueError(
                f"max_model_len {cfg.max_model_len} exceeds the "
                f"positional table ({self.cfg.seq_len})"
            )
        self.max_model_len, buckets = derive_geometry(cfg, self.cfg)
        blocks_per_seq = -(-self.max_model_len // cfg.block_size)
        num_blocks = cfg.num_blocks
        if num_blocks is None:
            num_blocks = (cfg.num_slots + 1) * blocks_per_seq + 1
        if num_blocks - 1 < blocks_per_seq:
            raise ValueError(
                f"num_blocks {num_blocks} cannot hold even one "
                f"max-length sequence ({blocks_per_seq} blocks)"
            )
        self.cache = PagedKVCache(self.cfg, num_blocks, cfg.block_size,
                                  dtype=self._c, device=self.device)
        # The longest retained bucket bounds the admissible prompt length;
        # submit() enforces it, so bucket_for never raises in the loop.
        self.max_prompt_len = buckets[-1]
        self.scheduler = Scheduler(
            cfg.num_slots, self.cache.allocator, cfg.block_size,
            blocks_per_seq, buckets, max_queue=cfg.max_queue,
            max_queue_per_adapter=cfg.max_queue_per_adapter,
        )
        self._chunk: Optional[int] = None
        if cfg.prefill_chunk is not None:
            self._chunk = int(cfg.prefill_chunk)
            if self._chunk < cfg.block_size \
                    or self._chunk % cfg.block_size:
                raise ValueError(
                    f"prefill_chunk {cfg.prefill_chunk} must be a "
                    f"positive multiple of block_size {cfg.block_size}"
                )
            if self._chunk > self.max_model_len:
                raise ValueError(
                    f"prefill_chunk {cfg.prefill_chunk} exceeds "
                    f"max_model_len {self.max_model_len}"
                )
            self.scheduler.chunk_width = self._chunk
        self.prefix_cache: Optional[PrefixIndex] = None
        if cfg.prefix_cache:
            self.prefix_cache = PrefixIndex(self.cache.allocator,
                                            cfg.block_size)
            self.scheduler.claim_fn = self._claim_prefix
            # Resident chains are evicted before any request is preempted.
            self.scheduler.reclaim = self.prefix_cache.evict
        # Chunked prefills in flight, by slot.  While a job runs its slot's
        # scheduler row is trashed and its seq_len 0: the decode step
        # treats it as an inactive slot.
        self._chunk_jobs: Dict[int, _PrefillJob] = {}
        # Adapters whose cached chains go before the next admission:
        # add/remove_adapter run on other threads and queue the drop here
        # (under self._lock); step() drains it under the lock it polls
        # under, so no claim ever meets the old factors' KV.
        self._prefix_drops: List[str] = []
        self.stats = ServeStats()
        self._pool = self.cache.init_pool()
        self._draft_pool = None
        if draft_module is not None:
            dcfg = draft_module.config
            if dcfg.seq_len < self.max_model_len:
                raise ValueError(
                    f"draft positional table ({dcfg.seq_len}) shorter "
                    f"than max_model_len ({self.max_model_len})"
                )
            # The draft pool has the target pool's geometry and shares the
            # slot block tables: one allocator, two pools.
            self._draft_pool = PagedKVCache(
                dcfg, num_blocks, cfg.block_size, dtype=self._draft_c,
                device=self.device,
            ).init_pool()
        self._cur_tokens = np.zeros((cfg.num_slots,), np.int64)
        self._handles: Dict[str, ServeHandle] = {}  # guarded by self._lock
        self._lock = threading.Lock()

    # -- requests ------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               temperature: float = 0.0,
               eos_token_id: Optional[int] = None,
               top_k: Optional[int] = None,
               spec: Optional[int] = None,
               adapter: Optional[str] = None,
               sample_seed: Optional[int] = None,
               on_token=None, rid: Optional[str] = None) -> ServeHandle:
        """Enqueue one request (thread-safe).  A backpressure rejection
        shows at once as ``handle.status == "rejected"`` (and ``result()``
        raises).  ``adapter`` decodes the request through that tenant's
        LoRA adapter; an unknown name or a pool-less engine is a
        ``ValueError``, never a silent fall back to the base model.
        ``sample_seed`` presets the request's sampling stream (None = the
        submission ordinal).  ``spec`` caps the request's drafted tokens
        a tick (None = the engine's ``spec_k``, 0 = plain decode)."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        if top_k is not None:
            top_k = int(top_k)
            if top_k < 1:
                raise ValueError(f"top_k must be >= 1, got {top_k}")
            if temperature <= 0.0:
                raise ValueError(
                    "top_k requires temperature > 0 (temperature=0 is "
                    "greedy decoding, which would silently ignore it)"
                )
        if spec is not None:
            spec = int(spec)
            if spec < 0:
                raise ValueError(f"spec must be >= 0, got {spec}")
            if spec > 0 and self.draft_module is None:
                raise ValueError(
                    "spec > 0 on an engine without a draft model — "
                    "build the ServeEngine with draft_module/draft_params"
                )
        if sample_seed is not None:
            sample_seed = int(sample_seed)
            if sample_seed < 0:
                raise ValueError(
                    f"sample_seed must be >= 0, got {sample_seed}"
                )
        if adapter is not None:
            adapter = str(adapter)
            if self.adapters is None:
                raise ValueError(
                    f"request names adapter {adapter!r} but this engine "
                    f"has no adapter pool — build it with "
                    f"ServeConfig(max_adapters=N, adapter_rank=r)"
                )
        if len(prompt) + max_new_tokens > self.max_model_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_model_len "
                f"({self.max_model_len})"
            )
        if len(prompt) > self.max_prompt_len and self._chunk is None:
            raise ValueError(
                f"prompt ({len(prompt)}) exceeds the largest prefill "
                f"bucket ({self.max_prompt_len}); raise max_model_len "
                f"to a multiple of block_size, pass prefill_buckets, "
                f"or enable chunked prefill (ServeConfig.prefill_chunk)"
            )
        if any(not 0 <= t < self.cfg.vocab_size for t in prompt):
            raise ValueError("prompt token outside the vocab")
        rid = rid or uuid.uuid4().hex[:12]
        req = Request(
            rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=float(temperature), eos_token_id=eos_token_id,
            top_k=top_k, spec=spec, adapter=adapter,
            sample_seed=sample_seed, on_token=on_token,
        )
        handle = ServeHandle(rid, req)
        with self._lock:
            if adapter is not None:
                # Resolved under the lock that enqueues: a concurrent
                # remove_adapter either completes first (unknown name) or
                # sees this request through references_adapter.
                try:
                    req._adapter_slot = self.adapters.slot_of(adapter)
                except KeyError:
                    raise ValueError(
                        f"unknown adapter {adapter!r} — load it first "
                        f"(engine.add_adapter)"
                    ) from None
            self.stats.bump("submitted")
            accepted = self.scheduler.submit(req)
            if accepted:
                self._handles[rid] = handle
        if not accepted:
            self.stats.bump("rejected")
            req.finished_t = time.monotonic()
            handle._done.set()
        return handle

    def generate(self, prompt: Sequence[int], max_new_tokens: int,
                 **kw) -> List[int]:
        """Blocking convenience: submit, drive until idle, return the
        generated tokens."""
        handle = self.submit(prompt, max_new_tokens, **kw)
        self.run_until_idle()
        return handle.result(0)

    # -- the loop ------------------------------------------------------------
    def step(self) -> bool:
        """One serve iteration: admit (one prefill per admission, or a
        chunk job), one chunk for every chunk job, grow or preempt, one
        decode or draft → verify tick.  Returns True when any work was
        done."""
        with self._lock:
            if self.prefix_cache is not None and self._prefix_drops:
                # Replaced or removed tenants' chains go before any claim.
                for name in self._prefix_drops:
                    self.prefix_cache.drop(name)
                self._prefix_drops.clear()
            admissions = self.scheduler.poll()
        worked = bool(admissions)
        now = time.monotonic()
        for slot, req, bucket in admissions:
            self.stats.note_admitted(now - req.arrival_t)
            if bucket == 0:
                # Claimed and/or chunked: exact coverage, the uncovered
                # suffix through the chunk step — at once when it fits one
                # step, one chunk per engine step otherwise.
                suffix = req.prompt_len - req.claimed_tokens
                if self._chunk is not None and suffix > self._chunk:
                    self._start_chunk_job(slot, req)
                    continue
                self.stats.bump("prefills")
                first = self._suffix_prefill(slot, req)
            else:
                self.stats.bump("prefills")
                first = self._prefill(slot, req, bucket)
            self._first_token(slot, req, first)

        # One chunk for every chunked prefill before the decode tick, so
        # resident slots keep a token a step while a long prompt fills in.
        if self._chunk_jobs:
            worked = self._chunk_tick() or worked

        widths = self._tick_widths()
        # Growth, and preemption of the youngest request when the pool is
        # dry, for every slot about to write past its blocks: preemption
        # only ever buys the one position a plain decode writes.  The
        # speculative window is covered on top when the pool can fund it,
        # else the slot drafts fewer tokens (down to none): speculation
        # never costs another request its progress.
        for slot in self._decoding():
            if self.scheduler.slots[slot] is None:
                continue  # preempted by an earlier slot's growth
            while self.scheduler.needs_block(slot):
                if self.scheduler.grow(slot):
                    break
                victim = self.scheduler.preempt_youngest(protect=slot)
                if victim is None:
                    raise RuntimeError(
                        "block pool exhausted with a single live "
                        "request — num_blocks below one sequence"
                    )
                self.stats.bump("preempted")
        for slot, req in enumerate(self.scheduler.slots):
            if req is None or widths[slot] == 0:
                continue
            w = widths[slot]
            seq_len = int(self.scheduler.seq_lens[slot])
            while w > 0 and not self.scheduler.cover(slot, seq_len + w):
                w -= 1  # the pool cannot fund the window: draft less
            widths[slot] = w

        active = self._decoding()
        if active:
            worked = True
            if any(widths[s] > 0 for s in active):
                self._spec_tick(active, widths)
            else:
                self._decode_tick(active)
        self._refresh_gauges()
        return worked

    def _decoding(self) -> List[int]:
        """Slots that decode this tick: occupied, not mid chunked
        prefill."""
        return [s for s, r in enumerate(self.scheduler.slots)
                if r is not None and s not in self._chunk_jobs]

    def _tick_widths(self) -> List[int]:
        """Drafted tokens per slot this tick (0 = plain decode): the
        engine's ``spec_k``, capped by the request's ``spec`` and by the
        tokens it has left."""
        widths = [0] * self.config.num_slots
        if self.spec_k == 0:
            return widths
        for slot, req in enumerate(self.scheduler.slots):
            if req is None or slot in self._chunk_jobs:
                continue
            k = self.spec_k if req.spec is None else min(req.spec,
                                                         self.spec_k)
            remaining = req.max_new_tokens - len(req.generated)
            widths[slot] = max(0, min(k, remaining - 1))
        return widths

    def _first_token(self, slot: int, req: Request, first: int) -> None:
        """A prefill's first token lands: TTFT, the stream, the prefix
        cache's insert."""
        t_first = time.monotonic()
        self.stats.note_first_token(t_first - req.arrival_t)
        done = self.scheduler.append_token(slot, first, now=t_first)
        self.stats.bump("tokens_out")
        if req.adapter is not None:
            self.stats.note_adapter(req.adapter, tokens=1)
        self._cur_tokens[slot] = first
        if self.prefix_cache is not None:
            self._prefix_insert(slot, req)
        if done:
            self._complete(slot)

    def _lora_inputs(self, slots: np.ndarray):
        """``(stacked adapter buffers, int32 slot ids on the device)``,
        or ``(None, None)`` without an adapter pool."""
        if self.adapters is None:
            return None, None
        return self.adapters.buffers, torch.tensor(
            slots, dtype=torch.int32, device=self.device
        )

    def _tables(self, rows: np.ndarray, upto: int) -> torch.Tensor:
        """The leading block-table columns that hold positions ``[0,
        upto)``, on the device: a step gathers and masks only the blocks
        its window can see, not the whole ``max_model_len``."""
        n = min(rows.shape[1], max(1, -(-upto // self.config.block_size)))
        return torch.from_numpy(np.ascontiguousarray(rows[:, :n])).to(
            self.device)

    def _sample_one(self, logits: torch.Tensor, req: Request,
                    position: int) -> int:
        """The request's token from ``logits (V,)`` at cache position
        ``position`` (the draw keyed by position)."""
        tok = sample_tokens(
            logits[None], [req.temperature], [req.top_k or 0],
            [req.sample_seed], [position], base_seed=self.config.seed,
        )
        return int(tok[0])  # the deliberate sync: TTFT lands here

    def _prefill(self, slot: int, req: Request, bucket: int) -> int:
        """Run the bucket's prefill for an admitted request (and the
        draft's, on a speculative engine); returns its first token."""
        dev = self.device
        ids = torch.tensor(
            self.scheduler._blocks[slot][: bucket // self.config.block_size],
            dtype=torch.long, device=dev,
        )
        padded = np.zeros((bucket,), np.int64)
        padded[: req.prompt_len] = req.prompt
        tokens = torch.from_numpy(padded).to(dev)
        ad, ad_id = self._lora_inputs(np.array([req._adapter_slot]))
        logits, self._pool = paged_prefill(
            self.cfg, self.params, self._pool, tokens, req.prompt_len, ids,
            compute_dtype=self._c, adapters=ad, adapter_id=ad_id,
            lora_impl=self._lora_impl,
        )
        if self.draft_module is not None:
            # The draft cache tracks every admission, so any later tick can
            # speculate for this slot.
            _, self._draft_pool = paged_prefill(
                self.draft_module.config, self.draft_params,
                self._draft_pool, tokens, req.prompt_len, ids,
                compute_dtype=self._draft_c,
            )
        return self._sample_one(logits, req, req.prompt_len - 1)

    def _run_chunk(self, req: Request, row: np.ndarray, start: int,
                   end: int, width: int) -> torch.Tensor:
        """Prompt positions ``[start, end)`` through the verify step at one
        row (``width`` wide, the tail past ``end`` written to the trash
        block), into the blocks of ``row``; the draft cache too on a
        speculative engine.  Returns the logits at position ``end - 1``."""
        dev = self.device
        window = np.zeros((1, width), np.int64)
        window[0, : end - start] = req.prompt[start:end]
        tokens = torch.from_numpy(window).to(dev)
        table = self._tables(row[None], end)
        start_t = torch.tensor([start], device=dev)
        limit = torch.tensor([end], device=dev)
        ad, ad_ids = self._lora_inputs(np.array([req._adapter_slot]))
        logits, self._pool = paged_verify_step(
            self.cfg, self.params, self._pool, table, start_t, tokens,
            limit, compute_dtype=self._c, adapters=ad, adapter_ids=ad_ids,
            lora_impl=self._lora_impl, head_at=end - 1 - start,
        )
        if self.draft_module is not None:
            _, self._draft_pool = paged_verify_step(
                self.draft_module.config, self.draft_params,
                self._draft_pool, table, start_t, tokens, limit,
                compute_dtype=self._draft_c, head_at=0,
            )
        self.stats.bump("prefill_chunks")
        return logits[0]

    # -- prefix cache and chunked prefill -----------------------------------
    def _claim_prefix(self, req: Request) -> List[int]:
        """Scheduler hook: retain the resident blocks of the longest
        whole-block shared prefix of ``req``'s prompt.  The cap
        ``(prompt_len - 1) // block_size`` keeps the last prompt token's
        block computed here (it yields the first token's logits), so every
        later write lands past the claimed blocks."""
        cap = (req.prompt_len - 1) // self.config.block_size
        return self.prefix_cache.claim(req.adapter, req.prompt, cap)

    def _suffix_prefill(self, slot: int, req: Request) -> int:
        """Prefill the uncovered suffix of a claimed (or chunk-admitted)
        request in one chunk step; returns the first token.  The window is
        the smallest bucket that covers the suffix, else the chunk
        width."""
        start = req.claimed_tokens
        suffix = req.prompt_len - start
        width = next((b for b in self.scheduler.buckets if b >= suffix),
                     self._chunk)
        logits = self._run_chunk(req, self.scheduler.block_tables[slot],
                                 start, req.prompt_len, width)
        return self._sample_one(logits, req, req.prompt_len - 1)

    def _start_chunk_job(self, slot: int, req: Request) -> None:
        """Begin a chunked prefill: the slot leaves the decode set
        (scheduler row trashed, seq_len 0) and its real block-table row is
        kept by the job."""
        sched = self.scheduler
        row = sched.block_tables[slot].copy()
        sched.block_tables[slot, :] = TRASH_BLOCK
        sched.seq_lens[slot] = 0
        sched.draft_lens[slot] = 0
        self.stats.bump("prefills")
        self._chunk_jobs[slot] = _PrefillJob(req=req, row=row,
                                             next_pos=req.claimed_tokens)

    def _chunk_tick(self) -> bool:
        """Advance every chunked prefill by one chunk.  The last chunk
        samples the first token, restores the slot's row and hands the
        request to the decode path."""
        sched = self.scheduler
        worked = False
        for slot, job in list(self._chunk_jobs.items()):
            if sched.slots[slot] is not job.req:
                # Preempted or cancelled under the job: its blocks are
                # freed already, and a re-admission starts afresh.
                del self._chunk_jobs[slot]
                continue
            req = job.req
            start = job.next_pos
            end = min(start + self._chunk, req.prompt_len)
            logits = self._run_chunk(req, job.row, start, end, self._chunk)
            job.next_pos = end
            worked = True
            if end < req.prompt_len:
                continue
            del self._chunk_jobs[slot]
            first = self._sample_one(logits, req, req.prompt_len - 1)
            sched.block_tables[slot, :] = job.row
            sched.seq_lens[slot] = req.prompt_len
            sched.draft_lens[slot] = req.prompt_len
            self._first_token(slot, req, first)
        return worked

    def _prefix_insert(self, slot: int, req: Request) -> None:
        """Publish the slot's whole-block prompt prefix: claimed blocks
        re-match, fresh full blocks are retained by the index."""
        n = req.prompt_len // self.config.block_size
        if n:
            self.prefix_cache.insert(req.adapter, req.prompt,
                                     self.scheduler._blocks[slot][:n])

    # -- ticks ---------------------------------------------------------------
    def _draft_step(self, tables, positions, prev, override, use_override,
                    limits) -> torch.Tensor:
        """One draft decode step over every slot: the token is
        ``override`` where ``use_override`` holds, else the previous
        step's proposal (resolved on the device); returns the greedy
        proposals."""
        tokens = torch.where(use_override, override, prev)
        logits, self._draft_pool = paged_verify_step(
            self.draft_module.config, self.draft_params, self._draft_pool,
            tables, positions, tokens[:, None], limits,
            compute_dtype=self._draft_c, head_at=0,
        )
        return torch.argmax(logits, dim=-1)

    def _decode_tick(self, active: List[int]) -> None:
        """One token for every active slot (the plain path, and a
        speculative engine's tick when no slot drafts)."""
        t0 = time.monotonic()
        sch, dev = self.scheduler, self.device
        tables = self._tables(sch.block_tables, int(sch.seq_lens.max()) + 1)
        seq_lens = torch.tensor(sch.seq_lens, device=dev)
        cur = torch.tensor(self._cur_tokens, device=dev)
        ad, ad_ids = self._lora_inputs(sch.adapter_slots)
        logits, self._pool = paged_decode_step(
            self.cfg, self.params, self._pool, tables, seq_lens, cur,
            compute_dtype=self._c, adapters=ad, adapter_ids=ad_ids,
            lora_impl=self._lora_impl,
        )
        if self.draft_module is not None:
            # Mirror the write into the draft cache, so its frontier stays
            # true after a tick in which no slot drafted.
            ones = torch.ones(self.config.num_slots, dtype=torch.bool,
                              device=dev)
            self._draft_step(tables, seq_lens, cur, cur, ones, seq_lens + 1)
            self.stats.bump("draft_steps")
        toks = sample_tokens(
            logits, sch.temperatures.tolist(), sch.top_ks.tolist(),
            sch.sample_seeds.tolist(), sch.seq_lens.tolist(),
            base_seed=self.config.seed,
        ).tolist()  # the tick's one sync: it must emit tokens
        dt = time.monotonic() - t0
        self.stats.bump("decode_steps")
        self.stats.note_token_latency(dt, n_tokens=len(active))
        for slot in active:
            sch.seq_lens[slot] += 1
            sch.draft_lens[slot] = sch.seq_lens[slot]
            tok = toks[slot]
            self._cur_tokens[slot] = tok
            req = sch.slots[slot]
            if req.adapter is not None:
                self.stats.note_adapter(req.adapter, tokens=1)
            if sch.append_token(slot, tok):
                self._complete(slot)

    def _spec_tick(self, active: List[int], widths: List[int]) -> None:
        """One draft-propose / target-verify round.

        1. The draft proposes up to ``spec_k`` tokens a slot: ``spec_k +
           1`` draft decode steps chained on the device (the first one
           doubles as the catch-up write of a slot whose draft cache
           trails by the last tick's bonus token).
        2. The target scores every slot's window (current token and
           drafts) in one verify step, drawing its own token at each
           position from the request's position-keyed stream.
        3. The host keeps each slot's longest agreeing draft prefix plus
           the target's token at the first disagreement, emits them, and
           rolls both caches back to the emitted frontier.

        Greedy slots emit exactly what sequential decoding would: each
        accepted draft equals the target's argmax, and the corrected
        token is the target's argmax."""
        sched, dev = self.scheduler, self.device
        K, W = self.spec_k, self.config.num_slots
        t0 = time.monotonic()
        limits = np.zeros((W,), np.int64)
        for slot in active:
            limits[slot] = int(sched.seq_lens[slot]) + widths[slot] + 1
        occupied = np.array([r is not None for r in sched.slots])
        gaps = np.where(occupied, sched.seq_lens - sched.draft_lens, 0)
        # The first draft step's token: the emitted token at draft_lens
        # (the bonus-token catch-up) for a trailing slot, else the
        # current token.
        start = np.zeros((W,), np.int64)
        for slot in active:
            req = sched.slots[slot]
            if gaps[slot]:
                start[slot] = req.generated[
                    int(sched.draft_lens[slot]) - req.prompt_len]
            else:
                start[slot] = self._cur_tokens[slot]
        cur = torch.tensor(self._cur_tokens, device=dev)
        limits_t = torch.tensor(limits, device=dev)
        # Every write below a limit: the verify window and the draft chain.
        tables = self._tables(sched.block_tables,
                              int(sched.seq_lens.max()) + K + 1)
        draft_lens = torch.tensor(sched.draft_lens, device=dev)
        ones = torch.ones(W, dtype=torch.bool, device=dev)
        trailing = torch.tensor(gaps > 0, device=dev)
        outs = []
        prev = cur
        for j in range(K + 1):
            if j == 0:
                override, mask = torch.tensor(start, device=dev), ones
            elif j == 1:
                override, mask = cur, trailing
            else:
                override, mask = cur, torch.zeros_like(ones)
            prev = self._draft_step(tables, draft_lens + j, prev, override,
                                    mask, limits_t)
            outs.append(prev)
        self.stats.bump("draft_steps", K + 1)
        outs = torch.stack(outs).cpu().numpy()  # (K+1, W): host accept

        # Each slot's proposals: the K chain outputs from its gap on.
        window = np.zeros((W, K + 1), np.int64)
        window[:, 0] = self._cur_tokens
        for slot in active:
            g = int(gaps[slot])
            window[slot, 1:] = outs[g: g + K, slot]
        ad, ad_ids = self._lora_inputs(sched.adapter_slots)
        logits, self._pool = paged_verify_step(
            self.cfg, self.params, self._pool, tables,
            torch.tensor(sched.seq_lens, device=dev),
            torch.from_numpy(window).to(dev), limits_t,
            compute_dtype=self._c, adapters=ad, adapter_ids=ad_ids,
            lora_impl=self._lora_impl,
        )
        T = K + 1
        positions = (sched.seq_lens[:, None].astype(np.int64)
                     + np.arange(T)[None, :]).reshape(-1)
        sampled = sample_tokens(
            logits.reshape(W * T, -1), np.repeat(sched.temperatures, T)
            .tolist(), np.repeat(sched.top_ks, T).tolist(),
            np.repeat(sched.sample_seeds, T).tolist(), positions.tolist(),
            base_seed=self.config.seed,
        ).reshape(W, T).cpu().numpy()  # the verify's sync
        self.stats.bump("verify_steps")
        dt = time.monotonic() - t0

        total = 0
        for slot in active:
            w = widths[slot]
            drafts = window[slot, 1: w + 1]
            target = sampled[slot, : w + 1]
            accepted = accepted_drafts(drafts, target)
            emit = [int(t) for t in drafts[:accepted]]
            emit.append(int(target[accepted]))
            seq_was = int(sched.seq_lens[slot])
            draft_was = int(sched.draft_lens[slot])
            req = sched.slots[slot]
            n, done = sched.append_tokens(slot, emit)
            new_len = seq_was + n
            # Both caches back to the emitted frontier: the target wrote
            # the window, the draft chain K + 1 positions from its own
            # frontier; everything past new_len is rejected.
            sched.truncate_slot_to(slot, new_len)
            sched.draft_lens[slot] = min(draft_was + K + 1, new_len)
            self._cur_tokens[slot] = emit[n - 1]
            total += n
            self.stats.note_spec_slot(w, min(accepted, n), n)
            if req.adapter is not None:
                self.stats.note_adapter(req.adapter, tokens=n)
            if done:
                self._complete(slot)
        self.stats.bump("spec_ticks")
        self.stats.note_token_latency(dt, n_tokens=total)

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        """Drive the loop until the queue and the slots drain."""
        for _ in range(max_steps):
            self.step()
            if not self.scheduler.has_work():
                return
        raise RuntimeError(f"still busy after {max_steps} serve steps")

    def _complete(self, slot: int) -> None:
        if self.prefix_cache is not None:
            # The finished chain stays resident too: the prompt and every
            # generated token whose k/v was written (the last sampled one
            # never was), so a follow-up turn claims it whole.
            req = self.scheduler.slots[slot]
            toks = req.prompt + req.generated[:-1]
            n = len(toks) // self.config.block_size
            if n:
                self.prefix_cache.insert(req.adapter, toks,
                                         self.scheduler._blocks[slot][:n])
        req = self.scheduler.finish(slot)
        self.stats.note_completed(req.finished_t - req.arrival_t)
        if req.adapter is not None:
            self.stats.note_adapter(req.adapter, completed=1)
        self._finish_handle(req)

    def _finish_handle(self, req: Request) -> None:
        with self._lock:
            handle = self._handles.pop(req.rid, None)
        if handle is not None:
            handle._done.set()

    # -- multi-tenant LoRA ---------------------------------------------------
    def add_adapter(self, name: str, adapter: dict) -> int:
        """Load (or replace) one tenant's LoRA adapter; returns its pool
        slot.  Replacing an adapter a queued or active request decodes
        through is refused: its model would change mid-stream."""
        if self.adapters is None:
            raise ValueError(
                "engine has no adapter pool — build it with "
                "ServeConfig(max_adapters=N, adapter_rank=r)"
            )
        name = str(name)
        with self._lock:
            if self.adapters.has(name) \
                    and self.scheduler.references_adapter(name):
                raise RuntimeError(
                    f"adapter {name!r} is serving queued/active "
                    f"requests — replacing its factors would change "
                    f"their model mid-stream; drain the tenant first"
                )
            slot = self.adapters.add(name, adapter)
            if self.prefix_cache is not None:
                # The tenant's chains hold the replaced factors' KV.
                self._prefix_drops.append(name)
        self.stats.bump("adapter_loads")
        return slot

    def remove_adapter(self, name: str) -> None:
        """Free one tenant's pool slot; refused while a queued or active
        request references the name (a re-issued slot would serve it
        another tenant's delta)."""
        if self.adapters is None:
            raise ValueError("engine has no adapter pool")
        name = str(name)
        with self._lock:
            if self.scheduler.references_adapter(name):
                raise RuntimeError(
                    f"adapter {name!r} is serving queued/active "
                    f"requests — drain the tenant before removing it"
                )
            self.adapters.remove(name)
            if self.prefix_cache is not None:
                self._prefix_drops.append(name)
        self.stats.bump("adapter_unloads")

    def cancel(self, rid: str) -> bool:
        """Drop one request wherever it is, queued or mid-decode.
        Idempotent: unknown or finished rids return False."""
        with self._lock:
            req = self.scheduler.cancel(rid)
            if req is None:
                return False
            handle = self._handles.pop(rid, None)
        self.stats.bump("cancelled")
        req.finished_t = time.monotonic()
        if handle is not None:
            handle._done.set()
        return True

    # -- telemetry -----------------------------------------------------------
    def _refresh_gauges(self) -> None:
        gauges = self.scheduler.snapshot()
        if self.adapters is not None:
            pool = self.adapters.snapshot()
            gauges["lora_adapters_loaded"] = pool["loaded"]
            gauges["lora_slots_free"] = pool["slots_free"]
            counts = [t for t in
                      self.stats.adapter_token_counts().values() if t]
            # Fairness spread: min/max lifetime tokens across tenants
            # with traffic (1.0 = perfectly fair).
            gauges["lora_fairness_spread"] = (
                min(counts) / max(counts) if len(counts) > 1 else 1.0
            )
        self.stats.set_gauges(**gauges)
        if self.prefix_cache is not None:
            self.stats.set_prefix(**self.prefix_cache.stats())

    def snapshot(self) -> dict:
        """The live serve snapshot: counters, gauges, latency summaries
        and, on adapter-pool engines, the per-tenant block."""
        return self.stats.snapshot()
