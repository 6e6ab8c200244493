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

The engine is single-threaded over the device: drive it in-process with
:meth:`step` / :meth:`run_until_idle` (or :meth:`generate` for one
request), or :meth:`start` its serve thread and reach it from any process
through :meth:`queue_handle` and ``serve/client.py::ServeClient``.
:meth:`submit` is thread-safe.  The queue plane's requests
(``serve_request``, ``serve_cancel``, ``serve_adapter_load`` frames) are
drained at the top of every step; replies (a ``serve_token`` frame per
token, then ``serve_done``) go back over each client's own queue from the
serve thread.  ``deadline_s`` expires a request still queued past it.
Exports: ``telemetry_dir`` (``serve-live.json``), ``prom_file`` /
``prom_port`` (OpenMetrics), ``trace_dir`` (``trace-serve-<name>.jsonl``
at :meth:`stop`) and, with ``ServeConfig(capacity=True, slo=True)``, the
headroom oracle and the burn-rate SLOs on the export cadence.  A loop
that raises marks the engine dead and fails every pending request
loudly.

The disaggregated plane (``serve/dist``) reaches a decode replica through
the same inbox: a ``serve_kv_handoff`` frame carries a prefill worker's
k/v blocks and last-position logits, which admission scatters into this
engine's own blocks (``import_blocks``) and samples the first token from
exactly as the local prefill would; a ``serve_migration`` frame seats a
draining replica's resident sequence mid-decode (:meth:`export_resident`
is the other end).
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import queue as _pyqueue
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.cluster.shm import SegmentError
from ray_lightning_tpu_torch.device import resolve_device
from ray_lightning_tpu_torch.models.generate import _reject_unmerged_lora
from ray_lightning_tpu_torch.serve.kv_cache import (
    TRASH_BLOCK, PagedKVCache, PrefixIndex, import_blocks, paged_decode_step,
    paged_prefill, paged_verify_step, prepare_params, sample_tokens,
)
from ray_lightning_tpu_torch.serve.lora import AdapterPool
from ray_lightning_tpu_torch.serve.metrics import ServeStats
from ray_lightning_tpu_torch.serve.scheduler import (
    Request, Scheduler, derive_geometry,
)
from ray_lightning_tpu_torch.telemetry.propagate import (
    child_context, extract, root_context, sent_ts, trace_args,
)
from ray_lightning_tpu_torch.telemetry.spans import SpanTracer

log = logging.getLogger(__name__)

__all__ = ["ServeConfig", "ServeEngine", "ServeHandle", "ServeRejected"]

# A torn or vanished handoff payload: the failures of the read and the
# decode of a frame's bytes.
_PAYLOAD_ERRORS = (ValueError, TypeError, KeyError, OSError, SegmentError,
                   pickle.UnpicklingError, EOFError)
# How long a handoff or migration whose tenant has not landed yet waits
# for its serve_adapter_load frame (which rides another connection).
_ADAPTER_WAIT_S = 10.0


def accepted_drafts(drafts, target) -> int:
    """The length of the longest prefix of ``drafts`` that the target's
    own tokens at the same window positions (``target``) agree with."""
    n = 0
    while n < len(drafts) and drafts[n] == target[n]:
        n += 1
    return n


class ServeRejected(RuntimeError):
    """Admission backpressure (the queue is full) or a deadline that
    passed in the queue.  Typed so clients can retry with backoff without
    string matching."""


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
    # The serve thread's sleep between polls when there is no work.
    idle_wait_s: float = 0.002
    # Refresh cadence of the live exports (prom textfile, serve-live.json)
    # and of the SLO and capacity plane.
    export_every_s: float = 1.0
    # The headroom oracle (serve/capacity.py) and the burn-rate SLOs
    # (telemetry/slo.py), ticked on the export cadence; off by default.
    capacity: bool = False
    slo: bool = False
    # Time-series bin width of the plane's store.
    ts_interval_s: float = 1.0
    # Queue-wait bound (ms) of the stock serve_queue_wait SLO.
    slo_queue_wait_ms: float = 500.0
    # The stock SLOs' (fast_s, slow_s, burn bound) window pairs; None =
    # telemetry/slo.py's defaults.
    slo_windows: Optional[Tuple[Tuple[float, float, float], ...]] = None


class ServeHandle:
    """Host-side future for one request."""

    def __init__(self, rid: str, request: Request):
        self.rid = rid
        self.request = request
        self.error: Optional[BaseException] = None  # the loop's, if it died
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
        :class:`ServeRejected` on backpressure or expiry, ``RuntimeError``
        (chained to the loop's error) when the engine died with the
        request pending, ``TimeoutError`` when the request did not finish
        in time."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.rid} not finished within {timeout}s "
                f"(state={self.status})"
            )
        if self.error is not None:
            raise RuntimeError(
                f"serve engine died with request {self.rid} in flight"
            ) from self.error
        if self.request.done_reason in ("rejected", "expired"):
            raise ServeRejected(
                f"request {self.rid} {self.request.done_reason}"
            )
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
        telemetry_dir: where ``serve-live.json`` is refreshed.
        prom_file/prom_port: the OpenMetrics textfile and the localhost
            ``/metrics`` port (0 = ephemeral).
        trace_dir/trace_name: request spans, exported at :meth:`stop` as
            ``<trace_dir>/trace-serve-<trace_name>.jsonl``; no tracing
            without ``trace_dir``.
    """

    def __init__(self, module, params: Dict[str, Any],
                 config: Optional[ServeConfig] = None,
                 adapters: Optional[Dict[str, dict]] = None,
                 device=None, draft_module=None, draft_params=None,
                 telemetry_dir: Optional[str] = None,
                 prom_file: Optional[str] = None,
                 prom_port: Optional[int] = None,
                 trace_dir: Optional[str] = None,
                 trace_name: Optional[str] = None):
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
        self._started_t = time.monotonic()
        # Request spans (queue wait, prefill, first token, the request);
        # off without trace_dir, when record() returns at once.
        self._trace_dir = trace_dir
        self._trace_name = trace_name or uuid.uuid4().hex[:6]
        self.tracer = SpanTracer(enabled=trace_dir is not None,
                                 maxlen=16384, rank=0)
        self._handles: Dict[str, ServeHandle] = {}  # guarded by self._lock
        # Terminal (rid, status) pairs since the last drain_done(), bounded
        # for an engine nobody drains.
        self._done_feed: deque = deque(maxlen=4096)  # guarded by self._lock
        # Non-terminal (rid, error) handoff admissions that failed (a torn
        # or vanished payload), for a replica's beat: the router re-routes
        # the prefill.  Filled only with report_handoff_failures on (a
        # replica runner sets it); a standalone engine replies "invalid".
        self._failed_feed: deque = deque(maxlen=4096)  # guarded by self._lock
        self.report_handoff_failures = False
        # Handoff and migration frames waiting for their tenant's
        # serve_adapter_load frame, retried once a drain.
        self._deferred_inbox: deque = deque()
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._inbox = None  # DriverQueue, made at the first queue_handle()
        # Reply queues by client address.  The serve thread sends through
        # them and stop() closes them from the caller's thread, hence the
        # lock.
        self._reply_handles: Dict[Tuple[str, int], Any] = {}  # self._lock
        self._exporter = None
        self._live_path = None
        self._last_export = 0.0
        if prom_file or prom_port is not None:
            from ray_lightning_tpu_torch.telemetry.export_prom import (
                PromExporter,
            )

            self._exporter = PromExporter(textfile=prom_file, port=prom_port)
        if telemetry_dir:
            os.makedirs(telemetry_dir, exist_ok=True)
            self._live_path = os.path.join(telemetry_dir, "serve-live.json")
        # The SLO and capacity plane: host-side folds on the export
        # cadence, no device work.
        self._capacity = None
        self._slo = None
        self._slo_alerts: deque = deque(maxlen=256)
        if cfg.capacity or cfg.slo:
            from ray_lightning_tpu_torch.serve.capacity import CapacityOracle

            self._capacity = CapacityOracle(interval_s=cfg.ts_interval_s,
                                            clock=time.time)
            # The derived snapshot (model fit and trends) refreshes at
            # most once a second; exports in between reuse it.
            self._capacity_every_s = max(cfg.export_every_s, 1.0)
            self._last_capacity = 0.0
        if cfg.slo:
            from ray_lightning_tpu_torch.telemetry.slo import (
                SloEvaluator, default_serve_slos,
            )

            specs = default_serve_slos(cfg.slo_queue_wait_ms)
            if cfg.slo_windows is not None:
                windows = tuple(tuple(w) for w in cfg.slo_windows)
                specs = tuple(replace(s, windows=windows) for s in specs)
            self._slo = SloEvaluator(self._capacity.store, specs,
                                     clock=time.time,
                                     emit=self._slo_alerts.append)

    # -- requests ------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               temperature: float = 0.0,
               eos_token_id: Optional[int] = None,
               top_k: Optional[int] = None,
               spec: Optional[int] = None,
               adapter: Optional[str] = None,
               deadline_s: Optional[float] = None,
               sample_seed: Optional[int] = None,
               on_token=None, rid: Optional[str] = None,
               _handoff: Optional[dict] = None,
               _trace_ctx=None) -> ServeHandle:
        """Enqueue one request (thread-safe).  A backpressure rejection
        shows at once as ``handle.status == "rejected"`` (and ``result()``
        raises).  ``adapter`` decodes the request through that tenant's
        LoRA adapter; an unknown name or a pool-less engine is a
        ``ValueError``, never a silent fall back to the base model.
        ``sample_seed`` presets the request's sampling stream (None = the
        submission ordinal).  ``spec`` caps the request's drafted tokens
        a tick (None = the engine's ``spec_k``, 0 = plain decode).
        ``deadline_s`` expires the request if it is still queued that
        many seconds after arrival (``ServeRejected`` from ``result()``).
        A dead engine (its loop raised) refuses with ``RuntimeError``.
        ``_handoff`` (``serve/dist``) carries a prefill worker's decoded
        payload: admission imports it instead of prefilling."""
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
        if self._error is not None:
            raise RuntimeError(
                "serve engine is dead (its loop raised; see the chained "
                "error) — build a fresh ServeEngine"
            ) from self._error
        rid = rid or uuid.uuid4().hex[:12]
        trace_ctx, trace_local = _trace_ctx, False
        if trace_ctx is None and self.tracer.enabled:
            # No upstream context: this engine owns the trace's root.
            trace_ctx, trace_local = root_context(rid), True
        req = Request(
            rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=float(temperature), eos_token_id=eos_token_id,
            top_k=top_k, spec=spec, adapter=adapter, deadline_s=deadline_s,
            sample_seed=sample_seed, on_token=on_token, trace=trace_ctx,
        )
        req._trace_local = trace_local
        req._handoff = _handoff
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
            else:
                self._done_feed.append((rid, "rejected"))
        if not accepted:
            self.stats.bump("rejected")
            req.finished_t = time.monotonic()
            handle._done.set()
        return handle

    def generate(self, prompt: Sequence[int], max_new_tokens: int,
                 timeout: Optional[float] = 60.0, **kw) -> List[int]:
        """Blocking convenience: submit, drive until idle (when no serve
        thread runs), return the generated tokens."""
        handle = self.submit(prompt, max_new_tokens, **kw)
        if self._thread is None:
            self.run_until_idle()
        return handle.result(timeout)

    # -- the loop ------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> bool:
        """One serve iteration: drain the queue plane, expire and admit
        (one prefill per admission, or a chunk job), one chunk for every
        chunk job, grow or preempt, one decode or draft → verify tick,
        the live exports.  Returns True when any work was done.  Grad
        mode is per thread, so the step turns it off itself: no served
        tensor requires grad on any thread."""
        self._drain_inbox()
        with self._lock:
            if self.prefix_cache is not None and self._prefix_drops:
                # Replaced or removed tenants' chains go before any claim.
                for name in self._prefix_drops:
                    self.prefix_cache.drop(name)
                self._prefix_drops.clear()
            admissions, expired = self.scheduler.poll()
        worked = bool(admissions) or bool(expired)
        for req in expired:
            self.stats.bump("expired")
            self._finish_handle(req)
        now = time.monotonic()
        t_adm = now
        tr = self.tracer
        for slot, req, bucket in admissions:
            wait = now - req.arrival_t
            self.stats.note_admitted(wait)
            ctx = req.trace if tr.enabled else None
            if ctx is not None:
                tr.record("queue_wait", time.time() - wait, wait,
                          args=trace_args(child_context(ctx), rid=req.rid,
                                          preemptions=req.preemptions))
                self.stats.note_phase("queue_wait", wait)
            t_ph = time.time() if ctx is not None else 0.0
            handoff = None
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
            elif req._handoff is not None:
                # A prefill worker ran this prompt: its blocks go into this
                # engine's blocks and the first token is drawn from its
                # logits, as the local prefill would draw it.  The payload
                # is dropped here, so a preempted request recomputes.
                handoff, req._handoff = req._handoff, None
                self.stats.bump("kv_imports")
                first = self._import_prefill(slot, req, bucket, handoff)
            else:
                self.stats.bump("prefills")
                first = self._prefill(slot, req, bucket)
            # The first token's read synced the device: the interval
            # covers the prefill's dispatch and compute.
            t_first = time.monotonic()
            self.stats.bump("admit_us", int((t_first - t_adm) * 1e6))
            t_adm = t_first
            if ctx is not None:
                t_sync = time.time()
                phase = ("decode_admission" if handoff is not None
                         else "prefill_compute")
                tr.record(phase, t_ph, max(0.0, t_sync - t_ph),
                          args=trace_args(child_context(ctx), rid=req.rid,
                                          bucket=bucket))
                self.stats.note_phase(phase, t_sync - t_ph)
            self._first_token(slot, req, first)
            if ctx is not None:
                ft_dur = max(0.0, time.time() - t_sync)
                tr.record("first_token", t_sync, ft_dur,
                          args=trace_args(child_context(ctx), rid=req.rid,
                                          token_index=0))
                self.stats.note_phase("first_token", ft_dur)

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
        self._maybe_export()
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

    def _import_prefill(self, slot: int, req: Request, bucket: int,
                        handoff: dict) -> int:
        """Admit a handed-off request: scatter the worker's blocks into
        the slot's bucket blocks and draw the first token from the shipped
        logits (the draft still prefills, on a speculative engine).  On a
        draft-less engine no prompt tokens go to the device."""
        dev = self.device
        ids = torch.tensor(
            self.scheduler._blocks[slot][: bucket // self.config.block_size],
            dtype=torch.long, device=dev,
        )
        self._pool = import_blocks(self._pool, handoff["kv"], ids)
        if self.draft_module is not None:
            padded = np.zeros((bucket,), np.int64)
            padded[: req.prompt_len] = req.prompt
            _, self._draft_pool = paged_prefill(
                self.draft_module.config, self.draft_params,
                self._draft_pool, torch.from_numpy(padded).to(dev),
                req.prompt_len, ids, compute_dtype=self._draft_c,
            )
        logits = torch.tensor(np.asarray(handoff["logits"]),
                              dtype=torch.float32, device=dev)
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
        later write lands past the claimed blocks.  A handoff never
        claims: its payload covers the whole prompt and scatters into
        private blocks."""
        if req._handoff is not None:
            return []
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
        # The tick's wall in µs: with decode_steps and tokens_out the
        # capacity oracle's tick-cost fit.
        self.stats.bump("decode_us", int(dt * 1e6))
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
        # Busy time as on the plain tick, for the capacity oracle.
        self.stats.bump("decode_us", int(dt * 1e6))

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
        e2e = req.finished_t - req.arrival_t
        self.stats.note_completed(e2e)
        if req.adapter is not None:
            self.stats.note_adapter(req.adapter, completed=1)
        if (self.tracer.enabled and req.trace is not None
                and getattr(req, "_trace_local", False)):
            # A trace this engine owns gets its root span here.
            self.tracer.record(
                "request", time.time() - e2e, e2e,
                args=trace_args(req.trace, rid=req.rid,
                                status=req.state.value),
            )
        self._finish_handle(req)

    def _finish_handle(self, req: Request) -> None:
        with self._lock:
            handle = self._handles.pop(req.rid, None)
            self._done_feed.append((req.rid, req.state.value))
        if handle is not None:
            handle._done.set()
        self._reply_done(req)

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

    def adapter_names(self) -> List[str]:
        """The loaded tenants' names."""
        return [] if self.adapters is None else self.adapters.names()

    def drain_done(self) -> List[Tuple[str, str]]:
        """Terminal ``(rid, status)`` pairs since the last call (the
        completion feed a router prunes its in-flight tracking from)."""
        with self._lock:
            items = list(self._done_feed)
            self._done_feed.clear()
        return items

    def drain_failed(self) -> List[Tuple[str, str]]:
        """Non-terminal ``(rid, error)`` handoff admissions that failed
        since the last call (a replica beat's ``failed`` feed, with
        ``report_handoff_failures`` on): the router re-dispatches each
        prefill, never a terminal reply."""
        with self._lock:
            items = list(self._failed_feed)
            self._failed_feed.clear()
        return items

    def cancel(self, rid: str) -> bool:
        """Drop one request wherever it is, queued or mid-decode.
        Idempotent: unknown or finished rids return False.  The terminal
        status is ``cancelled``, in the done feed and, for a queue-plane
        request, a ``serve_done`` reply."""
        with self._lock:
            req = self.scheduler.cancel(rid)
            if req is None:
                return False
            handle = self._handles.pop(rid, None)
            self._done_feed.append((rid, "cancelled"))
        self.stats.bump("cancelled")
        req.finished_t = time.monotonic()
        if handle is not None:
            handle._done.set()
        reply = getattr(req, "_reply", None)
        if reply is not None:
            self._reply(reply, {
                "type": "serve_done", "rid": rid,
                "status": "cancelled", "reason": "cancelled",
                "tokens": [int(t) for t in req.generated],
            })
        return True

    # -- the serve thread ----------------------------------------------------
    def start(self) -> "ServeEngine":
        """Run :meth:`step` on a background thread until :meth:`stop`."""
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._serve_forever, name="rlt-serve", daemon=True
        )
        self._thread.start()
        return self

    def _serve_forever(self) -> None:
        # The current CUDA device is per thread: serve on the engine's.
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            try:
                worked = self.step()
            except Exception as e:  # noqa: BLE001 - a dying loop fails
                # its pending work loudly, never strands it
                self._fail_pending(e)
                return
            if not worked:
                time.sleep(self.config.idle_wait_s)

    def _fail_pending(self, exc: BaseException) -> None:
        """The serve loop died: mark the engine dead (submit refuses from
        now on), fail every pending handle with the error and tell each
        queue-plane client (``serve_done(status="error")``)."""
        self._error = exc
        with self._lock:
            handles = list(self._handles.values())
            self._handles.clear()
        log.error("serve loop died: %r — failing %d pending request(s)",
                  exc, len(handles), exc_info=exc)
        for handle in handles:
            handle.error = exc
            req = handle.request
            reply = getattr(req, "_reply", None)
            if reply is not None:
                self._reply(reply, {
                    "type": "serve_done", "rid": req.rid,
                    "status": "error", "error": repr(exc),
                    "tokens": [int(t) for t in req.generated],
                })
            handle._done.set()

    def halt_loop(self) -> None:
        """Stop the serve thread without tearing the engine down
        (:meth:`stop` also closes the queues and exporters)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def export_resident(self) -> List[dict]:
        """Every resident decoding sequence's k/v blocks and position:
        the payload of a planned drain's live migration.  Call with the
        loop halted (:meth:`halt_loop`).  Queued requests and chunked
        prefills in flight are not exported: they have emitted nothing
        worth moving, and the router's recompute failover covers them.
        ``seq_len`` is prompt + generated - 1 (the last sampled token's
        k/v is written by its own tick), so ``ceil(seq_len /
        block_size)`` blocks hold all a survivor needs.  ``req`` is a
        ``serve_request`` body (the JAX engine's lacks the ``type`` key,
        which the JAX package's ``validate_serve_migration`` requires)."""
        out = []
        sched = self.scheduler
        Bs = self.config.block_size
        for slot, req in enumerate(sched.slots):
            if req is None or slot in self._chunk_jobs or not req.generated:
                continue
            seq_len = int(sched.seq_lens[slot])
            ids = sched._blocks[slot][: -(-seq_len // Bs)]
            fields = {
                "type": "serve_request",
                "rid": req.rid, "prompt": list(req.prompt),
                "max_new_tokens": int(req.max_new_tokens),
                "temperature": float(req.temperature),
                "eos_token_id": req.eos_token_id,
                "top_k": req.top_k,
                "adapter": req.adapter,
                "priority": int(req.priority),
                "sample_seed": req.sample_seed,
            }
            reply = getattr(req, "_reply", None)
            if reply is not None:
                fields["reply"] = list(reply)
            out.append({
                "req": fields,
                "generated": list(req.generated),
                "cur_token": int(self._cur_tokens[slot]),
                "seq_len": seq_len,
                "kv": self.cache.export_blocks(self._pool, ids),
            })
        return out

    def stop(self) -> None:
        """Stop the serve thread, close the inbox and reply queues, make
        the last export and write the span file."""
        self.halt_loop()
        if self.prefix_cache is not None:
            self.prefix_cache.drop_all()
        if self._inbox is not None:
            self._inbox.shutdown()
            self._inbox = None
        with self._lock:
            reply_handles = list(self._reply_handles.values())
            self._reply_handles.clear()
        for h in reply_handles:
            h.close()
        # The last export is unthrottled: counters bumped inside the last
        # export_every_s still reach the files.
        self._maybe_export(force=True)
        if self._exporter is not None:
            self._exporter.close()
        if self._trace_dir is not None and self.tracer.events():
            try:
                os.makedirs(self._trace_dir, exist_ok=True)
                self.tracer.export_jsonl(os.path.join(
                    self._trace_dir, f"trace-serve-{self._trace_name}.jsonl"))
            except OSError:
                pass  # a full disk must not fail the teardown
        # Segments of dead producers that no consumer will read (a KV
        # handoff's producer killed mid-send) are reclaimed here.
        from ray_lightning_tpu_torch.cluster.shm import sweep_stale_segments

        sweep_stale_segments("rlt-kv")

    # -- the queue plane -----------------------------------------------------
    def queue_handle(self):
        """The picklable submission handle a ``ServeClient`` takes (the
        TCP inbox is made at the first call)."""
        if self._inbox is None:
            from ray_lightning_tpu_torch.cluster.queue import DriverQueue

            self._inbox = DriverQueue()
        return self._inbox.handle

    def _drain_inbox(self) -> None:
        if self._inbox is None:
            return
        items = []
        while True:
            try:
                items.append(self._inbox.get_nowait())
            except _pyqueue.Empty:
                break
        if self._deferred_inbox:
            # One retry a drain, after this drain's frames: an adapter-load
            # frame that just landed lets its deferred handoffs through.
            retry, self._deferred_inbox = self._deferred_inbox, deque()
            items.extend(retry)
        for item in items:
            try:
                self._handle_queue_request(item)
            except Exception as e:  # noqa: BLE001 - a bad frame must
                # never take the serve loop down
                log.warning("serve: dropped malformed queue request: %s", e)

    def _handle_queue_request(self, item: dict) -> None:
        if not isinstance(item, dict):
            raise ValueError(f"not a serve item: {type(item).__name__}")
        kind = item.get("type")
        if kind == "serve_adapter_load":
            # A tenant hot-loaded from the queue plane, on the serve
            # thread between ticks.
            self._load_adapter_item(item)
            return
        if kind == "serve_cancel":
            self.cancel(str(item["rid"]))
            return
        if kind in ("serve_kv_handoff", "serve_migration"):
            fields = dict(item["req"])
            adapter = fields.get("adapter")
            if (adapter is not None and self.adapters is not None
                    and not self.adapters.has(str(adapter))):
                # The tenant's serve_adapter_load frame rides the
                # router's lane, the handoff the worker's: it may arrive
                # first.  Defer on a wall-clock deadline, checked before
                # the payload is read, so a read-once segment survives.
                deadline = item.get("_adapter_wait_deadline")
                if deadline is None:
                    deadline = time.monotonic() + _ADAPTER_WAIT_S
                    item["_adapter_wait_deadline"] = deadline
                if time.monotonic() < deadline:
                    self._deferred_inbox.append(item)
                    return
        elif kind == "serve_request":
            fields = item
        else:
            raise ValueError(f"not a serve request/handoff: {kind!r}")
        rid = str(item["rid"])
        reply = tuple(fields["reply"])  # (host, port)
        if kind == "serve_migration":
            self._admit_migration(item, fields, rid, reply)
            return
        if item.get("hedge"):
            # A hedged duplicate reaching a single engine: the first
            # admission already decodes this rid.
            with self._lock:
                if rid in self._handles:
                    return

        def on_token(i: int, tok: int) -> None:
            self._reply(reply, {
                "type": "serve_token", "rid": rid, "index": i,
                "token": int(tok),
            })

        try:
            handoff = (self._decode_handoff(item)
                       if kind == "serve_kv_handoff" else None)
            trace_ctx = None
            if self.tracer.enabled:
                # The request carries the router's context (the trace
                # root); a handoff envelope also carries the worker's span
                # and its send time, booked here at the read, where
                # queue_wait begins.
                trace_ctx = extract(fields)
                h_sent = sent_ts(item) if handoff is not None else None
                if h_sent is not None and trace_ctx is not None:
                    h_dur = max(0.0, time.time() - h_sent)
                    self.tracer.record(
                        "handoff_transfer", h_sent, h_dur,
                        args=trace_args(
                            child_context(extract(item) or trace_ctx),
                            rid=rid))
                    self.stats.note_phase("handoff_transfer", h_dur)
            handle = self._submit_fields(
                fields, on_token, rid, spec=fields.get("spec"),
                deadline_s=fields.get("deadline_s"), _handoff=handoff,
                _trace_ctx=trace_ctx,
            )
        except _PAYLOAD_ERRORS as e:
            # A bad field once the reply address is known: the typed
            # "invalid" reply, never a silent drop that leaves the client
            # waiting for its timeout (and a router counting a phantom
            # request against this replica).
            if kind == "serve_kv_handoff" and self.report_handoff_failures:
                # On a replica a torn or vanished payload is the
                # prefill's failure, not the request's: the beat's failed
                # feed has the router re-dispatch the prefill.
                with self._lock:
                    self._failed_feed.append((rid, repr(e)))
                return
            with self._lock:
                self._done_feed.append((rid, "invalid"))
            self._reply(reply, {
                "type": "serve_done", "rid": rid, "status": "invalid",
                "error": str(e), "tokens": [],
            })
            return
        handle.request._reply = reply
        if handle.status == "rejected":
            self._reply_done(handle.request)

    def _submit_fields(self, fields: dict, on_token, rid: str,
                       **extra) -> ServeHandle:
        """``submit`` a wire request's fields: a ``serve_request``, a
        handoff's ``req`` (``extra`` adds its spec, deadline, payload and
        trace) or a migration's recompute fallback."""
        return self.submit(
            fields["prompt"], int(fields["max_new_tokens"]),
            temperature=float(fields.get("temperature", 0.0)),
            eos_token_id=fields.get("eos_token_id"),
            top_k=fields.get("top_k"),
            adapter=fields.get("adapter"),
            sample_seed=fields.get("sample_seed"),
            on_token=on_token, rid=rid, **extra,
        )

    def _decode_handoff(self, item: dict) -> dict:
        """The ``{"kv", "logits"}`` payload of a ``serve_kv_handoff``
        frame (a segment is read once and unlinked).  A worker and a
        replica whose block geometry differs is a deployment bug: the
        typed ``ValueError`` fails the request loudly."""
        from ray_lightning_tpu_torch.serve.dist.handoff import (
            decode_kv_payload,
        )

        tree = decode_kv_payload(item)
        bucket = int(item["bucket"])
        n_blocks = int(tree["kv"]["k"].shape[1])
        expect = self.scheduler.bucket_for(int(item["prompt_len"]))
        if bucket != expect or n_blocks * self.config.block_size != bucket:
            raise ValueError(
                f"kv handoff geometry mismatch: worker bucket {bucket} "
                f"({n_blocks} blocks of {self.config.block_size}) vs "
                f"replica bucket {expect} — prefill worker and decode "
                f"replica must share block_size/bucket config"
            )
        return tree

    def _admit_migration(self, item: dict, fields: dict, rid: str,
                         reply: Tuple[str, int]) -> None:
        """One ``serve_migration`` frame: seat a draining replica's
        resident sequence mid-decode (its blocks imported, its emitted
        tokens kept) and continue at the position the source stopped;
        the position-keyed sampler continues the same stream.  When the
        adoption fails (no slot, pool dry, a malformed payload) the
        request is submitted afresh with the same seed: a recompute whose
        re-emitted indices the client dedups.  A frame with no payload at
        all is malformed and answered ``invalid`` with the error a handoff
        without one gets (the JAX engine recomputes it)."""
        if item.get("shm") is None and "data" not in item:
            with self._lock:
                self._done_feed.append((rid, "invalid"))
            self._reply(reply, {
                "type": "serve_done", "rid": rid, "status": "invalid",
                "error": str(KeyError("data")), "tokens": [],
            })
            return

        def on_token(i: int, tok: int) -> None:
            self._reply(reply, {
                "type": "serve_token", "rid": rid, "index": i,
                "token": int(tok),
            })

        try:
            adopted = self._adopt_migration(item, fields, rid, reply,
                                            on_token)
        except _PAYLOAD_ERRORS as e:
            log.warning("serve: migration adopt failed for %s (%s) — "
                        "recompute fallback", rid, e)
            adopted = False
        if adopted:
            self.stats.bump("migrations_in")
            return
        self.stats.bump("migration_fallbacks")
        try:
            handle = self._submit_fields(fields, on_token, rid)
        except (ValueError, TypeError, KeyError, OSError) as e:
            with self._lock:
                self._done_feed.append((rid, "invalid"))
            self._reply(reply, {
                "type": "serve_done", "rid": rid, "status": "invalid",
                "error": str(e), "tokens": [],
            })
            return
        handle.request._reply = reply
        if handle.status == "rejected":
            self._reply_done(handle.request)

    def _adopt_migration(self, item: dict, fields: dict, rid: str,
                         reply: Tuple[str, int], on_token) -> bool:
        """Seat one migrated sequence.  True = adopted (decode resumes at
        ``seq_len`` on the next tick); False = no slot or blocks free.  A
        malformed frame raises."""
        from ray_lightning_tpu_torch.serve.dist.handoff import (
            decode_kv_payload,
        )

        sched = self.scheduler
        Bs = self.config.block_size
        prompt = [int(t) for t in fields["prompt"]]
        generated = [int(t) for t in item["generated"]]
        max_new = int(fields["max_new_tokens"])
        seq_len = int(item["seq_len"])
        cur_token = int(item["cur_token"])
        if not generated or len(generated) >= max_new:
            raise ValueError("migration carries no live decode position")
        if seq_len != len(prompt) + len(generated) - 1:
            raise ValueError(
                f"migration position mismatch: seq_len {seq_len} != "
                f"prompt {len(prompt)} + generated {len(generated)} - 1"
            )
        if len(prompt) + max_new > self.max_model_len:
            raise ValueError(
                f"migrated request exceeds max_model_len "
                f"({self.max_model_len})"
            )
        sample_seed = fields.get("sample_seed")
        if sample_seed is None:
            raise ValueError(
                "migration without a sample_seed — the continued stream "
                "would not replay the source's"
            )
        n_blocks = -(-seq_len // Bs)
        kv = decode_kv_payload(item)["kv"]
        if int(kv["k"].shape[1]) != n_blocks:
            raise ValueError(
                f"migration payload carries {int(kv['k'].shape[1])} "
                f"blocks, position {seq_len} needs {n_blocks} — source "
                f"and survivor must share block_size"
            )
        with self._lock:
            ids = sched._alloc(n_blocks)
        if ids is None:
            return False
        ok = False
        try:
            self._pool = import_blocks(
                self._pool, kv,
                torch.tensor(ids, dtype=torch.long, device=self.device))
            req = Request(
                rid=rid, prompt=prompt, max_new_tokens=max_new,
                temperature=float(fields.get("temperature", 0.0)),
                eos_token_id=fields.get("eos_token_id"),
                top_k=fields.get("top_k"),
                # The draft cache never saw this sequence: plain decode
                # (a width-0 slot of a speculative tick emits exactly the
                # plain token).
                spec=0,
                adapter=fields.get("adapter"),
                priority=int(fields.get("priority") or 0),
                sample_seed=int(sample_seed),
                on_token=on_token,
            )
            req.generated = generated
            handle = ServeHandle(rid, req)
            with self._lock:
                if req.adapter is not None:
                    if self.adapters is None:
                        raise ValueError(
                            f"migrated request names adapter "
                            f"{req.adapter!r} but this engine has no "
                            f"adapter pool"
                        )
                    try:
                        req._adapter_slot = self.adapters.slot_of(
                            req.adapter)
                    except KeyError:
                        raise ValueError(
                            f"unknown adapter {req.adapter!r} on the "
                            f"migration survivor"
                        ) from None
                slot = sched.adopt(req, ids, seq_len)
                if slot is None:
                    return False
                self.stats.bump("submitted")
                self._handles[rid] = handle
            self._cur_tokens[slot] = cur_token
            req._reply = reply
            ok = True
            return True
        finally:
            if not ok:
                with self._lock:
                    sched.allocator.free(ids)

    def _load_adapter_item(self, item: dict) -> None:
        """One ``serve_adapter_load`` frame: decode its ``data`` or
        ``shm`` payload and add the tenant.  A failure raises into
        ``_drain_inbox``, which logs it; the tenant's requests then come
        back ``invalid`` ("unknown adapter"), so a failed load is never
        silent.  Replacing a tenant that requests still use is refused
        (``add_adapter``): the pool is written in place, and a write must
        never race a tick that reads the slot."""
        from ray_lightning_tpu_torch.serve.lora import decode_adapter

        if self.adapters is None:
            raise ValueError(
                "serve_adapter_load on an engine without an adapter pool "
                "(ServeConfig.max_adapters == 0)"
            )
        rank = item.get("rank")
        if rank is not None and int(rank) != self.adapters.rank:
            raise ValueError(
                f"serve_adapter_load of rank {rank} into a pool of rank "
                f"{self.adapters.rank}"
            )
        self.add_adapter(str(item["name"]), decode_adapter(item))

    def _reply_done(self, req: Request) -> None:
        reply = getattr(req, "_reply", None)
        if reply is None:
            return
        self._reply(reply, {
            "type": "serve_done", "rid": req.rid,
            "status": req.state.value, "reason": req.done_reason,
            "tokens": [int(t) for t in req.generated],
        })

    def _reply(self, addr: Tuple[str, int], item: dict) -> None:
        """Send one reply frame; a client that went away loses its
        stream and the engine keeps serving the others."""
        from ray_lightning_tpu_torch.cluster.queue import QueueHandle

        with self._lock:
            handle = self._reply_handles.get(addr)
            if handle is None:
                handle = QueueHandle(addr[0], addr[1])
                self._reply_handles[addr] = handle
        try:
            handle.put(item)
        except (OSError, ConnectionError):
            with self._lock:
                self._reply_handles.pop(addr, None)

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
        if self.prefix_cache is not None:
            ps = self.prefix_cache.stats()
            hit_rate = ps["hits"] / ps["lookups"] if ps["lookups"] else 0.0
            gauges["prefix_cache_hit_rate"] = hit_rate
            gauges["prefix_cached_blocks"] = ps["cached_blocks"]
            self.stats.set_prefix(hit_rate=hit_rate, **ps)
        if self.spec_k > 0:
            counters = self.stats.counters
            drafted = counters.get("spec_drafted", 0)
            gauges["spec_acceptance_rate"] = (
                counters.get("spec_accepted", 0) / drafted if drafted
                else 0.0
            )
            elapsed = max(time.monotonic() - self._started_t, 1e-9)
            # Goodput: the emitted tokens a second clients see.
            gauges["spec_goodput_tokens_per_sec"] = (
                counters.get("spec_emitted", 0) / elapsed
            )
        self.stats.set_gauges(**gauges)

    @property
    def capacity_oracle(self):
        """The headroom oracle (``serve/capacity.py``) when the capacity
        plane is on, else None."""
        return self._capacity

    @property
    def slo_evaluator(self):
        """The burn-rate evaluator (``telemetry/slo.py``) when the SLO
        plane is on, else None."""
        return self._slo

    @property
    def slo_alerts(self) -> List[dict]:
        """Fired ``slo_alert`` events (a bounded ring, newest last)."""
        return list(self._slo_alerts)

    def snapshot(self) -> dict:
        """The live serve snapshot: counters, gauges, latency summaries,
        and where they apply the per-tenant, prefix-cache, phase and
        ``capacity`` blocks."""
        snap = self.stats.snapshot()
        if self._capacity is not None and self._capacity.last is not None:
            snap["capacity"] = dict(self._capacity.last)
        return snap

    def _maybe_export(self, force: bool = False) -> None:
        """On the export cadence: tick the SLO and capacity plane, then
        refresh the OpenMetrics text and ``serve-live.json``.  The JAX
        package's ``programs`` key (its program ledger) is not ported."""
        if self._exporter is None and self._live_path is None \
                and self._capacity is None:
            return
        now = time.monotonic()
        if not force and now - self._last_export < self.config.export_every_s:
            return
        self._last_export = now
        if self._capacity is not None:
            # The cheap stats slice; recompiles are CUDA-graph captures on
            # the port, and the eager server captures none.
            self._capacity.observe(self.stats.capacity_view(), recompiles=0)
            if force or now - self._last_capacity >= self._capacity_every_s:
                self._last_capacity = now
                self._capacity.snapshot()  # cached on .last
        if self._slo is not None:
            fired = self._slo.evaluate()
            if fired:
                self.stats.bump("slo_alerts", len(fired))
        if self._exporter is None and self._live_path is None:
            return
        snap = self.snapshot()
        payload = {"serve": snap}
        if self._slo is not None:
            payload["slo"] = self._slo.snapshot()
        if self._exporter is not None:
            self._exporter.update(payload)
        if self._live_path is not None:
            tmp = self._live_path + ".tmp"
            try:
                with open(tmp, "w") as f:
                    json.dump({"ts": snap["ts"], **payload}, f)
                os.replace(tmp, self._live_path)
            except OSError:
                pass  # a full disk must not take the serve loop down
