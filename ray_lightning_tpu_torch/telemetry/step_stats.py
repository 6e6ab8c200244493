"""Step-stats engine: where the step time goes, and how fast it is.  A
copy of ``ray_lightning_tpu/telemetry/step_stats.py`` for one device.

Per-step wall time is split into three host-observable phases:

* **data_wait**: time the loop spent waiting for the next batch;
* **dispatch**: time inside the step call.  Kernels are queued on the
  card and run after the call returns, so this is host issue cost, not
  device compute (the autograd and Python work of an eager step; one
  ``CUDAGraph.replay`` of a captured stride);
* **device step**: measured on a periodic sampling window: every
  ``sample_every``-th step the loop records a CUDA event after the step
  and waits for it, so that step's wall time includes device execution.
  Between samples the host keeps queuing ahead of the card; at each
  epoch's end the loop waits for what is still queued and books the wait
  into the last step or stride (:meth:`StepStats.record_drain`), so the
  step times cover the device time at any fit length.

On top of the split: examples/sec and tokens/sec, an analytic-FLOPs MFU
for the GPT family against the card's dense bf16 peak, and a count of
CUDA-graph captures in the place where the JAX package counts backend
compiles (``recompiles``).

The first record is booked as **compile** (for a captured megastep, the
eager warm-up stride and the capture) and kept out of the steady-state
aggregates.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = [
    "StepStats",
    "model_flops_per_token",
    "flops_for_module",
    "peak_flops_per_chip",
]


# ---------------------------------------------------------------------------
# Analytic FLOPs (the published-MFU accounting)
# ---------------------------------------------------------------------------

def model_flops_per_token(cfg: Any, attn: str = "full") -> float:
    """Fwd+bwd matmul FLOPs per token for the GPT family (backward = 2x
    forward, no remat-recompute credit).

    ``attn="full"`` charges the full S² attention matrix (the standard
    published-MFU convention); ``attn="causal"`` charges the causal half
    the kernels actually execute.
    """
    d, L, s, V = cfg.d_model, cfg.n_layer, cfg.seq_len, cfg.vocab_size
    mm = 24 * L * d * d          # qkv + proj + mlp weight matmuls
    attn_term = 4 * L * s * d    # QK^T and AV, full square
    if attn == "causal":
        attn_term /= 2
    head = 2 * d * V             # tied LM head
    return 3.0 * (mm + attn_term + head)


def flops_for_module(module: Any) -> Tuple[Optional[float], Optional[int]]:
    """``(flops_per_example, tokens_per_example)`` for a known model
    family (the port has GPT), ``(None, None)`` otherwise: MFU is then
    not reported, never guessed."""
    cfg = getattr(module, "cfg", None) or getattr(module, "config", None)
    if cfg is None or type(cfg).__name__ != "GPTConfig":
        return None, None
    try:
        return model_flops_per_token(cfg) * cfg.seq_len, cfg.seq_len
    except AttributeError:
        return None, None


# Dense bf16 tensor-core peak by device-name substring (NVIDIA's data
# sheets, SXM parts at their full power limit).
_PEAK_FLOPS = (
    ("H100 80GB HBM3", 989.4e12),   # H100 SXM
    ("H100 SXM", 989.4e12),
)


def peak_flops_per_chip(device: Any = None) -> Optional[float]:
    """Dense bf16 peak of ``device``, or ``None`` where none is known:
    the CPU, and any card not named in the table (an "MFU" against a
    guessed denominator would be noise).  ``RLT_TELEMETRY_PEAK``
    overrides (also how CPU tests pin the MFU math)."""
    env = os.environ.get("RLT_TELEMETRY_PEAK")
    if env:
        return float(env)
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev)
    for key, peak in _PEAK_FLOPS:
        if key in name:
            return peak
    return None


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class _Agg:
    """Running min/max/sum of one per-step duration."""

    __slots__ = ("n", "total", "min", "max", "_before")

    def __init__(self):
        self.n = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self._before = None

    def add(self, v: float) -> None:
        self.add_scaled(v, 1)

    def add_scaled(self, total: float, n: int) -> None:
        """Book ``n`` steps observed as ONE wall measurement (a megastep
        stride): the mean stays exact; min/max see the stride's per-step
        average."""
        self._before = (self.n, self.total, self.min, self.max, total)
        self.n += n
        self.total += total
        per = total / n
        if per < self.min:
            self.min = per
        if per > self.max:
            self.max = per

    def extend_last(self, extra: float) -> None:
        """Add ``extra`` seconds to the last measurement booked, as if it
        had been booked so."""
        n0, total0, min0, max0, last = self._before
        n = self.n - n0
        self.n, self.total, self.min, self.max = n0, total0, min0, max0
        self.add_scaled(last + extra, n)

    def summary_ms(self) -> Dict[str, float]:
        if not self.n:
            return {}
        return {
            "mean_ms": 1e3 * self.total / self.n,
            "min_ms": 1e3 * self.min,
            "max_ms": 1e3 * self.max,
        }


class StepStats:
    """Aggregates the per-step timing split for one fit.  The loop owns
    the clocks and feeds each step via :meth:`record_step` or each
    megastep stride via :meth:`record_stride`; this class only
    aggregates (float math, no device traffic)."""

    def __init__(self, sample_every: int = 32,
                 flops_per_example: Optional[float] = None,
                 tokens_per_example: Optional[int] = None,
                 peak_flops: Optional[float] = None):
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        self.sample_every = sample_every
        self.flops_per_example = flops_per_example
        self.tokens_per_example = tokens_per_example
        self.mfu_basis = "analytic"
        self.peak_flops = peak_flops
        self.device: Optional[torch.device] = None
        self.captures = 0
        self.capture_s = 0.0
        self.compile_ms: Optional[float] = None
        self.steps = 0
        self.examples = 0
        self.tokens = 0
        self._step = _Agg()
        self._data_wait = _Agg()
        self._dispatch = _Agg()
        self._device = _Agg()   # sampled steps only
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        # Whether the last record was sampled; None when it was booked
        # as compile.
        self._last_sampled: Optional[bool] = None

    def configure_model(self, module: Any, device: Any = None) -> None:
        """Late-bind the analytic-FLOPs model and the card's peak (the
        loop knows the module and device after telemetry is built)."""
        if self.flops_per_example is None:
            fpe, tpe = flops_for_module(module)
            self.flops_per_example = fpe
            self.tokens_per_example = tpe
        if device is not None:
            self.device = torch.device(device)
        if self.peak_flops is None:
            self.peak_flops = peak_flops_per_chip(self.device)

    # -- per-step feed ------------------------------------------------------
    def should_sample(self) -> bool:
        """True when the NEXT recorded step should wait for the device so
        its wall time includes device compute.  Never the compile step
        (step 0), always step 1, then every ``sample_every``-th."""
        if self.steps == 0:
            return False
        return self.steps == 1 or self.steps % self.sample_every == 0

    def should_sample_stride(self, k: int) -> bool:
        """Stride-shaped :meth:`should_sample`: never the compile stride,
        always the stride right after it, then whenever the stride
        crosses the ``sample_every`` cadence."""
        if self.steps == 0:
            return False
        return (
            self.steps <= k
            or (self.steps // self.sample_every)
            != ((self.steps + k) // self.sample_every)
        )

    def _record_midfit_compile(self, wall_s: float, k: int) -> None:
        """A first-use program (a capture after a singles-only start, or
        a new batch shape) MID-fit: book the wall as compile time and cut
        the interval out of the throughput window."""
        self.compile_ms = (self.compile_ms or 0.0) + 1e3 * wall_s
        self._last_sampled = None
        self.steps += k
        if self._t_first is not None:
            self._t_first += wall_s

    def record_stride(self, stride_s: float, data_wait_s: float,
                      dispatch_s: float, examples: int, k: int,
                      sampled: bool = False, compiled: bool = False) -> None:
        """One megastep stride = ``k`` micro-steps in one call.
        ``step_time_ms`` stays a PER-MICRO-STEP number: ``k`` steps are
        booked per call.  The first stride is booked as compile, like
        step 0 on the per-step path."""
        if self.steps == 0:
            self.compile_ms = 1e3 * stride_s
            self._last_sampled = None
            self.steps = k
            self._t_first = time.perf_counter()
            return
        if compiled:
            self._record_midfit_compile(stride_s, k)
            return
        self.steps += k
        self.examples += int(examples)
        if self.tokens_per_example:
            self.tokens += int(examples) * self.tokens_per_example
        self._step.add_scaled(stride_s, k)
        self._data_wait.add_scaled(data_wait_s, k)
        self._dispatch.add_scaled(dispatch_s, k)
        if sampled:
            self._device.add_scaled(stride_s, k)
        self._last_sampled = sampled
        self._t_last = time.perf_counter()

    def record_step(self, step_s: float, data_wait_s: float,
                    dispatch_s: float, examples: int,
                    sampled: bool = False, compiled: bool = False) -> None:
        """One loop iteration: total wall, input wait, step-call time.
        ``sampled=True`` marks a step whose caller waited for the device
        before the end mark."""
        if self.steps == 0:
            self.compile_ms = 1e3 * step_s
            self._last_sampled = None
            self.steps = 1
            self._t_first = time.perf_counter()
            return
        if compiled:
            self._record_midfit_compile(step_s, 1)
            return
        self.steps += 1
        self.examples += int(examples)
        if self.tokens_per_example:
            self.tokens += int(examples) * self.tokens_per_example
        self._step.add(step_s)
        self._data_wait.add(data_wait_s)
        self._dispatch.add(dispatch_s)
        if sampled:
            self._device.add(step_s)
        self._last_sampled = sampled
        self._t_last = time.perf_counter()

    def record_drain(self, wait_s: float) -> None:
        """The epoch's end: the loop waited ``wait_s`` for the work still
        queued on the card.  The wait is booked into the last record's
        wall, so ``step_time_ms`` and the throughput window cover the
        device time of every step they book at any fit length (into
        compile time when the last record was compile)."""
        if self._last_sampled is None:
            if self.compile_ms is not None:
                self.compile_ms += 1e3 * wait_s
            return
        self._step.extend_last(wait_s)
        if self._last_sampled:
            self._device.extend_last(wait_s)
        self._t_last = time.perf_counter()

    def record_capture(self, seconds: float) -> None:
        """One CUDA-graph capture of training steps and its wall time,
        counted as ``recompiles`` (where the JAX package counts backend
        compiles)."""
        self.captures += 1
        self.capture_s += float(seconds)

    # -- derived numbers ----------------------------------------------------
    def throughput(self) -> Dict[str, float]:
        if self._t_first is None or self._t_last is None:
            return {}
        wall = self._t_last - self._t_first
        if wall <= 0 or not self.examples:
            return {}
        out = {"examples_per_sec": self.examples / wall}
        if self.tokens:
            out["tokens_per_sec"] = self.tokens / wall
        return out

    def mfu(self) -> Optional[float]:
        """Model-FLOPs utilisation against the card's dense peak, ``None``
        when either side is unknown."""
        if not (self.flops_per_example and self.peak_flops):
            return None
        tp = self.throughput().get("examples_per_sec")
        if not tp:
            return None
        return tp * self.flops_per_example / self.peak_flops

    def memory_stats(self) -> Dict[str, float]:
        """The card's allocator numbers (none on the CPU)."""
        dev = self.device
        if dev is None or dev.type != "cuda":
            return {}
        return {
            "bytes_in_use": float(torch.cuda.memory_allocated(dev)),
            "peak_bytes_in_use": float(torch.cuda.max_memory_allocated(dev)),
            "bytes_limit": float(
                torch.cuda.get_device_properties(dev).total_memory),
        }

    def headline(self) -> Dict[str, float]:
        """The numbers a fit surfaces through ``callback_metrics``."""
        out: Dict[str, float] = {}
        if self._step.n:
            out["step_time_ms"] = 1e3 * self._step.total / self._step.n
            out["data_wait_ms"] = (
                1e3 * self._data_wait.total / self._data_wait.n
            )
            out["dispatch_ms"] = (
                1e3 * self._dispatch.total / self._dispatch.n
            )
        if self._device.n:
            out["device_step_ms"] = 1e3 * self._device.total / self._device.n
        out.update(self.throughput())
        m = self.mfu()
        if m is not None:
            out["mfu"] = m
        out["recompiles"] = float(self.captures)
        return out

    def summary(self) -> Dict[str, Any]:
        """Full snapshot (``Trainer.telemetry_report["step_stats"]``)."""
        out: Dict[str, Any] = {
            "steps": self.steps,
            "examples": self.examples,
            "recompiles": self.captures,
            "sample_every": self.sample_every,
        }
        if self.tokens:
            out["tokens"] = self.tokens
        if self.compile_ms is not None:
            out["compile_ms"] = self.compile_ms
        if self.capture_s > 0:
            out["capture_total_s"] = round(self.capture_s, 6)
        for name, agg in (("step", self._step),
                          ("data_wait", self._data_wait),
                          ("dispatch", self._dispatch),
                          ("device_step", self._device)):
            for k, v in agg.summary_ms().items():
                out[f"{name}_{k}"] = v
        out.update(self.throughput())
        m = self.mfu()
        if m is not None:
            out["mfu"] = m
            out["mfu_basis"] = self.mfu_basis
        mem = self.memory_stats()
        if mem:
            out["memory"] = mem
        return out
