"""Step functions of the fit loop on one device: the port of
``_loss_and_grads``, ``_single_device_raw_step`` and ``make_multi_step``
(``ray_lightning_tpu/parallel/step_fns.py``).  PyTorch runs eagerly:
``torch.autograd.grad`` takes the place of ``jax.value_and_grad``, and a
CUDA graph that captured K eager steps takes the place of the JAX
package's ``lax.scan`` over K steps (:class:`MultiStep`)."""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_lightning_tpu_torch.core.module import TrainModule, TrainState
from ray_lightning_tpu_torch.models.optim import (
    known_zeros, tree_leaves, tree_map,
)

__all__ = ["loss_and_grads", "single_device_step", "build_eval_step",
           "build_predict_step",
           "place_batch", "copy_state", "StepRng", "MultiStep",
           "MegastepCaptureError"]


def loss_and_grads(module: TrainModule, params: Any, batch: Any, rng
                   ) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """``(grads, logs)`` of ``module.training_step``: grads in the params'
    tree, logs detached, with ``loss`` added when the module logs none.

    Only the leaves ``module.trainable(params)`` marks (every leaf when it
    returns None) require a gradient, so autograd computes nothing for the
    others (under LoRA the frozen base's weight-gradient products and the
    CE dW kernel; the JAX package's ``value_and_grad`` leaves that dead
    work to XLA to drop).  Their gradients are
    ``models.optim.known_zeros``, which the optimizer's ``set_to_zero``
    discards."""
    train = module.trainable(params)
    if train is None:
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    else:
        leaves = tree_map(lambda t, on: t.detach().requires_grad_(bool(on)),
                          params, train)
    with torch.enable_grad():
        loss, logs = module.training_step(leaves, batch, rng)
        flat = tree_leaves(leaves)
        wanted = [t for t in flat if t.requires_grad]
        grads = iter(torch.autograd.grad(loss, wanted, allow_unused=True))
    zero = {}

    def grad_of(t):
        if not t.requires_grad:
            key = (t.dtype, t.device)
            if key not in zero:
                zero[key] = t.new_zeros(())
            return known_zeros(t, zero[key])
        g = next(grads)
        return g if g is not None else torch.zeros_like(t)

    grad_tree = tree_map(grad_of, leaves)
    logs = {k: v.detach() for k, v in dict(logs).items()}
    logs.setdefault("loss", loss.detach())
    return grad_tree, logs


def single_device_step(module: TrainModule, tx
                       ) -> Callable[[TrainState, Any, Any],
                                     Tuple[TrainState, Dict[str, Any]]]:
    def step(state: TrainState, batch, rng):
        grads, logs = loss_and_grads(module, state.params, batch, rng)
        return state.apply_gradients(grads, tx), logs

    return step


def build_eval_step(module: TrainModule, kind: str = "validation"
                    ) -> Callable[[Any, Any], Dict[str, Any]]:
    """``(params, batch) -> logs`` of ``validation_step`` (``kind``
    "validation") or ``test_step`` ("test"), without gradients."""
    step_method = (module.validation_step if kind == "validation"
                   else module.test_step)

    def step(params, batch):
        with torch.no_grad():
            return dict(step_method(params, batch))

    return step


def build_predict_step(module: TrainModule) -> Callable[[Any, Any], Any]:
    """``(params, batch) -> outputs`` of ``predict_step``, without
    gradients."""

    def step(params, batch):
        with torch.no_grad():
            return module.predict_step(params, batch)

    return step


def place_batch(batch: Any, device: torch.device) -> Any:
    """A host (numpy) batch on ``device``; the copy does not wait for the
    device."""
    if isinstance(batch, dict):
        return {k: place_batch(v, device) for k, v in batch.items()}
    return torch.as_tensor(np.asarray(batch)).to(device, non_blocking=True)


def copy_state(dst: TrainState, src: TrainState) -> None:
    """Write ``src``'s params and optimizer state into ``dst``'s own
    tensors, leaf by leaf (the write-back of a captured step)."""
    for d, s in zip(tree_leaves((dst.params, dst.opt_state)),
                    tree_leaves((src.params, src.opt_state))):
        d.copy_(s)


class StepRng:
    """The ``rng`` handed to ``training_step``: its draws at micro-step
    ``i`` are a function of the fit seed and ``i`` alone, with megastep on
    and off.

    On the card it is one generator for the fit, seeded ``seed``, whose
    Philox offset is set to ``i · OFFSET_STEP`` before micro-step ``i``
    (a step that draws more than ``OFFSET_STEP`` offsets, 2^32, would
    overlap the next one's draws).  A captured stride gives each inner
    step a generator state of its own, registered with the graph whether
    the step draws or not, and sets their offsets before each replay, so
    a replay draws what the eager steps would.  On the CPU (no
    offsets, no graphs) the generator is seeded ``seed·1000003 + i``
    before micro-step ``i``."""

    OFFSET_STEP = 1 << 32

    def __init__(self, device: torch.device, seed: int):
        self.device = device
        self.seed = int(seed)
        self.generator = torch.Generator(device=device)
        if device.type == "cuda":
            self.generator.manual_seed(self.seed)

    def at(self, i: int) -> torch.Generator:
        if self.device.type == "cuda":
            self.generator.set_offset(i * self.OFFSET_STEP)
        else:
            self.generator.manual_seed(self.seed * 1_000_003 + i)
        return self.generator

    def graph_states(self, graph, k: int) -> List[torch.Generator]:
        """One generator state per inner step of a capture, registered
        with ``graph``."""
        if not hasattr(graph, "register_generator_state"):
            raise NotImplementedError(
                "this PyTorch cannot register generator states with a CUDA "
                "graph, which a captured stride needs for its steps' rng; "
                "use megastep='off'")
        states = [self.generator.clone_state() for _ in range(k)]
        for s in states:
            graph.register_generator_state(s)
        return states

    def set_graph_offsets(self, states: List[torch.Generator],
                          start: int) -> None:
        """Before a replay of the stride that starts at micro-step
        ``start``: inner step ``j`` draws at ``(start + j)·OFFSET_STEP``."""
        base = self.generator.graphsafe_get_state()
        for j, s in enumerate(states):
            self.generator.graphsafe_set_state(s)
            self.generator.set_offset((start + j) * self.OFFSET_STEP)
        self.generator.graphsafe_set_state(base)


class MegastepCaptureError(RuntimeError):
    """A CUDA-graph capture of training steps failed; the fit stops."""


def _batch_items(batch: Any) -> Dict[Any, np.ndarray]:
    if isinstance(batch, dict):
        return {k: np.asarray(v) for k, v in batch.items()}
    return {None: np.asarray(batch)}


def _batch_from(items: Dict[Any, Any]) -> Any:
    return items[None] if list(items) == [None] else dict(items)


def _new_sums(logs: Dict[str, torch.Tensor]):
    return ({k: torch.zeros_like(v, dtype=torch.float32)
             for k, v in logs.items()},
            {k: torch.zeros_like(v, dtype=torch.float32)
             for k, v in logs.items()})


def _fold_logs(sums, cnts, logs: Dict[str, torch.Tensor]) -> None:
    """The stride's running sums of the finite values and their counts
    (``_RunningMeanLogs``'s contract), in place."""
    for k, v in logs.items():
        v32 = v.float()
        finite = torch.isfinite(v32)
        sums[k].add_(torch.where(finite, v32, 0.0))
        cnts[k].add_(finite.float())


def _site_of(exc: BaseException) -> str:
    """The innermost frame of ``exc``'s traceback outside PyTorch: the
    call at fault."""
    torch_dir = os.path.dirname(torch.__file__)
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if not f.filename.startswith(torch_dir)]
    if not frames:
        return "inside PyTorch"
    f = frames[-1]
    return f"{f.filename}:{f.lineno} in {f.name}: {(f.line or '').strip()}"


class _CapturedStride:
    """One CUDA graph of K training steps and the static tensors it reads
    and writes: the state, a ``(K, B, ...)`` batch buffer (filled from a
    pinned host buffer of the same shape), the stride's log sums and
    counts, and the last step's logs."""

    def __init__(self, state: TrainState, batch: Dict[Any, torch.Tensor],
                 pinned: Dict[Any, torch.Tensor], sums, cnts, last, graph,
                 gens):
        self.state = state
        self.batch = batch
        self.pinned = pinned
        self.sums, self.cnts, self.last = sums, cnts, last
        self.graph = graph
        self.gens = gens
        # Recorded after the last copy out of ``pinned``: the host waits
        # for it before it writes the next stride's batches there.
        self.copied: Optional[torch.cuda.Event] = None


class MultiStep:
    """``make_multi_step``: K micro-steps per call, ``aux = multi(owner,
    host_batches, start)`` with ``start`` the micro-step of the first.
    The call takes the state from ``owner.state`` and puts the new state
    there: the owner's reference is dropped while the steps run, so a
    state's memory is freed as soon as its successor exists (the JAX
    package donates the state to the step).  ``aux`` holds, per log key,
    the f32 ``sum`` and finite ``cnt`` over the stride and the ``last``
    step's logs (the JAX aux).

    On the CPU the K steps run eagerly one after another.  On the card the
    first stride of each batch shape runs eagerly (real training, and the
    warm-up); the second is captured into one CUDA graph of K steps, on
    the state it is handed (so no earlier state is alive while the
    capture allocates), and replayed, as is every later stride of that
    shape.  Each captured step writes the new params and optimizer state
    back into the state's own tensors (:func:`copy_state`) before the
    next one reads them, and the loop's batches are copied into the
    graph's static batch buffer before each replay (the host waits for
    the previous stride's copy out of the pinned buffer first, which keeps
    it at most about a stride ahead of the card).  ``captured`` says
    whether the last call captured, and ``capture_s`` the wall seconds of
    the last capture.  A capture that fails raises
    :class:`MegastepCaptureError`, naming the call at fault; nothing
    falls back to eager steps."""

    def __init__(self, module: TrainModule, tx, k: int,
                 device: torch.device, rng: StepRng):
        if k < 2:
            raise ValueError(f"make_multi_step needs k >= 2, got {k}")
        self.step = single_device_step(module, tx)
        self.k = k
        self.device = device
        self.rng = rng
        self.graphed = device.type == "cuda"
        self.captured = False
        self.capture_s = 0.0
        # batch shape -> its logs' shapes and dtypes (after the eager
        # stride), then -> the captured stride.
        self._warm: Dict[Any, Dict[str, Any]] = {}
        self._captured: Dict[Any, _CapturedStride] = {}

    def __call__(self, owner, batches: List[Any], start: int):
        if len(batches) != self.k:
            raise ValueError(f"a stride takes {self.k} batches, got "
                             f"{len(batches)}")
        key = tuple((k, v.shape, v.dtype.str)
                    for k, v in _batch_items(batches[0]).items())
        self.captured = False
        cap = self._captured.get(key)
        if cap is None and key in self._warm:
            cap = self._captured[key] = self._capture(
                owner.state, batches, self._warm.pop(key))
            self.captured = True
        if cap is not None:
            owner.state, aux = self._replay(cap, owner.state, batches, start)
            return aux
        aux = self._eager(owner, batches, start)
        if self.graphed:
            self._warm[key] = {k: (v.shape, v.dtype)
                               for k, v in aux["last"].items()}
        return aux

    def _eager(self, owner, batches, start):
        state, owner.state = owner.state, None
        sums = cnts = last = None
        for j, batch in enumerate(batches):
            state, last = self.step(state, place_batch(batch, self.device),
                                    self.rng.at(start + j))
            if sums is None:
                sums, cnts = _new_sums(last)
            _fold_logs(sums, cnts, last)
        owner.state = state
        return {"sum": sums, "cnt": cnts, "last": last}

    def _capture(self, state: TrainState, batches,
                 log_specs: Dict[str, Any]) -> _CapturedStride:
        t0 = time.perf_counter()
        items = _batch_items(batches[0])
        batch = {k: torch.empty((self.k, *v.shape),
                                dtype=torch.from_numpy(v[:0]).dtype,
                                device=self.device)
                 for k, v in items.items()}
        pinned = {k: torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
                  for k, b in batch.items()}
        last = {k: torch.empty(shape, dtype=dtype, device=self.device)
                for k, (shape, dtype) in log_specs.items()}
        sums, cnts = _new_sums(last)
        graph = torch.cuda.CUDAGraph()
        gens = self.rng.graph_states(graph, self.k)
        gen = self.rng.generator
        base = gen.graphsafe_get_state()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        failure: List[BaseException] = []
        try:
            with torch.cuda.graph(graph, stream=side):
                try:
                    for t in (*sums.values(), *cnts.values()):
                        t.zero_()
                    for j in range(self.k):
                        gen.graphsafe_set_state(gens[j])
                        new, logs = self.step(
                            state, _batch_from({k: v[j] for k, v in
                                                batch.items()}), gen)
                        copy_state(state, new)
                        _fold_logs(sums, cnts, logs)
                        del new
                    for k, v in logs.items():
                        last[k].copy_(v)
                except BaseException as e:
                    failure.append(e)
                    raise
        except Exception as e:
            cause = failure[0] if failure else e
            raise MegastepCaptureError(
                f"megastep: the CUDA-graph capture of {self.k} training "
                f"steps failed at {_site_of(cause)} ({type(cause).__name__}:"
                f" {cause}).  A captured step may not wait for the device "
                f"(.item(), float(tensor), printing a tensor, "
                f"torch.cuda.synchronize()) nor copy from the host; pass "
                f"megastep='off' to run every step eagerly") from cause
        finally:
            gen.graphsafe_set_state(base)
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.capture_s = time.perf_counter() - t0
        return _CapturedStride(state, batch, pinned, sums, cnts, last, graph,
                               gens)

    def _replay(self, cap: _CapturedStride, state: TrainState, batches,
                start: int):
        if state is not cap.state:
            # Eager steps ran since the last replay (singles at a
            # boundary): their state becomes the graph's.
            copy_state(cap.state, state)
            cap.state.step = state.step
        if cap.copied is not None:
            cap.copied.synchronize()
        for k, buf in cap.batch.items():
            np.stack([_batch_items(b)[k] for b in batches],
                     out=cap.pinned[k].numpy())
            buf.copy_(cap.pinned[k], non_blocking=True)
        cap.copied = torch.cuda.Event()
        cap.copied.record()
        self.rng.set_graph_offsets(cap.gens, start)
        cap.graph.replay()
        cap.state.step += self.k
        # The static buffers are overwritten by the next replay.
        aux = {name: {k: v.clone() for k, v in bufs.items()}
               for name, bufs in (("sum", cap.sums), ("cnt", cap.cnts),
                                  ("last", cap.last))}
        return cap.state, aux
