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
    apply_updates, known_zeros, multi_steps_flush, tree_leaves, tree_map,
)

__all__ = ["loss_and_grads", "single_device_step", "accum_flush",
           "DistributedStep", "build_dist_step",
           "build_eval_step", "build_predict_step",
           "place_batch", "copy_state", "StepRng", "MultiStep",
           "MegastepCaptureError"]


def loss_and_grads(module: TrainModule, params: Any, batch: Any, rng,
                   loss_div: int = 1
                   ) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """``(grads, logs)`` of ``module.training_step``: grads in the params'
    tree (of ``loss / loss_div``: the int8 gradient wire's partial, as the
    JAX island differentiates it), logs detached, with ``loss`` added when
    the module logs none.

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
        target = loss if loss_div == 1 else loss / loss_div
        grads = iter(torch.autograd.grad(target, wanted, allow_unused=True))
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


def accum_flush(state: TrainState, inner_tx, norm_sq=None) -> TrainState:
    """The partial-window flush (the JAX loop's ``_build_accum_flush``):
    one optimizer update from the running mean of the window's
    micro-gradients (``norm_sq``: the clip's norm over a model-parallel
    rank's slices, ``sharding.ModelPlan.norm_sq``)."""
    with torch.no_grad():
        updates, opt_state = multi_steps_flush(inner_tx, state.opt_state,
                                               state.params, norm_sq=norm_sq)
        return TrainState(apply_updates(state.params, updates), opt_state,
                          state.step + 1, state.grad_residual)


class DistributedStep:
    """One training step of a rank of a data-parallel strategy: the
    port's counterpart of the JAX step under a mesh, with the gradient
    sync as explicit ``torch.distributed`` collectives on the grad tree.

    The rank's logs are averaged over the ranks (``DistContext.mean_logs``)
    and the module's derived logs taken from those means
    (``TrainModule.derive_logs``), so they read as the JAX step's over the
    global batch.  The gradients, by ``sync``:

    * a full-width sync (``grad_sync.BucketSync`` for ``RayStrategy``,
      ``LeafSync`` for ``HorovodRayStrategy``): the gradients of the
      rank's mean loss, averaged over the ranks;
    * a ``grad_sync.GradSync`` (the int8 wire): the gradients of
      ``loss / n`` summed over the ranks (:meth:`GradSync.step`, at the
      step end or inside the backward), the EF residual threaded through
      the state (``TrainState.grad_residual``) and the wire's bytes
      logged as ``grad_sync_bytes`` (the JAX step's log);
    * none (ZeRO, and the sharded weight update at full width):
      reduce-scattered onto this rank's slices.

    Then the update: with no ``zero_plan`` every rank applies the same
    update to its full state; with one (ZeRO, or the sharded weight
    update) the optimizer updates this rank's slices of its moments and
    params, the int8 wire's synced gradients sliced
    (``ZeroPlan.slice_grads``), else the gradients reduce-scattered, the
    clip's norm taken over the whole update (the
    plan's ``norm_sq`` handed to the optimizer), and stage 1 all-gathers
    the params; under stage 3 the state holds only the slices and a step
    all-gathers the full params for its forward first.  Each micro-step
    under accumulation is synced, as the JAX island syncs each one.

    :meth:`flush` is the partial accumulation window's update
    (:func:`accum_flush`) under the same rule.

    Under model axes (``model_plan``, a ``sharding.ModelPlan``) the state
    holds the rank's slices of the weights, the sync runs over the rank's
    replica group and the clip's norm is the plan's (each sharded leaf's
    squares summed over its model group, each replicated leaf once)."""

    def __init__(self, module: TrainModule, tx, dist, sync=None,
                 zero_plan=None, model_plan=None):
        if sync is None and zero_plan is None:
            raise ValueError("a DistributedStep takes a gradient sync, a "
                             "ZeRO plan or both")
        self.module = module
        self.tx = tx
        self.dist = dist
        self.sync = sync
        self.plan = zero_plan
        self._norm_sq = None if model_plan is None else model_plan.norm_sq
        self._wire = hasattr(sync, "step")
        self._wire_bytes = (float(sync.bytes_per_step) if self._wire
                            else None)
        # The wire's bytes as a device tensor, made at the first (eager)
        # step: a captured step may not copy from the host.
        self._wire_bytes_t: Optional[torch.Tensor] = None

    def full_params(self, params: Any) -> Any:
        """The full params of a state's: gathered under ZeRO-3 (a
        collective), else the state's own."""
        if self.plan is not None and self.plan.stage == 3:
            return self.plan.all_gather(params)
        return params

    def __call__(self, state: TrainState, batch, rng):
        params = self.full_params(state.params)
        resid = state.grad_residual
        if self._wire:
            grads, logs, resid = self.sync.step(params, resid, batch, rng)
        else:
            grads, logs = loss_and_grads(self.module, params, batch, rng)
            if self.sync is not None:
                grads = self.sync(grads)
        logs = self.module.derive_logs(self.dist.mean_logs(logs))
        if self._wire:
            if self._wire_bytes_t is None:
                self._wire_bytes_t = torch.tensor(
                    self._wire_bytes, dtype=torch.float32,
                    device=tree_leaves(params)[0].device)
            logs["grad_sync_bytes"] = self._wire_bytes_t.clone()
        if self.plan is None:
            if self._norm_sq is None:
                new = state.apply_gradients(grads, self.tx)
            else:
                with torch.no_grad():
                    updates, opt_state = self.tx.update(
                        grads, state.opt_state, state.params,
                        norm_sq=self._norm_sq)
                    new = TrainState(apply_updates(state.params, updates),
                                     opt_state, state.step + 1)
            new.grad_residual = resid
            return new, logs
        gshards = (self.plan.reduce_scatter_grads(grads) if self.sync is None
                   else self.plan.slice_grads(grads))
        del grads
        new = self._sharded_update(
            state, lambda opt, pview, norm_sq: self.tx.update(
                gshards, opt, pview, norm_sq=norm_sq), params)
        new.grad_residual = resid
        return new, logs

    def flush(self, state: TrainState, inner_tx) -> TrainState:
        if self.plan is None:
            return accum_flush(state, inner_tx, self._norm_sq)
        new = self._sharded_update(
            state, lambda opt, pview, norm_sq: multi_steps_flush(
                inner_tx, opt, pview, norm_sq=norm_sq))
        new.grad_residual = state.grad_residual
        return new

    def _sharded_update(self, state: TrainState, update,
                        full: Any = None) -> TrainState:
        """The update of this rank's slices in the plan's update layout
        (``full``: the step's whole params, gathered already under
        stage 3), then stage 1's params all-gathered, or stage 3's put
        back in their stored layout."""
        plan = self.plan
        if plan.relayout:
            if full is None:
                full = self.full_params(state.params)
            pview = plan.update_view(full)
        else:
            pview = (state.params if plan.stage == 3
                     else plan.shard_tree(state.params))
        with torch.no_grad():
            updates, opt_state = update(plan.opt_to_update(state.opt_state),
                                        pview, plan.norm_sq)
            opt_state = plan.opt_to_storage(opt_state)
            new = apply_updates(pview, updates)
            new = (plan.all_gather(new, update=True) if plan.stage == 1
                   else plan.to_storage(new))
        return TrainState(new, opt_state, state.step + 1)


def _unsynced(grads: Any) -> Any:
    """The gradient sync of a rank whose replica group is itself."""
    return grads


def build_dist_step(module: TrainModule, tx, dist, params: Any, mode: str,
                    zero_stage: int, grad_sync=None,
                    shard_update: bool = False,
                    model_plan=None) -> DistributedStep:
    """The flavor's :class:`DistributedStep`: under ZeRO (``zero_stage``
    1 or 3) and for the sharded weight update (``shard_update``, as
    stage 1) a ``ZeroPlan`` of ``params``, its gradients reduce-scattered
    or, with the int8 wire (``grad_sync``, whose output every rank holds
    in full), synced and sliced; else the int8 sync or the flavor's
    full-width one (bucketed for ``"gspmd"``, a leaf at a time for
    ``"shard_map"``).  The sharded update at full width is ZeRO-1's
    step: the JAX package's GSPMD likewise turns its all-reduce into a
    reduce-scatter.  Under model axes (``model_plan``; ``params`` the
    rank's slices) the full-width sync runs over the rank's replica group
    and ZeRO over its ZeRO group among the ranks with the same model
    coordinates."""
    from ray_lightning_tpu_torch.parallel.grad_sync import BucketSync, LeafSync
    from ray_lightning_tpu_torch.parallel.mesh import zero_groups
    from ray_lightning_tpu_torch.parallel.sharding import ZeroPlan

    mp = dist.mp if model_plan is not None else None
    if zero_stage >= 1 or shard_update:
        extra = {} if mp is None else dict(model=model_plan,
                                           replica_group=mp.replica.group)
        return DistributedStep(module, tx, dist, sync=grad_sync,
                               zero_plan=ZeroPlan(params, zero_stage or 1,
                                                  **zero_groups(dist),
                                                  **extra),
                               model_plan=model_plan)
    n, group = ((dist.world_size, None) if mp is None
                else (mp.replica.size, mp.replica.group))
    if mp is not None and n == 1:
        # A mesh of model axes only: no other rank holds this rank's
        # slices, and a group of one has no handle (None would be every
        # rank), so the gradients go to the update as they are.
        sync = grad_sync or _unsynced
    else:
        sync = grad_sync or (BucketSync(n, group=group) if mode == "gspmd"
                             else LeafSync(n, group=group))
    return DistributedStep(module, tx, dist, sync=sync,
                           model_plan=model_plan)


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
    """Write ``src``'s params, optimizer state and error-feedback residual
    into ``dst``'s own tensors, leaf by leaf (the write-back of a captured
    step; under ZeRO the leaves are this rank's slices)."""
    for d, s in zip(tree_leaves((dst.params, dst.opt_state)),
                    tree_leaves((src.params, src.opt_state))):
        d.copy_(s)
    if dst.grad_residual is not None:
        dst.grad_residual.copy_(src.grad_residual)


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
    ``step`` is the step a micro-step runs: :func:`single_device_step` by
    default, or a rank's :class:`DistributedStep` under a strategy (the
    JAX mesh branches' ``lax.scan`` over the sharded step), whose
    collectives a capture takes into the graph (NCCL's only: the loop's
    ``_resolve_megastep`` refuses K > 1 over gloo on the card).
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
                 device: torch.device, rng: StepRng, step=None):
        if k < 2:
            raise ValueError(f"make_multi_step needs k >= 2, got {k}")
        self.step = step or single_device_step(module, tx)
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
