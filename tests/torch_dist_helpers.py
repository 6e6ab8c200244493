"""Picklable pieces of the port's multi-process tests.

The port's workers get every class and function by reference (stdlib
pickle), so what a test ships to them lives in an importable module;
this one imports neither jax nor the JAX package, so a worker that
unpickles it loads only the port.
"""

from __future__ import annotations

import importlib
import os
from typing import Any, Dict, List

import numpy as np
import torch

from ray_lightning_tpu_torch.core.callbacks import Callback
from ray_lightning_tpu_torch.core.data import (
    ArrayDataset, NumpyLoader, TpuDataModule,
)
from ray_lightning_tpu_torch.models.gpt import GPT

# The loss scale of each step's batch: the clip (global norm 1.0) binds at
# the first and third steps (norm ~1.4 unscaled) and not at the second, so
# a clip that took another norm than the global one moves the later
# updates (AdamW's update is blind to one common scale of every step).
SCALES = (60.0, 0.02, 1.0)


def scaled_batches(vocab: int, seq_len: int, batch: int, steps: int,
                   seed: int) -> Dict[str, np.ndarray]:
    """``steps`` global batches of tokens, each row with its batch's loss
    scale (rows of one batch share it)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(batch * steps, seq_len + 1)
                          ).astype(np.int32)
    scale = np.repeat(np.asarray(SCALES[:steps], np.float32), batch)
    return {"tokens": tokens, "scale": scale}


class ScaledGPT(GPT):
    """GPT whose training loss is scaled by its batch's ``scale``."""

    def training_step(self, params, batch, rng):
        loss, logs = super().training_step(params, batch, rng)
        return loss * batch["scale"].mean(), logs


class ArraysDataModule(TpuDataModule):
    """Fixed numpy arrays as train, val, test and predict loaders of
    ``batch_size`` global rows (the rank's share after ``set_shard``)."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int):
        super().__init__()
        self.arrays = arrays
        self.batch_size = batch_size

    def _loader(self):
        return NumpyLoader(ArrayDataset(**self.arrays),
                           batch_size=self.batch_size,
                           shard_index=self.shard_index,
                           num_shards=self.num_shards)

    train_dataloader = val_dataloader = test_dataloader = _loader
    predict_dataloader = _loader


def write_marker(directory: str) -> None:
    """An ``init_hook``: a file named after the worker's pid."""
    with open(os.path.join(directory, f"hook-{os.getpid()}"), "w") as f:
        f.write("ran")


class RankProbe(Callback):
    """Writes, from each rank, its session rank, the trainer's world size
    and rank, and the elements of params and optimizer state it holds
    (the leaves whose shape a ZeRO slice changes, and the rest)."""

    def __init__(self, directory: str):
        self.directory = directory

    def on_fit_start(self, trainer, module) -> None:
        from ray_lightning_tpu_torch.models.optim import tree_leaves
        from ray_lightning_tpu_torch.session import get_actor_rank

        rank = get_actor_rank()
        st = trainer.state
        record = {
            "session_rank": rank, "global_rank": trainer.global_rank,
            "world_size": trainer.world_size,
            "params": [list(t.shape) for t in tree_leaves(st.params)],
            "opt": [list(t.shape) for t in tree_leaves(st.opt_state)],
            # The bytes the state's tensors keep alive (a slice that is a
            # view keeps its whole leaf's storage).
            "storage": sum(t.untyped_storage().nbytes() for t in
                           tree_leaves((st.params, st.opt_state))),
            "elements": sum(t.numel() * t.element_size() for t in
                            tree_leaves((st.params, st.opt_state))),
        }
        with open(os.path.join(self.directory, f"rank{rank}.txt"), "w") as f:
            f.write(repr(record))


class LossLog(Callback):
    """Each step's ``train_loss`` (as the loop logs it: under a strategy,
    the mean over the ranks); travels back as the callback's state."""

    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, logs, batch_idx) -> None:
        self.losses.append(float(logs["train_loss"]))

    def state_dict(self):
        return {"losses": list(self.losses)}

    def load_state_dict(self, state):
        self.losses = list(state["losses"])


class Exploding(GPT):
    """Fails in the worker, inside the fit."""

    def configure_optimizers(self):
        raise RuntimeError("worker-side boom")


# -- chip_smoke.py phase 15: what each rank measured --------------------------

# label -> rank -> the rank's record, filled in the driver by the thunks the
# ranks put on the queue (``record``).
RECORDS: Dict[str, Dict[int, Dict[str, Any]]] = {}


def record(label: str, rank: int, payload: Dict[str, Any]) -> None:
    """Runs in the driver (a thunk off the queue), or in-process for a
    local fit."""
    RECORDS.setdefault(label, {})[rank] = payload


def kernel_launches() -> Dict[str, int]:
    """The training kernels' launch counters of this process."""
    from ray_lightning_tpu_torch.ops import cross_entropy as ce
    from ray_lightning_tpu_torch.ops import flash_attention as fa
    from ray_lightning_tpu_torch.ops import layer_norm as ln

    return {"ln_fwd": ln.ln_fwd.launches, "ln_bwd": ln.ln_bwd.launches,
            "flash_fwd": fa.flash_fwd.launches,
            "flash_bwd": fa.flash_bwd.launches,
            "ce_fwd": ce.ce_fwd.launches, "ce_bwd_dx": ce.ce_bwd_dx.launches,
            "ce_bwd_dw": ce.ce_bwd_dw.launches}


def _zero_launches() -> None:
    from ray_lightning_tpu_torch.ops import cross_entropy as ce
    from ray_lightning_tpu_torch.ops import flash_attention as fa
    from ray_lightning_tpu_torch.ops import layer_norm as ln

    for fn in (ln.ln_fwd, ln.ln_bwd, fa.flash_fwd, fa.flash_bwd, ce.ce_fwd,
               ce.ce_bwd_dx, ce.ce_bwd_dw):
        fn.launches = 0


def vector_leaves(params: Any) -> Dict[str, torch.Tensor]:
    """Host copies of the GPT's vector leaves (the LN gains ``*_g`` and
    every bias ``*_b``), keyed by path as ``chip_smoke.by_path`` keys
    them."""
    from ray_lightning_tpu_torch.parallel.sharding import leaves_with_paths

    return {"".join(f"['{k}']" for k in path): t.detach().cpu().clone()
            for path, t in leaves_with_paths(params)
            if str(path[-1]).endswith(("_g", "_b"))}


class StepProbe(Callback):
    """The rank's ``memory_allocated`` once the state is built and its
    peak over the steps (on a card), each step's wall time (the card
    synchronised at each step's end), its kernel launches (counts set to
    0 at the fit's start), the per-step losses, the wall-clock times of
    the fit's start and end, and on one rank the vector leaves of the
    initial params (:func:`vector_leaves`); delivered to the driver's
    :data:`RECORDS` under ``label``."""

    def __init__(self, label: str):
        self.label = label

    def _sync(self, trainer) -> None:
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()

    def on_fit_start(self, trainer, module) -> None:
        import time

        self._sync(trainer)
        cuda = trainer.device.type == "cuda"
        self._setup_bytes = torch.cuda.memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        self._init = (vector_leaves(trainer.state.params)
                      if trainer.world_size == 1 else {})
        self._times, self._losses = [], []
        self._start = time.time()
        self._t = time.perf_counter()

    def on_train_batch_end(self, trainer, module, logs, batch_idx) -> None:
        import time

        self._sync(trainer)
        now = time.perf_counter()
        self._times.append(now - self._t)
        self._t = now
        self._losses.append(float(logs["train_loss"]))

    def on_fit_end(self, trainer, module) -> None:
        import time

        from ray_lightning_tpu_torch import session

        cuda = trainer.device.type == "cuda"
        payload = {"setup_bytes": self._setup_bytes,
                   "peak_bytes": (torch.cuda.max_memory_allocated()
                                  if cuda else 0),
                   "step_s": self._times, "losses": self._losses,
                   "launches": kernel_launches(),
                   "device": str(trainer.device),
                   "init_vectors": self._init,
                   "fit_start": self._start, "fit_end": time.time()}
        if session.is_session_enabled():
            import functools

            session.put_queue(functools.partial(
                record, self.label, trainer.global_rank, payload))
        else:
            record(self.label, 0, payload)


def warm_up(device: str, warnings_to: str = None) -> None:
    """An ``init_hook``: import the port's model (torch, the kernels'
    wrappers and all) before the worker's first task, and on a card run
    one bf16 step of a one-layer GPT of GPT-2-small's width (the kernels,
    remat "dots+flash", CE over the 50304-token vocabulary) on 2 x 1024
    tokens, so the CUDA context, the kernels' libraries and PyTorch's
    own kernels are loaded before the fit's first step.  With
    ``warnings_to`` every warning the worker shows from then on is also
    appended to that file, one line each."""
    if warnings_to is not None:
        import warnings

        show = warnings.showwarning

        def tee(message, category, filename, lineno, file=None, line=None):
            with open(warnings_to, "a") as f:
                f.write(f"pid {os.getpid()}: {category.__name__}: "
                        f"{message}\n".replace("\n", " ") + "\n")
            show(message, category, filename, lineno, file, line)

        warnings.simplefilter("always")
        warnings.showwarning = tee
    gpt = importlib.import_module("ray_lightning_tpu_torch.models.gpt")
    if device != "cuda":
        return
    from ray_lightning_tpu_torch.parallel.step_fns import loss_and_grads

    cfg = gpt.GPTConfig(n_layer=1)
    module = gpt.GPT(cfg, precision="bf16", remat=True,
                     remat_policy="dots+flash")
    params = module.init_params(torch.Generator("cuda").manual_seed(0))
    tokens = torch.zeros((2, cfg.seq_len + 1), dtype=torch.int32,
                         device="cuda")
    loss_and_grads(module, params, {"tokens": tokens}, None)
    torch.cuda.synchronize()
    del params
    torch.cuda.empty_cache()


# -- the int8 gradient wire on CPU ranks (tests/test_torch_grad_comm.py and
# chip_smoke.py phase 16 (h)) ------------------------------------------------

def _flat(tree) -> Dict[str, np.ndarray]:
    from ray_lightning_tpu_torch.parallel.sharding import leaves_with_paths

    return {"/".join(map(str, p)): t.detach().float().cpu().numpy().copy()
            for p, t in leaves_with_paths(tree)}


def pack(tree, plan, order) -> torch.Tensor:
    """A tree's leaves, in JAX order (``order``), laid out as the bucket
    plan pads them: the flat vector the wire carries."""
    from ray_lightning_tpu_torch.models.optim import tree_leaves

    leaves = tree_leaves(tree)
    out = torch.zeros(plan.total_padded, dtype=torch.float32)
    for b in plan.buckets:
        pos = b.offset
        for i, sz in zip(b.indices, b.sizes):
            out[pos:pos + sz] = leaves[order[i]].detach().reshape(-1).float()
            pos += sz
    return out


def reference_sync(plan, partials, resids):
    """The plain version of a step-end sync: every rank's packed partial
    (``partials[r]``) plus its residual row, bucket by bucket through
    ``int8_all_reduce_reference``; returns (the reduced vector, each
    rank's new residual row)."""
    from ray_lightning_tpu_torch.ops.collective_quant import (
        int8_all_reduce_reference,
    )

    n = len(partials)
    reduced = torch.zeros(plan.total_padded)
    errs = [torch.zeros(plan.total_padded) for _ in range(n)]
    for b in plan.buckets:
        sl = slice(b.offset, b.offset + b.padded)
        out = int8_all_reduce_reference(
            [p[sl] + (0 if r is None else r[sl])
             for p, r in zip(partials, resids)], plan.block_size)
        reduced[sl] = out[0][0]
        for r, (_, e) in enumerate(out):
            errs[r][sl] = e
    return reduced, errs


class _Trainer:
    """The attribute a module's forward reads from its trainer."""

    def __init__(self):
        self.grad_tap_plane = None


def _wire_checks(rank: int, n: int, payload: Dict[str, Any]
                 ) -> Dict[str, Any]:
    import torch.distributed as dist

    from ray_lightning_tpu_torch.models.convert import params_from_jax
    from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
    from ray_lightning_tpu_torch.ops import collective_quant as cq
    from ray_lightning_tpu_torch.parallel.grad_sync import (
        maybe_build_grad_sync,
    )
    from ray_lightning_tpu_torch.parallel.step_fns import loss_and_grads

    block = payload["block_size"]
    out: Dict[str, Any] = {}
    # The collective against its plain version.
    parts = [torch.from_numpy(p) for p in payload["partials"][n]]
    got, err = cq.int8_all_reduce(parts[rank].clone(), None, n, block,
                                  want_error=True)
    want, want_err = cq.int8_all_reduce_reference(parts, block)[rank]
    out["collective_equal"] = bool(torch.equal(got, want)
                                   and torch.equal(err, want_err))

    module = GPT(GPTConfig(**payload["cfg"]), device="cpu")
    params = params_from_jax(payload["tree"], "cpu")
    rows = payload["batches"][0].shape[0] // n

    def batch_of(tokens):
        return {"tokens": torch.from_numpy(
            np.ascontiguousarray(tokens[rank * rows:(rank + 1) * rows]))}

    def gather(vec):
        bufs = [torch.empty_like(vec) for _ in range(n)]
        dist.all_gather(bufs, vec)
        return bufs

    # Synced steps at fixed params (the residual threaded), each against
    # the plain sync of the ranks' own partials of loss / n.
    for mode in payload["modes"]:
        gs = maybe_build_grad_sync(
            module, {"mode": mode, "block_size": block,
                     "bucket_bytes": payload["bucket_bytes"]}, n,
            params=params)
        resid = gs.init_residual(torch.device("cpu"))
        steps = []
        for tokens in payload["batches"]:
            batch = batch_of(tokens)
            partial, _ = loss_and_grads(module, params, batch, None,
                                        loss_div=n)
            packed = pack(partial, gs.plan, gs.order)
            grads, logs, new = gs.step(params, resid, batch, None)
            loss = logs["loss"].detach().clone()
            dist.all_reduce(loss)
            ref, ref_errs = reference_sync(
                gs.plan, gather(packed),
                gather(resid) if resid is not None else [None] * n)
            equal = torch.equal(pack(grads, gs.plan, gs.order), ref)
            if new is not None:
                equal = equal and torch.equal(new, ref_errs[rank])
            steps.append({"grads": _flat(grads),
                          "resid": None if new is None else new.numpy(),
                          "loss": float(loss) / n,
                          "partial_amax": float(packed.abs().max()),
                          "ref_equal": bool(equal)})
            resid = new
        out[mode] = steps

    # The taps (G segments) against the step-end sync over the same plan,
    # two steps, the residual threaded.
    G = payload["segments"]
    trainer = _Trainer()
    module.trainer = trainer
    gs = maybe_build_grad_sync(module, {"mode": "int8_ef",
                                        "block_size": block}, n,
                               params=params, overlap_segments=G)
    r_tap = r_end = gs.init_residual(torch.device("cpu"))
    same = True
    for tokens in payload["batches"][:2]:
        batch = batch_of(tokens)
        g_tap, _, r_tap = gs.step(params, r_tap, batch, None)
        partial, _ = loss_and_grads(module, params, batch, None, loss_div=n)
        g_end, r_end = gs.sync_tree(partial, r_end)
        a, b = _flat(g_tap), _flat(g_end)
        same = same and all(np.array_equal(a[k], b[k]) for k in a) \
            and torch.equal(r_tap, r_end)
    out["overlap_equal"] = bool(same)
    out["overlap_plan"] = (gs.plan.trunk_segments, gs.plan.total_padded)
    module.trainer = None
    return out


def wire_rank(rank: int, world: int, port: int, payload: Dict[str, Any]
              ) -> Dict[str, Any]:
    """One CPU rank of the wire checks (submitted to a strategy's worker):
    joins a gloo group of ``world`` ranks, runs :func:`_wire_checks` over
    it and leaves it."""
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        return _wire_checks(rank, world, payload)
    finally:
        dist.destroy_process_group()


def wire_worlds(workers, payload: Dict[str, Any], timeout: float,
                worlds=(3, 2), fn=None) -> Dict[int, List[Dict[str, Any]]]:
    """``fn`` (:func:`wire_rank` by default) on the first ``n`` of
    ``workers`` (CPU workers of a strategy) for each ``n`` of ``worlds`` in
    turn, each a world of its own: ``{n: [rank 0's results, ...]}``."""
    from ray_lightning_tpu_torch.cluster.rpc import find_free_port

    out = {}
    for n in worlds:
        port = find_free_port()
        futures = [w.submit(fn or wire_rank, rank, n, port, payload)
                   for rank, w in enumerate(workers[:n])]
        out[n] = [f.result(timeout=timeout) for f in futures]
    return out


class WireProbe(Callback):
    """Holds a fit's int8 wire to its plain version, in the fit: for the
    fit's span ``grad_sync.sync_leaf_buckets_int8`` (the one sync of the
    step end and of every tap) is wrapped so that on each call the
    smallest bucket's codec input (the rank's partials of ``loss / n``
    packed as the plan packs them, plus its residual slice under EF) is
    gathered from every rank and put through
    ``int8_all_reduce_reference``; the synced values and the new residual
    must equal it bitwise, and each residual slice handed in must be
    bitwise the one the same call of the previous step wrote (the row
    threaded through the state).  The counts go to the driver's
    :data:`RECORDS` under ``label``.  Each check moves one bucket through
    gloo, a few ms a call."""

    def __init__(self, label: str):
        self.label = label

    def on_fit_start(self, trainer, module) -> None:
        from ray_lightning_tpu_torch.parallel import grad_sync

        self._orig = grad_sync.sync_leaf_buckets_int8
        self._counts = {"calls": 0, "equal": 0, "threaded": 0,
                        "thread_checks": 0}
        self._prev: Dict[int, torch.Tensor] = {}
        self._now: Dict[int, torch.Tensor] = {}
        grad_sync.sync_leaf_buckets_int8 = self._checked

    def _checked(self, leaves, buckets, n, block_size, resid=None,
                 out=None, resid_out=None):
        import torch.distributed as dist

        from ray_lightning_tpu_torch.ops.collective_quant import (
            int8_all_reduce_reference,
        )

        b = min(buckets, key=lambda x: (x.padded, x.offset))
        sl = slice(b.offset, b.offset + b.padded)
        flat = torch.cat([leaves[i].reshape(-1).float() for i in b.indices])
        flat = torch.nn.functional.pad(flat, (0, b.padded - b.size))
        if resid is not None:
            flat = flat + resid[sl]
        ins = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(ins, flat)
        total = buckets[-1].offset + buckets[-1].padded
        device = flat.device
        if out is None:
            out = torch.empty(total, dtype=torch.float32, device=device)
        if resid is not None and resid_out is None:
            resid_out = torch.empty(total, dtype=torch.float32,
                                    device=device)
        result = self._orig(leaves, buckets, n, block_size, resid=resid,
                            out=out, resid_out=resid_out)
        want, want_err = int8_all_reduce_reference(
            ins, block_size, want_error=resid is not None)[dist.get_rank()]
        equal = torch.equal(out[sl], want)
        call = len(self._now)
        if resid is not None:
            equal = equal and torch.equal(resid_out[sl], want_err)
            if call in self._prev:
                self._counts["thread_checks"] += 1
                self._counts["threaded"] += int(torch.equal(
                    resid[sl], self._prev[call]))
            self._now[call] = resid_out[sl].clone()
        else:
            self._now[call] = None
        self._counts["calls"] += 1
        self._counts["equal"] += int(equal)
        return result

    def on_train_batch_end(self, trainer, module, logs, batch_idx) -> None:
        self._prev, self._now = self._now, {}

    def on_fit_end(self, trainer, module) -> None:
        import functools

        from ray_lightning_tpu_torch import session
        from ray_lightning_tpu_torch.parallel import grad_sync

        grad_sync.sync_leaf_buckets_int8 = self._orig
        payload = dict(self._counts)
        if session.is_session_enabled():
            session.put_queue(functools.partial(
                record, self.label, trainer.global_rank, payload))
        else:
            record(self.label, 0, payload)


class FinalDigest(Callback):
    """Each rank's digest of its final params (sha256 over the leaves'
    bytes in tree order, taken on the rank's device copy), delivered to
    the driver's :data:`RECORDS` under ``label``: equal digests mean the
    ranks hold bitwise the same params."""

    def __init__(self, label: str):
        self.label = label

    def on_fit_end(self, trainer, module) -> None:
        import functools
        import hashlib

        from ray_lightning_tpu_torch import session
        from ray_lightning_tpu_torch.models.optim import tree_leaves

        params = trainer.state.params
        if trainer.zero_plan is not None and trainer.zero_plan.stage == 3:
            params = trainer.zero_plan.all_gather(params)
        h = hashlib.sha256()
        for t in tree_leaves(params):
            h.update(t.detach().cpu().contiguous().view(torch.uint8)
                     .numpy().tobytes())
        payload = {"digest": h.hexdigest()}
        if session.is_session_enabled():
            session.put_queue(functools.partial(
                record, self.label, trainer.global_rank, payload))
        else:
            record(self.label, 0, payload)


# -- ZeRO's bucketed collectives against the per-leaf ones (tests/
# test_torch_zero_buckets.py) -------------------------------------------------

def per_leaf_plan(params, stage: int, rank: int, world: int):
    """A ``ZeroPlan`` whose step collectives go one leaf at a time (the
    plan's first form): one ``reduce_scatter_tensor`` or ``all_gather_
    into_tensor`` a sharded leaf and one ``all_reduce`` a replicated one,
    the reference the bucketed collectives are held against."""
    from ray_lightning_tpu_torch.models.optim import (
        is_known_zeros, known_zeros, tree_leaves, tree_unflatten,
    )
    from ray_lightning_tpu_torch.parallel import sharding

    class PerLeafPlan(sharding.ZeroPlan):
        def all_gather(self, shards):
            leaves = tree_leaves(shards)
            return tree_unflatten(shards, [
                s if d is None else self._gather(s, d)
                for s, d in zip(leaves, self.dims)])

        def reduce_scatter_grads(self, grads):
            import torch.distributed as dist

            leaves = tree_leaves(grads)
            out = []
            for g, d in zip(leaves, self.dims):
                if is_known_zeros(g):
                    out.append(g if d is None else known_zeros(
                        g.narrow(d, 0, g.shape[d] // self.world)))
                    continue
                if d is None:
                    dist.all_reduce(g, op=dist.ReduceOp.SUM)
                    out.append(g.div_(self.world))
                    continue
                x = (g if d == 0 else g.movedim(d, 0)).contiguous()
                part = torch.empty((x.shape[0] // self.world, *x.shape[1:]),
                                   dtype=x.dtype, device=x.device)
                sharding._collective("reduce_scatter_single",
                                     "reduce_scatter_tensor")(
                    part, x, op=dist.ReduceOp.SUM)
                part.div_(self.world)
                out.append(part if d == 0 else
                           part.movedim(0, d).contiguous())
            return tree_unflatten(grads, out)

    return PerLeafPlan(params, stage, rank, world)


class _Counted:
    """``torch.distributed``'s step collectives wrapped to count their
    calls while the context is open."""

    NAMES = ("all_reduce", "reduce_scatter_tensor", "reduce_scatter_single",
             "all_gather_into_tensor", "all_gather_single")

    def __enter__(self):
        import torch.distributed as dist

        self.counts = {n: 0 for n in self.NAMES}
        self._orig = {n: getattr(dist, n) for n in self.NAMES
                      if hasattr(dist, n)}

        def wrap(name, fn):
            def counted(*a, **k):
                self.counts[name] += 1
                return fn(*a, **k)
            return counted

        for n, fn in self._orig.items():
            setattr(dist, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for n, fn in self._orig.items():
            setattr(dist, n, fn)

    def summary(self) -> Dict[str, int]:
        c = self.counts
        return {"all_reduce": c["all_reduce"],
                "reduce_scatter": c["reduce_scatter_tensor"]
                + c["reduce_scatter_single"],
                "all_gather": c["all_gather_into_tensor"]
                + c["all_gather_single"]}


def _zero_checks(rank: int, n: int, payload: Dict[str, Any]
                 ) -> Dict[str, Any]:
    """Three steps of ZeRO-1, ZeRO-3 and the sharded update (ZeRO-1's step)
    from the same params and batches, once with the bucketed plan and
    once with :func:`per_leaf_plan`: each arm's final state (full params
    and moments, gathered) and its collectives a step."""
    from ray_lightning_tpu_torch.core.module import TrainState
    from ray_lightning_tpu_torch.models.convert import params_from_jax
    from ray_lightning_tpu_torch.models.gpt import GPTConfig
    from ray_lightning_tpu_torch.parallel import sharding
    from ray_lightning_tpu_torch.parallel.grad_sync import build_bucket_plan
    from ray_lightning_tpu_torch.parallel.mesh import DistContext
    from ray_lightning_tpu_torch.parallel.step_fns import DistributedStep

    dist_ctx = DistContext(rank, n, torch.device("cpu"), "gloo")
    module = ScaledGPT(GPTConfig(**payload["cfg"]), device="cpu")
    arrays = payload["arrays"]
    rows = payload["batch"] // n
    out: Dict[str, Any] = {}
    for stage in (1, 3):
        for kind in ("bucketed", "per_leaf"):
            params = params_from_jax(payload["tree"], "cpu")
            plan = (sharding.ZeroPlan(params, stage, rank, n)
                    if kind == "bucketed"
                    else per_leaf_plan(params, stage, rank, n))
            tx = module.configure_optimizers()
            shards = plan.shard_tree(params, own=True)
            state = TrainState(shards if stage == 3 else params,
                               tx.init(shards), 0)
            step = DistributedStep(module, tx, dist_ctx, zero_plan=plan)
            counts = []
            for s in range(payload["steps"]):
                lo = s * payload["batch"] + rank * rows
                batch = {k: torch.from_numpy(np.ascontiguousarray(
                    v[lo:lo + rows])) for k, v in arrays.items()}
                with _Counted() as c:
                    state, _ = step(state, batch, None)
                counts.append(c.summary())
            full = plan.all_gather(state.params) if stage == 3 \
                else state.params
            out[f"zero{stage}_{kind}"] = {
                "params": _flat(full),
                "opt": _flat(plan.gather_opt_state(state.opt_state)),
                "counts": counts}
        order = plan._order
        sharded = [i for i in order if plan.dims[i] is not None]
        repl = [i for i in order if plan.dims[i] is None]
        out[f"zero{stage}_buckets"] = {
            "sharded": build_bucket_plan(
                [plan.full_shapes[i] for i in sharded], n).num_buckets,
            "replicated": build_bucket_plan(
                [plan.full_shapes[i] for i in repl], n).num_buckets,
            "sharded_leaves": len(sharded), "replicated_leaves": len(repl)}
    return out


def zero_rank(rank: int, world: int, port: int, payload: Dict[str, Any]
              ) -> Dict[str, Any]:
    """One CPU rank of the bucketed ZeRO checks (submitted to a
    strategy's worker): joins a gloo group of ``world`` ranks, runs
    :func:`_zero_checks` over it and leaves it."""
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        return _zero_checks(rank, world, payload)
    finally:
        dist.destroy_process_group()


# -- restarts (tests/test_torch_restart.py, chip_smoke.py phase 17) -----------

class CrashOnce(Callback):
    """Hard-kills rank ``crash_rank`` at the start of epoch
    ``crash_epoch``, on the first attempt only: a marker file records that
    it happened, so the respawned worker set trains through."""

    def __init__(self, marker: str, crash_rank: int = 1,
                 crash_epoch: int = 1):
        self.marker = marker
        self.crash_rank = crash_rank
        self.crash_epoch = crash_epoch

    def on_train_epoch_start(self, trainer, module) -> None:
        import time

        if (trainer.global_rank == self.crash_rank
                and trainer.current_epoch == self.crash_epoch
                and not os.path.exists(self.marker)):
            with open(self.marker, "w") as f:
                f.write(repr(time.time()))
            os._exit(1)


class AlwaysCrash(CrashOnce):
    """As :class:`CrashOnce`, on every attempt."""

    def on_train_epoch_start(self, trainer, module) -> None:
        if (trainer.global_rank == self.crash_rank
                and trainer.current_epoch == self.crash_epoch):
            os._exit(1)


class BadHook(Callback):
    """Raises in user code at the first epoch's start."""

    def on_train_epoch_start(self, trainer, module) -> None:
        raise ValueError("deterministic user bug")


class EpochRecorder(Callback):
    """The epochs trained, a state that rides the restart checkpoints."""

    def __init__(self):
        self.epochs = []

    def on_train_epoch_end(self, trainer, module) -> None:
        self.epochs.append(trainer.current_epoch)

    def state_dict(self):
        return {"epochs": list(self.epochs)}

    def load_state_dict(self, state):
        self.epochs = list(state["epochs"])


class LoadStatsProbe(Callback):
    """Each rank's ``sharded_ckpt.LOAD_STATS`` at the fit's start (after a
    resume read its checkpoint) and the wall-clock time of its first
    step's end (the card synchronised), delivered to the driver's
    :data:`RECORDS` under ``label`` (a later attempt's replace an earlier
    one's)."""

    def __init__(self, label: str):
        self.label = label

    def on_fit_start(self, trainer, module) -> None:
        from ray_lightning_tpu_torch.utils import sharded_ckpt

        self._stats = dict(sharded_ckpt.LOAD_STATS)
        self._first = None
        self._resumed = bool(trainer.config.resume_from_checkpoint)

    def on_train_batch_end(self, trainer, module, logs, batch_idx) -> None:
        import functools
        import time

        from ray_lightning_tpu_torch import session

        if self._first is not None:
            return
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()
        self._first = time.time()
        payload = {"load_stats": self._stats, "first_step": self._first,
                   "resumed": self._resumed}
        if session.is_session_enabled():
            session.put_queue(functools.partial(
                record, self.label, trainer.global_rank, payload))
        else:
            record(self.label, 0, payload)


def restart_unit_checks(directory: str) -> Dict[str, bool]:
    """The restart plane's invariants checked in one process, without a
    card or JAX (``tests/test_torch_restart.py`` holds each True;
    ``chip_faults.py`` step 15 runs them on copies of the port with a fault
    planted, each of which must turn its check False):

    * ``write_order``: a rank's restart write is its shard, the barrier,
      then (rank 0) META;
    * ``walk_back``: discovery skips a newest checkpoint with a flipped
      byte and resumes the one before it;
    * ``selective_slices``: each rank's selective read of a two-rank
      ZeRO-3 directory is its own slices, bitwise;
    * ``accum_rederived``: a one-rank fit resuming a two-rank checkpoint
      trains at accum 2 (2 micro-steps, 1 optimizer step an epoch);
    * ``window``: a death older than ``restart_window_s`` does not count
      against ``max_restarts``;
    * ``ef_dropped``: a residual written at world 2 is dropped loudly (and
      zeroed) when resumed at world 4, even where its rows are as long
      as the new world's."""
    import types
    import warnings

    from ray_lightning_tpu_torch.cluster.actor import ActorDiedError
    from ray_lightning_tpu_torch.core import loop
    from ray_lightning_tpu_torch.core.module import TrainState
    from ray_lightning_tpu_torch.core.trainer import Trainer
    from ray_lightning_tpu_torch.models.gpt import (
        GPTConfig, SyntheticLMDataModule,
    )
    from ray_lightning_tpu_torch.parallel import strategies
    from ray_lightning_tpu_torch.parallel.grad_sync import (
        maybe_build_grad_sync,
    )
    from ray_lightning_tpu_torch.parallel.sharding import ZeroPlan
    from ray_lightning_tpu_torch.telemetry.runtime import Telemetry
    from ray_lightning_tpu_torch.utils import sharded_ckpt as sc
    from ray_lightning_tpu_torch.utils import treedef as td

    out: Dict[str, bool] = {}
    cfg = GPTConfig.tiny()
    module = GPT(cfg, device="cpu")
    tx = module.configure_optimizers()
    state = TrainState.create(module.init_params(
        torch.Generator().manual_seed(0)), tx)

    def trees(world, **kw):
        out_trees = []
        for r in range(world):
            plan = ZeroPlan(state.params, 3, r, world)
            mine = TrainState(plan.shard_tree(state.params),
                              plan.shard_opt_state(state.opt_state),
                              state.step)
            out_trees.append(sc.state_tree(mine, plan, r, world, **kw))
        return out_trees

    def write(tag, ranks, extra):
        for r, tree in enumerate(ranks):
            sc.save_shard(tree, tag, r, len(ranks))
        sc.save_meta(ranks[0], tag, len(ranks), extra=extra)

    # write_order
    calls: List[str] = []

    class FakeDist:
        rank, world_size = 0, 2

        def barrier(self):
            calls.append("barrier")

    ctx = loop.LoopContext(loop.FitConfig(restart_dir=os.path.join(
        directory, "order")), torch.device("cpu"), FakeDist())
    ctx.telemetry = Telemetry.build("off")
    ctx.state = state
    saved = sc.save_shard, sc.save_meta
    sc.save_shard = lambda *a, **k: calls.append("shard")
    sc.save_meta = lambda *a, **k: calls.append("meta")
    try:
        loop._write_restart(ctx, [], 1, 0)
    finally:
        sc.save_shard, sc.save_meta = saved
    out["write_order"] = calls == ["shard", "barrier", "meta"]

    # walk_back
    rdir = os.path.join(directory, "walk")
    tags = [os.path.join(rdir, f"restart-epoch-{e:06d}.ckpt")
            for e in (0, 1)]
    for e, tag in enumerate(tags):
        write(tag, trees(1), {"epoch": e})
        os.utime(os.path.join(tag, "META.ckpt"), (e + 1, e + 1))
    path = os.path.join(tags[1], "shard-00000-of-00001.ckpt")
    with open(path, "r+b") as f:
        f.seek(-7, 2)
        b = f.read(1)
        f.seek(-7, 2)
        f.write(bytes([b[0] ^ 0x10]))
    info = strategies._remote_latest_restart_checkpoint(rdir)
    out["walk_back"] = (info["path"] == tags[0]
                        and [c["path"] for c in info["corrupt"]]
                        == [tags[1]])

    # selective_slices
    tag = os.path.join(directory, "zero3.ckpt")
    ranks = trees(2)
    write(tag, ranks, {"epoch": 0, "global_step": 2, "micro_step": 2,
                       "world_size": 2, "accum": 1})
    same = True
    for tree in ranks:
        got = td.flatten(sc.load_sharded(tag, targets=tree)["state"])[1]
        want = [x.data if isinstance(x, sc.Shard) else x
                for x in td.flatten(tree)[1]]
        same = same and sc.LOAD_STATS["selective"] and all(
            torch.equal(a, w) for a, w in zip(got, want))
    out["selective_slices"] = bool(same)

    # accum_rederived: epoch 1 of 2 batches, resumed at world 1.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr = Trainer(strategies.LocalStrategy(device="cpu"), max_epochs=2,
                     limit_train_batches=2, limit_val_batches=0,
                     enable_checkpointing=False,
                     default_root_dir=os.path.join(directory, "fit"),
                     resume_from_checkpoint=tag)
        tr.fit(GPT(cfg, device="cpu"), SyntheticLMDataModule(
            cfg, batch_size=2, num_batches=2, seed=0))
    out["accum_rederived"] = (tr.micro_step, tr.global_step) == (4, 3)

    # window
    clock = [1000.0]
    s = strategies.RayStrategy(num_workers=1, device="cpu", max_restarts=1,
                               restart_window_s=60.0, restart_backoff_s=0.0)
    s._workers = [object()]
    s._respawn_workers = s._kill_workers = lambda: None
    s._latest_restart_checkpoint = lambda d: {"path": None, "corrupt": []}
    attempts = [0]

    def run_once(*a):
        attempts[0] += 1
        if attempts[0] == 2:
            clock[0] += 61.0
        if attempts[0] <= 2:
            raise ActorDiedError(f"death {attempts[0]}")
        return [{"rank": 0}]

    s._run_once = run_once
    real_time = strategies.time
    strategies.time = types.SimpleNamespace(monotonic=lambda: clock[0],
                                            sleep=real_time.sleep)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s.run("fit", None, None, loop.FitConfig(
                default_root_dir=os.path.join(directory, "gov")), [])
        out["window"] = s.restarts_used == 2
    except ActorDiedError:
        out["window"] = False
    finally:
        strategies.time = real_time

    # ef_dropped
    params = {"w": torch.zeros(1024)}
    small = TrainState.create(params, tx)
    rows = [torch.full((1024,), float(r + 1)) for r in range(2)]
    tag = os.path.join(directory, "ef.ckpt")
    write(tag, [sc.state_tree(small, None, r, 2, residual=rows[r])
                for r in range(2)], {"epoch": 0, "world_size": 2})
    payload = sc.load_sharded(tag)
    gs = maybe_build_grad_sync(None, {"mode": "int8_ef"}, 4, params=params)
    fake = types.SimpleNamespace(world_size=4, global_rank=1)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        loaded = loop._loaded_state(payload["state"], fake,
                                    payload["world_size"])
        new = gs.reconcile_resumed_state(loaded)
    out["ef_dropped"] = (
        gs.plan.total_padded == 1024
        and not bool(new.grad_residual.abs().sum())
        and any("does not survive" in str(x.message) for x in w))
    return out
