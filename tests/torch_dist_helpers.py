"""Picklable pieces of the port's multi-process tests.

The port's workers get every class and function by reference (stdlib
pickle), so what a test ships to them lives in an importable module;
this one imports neither jax nor the JAX package, so a worker that
unpickles it loads only the port.
"""

from __future__ import annotations

import importlib
import math
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
    0 at the fit's start), the per-step losses (and MoE's
    ``moe_aux_loss``), the wall-clock times of the fit's start and end, and on one rank the vector leaves of the
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
        self._times, self._losses, self._aux = [], [], []
        self._start = time.time()
        self._t = time.perf_counter()

    def on_train_batch_end(self, trainer, module, logs, batch_idx) -> None:
        import time

        self._sync(trainer)
        now = time.perf_counter()
        self._times.append(now - self._t)
        self._t = now
        self._losses.append(float(logs["train_loss"]))
        if "moe_aux_loss" in logs:
            self._aux.append(float(logs["moe_aux_loss"]))

    def on_fit_end(self, trainer, module) -> None:
        import time

        from ray_lightning_tpu_torch import session

        cuda = trainer.device.type == "cuda"
        payload = {"setup_bytes": self._setup_bytes, "aux": self._aux,
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


def tee_warnings(path: str) -> None:
    """Every warning this process shows from now on is also appended to
    ``path``, one line each (a worker's warnings, for the driver to
    read)."""
    import warnings

    show = warnings.showwarning

    def tee(message, category, filename, lineno, file=None, line=None):
        with open(path, "a") as f:
            f.write(f"pid {os.getpid()}: {category.__name__}: "
                    f"{message}\n".replace("\n", " ") + "\n")
        show(message, category, filename, lineno, file, line)

    warnings.simplefilter("always")
    warnings.showwarning = tee


def warm_up(device: str, warnings_to: str = None) -> None:
    """An ``init_hook``: import the port's model (torch, the kernels'
    wrappers and all) before the worker's first task, and on a card run
    one bf16 step of a one-layer GPT of GPT-2-small's width (the kernels,
    remat "dots+flash", CE over the 50304-token vocabulary) on 2 x 1024
    tokens, so the CUDA context, the kernels' libraries and PyTorch's
    own kernels are loaded before the fit's first step.  With
    ``warnings_to``, :func:`tee_warnings` to that file."""
    if warnings_to is not None:
        tee_warnings(warnings_to)
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
        def all_gather(self, shards, update=False):
            # (No int8 moments here: the update layout is the stored one.)
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


# -- the sharded update's cost, split (chip_smoke.py --phase16 p_*) -----------

# The parts a profiled step is cut into: the wrapped callable, the range
# it records.  Each wrapped call synchronises the card at its entry and its
# exit, so a part's wall time is its launches and its device work, not the
# queue it found.
_SPLIT_TARGETS = (
    ("ray_lightning_tpu_torch.parallel.step_fns", None, "loss_and_grads",
     "grads"),
    ("ray_lightning_tpu_torch.parallel.grad_sync", "BucketSync", "__call__",
     "sync"),
    ("ray_lightning_tpu_torch.parallel.sharding", "ZeroPlan",
     "reduce_scatter_grads", "reduce_scatter"),
    ("ray_lightning_tpu_torch.parallel.sharding", "ZeroPlan", "all_gather",
     "all_gather"),
    ("ray_lightning_tpu_torch.parallel.sharding", "ZeroPlan", "norm_sq",
     "norm_sq"),
    ("ray_lightning_tpu_torch.parallel.step_fns", "DistributedStep",
     "_sharded_update", "update"),
    ("ray_lightning_tpu_torch.core.module", "TrainState", "apply_gradients",
     "update"),
    ("ray_lightning_tpu_torch.parallel.mesh", "DistContext", "mean_logs",
     "mean_logs"),
)
_SPLIT_COLLECTIVES = ("all_reduce", "reduce_scatter_tensor",
                      "all_gather_into_tensor", "reduce_scatter_single",
                      "all_gather_single")


class StepSplit(Callback):
    """One training step of the rank (the ``step``-th, 0-based) profiled
    with ``torch.profiler`` and cut into parts: the card synchronised at
    the entry and exit of each part (:data:`_SPLIT_TARGETS`, and every
    ``torch.distributed`` collective inside them, the range
    ``collective``), each part's wall ms booked under its range.  On
    the driver's :data:`RECORDS` under ``label``: the ranges' ms, the
    step's wall ms, the profiler's device ms of kernels and of host-device
    copies, and the split of the step (:func:`split_step`)."""

    def __init__(self, label: str, step: int = 2):
        self.label = label
        self.step = step

    def on_train_batch_end(self, trainer, module, logs, batch_idx) -> None:
        import time

        if batch_idx == self.step - 1:
            self._sync = (torch.cuda.synchronize
                          if trainer.device.type == "cuda" else lambda: None)
            self._sync()
            self._install()
            self._prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._t0 = time.perf_counter()
        elif batch_idx == self.step:
            self._sync()
            wall = time.perf_counter() - self._t0
            self._prof.__exit__(None, None, None)
            self._uninstall()
            self._deliver(trainer, wall)

    def _install(self) -> None:
        import time

        import torch.distributed as dist

        self.ms: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self._saved = []
        stack: List[str] = []

        def wrap(fn, name):
            def inner(*a, **kw):
                # A collective is booked under the part it runs in.
                key = (f"{name}@{stack[-1] if stack else 'step'}"
                       if name == "collective" else name)
                self._sync()
                t = time.perf_counter()
                stack.append(name)
                try:
                    with torch.profiler.record_function("rlt." + name):
                        out = fn(*a, **kw)
                        self._sync()
                finally:
                    stack.pop()
                self.ms[key] = self.ms.get(key, 0.0) + 1e3 * (
                    time.perf_counter() - t)
                self.calls[key] = self.calls.get(key, 0) + 1
                return out
            return inner

        for mod_name, cls_name, attr, name in _SPLIT_TARGETS:
            owner = importlib.import_module(mod_name)
            if cls_name is not None:
                owner = getattr(owner, cls_name)
            fn = owner.__dict__[attr] if cls_name else getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, wrap(fn, name))
        for attr in _SPLIT_COLLECTIVES:
            fn = getattr(dist, attr, None)
            if fn is not None:
                self._saved.append((dist, attr, fn))
                setattr(dist, attr, wrap(fn, "collective"))

    def _uninstall(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []

    def _deliver(self, trainer, wall_s: float) -> None:
        import functools

        from ray_lightning_tpu_torch import session

        kernel_us = copy_us = 0.0
        for e in self._prof.key_averages():
            dev = float(getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0)))
            if e.key.startswith(("rlt.", "ProfilerStep")):
                continue  # a range's device time is its kernels'
            if e.key.startswith("Memcpy"):
                copy_us += dev
            else:
                kernel_us += dev
        payload = {"wall_ms": 1e3 * wall_s, "ms": dict(self.ms),
                   "calls": dict(self.calls),
                   "device_kernel_ms": kernel_us / 1e3,
                   "device_copy_ms": copy_us / 1e3}
        payload["split"] = split_step(payload)
        if session.is_session_enabled():
            session.put_queue(functools.partial(
                record, self.label, trainer.global_rank, payload))
        else:
            record(self.label, 0, payload)


def split_step(rec: Dict[str, Any]) -> Dict[str, float]:
    """A profiled step (:class:`StepSplit`'s payload) in the four parts of
    the sharded update's cost, ms: ``collectives`` (the gradient sync's
    and the param gather's collectives, the clip's norm all-reduce among
    them), ``update`` (the optimizer on the state it updates, the slicing
    included), ``copies`` (into and out of the buckets: the sync ranges
    less their collectives), and ``gaps`` (the rest of the step past the
    forward and backward, ``grads``, and the logs' mean)."""
    ms = rec["ms"]
    parts = ("sync", "reduce_scatter", "all_gather", "norm_sq")
    coll = sum(ms.get(f"collective@{p}", 0.0) for p in parts)
    sync = sum(ms.get(p, 0.0) for p in parts)
    update = ms.get("update", 0.0) - ms.get("all_gather", 0.0) - ms.get(
        "norm_sq", 0.0)
    mean_logs = ms.get("mean_logs", 0.0)
    return {"grads": ms.get("grads", 0.0), "collectives": coll,
            "update": update, "copies": sync - coll,
            "gaps": (rec["wall_ms"] - ms.get("grads", 0.0) - mean_logs
                     - sync - update),
            "mean_logs": mean_logs}


# -- int8 moments under ZeRO (tests/test_torch_zero_int8.py) ------------------

def _int8_zero_checks(rank: int, n: int, payload: Dict[str, Any]
                      ) -> Dict[str, Any]:
    """Two AdamW updates with int8 moments of a params dict of
    ``payload["shapes"]``, from the same seeded params and gradients:
    once whole, as one device runs them, and once as this rank's ZeRO
    stage-1 update of its runs (``ZeroPlan.update_view``, the moments
    sharded with ``shard_opt_state``), its new params all-gathered and
    its moments gathered.  Returns both, and each param's update layout
    and each moment's run."""
    from ray_lightning_tpu_torch.models import optim as topt
    from ray_lightning_tpu_torch.parallel import sharding

    rng = np.random.default_rng(payload["seed"])
    shapes = payload["shapes"]

    def tree(scale):
        return {f"p{i}_w": torch.from_numpy(
            (rng.standard_normal(s) * scale).astype(np.float32))
            for i, s in enumerate(shapes)}

    params = tree(1.0)
    grads = [tree(1e-2), tree(1e-3)]
    tx = topt.quantize_opt_state(topt.adamw(
        lambda c: torch.tensor(1e-3), b1=0.9, b2=0.95, weight_decay=0.1,
        mask=topt.decay_mask, mu_dtype=torch.float32), "int8")
    whole_p, whole_s = params, tx.init(params)
    for g in grads:
        upd, whole_s = tx.update(g, whole_s, whole_p)
        whole_p = topt.apply_updates(whole_p, upd)
    plan = sharding.ZeroPlan(params, 1, rank, n)
    state = plan.shard_opt_state(tx.init(params))
    plan.set_moment_layout(state)
    p = params
    for g in grads:
        view = plan.update_view(p)
        upd, state = tx.update(plan.update_view(g), state, view)
        p = plan.all_gather(topt.apply_updates(view, upd), update=True)
    runs = {str(path): (bq.shard.start, bq.q.numel(), bq.shard.scale_sharded)
            for path, bq in sharding._quantized_nodes(state)
            if bq.shard is not None}
    return {"whole": {"params": _flat(whole_p), "opt": _flat(whole_s)},
            "zero": {"params": _flat(p),
                     "opt": _flat(plan.gather_opt_state(state))},
            "udims": list(plan.udims), "flat": list(plan.flat),
            "dims": list(plan.dims), "runs": runs}


def int8_zero_rank(rank: int, world: int, port: int,
                   payload: Dict[str, Any]) -> Dict[str, Any]:
    """One CPU rank of the int8-moment ZeRO update checks (submitted to a
    strategy's worker): joins a gloo group of ``world`` ranks, runs
    :func:`_int8_zero_checks` over it and leaves it."""
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        return _int8_zero_checks(rank, world, payload)
    finally:
        dist.destroy_process_group()


class PlanProbe(Callback):
    """Each rank's ZeRO plan at the fit's end (its place in the group it
    shards over, the group's size, the slice's replicas) and a digest of
    its state's slices, delivered to the driver's :data:`RECORDS` under
    ``label``: ranks holding the same slices hold the same digest."""

    def __init__(self, label: str):
        self.label = label

    def on_fit_end(self, trainer, module) -> None:
        import functools
        import hashlib

        from ray_lightning_tpu_torch import session
        from ray_lightning_tpu_torch.models.optim import tree_leaves

        plan = trainer.zero_plan
        h = hashlib.sha256()
        for t in tree_leaves((trainer.state.params,
                              trainer.state.opt_state)):
            h.update(t.detach().cpu().reshape(-1).contiguous()
                     .view(torch.uint8).numpy().tobytes())
        from ray_lightning_tpu_torch.models.optim import moment_bytes

        f32 = sum(8 * math.prod(plan.shard_shape(i))
                  for i in range(len(plan.dims)))
        payload = {"rank": plan.rank, "world": plan.world,
                   "replicas": plan.replicas, "digest": h.hexdigest(),
                   "moment_bytes": moment_bytes(trainer.state.opt_state),
                   "f32_moment_bytes": f32,
                   "peak_bytes": (torch.cuda.max_memory_allocated()
                                  if trainer.device.type == "cuda" else 0)}
        if session.is_session_enabled():
            session.put_queue(functools.partial(
                record, self.label, trainer.global_rank, payload))
        else:
            record(self.label, 0, payload)


# -- the sharded CE island (tests/test_torch_ce_island.py, chip_smoke.py
# phase 18 (d)) ---------------------------------------------------------------

def island_checks(rank: int, n: int, payload: Dict[str, Any],
                  device: str = "cpu") -> Dict[str, Any]:
    """This rank's rows of ``payload``'s global ``x``/``targets`` through
    ``ops.cross_entropy.fused_lm_head_cross_entropy_sharded`` (its share
    of the global mean, ``sum / global tokens``), differentiated: the
    share, its ``dx`` rows, ``dwte`` and the collectives the backward
    issued; and the island's refusal of a global batch that does not
    split."""
    import torch.distributed as dist

    from ray_lightning_tpu_torch.ops.cross_entropy import (
        fused_lm_head_cross_entropy_sharded,
    )

    device = payload.get("device", device)
    if "seed" in payload:
        x, wte, t = island_inputs(payload, device, n)
    else:
        x = torch.from_numpy(payload["x"]).to(device)
        wte = torch.from_numpy(payload["wte"]).to(device)
        t = torch.from_numpy(payload["targets"]).to(device)
    B = x.shape[0]
    rows = slice(rank * B // n, (rank + 1) * B // n)
    xr = x[rows].clone().requires_grad_(True)
    w = wte.clone().requires_grad_(True)
    dtype = getattr(torch, payload.get("compute_dtype", "float32"))
    losses = fused_lm_head_cross_entropy_sharded(
        xr, w, t[rows], global_batch=B, compute_dtype=dtype,
        use_kernel=payload["use_kernel"])
    share = losses.sum() / t.numel()
    with _Counted() as c:
        share.backward()
    try:
        fused_lm_head_cross_entropy_sharded(xr, w, t[rows],
                                            global_batch=B - 1)
        refused = ""
    except ValueError as e:
        refused = str(e)
    total = share.detach().clone()
    dist.all_reduce(total)
    return {"share": float(share.detach()), "loss": float(total),
            "dx": xr.grad.float().cpu().numpy(),
            "dwte": w.grad.float().cpu().numpy(),
            "collectives": c.summary(), "refused": refused}


def island_inputs(payload: Dict[str, Any], device: str, ranks: int):
    """The global ``x (ranks·B, T, d)``, ``wte (V, d)`` and targets of
    ``payload["shape"]`` (a rank's ``B``), made on ``device`` from
    ``payload["seed"]``: the same tensors on every rank and in the
    driver."""
    sh = payload["shape"]
    g = torch.Generator(device=device).manual_seed(payload["seed"])
    B = ranks * sh["B"]
    x = torch.randn((B, sh["T"], sh["d"]), generator=g, device=device)
    wte = torch.randn((sh["V"], sh["d"]), generator=g, device=device) * 0.1
    t = torch.randint(0, sh["V"], (B, sh["T"]), generator=g, device=device,
                      dtype=torch.int32)
    return x, wte, t


def island_rank(rank: int, world: int, port: int, payload: Dict[str, Any]
                ) -> Dict[str, Any]:
    """One CPU rank of the island checks (submitted to a strategy's
    worker): joins a gloo group of ``world`` ranks, runs
    :func:`island_checks` over it and leaves it."""
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        return island_checks(rank, world, payload)
    finally:
        dist.destroy_process_group()


# -- captured megastep under a process group (chip_smoke.py phase 18 (a)) -----

class GraphProbe(Callback):
    """The rank's CUDA graphs of the fit (a captured megastep stride's):
    from the fit's start every ``torch.cuda.CUDAGraph`` keeps its graph
    (``keep_graph``, debug mode), and every ``torch.distributed``
    collective the rank issues is counted, apart for the calls made while
    its stream captures (the collectives a stride's graph holds, whether
    NCCL makes them nodes or, at one rank, nothing at all), the counts
    taken at each step's (or stride's) end.  At the fit's end: each
    graph's kernel nodes by mangled name (its DOT dump), the collectives
    issued eagerly and under capture, the peak memory and what the
    allocator holds; delivered to the driver's :data:`RECORDS` under
    ``label``."""

    NAMES = ("all_reduce", "reduce_scatter_tensor", "reduce_scatter_single",
             "all_gather_into_tensor", "all_gather_single", "broadcast")

    def __init__(self, label: str):
        self.label = label

    def on_fit_start(self, trainer, module) -> None:
        import torch.distributed as dist

        self.graphs: list = []
        self.calls = {"eager": 0, "captured": 0}
        # The counts at each step's (or stride's) end: the collectives of
        # the steps between two ends, apart from the fit's own around them.
        self.marks: list = []
        base = self._base = torch.cuda.CUDAGraph
        graphs = self.graphs

        class Kept(base):
            def __init__(self, *args, **kwargs):
                super().__init__(keep_graph=True)
                self.enable_debug_mode()
                graphs.append(self)

        torch.cuda.CUDAGraph = Kept
        self._orig = {n: getattr(dist, n) for n in self.NAMES
                      if hasattr(dist, n)}

        def wrap(fn):
            def counted(*a, **k):
                key = ("captured" if torch.cuda.is_current_stream_capturing()
                       else "eager")
                self.calls[key] += 1
                return fn(*a, **k)
            return counted

        for n, fn in self._orig.items():
            setattr(dist, n, wrap(fn))

    def on_train_batch_end(self, trainer, module, logs, batch_idx) -> None:
        self.marks.append(dict(self.calls))

    def on_fit_end(self, trainer, module) -> None:
        import collections
        import functools
        import re
        import tempfile
        import warnings

        import torch.distributed as dist

        from ray_lightning_tpu_torch import session

        torch.cuda.CUDAGraph = self._base
        for n, fn in self._orig.items():
            setattr(dist, n, fn)
        nodes = []
        with tempfile.TemporaryDirectory() as tmp:
            for i, g in enumerate(self.graphs):
                path = os.path.join(tmp, f"g{i}.dot")
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    g.debug_dump(path)
                with open(path) as f:
                    text = f.read()
                nodes.append(dict(collections.Counter(
                    re.findall(r"\b(_Z\w+|nccl\w+)", text))))
        torch.cuda.synchronize()
        payload = {"graphs": nodes, "calls": dict(self.calls),
                   "marks": self.marks,
                   "peak_bytes": torch.cuda.max_memory_allocated(),
                   "reserved_bytes": torch.cuda.memory_reserved()}
        if session.is_session_enabled():
            session.put_queue(functools.partial(
                record, self.label, trainer.global_rank, payload))
        else:
            record(self.label, 0, payload)


# -- model parallelism (tests/test_torch_model_parallel.py, ring) ------------

class GradProbe(Callback):
    """Each rank's gradient of its first step, as the rank's backward
    leaves it (the gradient of its own loss, before the sync; under
    ``tensor`` and ``expert`` the copy-in all-reduces already applied), by
    key path, delivered to :data:`RECORDS` under ``label``.  For the fit's
    span ``step_fns.loss_and_grads`` is wrapped to keep the first call's
    result."""

    def __init__(self, label: str):
        self.label = label

    def on_fit_start(self, trainer, module) -> None:
        from ray_lightning_tpu_torch.parallel import step_fns
        from ray_lightning_tpu_torch.parallel.sharding import (
            leaves_with_paths,
        )

        self._orig = step_fns.loss_and_grads
        self._grads = None
        probe = self

        def kept(*args, **kwargs):
            grads, logs = probe._orig(*args, **kwargs)
            if probe._grads is None:
                probe._grads = {"/".join(map(str, p)):
                                t.detach().float().cpu().numpy().copy()
                                for p, t in leaves_with_paths(grads)}
            return grads, logs

        step_fns.loss_and_grads = kept

    def on_fit_end(self, trainer, module) -> None:
        from ray_lightning_tpu_torch import session
        from ray_lightning_tpu_torch.parallel import step_fns

        step_fns.loss_and_grads = self._orig
        payload = {"grads": self._grads}
        if session.is_session_enabled():
            import functools

            session.put_queue(functools.partial(
                record, self.label, trainer.global_rank, payload))
        else:
            record(self.label, 0, payload)


def ring_rank(rank: int, world: int, port: int, payload: Dict[str, Any]
              ) -> Dict[str, Any]:
    """One CPU rank of the ring checks: joins a gloo group of ``world``
    ranks, runs ``ring_causal_attention`` on its rows of the payload's
    (B, S, H, D) ``q``/``k``/``v`` (zig-zag order for that layout) and
    backpropagates its rows of ``cot``; returns its rows of the output and
    of dq, dk, dv."""
    import datetime

    import torch.distributed as dist

    from ray_lightning_tpu_torch.ops.ring_attention import (
        ring_causal_attention, zigzag_indices,
    )
    from ray_lightning_tpu_torch.parallel.model_parallel import AxisGroup

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        layout = payload["layout"]
        S = payload["q"].shape[1]
        order = (zigzag_indices(S, world) if layout == "zigzag"
                 else np.arange(S))
        s = S // world
        rows = order[rank * s:(rank + 1) * s]
        q, k, v = (torch.from_numpy(payload[n][:, rows].copy()
                                    ).requires_grad_(True)
                   for n in ("q", "k", "v"))
        group = AxisGroup(None, rank, world, tuple(range(world)))
        out = ring_causal_attention(q, k, v, group, layout)
        out.backward(torch.from_numpy(payload["cot"][:, rows].copy()))
        return {"rows": rows, "out": out.detach().numpy(),
                "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                "dv": v.grad.numpy()}
    finally:
        dist.destroy_process_group()


def ring_inputs(payload: Dict[str, Any], device) -> List[torch.Tensor]:
    """``q``, ``k``, ``v`` and the output's cotangent, (B, S, H, D) f32,
    drawn from ``payload["seed"]`` on the CPU and put on ``device``."""
    g = torch.Generator().manual_seed(int(payload["seed"]))
    return [torch.randn(tuple(payload["shape"]), generator=g).to(device)
            for _ in range(4)]


def ring_card_rank(rank: int, world: int, port: int,
                   payload: Dict[str, Any]) -> Dict[str, Any]:
    """One gloo rank on the card (``chip_smoke.py`` phase 19 (a); on the
    CPU where ``payload["device"]`` says so): the ring's forward and input
    gradients over its rows of :func:`ring_inputs` (on the card the route
    gloo-host: blocks staged through the host); and the ms of a hop of
    ``payload["hop_shape"]`` (k and v stacked, bf16) over the route, a
    median of five after one."""
    import datetime
    import time

    import torch.distributed as dist

    from ray_lightning_tpu_torch.ops.ring_attention import (
        _exchange, hop_route, ring_causal_attention, zigzag_indices,
    )
    from ray_lightning_tpu_torch.parallel.model_parallel import AxisGroup

    cuda = payload.get("device", "cuda") == "cuda"
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        q, k, v, cot = ring_inputs(payload, device)
        S = q.shape[1]
        order = (zigzag_indices(S, world) if payload["layout"] == "zigzag"
                 else np.arange(S))
        s = S // world
        rows = torch.as_tensor(order[rank * s:(rank + 1) * s].astype(
            np.int64), device=device)
        mine = [x.index_select(1, rows).requires_grad_(True)
                for x in (q, k, v)]
        group = AxisGroup(None, rank, world, tuple(range(world)))
        out = ring_causal_attention(*mine, group, payload["layout"])
        out.backward(cot.index_select(1, rows))
        block = torch.randn(tuple(payload["hop_shape"]), device=device
                            ).to(torch.bfloat16)
        times = []
        for _ in range(6):
            sync()
            t0 = time.perf_counter()
            _exchange(block, group, group.rank_at(rank + 1),
                      group.rank_at(rank - 1))
            sync()
            times.append(time.perf_counter() - t0)
        hop = sorted(times[1:])[2]
        return {"rows": rows.cpu().numpy(),
                "out": out.detach().cpu().numpy(),
                "dq": mine[0].grad.cpu().numpy(),
                "dk": mine[1].grad.cpu().numpy(),
                "dv": mine[2].grad.cpu().numpy(),
                "route": hop_route(group, block),
                "hop_ms": 1e3 * hop,
                "hop_bytes": block.numel() * block.element_size()}
    finally:
        dist.destroy_process_group()


class ShapeProbe(Callback):
    """The rank's param shapes and bytes once the state is built (its
    slices under model axes, and under ZeRO-3 the ZeRO slices of those),
    its model-parallel slices' shapes (``trainer.model_plan``), and a
    digest of each of its final param leaves, by key path, delivered to
    :data:`RECORDS` at the fit's end."""

    def __init__(self, label: str):
        self.label = label

    def on_fit_start(self, trainer, module) -> None:
        from ray_lightning_tpu_torch.parallel.sharding import (
            leaves_with_paths,
        )

        leaves = list(leaves_with_paths(trainer.state.params))
        plan = getattr(trainer, "model_plan", None)
        self._payload = {
            "shapes": {"/".join(map(str, p)): tuple(t.shape)
                       for p, t in leaves},
            "model_shapes": {} if plan is None else {
                "/".join(map(str, p)): s for p, s in zip(
                    plan.paths, plan.local_shapes)},
            "param_bytes": sum(t.numel() * t.element_size()
                               for _, t in leaves)}

    def on_fit_end(self, trainer, module) -> None:
        import hashlib

        from ray_lightning_tpu_torch import session
        from ray_lightning_tpu_torch.parallel.sharding import (
            leaves_with_paths,
        )

        payload = dict(self._payload, digests={
            "/".join(map(str, p)): hashlib.sha1(
                t.detach().cpu().contiguous().view(torch.uint8).numpy()
                .tobytes()).hexdigest()
            for p, t in leaves_with_paths(trainer.state.params)})
        if session.is_session_enabled():
            import functools

            session.put_queue(functools.partial(
                record, self.label, trainer.global_rank, payload))
        else:
            record(self.label, 0, payload)
