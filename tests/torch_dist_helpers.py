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


def warm_up(device: str) -> None:
    """An ``init_hook``: import the port's model (torch, the kernels'
    wrappers and all) before the worker's first task, and on a card run
    one bf16 step of a one-layer GPT of GPT-2-small's width (the kernels,
    remat "dots+flash", CE over the 50304-token vocabulary) on 2 x 1024
    tokens, so the CUDA context, the kernels' libraries and PyTorch's
    own kernels are loaded before the fit's first step."""
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
                worlds=(3, 2)) -> Dict[int, List[Dict[str, Any]]]:
    """:func:`wire_rank` on the first ``n`` of ``workers`` (CPU workers of
    a strategy) for each ``n`` of ``worlds`` in turn, each a world of its
    own: ``{n: [rank 0's results, ...]}``."""
    from ray_lightning_tpu_torch.cluster.rpc import find_free_port

    out = {}
    for n in worlds:
        port = find_free_port()
        futures = [w.submit(wire_rank, rank, n, port, payload)
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
