"""Model parallelism on four CPU ranks over gloo, held against the JAX
package's fits over the same meshes of CPU test devices: ring attention
over ``{"data": 2, "sp": 2}`` in both layouts (and under ZeRO-1, the
``data`` group's slices all-reduced along ``sp``), Megatron tensor
parallelism over ``{"data": 2, "tensor": 2}`` and over ``{"tensor": 2}``
alone, ZeRO-3 over ``{"fsdp": 2, "tensor": 2}``, and MoE expert
parallelism over ``{"data": 2, "expert": 2}`` and over ``{"expert": 2,
"tensor": 2}`` (the meshes of model axes only, where a rank's replica
group is itself and its gradients take no sync); every fit through
``Trainer.fit`` with the strategy's ``mesh_axes``, on the first of one
module-scoped pool of four workers.

Each arm runs three steps of the narrow GPT (``torch_multi_fits.CFG``)
from the same JAX init tree on the same batches, with the loss scaled by
``torch_dist_helpers.SCALES`` so that the clip (global norm 1.0) binds at
the first and third steps (checked on the JAX gradient): a clip whose
norm counted a replicated leaf once per tensor rank, or missed a slice,
moves the later updates.  Checked against the JAX fit:

* the per-step losses within 5e-6 (f32 summed in another order: the
  ring's online softmax, the tensor ranks' partial products, the
  experts' partial outputs; about 5e-7 measured);
* every leaf's gradient of the first step within 1e-5 of the leaf's
  largest JAX element (max abs difference over it; the first batch's
  loss scale 60 puts elements near 10; about 8e-7 measured): each
  rank's backward (``torch_dist_helpers.GradProbe``) averaged over its
  replica group (the ranks along ``data`` and ``sp``) against its slice
  (``models.convert.shard_params``, ``qkv`` by heads) of ``jax.grad`` of
  the same loss over the global batch.  A misplaced copy-in leaves a
  replicated leaf's gradient partial; a contiguous ``qkv`` split hands a
  rank the wrong columns;
* the gathered final params (the JAX global arrays) within 5e-6 (about
  3e-7 measured).

MoE runs at drop-free capacity (factor 4.0 = E), where the JAX routing
groups only relabel slots, over ``{"data": 2, "expert": 2}`` and over
four data shards (the load-balance loss over every shard's statistics,
as JAX takes it over every group), and its ``moe_aux_loss`` is held
within 1e-5.
Every refusal under model axes is checked to raise, naming its ROADMAP
item: the model's and the mesh's on the driver
(``strategies.check_model_axes``), the fit's knobs on the ranks (the
loop's resolvers; a ``RemoteError`` carrying the ranks'
``NotImplementedError``), and megastep's auto resolving to 1 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as helpers
import torch_multi_fits as mf
from ray_lightning_tpu.core import loop as jax_loop
from ray_lightning_tpu.core.callbacks import Callback as JaxCallback
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from ray_lightning_tpu.parallel.mesh import build_mesh as jax_build_mesh
from ray_lightning_tpu.utils import state_stream as jax_ss
from ray_lightning_tpu_torch.cluster.actor import RemoteError
from ray_lightning_tpu_torch.core import loop
from ray_lightning_tpu_torch.core.loop import FitConfig
from ray_lightning_tpu_torch.models.convert import (
    params_from_jax, shard_params,
)
from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
from ray_lightning_tpu_torch.parallel.mesh import REPLICA_AXES, RankLayout
from ray_lightning_tpu_torch.parallel.model_parallel import AxisGroup
from ray_lightning_tpu_torch.parallel.strategies import (
    RayShardedStrategy, RayStrategy,
)

BATCH, STEPS = 8, 3
MOE = dict(n_experts=4, moe_capacity_factor=4.0)
ARMS = {
    "sp_contiguous": ({"data": 2, "sp": 2}, 0, {}, dict(attn_impl="ring")),
    "sp_zigzag": ({"data": 2, "sp": 2}, 0, {},
                  dict(attn_impl="ring", ring_layout="zigzag")),
    "tensor": ({"data": 2, "tensor": 2}, 0, {}, {}),
    "fsdp_tensor_zero3": ({"fsdp": 2, "tensor": 2}, 3, {}, {}),
    "sp_zero1": ({"data": 2, "sp": 2}, 1, {}, dict(attn_impl="ring")),
    "expert": ({"data": 2, "expert": 2}, 0, MOE, {}),
    "tensor_only": ({"tensor": 2}, 0, {}, {}),
    "expert_tensor": ({"expert": 2, "tensor": 2}, 0, MOE, {}),
    "moe_data": ({"data": 4}, 0, MOE, {}),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    strategy = RayStrategy(num_workers=4, **mf.WORKER)
    with mf.limit():
        strategy.setup()
    yield strategy
    strategy.teardown()


@pytest.fixture(scope="module")
def data():
    return helpers.scaled_batches(mf.CFG["vocab_size"], mf.CFG["seq_len"],
                                  BATCH, STEPS, seed=5)


def _cfg(extra):
    return {**mf.CFG, **extra}


def _tree(extra):
    return jax.tree.map(np.asarray, JaxGPT(JaxGPTConfig(**_cfg(
        extra))).init_params(jax.random.PRNGKey(2)))


class JaxScaledGPT(JaxGPT):
    def training_step(self, params, batch, rng):
        loss, logs = super().training_step(params, batch, rng)
        return loss * jnp.mean(batch["scale"]), logs


class JaxLossLog(JaxCallback):
    def __init__(self):
        self.losses, self.aux = [], []

    def on_train_batch_end(self, trainer, module, logs, batch_idx):
        self.losses.append(float(logs["train_loss"]))
        if "moe_aux_loss" in logs:
            self.aux.append(float(logs["moe_aux_loss"]))


def _jax_fit(tree, arrays, axes, zero_stage, extra, model_kw, root):
    n = int(np.prod(list(axes.values())))
    mesh = jax_build_mesh(JaxMeshSpec(dict(axes)), devices=jax.devices()[:n])
    m = JaxScaledGPT(JaxGPTConfig(**_cfg(extra)), **model_kw)
    m.initial_params = tree
    log = JaxLossLog()
    res = jax_loop.run_fit(
        m, mf.JaxArrays(arrays, BATCH),
        jax_loop.FitConfig(seed=0, default_root_dir=str(root),
                           limit_val_batches=0, log_every_n_steps=1),
        callbacks=[log], mesh=mesh, zero_stage=zero_stage)
    state = jax_ss.load_state_stream(res["state_stream"])
    return {"params": mf.jax_by_path(state.params), "losses": log.losses,
            "aux": log.aux}


def _jax_grads(tree, arrays, extra, model_kw):
    """``jax.grad`` of the scaled loss over the first global batch, on one
    device (sharding is numerically a relabeling), and its global norm."""
    m = JaxScaledGPT(JaxGPTConfig(**_cfg(extra)), **{
        k: v for k, v in model_kw.items() if k != "attn_impl"})
    batch = {k: jnp.asarray(v[:BATCH]) for k, v in arrays.items()}
    params = jax.tree.map(jnp.asarray, tree)
    grads = jax.grad(lambda p: m.training_step(p, batch, None)[0])(params)
    norm = float(jnp.sqrt(sum(jnp.sum(g * g)
                              for g in jax.tree.leaves(grads))))
    return mf.jax_by_path(grads), norm


def _port_fit(pool, tree, arrays, axes, zero_stage, extra, model_kw, label,
              root):
    cls = RayShardedStrategy if zero_stage else RayStrategy
    kw = {"zero_stage": zero_stage} if zero_stage else {}
    strategy = mf.on_pool(pool, cls, int(np.prod(list(axes.values()))),
                          mesh_axes=axes, **kw)
    m = helpers.ScaledGPT(GPTConfig(**_cfg(extra)), device="cpu", **model_kw)
    m.initial_params = params_from_jax(tree, "cpu")
    tr = mf.KeptWorkers(strategy, max_epochs=1, limit_val_batches=0,
                        log_every_n_steps=1, enable_checkpointing=False,
                        default_root_dir=str(root),
                        callbacks=[helpers.LossLog(),
                                   helpers.GradProbe(label)])
    with mf.limit():
        tr.fit(m, helpers.ArraysDataModule(arrays, BATCH))
    return tr


class _Coords:
    """A rank's model coordinates as ``shard_params`` reads them."""

    def __init__(self, layout, rank):
        self.c, self.sizes = layout.coords(rank), layout.sizes

    def axis(self, name):
        if name not in self.sizes:
            return None
        return AxisGroup(None, self.c[name], self.sizes[name], ())


def _rank_grads_vs_jax(layout, records, jax_grads, specs):
    """The worst, over ranks and leaves, of the max abs difference between
    a rank's replica-averaged backward and its slice of the JAX gradient,
    relative to the leaf's largest JAX element."""
    full = {}
    for key, g in jax_grads.items():
        node = full
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.from_numpy(np.array(g))
    worst = 0.0
    replicas = layout.groups_along(tuple(a for a in REPLICA_AXES
                                         if a in layout.sizes))
    for rank in range(layout.world_size):
        want = mf.port_by_path(shard_params(full, _Coords(layout, rank),
                                            specs))
        group = next(g for g in replicas if rank in g)
        got = {k: np.mean([records[r]["grads"][k] for r in group], axis=0)
               for k in records[rank]["grads"]}
        assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
        for k in want:
            assert got[k].shape == want[k].shape, (k, got[k].shape,
                                                   want[k].shape)
            scale = max(float(np.abs(jax_grads[k]).max()), 1e-30)
            worst = max(worst, float(np.abs(got[k] - want[k]).max())
                        / scale)
    return worst


@pytest.mark.parametrize("arm", list(ARMS))
def test_model_parallel_fit_matches_the_jax_fit(pool, data, arm, tmp_path):
    axes, zero_stage, extra, model_kw = ARMS[arm]
    tree = _tree(extra)
    tr = _port_fit(pool, tree, data, axes, zero_stage, extra, model_kw, arm,
                   tmp_path / "p")
    jx = _jax_fit(tree, data, axes, zero_stage, extra, model_kw,
                  tmp_path / "j")
    grads, norm = _jax_grads(tree, data, extra, model_kw)
    # The clip binds at the first step.
    assert norm > 1.0
    assert tr.global_step == STEPS
    losses = mf.losses(tr)
    assert len(losses) == STEPS
    assert np.max(np.abs(np.asarray(losses) - jx["losses"])) < 5e-6
    if extra.get("n_experts"):
        assert abs(tr.callback_metrics["moe_aux_loss"]
                   - np.mean(jx["aux"])) < 1e-5
    specs = GPT(GPTConfig(**_cfg(extra)), device="cpu",
                **model_kw).param_partition_specs()
    rel = _rank_grads_vs_jax(RankLayout(axes), helpers.RECORDS[arm], grads,
                             specs)
    assert rel < 1e-5
    assert mf.max_diff(mf.port_by_path(tr.state.params), jx["params"]) < 5e-6


def _refused(pool, model_kw=None, extra=None, trainer_kw=None, **strategy):
    zero = strategy.pop("zero_stage", 0)
    cls = RayShardedStrategy if zero else RayStrategy
    s = mf.on_pool(pool, cls, 4, **({"zero_stage": zero} if zero else {}),
                   **strategy)
    m = GPT(GPTConfig(**_cfg(extra or {})), device="cpu", **(model_kw or {}))
    # The pool's workers outlive the refused stage (a plain Trainer's
    # teardown would kill them under the module's later tests).
    tr = mf.KeptWorkers(s, max_steps=1, enable_checkpointing=False,
                        **(trainer_kw or {}))
    return tr, m


# Each case: the strategy's, the model's and the Trainer's keywords, the
# words of the refusal, and where it is raised (the driver before any
# worker runs, or every rank, which the driver re-raises as RemoteError).
@pytest.mark.parametrize("case", [
    ("sp without ring", {"mesh_axes": {"data": 2, "sp": 2}}, {}, {}, {},
     "attn_impl='ring'", "driver"),
    ("MoE x sp", {"mesh_axes": {"data": 2, "sp": 2}},
     {"attn_impl": "ring"}, MOE, {}, "MoE together with 'sp'", "driver"),
    ("megastep", {"mesh_axes": {"data": 2, "tensor": 2}, "megastep": 4},
     {}, {}, {}, "megastep=4", "ranks"),
    ("int8 wire", {"mesh_axes": {"data": 2, "tensor": 2},
                   "grad_comm": "int8_ef"}, {}, {}, {},
     "int8 gradient wire", "ranks"),
    ("update sharding", {"mesh_axes": {"data": 2, "tensor": 2},
                         "update_sharding": "on"}, {}, {}, {},
     "update_sharding='on'", "ranks"),
    ("restart", {"mesh_axes": {"data": 2, "tensor": 2}}, {}, {},
     {"restart_dir": "rs", "restart_every_n_epochs": 1}, "RLTSHRD2",
     "ranks"),
    ("elastic", {"mesh_axes": {"data": 2, "expert": 2}, "max_restarts": 1},
     {}, MOE, {}, "RLTSHRD2", "ranks"),
    ("lora", {"mesh_axes": {"data": 2, "tensor": 2}}, {},
     {"lora_rank": 4}, {}, "LoRA", "driver"),
], ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_model_axes_refusals_name_their_roadmap_item(pool, data, case):
    _, strategy, model_kw, extra, trainer_kw, words, where = case
    tr, m = _refused(pool, model_kw, extra, trainer_kw, **dict(strategy))
    with pytest.raises((NotImplementedError, RemoteError)) as err:
        tr.fit(m, helpers.ArraysDataModule(data, BATCH))
    if where == "driver":
        assert isinstance(err.value, NotImplementedError)
    else:
        assert isinstance(err.value, RemoteError)
        assert "NotImplementedError" in err.value.remote_traceback
    assert words in str(err.value)
    assert "ROADMAP Queue 1 item 3" in str(err.value)


@pytest.mark.parametrize("device,backend", [("cuda", "nccl"),
                                            ("cuda", "gloo"),
                                            ("cpu", "gloo")])
def test_megastep_under_model_axes_is_one_and_refuses_more(device, backend):
    """Under model axes megastep's auto is 1 (over NCCL on the card too,
    where it is 8 without them: a stride's graph would capture the
    model-parallel collectives), and K > 1 raises naming its item."""
    dev = torch.device(device)
    auto = FitConfig(megastep="auto")
    assert loop._resolve_megastep(auto, dev, backend, model_axes=True) == 1
    if (device, backend) == ("cuda", "nccl"):
        assert loop._resolve_megastep(auto, dev, backend) == 8
    with pytest.raises(NotImplementedError,
                       match="megastep=4 under model axes.*ROADMAP Queue 1 "
                             "item 3"):
        loop._resolve_megastep(FitConfig(megastep=4), dev, backend,
                               model_axes=True)


def test_ring_without_an_sp_axis_raises_as_jax_does():
    m = GPT(GPTConfig(**mf.CFG), device="cpu", attn_impl="ring")
    tokens = torch.zeros(1, 9, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs mesh axis 'sp'"):
        m._loss(m.init_params(), tokens)


@pytest.mark.parametrize("extra", [{}, MOE, {"lora_rank": 4}])
def test_param_partition_specs_equal_jax(extra):
    """The port's specs are the JAX ``param_partition_specs`` as tuples,
    leaf for leaf."""
    jspecs = JaxGPT(JaxGPTConfig(**_cfg(extra))).param_partition_specs()
    tspecs = GPT(GPTConfig(**_cfg(extra)), device="cpu"
                 ).param_partition_specs()
    flat = {}
    for k, v in tspecs.items():
        for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
            flat[k if kk is None else f"{k}/{kk}"] = vv
    jflat = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda s: isinstance(
                s, jax.sharding.PartitionSpec))[0]:
        jflat["/".join(str(getattr(k, "key", k)) for k in path)] = tuple(s)
    assert flat == jflat


def test_checkpoint_of_a_tensor_fit_holds_the_global_arrays(pool, data,
                                                            tmp_path):
    """The ``RLTCKPT1`` file of a ``{"data": 2, "tensor": 2}`` fit holds
    the gathered global arrays (params and moments at the JAX shapes), and
    a fit resumed from it on the same mesh (cut back to each rank's
    slices) continues as the straight two-epoch fit does, within 5e-6."""
    from ray_lightning_tpu_torch.core.callbacks import ModelCheckpoint
    from ray_lightning_tpu_torch.models.convert import (
        jax_train_state_fields, train_state_from_jax,
    )
    from ray_lightning_tpu_torch.utils.state_stream import (
        load_state_stream, state_stream_from_file,
    )

    tree = _tree({})
    axes = {"data": 2, "tensor": 2}

    def fit(root, epochs, callbacks=(), **kw):
        m = helpers.ScaledGPT(GPTConfig(**mf.CFG), device="cpu")
        m.initial_params = params_from_jax(tree, "cpu")
        tr = mf.KeptWorkers(mf.on_pool(pool, RayStrategy, 4,
                                       mesh_axes=axes),
                            max_epochs=epochs, limit_val_batches=0,
                            log_every_n_steps=1, default_root_dir=str(root),
                            callbacks=[helpers.LossLog(), *callbacks], **kw)
        with mf.limit():
            tr.fit(m, helpers.ArraysDataModule(data, BATCH))
        return tr

    ck = ModelCheckpoint(dirpath=str(tmp_path / "ck"))
    fit(tmp_path / "a", 1, [ck], enable_checkpointing=True)
    path = ck.best_model_path
    state = load_state_stream(state_stream_from_file(path))["state"]
    want = {k: v.shape for k, v in mf.jax_by_path(tree).items()}
    got = {k: tuple(v.shape) for k, v in mf.port_by_path(
        jax_train_state_fields(state)[0]).items()}
    assert got == want
    adam = train_state_from_jax(state).opt_state[1]
    for moment in ("mu", "nu"):
        assert {k: tuple(v.shape) for k, v in mf.port_by_path(
            adam[moment]).items()} == want
    resumed = fit(tmp_path / "b", 2, resume_from_checkpoint=path,
                  enable_checkpointing=False)
    straight = fit(tmp_path / "c", 2, enable_checkpointing=False)
    assert resumed.global_step == straight.global_step == 2 * STEPS
    assert abs(resumed.callback_metrics["train_loss"]
               - straight.callback_metrics["train_loss"]) < 5e-6
    assert mf.max_diff(mf.port_by_path(resumed.state.params),
                       mf.port_by_path(straight.state.params)) < 5e-6
