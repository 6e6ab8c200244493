"""MoE (``ray_lightning_tpu_torch/ops/moe.py`` and the GPT's routed MLP)
held against the JAX package's ``ray_lightning_tpu/ops/moe.py`` on the
same numpy inputs, on the CPU:

* ``topk_capacity_routing`` (with and without capacity drops, top 1 to 3)
  and ``load_balance_loss``: within 1e-6 (the same f32 operations);
* ``moe_mlp``'s output, aux loss and input/weight gradients at groups 1
  and 2: within 1e-5 max abs (f32 einsums contracted in another order);
* the group-count invariance of ``tests/test_moe.py`` at drop-free
  capacity: groups 1, 2 and 4 give outputs and aux within 1e-6;
* one training step of ``GPTConfig.tiny_moe`` (loss, ``moe_aux_loss``
  and every leaf's gradient) against ``jax.value_and_grad`` of the JAX
  module's step: within 1e-5 of each leaf's largest element;
* greedy MoE decode (``generate``) equal to the argmax rollout of full
  forwards token for token (the claim of ``tests/test_generate.py``'s
  ``test_moe_greedy_generation_matches_argmax_rollout``), to the JAX
  ``generate`` on the same params, and to the paged serving engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.generate import generate as jax_generate
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.ops import moe as jmoe
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.models.generate import generate
from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig
from ray_lightning_tpu_torch.ops import moe as tmoe
from ray_lightning_tpu_torch.parallel.sharding import leaves_with_paths


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("top_k", [1, 2, 3])
@pytest.mark.parametrize("capacity", [3, 16])
def test_routing_and_aux_loss_match_jax(top_k, capacity):
    rng = np.random.default_rng(top_k * 7 + capacity)
    logits = rng.standard_normal((32, 4)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    jc, jd = jmoe.topk_capacity_routing(jnp.asarray(probs), top_k, capacity)
    tc, td = tmoe.topk_capacity_routing(_t(probs), top_k, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert np.abs(tc.numpy() - np.asarray(jc)).max() < 1e-6
    if capacity == 3:
        assert float(jd.sum()) < 32 * min(top_k, 4)  # some drops
    ja = float(jmoe.load_balance_loss(jnp.asarray(probs), jd))
    ta = float(tmoe.load_balance_loss(_t(probs), td))
    assert abs(ja - ta) < 1e-6


def _mlp_inputs(seed, d=16, E=4, h=32):
    rng = np.random.default_rng(seed)
    f = np.float32
    return [rng.standard_normal(s).astype(f) * sc for s, sc in (
        ((2, 16, d), 1.0), ((d, E), 1.0), ((E, d, h), 0.1), ((E, h), 0.1),
        ((E, h, d), 0.1), ((E, d), 0.1))]


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("cap", [1.25, 4.0])
def test_moe_mlp_and_its_gradients_match_jax(groups, cap):
    args = _mlp_inputs(groups)
    rng = np.random.default_rng(5)
    cot = rng.standard_normal(args[0].shape).astype(np.float32)

    def jf(*a):
        y, aux = jmoe.moe_mlp(*a, top_k=2, capacity_factor=cap,
                              groups=groups)
        return jnp.sum(y * cot) + 3.0 * aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(jf, argnums=tuple(range(6)),
                                             has_aux=True)(
        *(jnp.asarray(a) for a in args))
    ta = [_t(a).requires_grad_(True) for a in args]
    ty, taux = tmoe.moe_mlp(*ta, top_k=2, capacity_factor=cap,
                            groups=groups)
    (torch.sum(ty * _t(cot)) + 3.0 * taux).backward()
    assert np.abs(ty.detach().numpy() - np.asarray(jy)).max() < 1e-5
    assert abs(float(taux.detach()) - float(jaux)) < 1e-6
    for got, want in zip(ta, jg):
        assert np.abs(got.grad.numpy() - np.asarray(want)).max() < 1e-5


def test_routing_group_count_invariance_at_drop_free_capacity():
    args = [_t(a) for a in _mlp_inputs(9)]
    outs = [tmoe.moe_mlp(*args, top_k=2, capacity_factor=4.0, groups=g)
            for g in (1, 2, 4)]
    for y, aux in outs[1:]:
        assert np.abs(y.numpy() - outs[0][0].numpy()).max() < 1e-6
        assert abs(float(aux) - float(outs[0][1])) < 1e-6
    # A group count that does not divide the tokens is clamped to 1.
    y3, _ = tmoe.moe_mlp(*args, top_k=2, capacity_factor=4.0, groups=3)
    np.testing.assert_array_equal(y3.numpy(), outs[0][0].numpy())


@pytest.fixture(scope="module")
def moe_world():
    cfg = dict(vocab_size=128, n_layer=2, n_head=4, d_model=64, seq_len=32,
               warmup_steps=2, n_experts=4, moe_capacity_factor=4.0)
    jm = JaxGPT(JaxGPTConfig(**cfg), attn_impl="xla")
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(4)))
    # Wider block weights: varied greedy streams at random init.
    for key in ("qkv_w", "proj_w", "moe_in_w", "moe_out_w", "gate_w"):
        tree["blocks"][key] = tree["blocks"][key] * 10.0
    tm = GPT(GPTConfig(**cfg), device="cpu", attn_impl="xla")
    return dict(cfg=cfg, jm=jm, tree=tree, tm=tm,
                tp=params_from_jax(tree, "cpu"))


def test_moe_gpt_training_step_matches_jax(moe_world):
    w = moe_world
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, w["cfg"]["vocab_size"],
                          size=(4, w["cfg"]["seq_len"] + 1)).astype(np.int32)

    def jloss(p):
        loss, logs = w["jm"].training_step(p, {"tokens": jnp.asarray(tokens)},
                                           None)
        return loss, logs

    (jl, jlogs), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, w["tree"]))
    leaves = {k: v.clone().requires_grad_(True) if not isinstance(v, dict)
              else {kk: vv.clone().requires_grad_(True)
                    for kk, vv in v.items()} for k, v in w["tp"].items()}
    tl, tlogs = w["tm"].training_step(leaves, {"tokens": _t(tokens)}, None)
    tl.backward()
    assert abs(float(tl) - float(jl)) < 1e-5
    assert abs(float(tlogs["moe_aux_loss"])
               - float(jlogs["moe_aux_loss"])) < 1e-6
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path):
             np.asarray(v) for path, v in
             jax.tree_util.tree_flatten_with_path(jg)[0]}
    for path, t in leaves_with_paths(leaves):
        want = jflat["/".join(map(str, path))]
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(t.grad.numpy() - want).max() / scale < 1e-5, path


def test_moe_greedy_decode_equals_argmax_rollout_and_jax(moe_world):
    w = moe_world
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, w["cfg"]["vocab_size"], size=(2, 4))
    out = generate(w["tm"], w["tp"], _t(prompt), 6, device="cpu")
    assert tuple(out.shape) == (2, 10)
    cur = torch.from_numpy(prompt)
    with torch.no_grad():
        for _ in range(6):
            nxt = torch.argmax(w["tm"].forward(w["tp"], cur)[:, -1], dim=-1)
            cur = torch.cat([cur, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(out.numpy(), cur.numpy())
    want = jax_generate(w["jm"], jax.tree.map(jnp.asarray, w["tree"]),
                        jnp.asarray(prompt, jnp.int32), max_new_tokens=6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert len(set(out[:, 4:].flatten().tolist())) > 1  # varied streams


def test_moe_paged_engine_equals_generate(moe_world):
    from ray_lightning_tpu_torch.serve.engine import ServeConfig, ServeEngine

    w = moe_world
    engine = ServeEngine(w["tm"], w["tp"], ServeConfig(num_slots=2,
                                                       block_size=8),
                         device="cpu")
    rng = np.random.default_rng(8)
    for n in (5, 11):
        prompt = rng.integers(1, w["cfg"]["vocab_size"], size=(n,)).tolist()
        got = engine.generate(prompt, 6)
        want = generate(w["tm"], w["tp"], torch.tensor([prompt]), 6,
                        device="cpu")[0, n:].tolist()
        assert list(got) == want


def test_tiny_moe_config_equals_jax():
    for n in (2, 4):
        assert (dataclasses.asdict(GPTConfig.tiny_moe(n))
                == {k: v for k, v in dataclasses.asdict(
                    JaxGPTConfig.tiny_moe(n)).items()})
