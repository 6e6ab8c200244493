"""The PyTorch port's GPT and static decode path held against the JAX
package (CPU, f32).

One JAX GPT at test size (its block matrices scaled up so greedy streams
are not one repeated token) is converted leaf for leaf into the port;
both packages get the same numpy prompts.  Logits agree to atol 1e-5
(f32 products summed in another order through two layers); greedy tokens
are equal.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu.models.gpt import merge_lora as jax_merge_lora
from ray_lightning_tpu_torch.models import generate as tgen
from ray_lightning_tpu_torch.models.convert import (
    adapter_from_jax, params_from_jax,
)
from ray_lightning_tpu_torch.models.gpt import (
    GPT, GPTConfig, add_lora_adapters, extract_lora, has_lora_adapters,
    merge_lora, resolve_weight, synthetic_lora_adapter,
)

jgen = importlib.import_module("ray_lightning_tpu.models.generate")

CFG = dict(vocab_size=128, n_layer=2, n_head=4, d_model=64, seq_len=64)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    """``(jax module, jax params, port module, port params)``."""
    jm = JaxGPT(JaxGPTConfig(**CFG, warmup_steps=1), attn_impl="xla")
    tree = _np_tree(jm.init_params(jax.random.PRNGKey(0)))
    for key in ("qkv_w", "proj_w", "mlp_in_w", "mlp_out_w"):
        tree["blocks"][key] = tree["blocks"][key] * 10.0
    jp = jax.tree.map(jnp.asarray, tree)
    tm = GPT(GPTConfig(**CFG), device="cpu")
    return jm, jp, tm, params_from_jax(tree, "cpu")


def _prompts(seed, batch, length):
    rng = np.random.default_rng(seed)
    return rng.integers(1, CFG["vocab_size"],
                        size=(batch, length)).astype(np.int32)


def test_init_params_tree_matches_jax_layout(model):
    jm, jp, tm, _ = model
    ours = tm.init_params(torch.Generator().manual_seed(0))
    flat_j = {jax.tree_util.keystr(k): v.shape for k, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
              jax.tree_util.tree_flatten_with_path(ours)[0]}
    assert flat_t == flat_j
    assert all(v.dtype == torch.float32 for v in ours["blocks"].values())


def test_params_from_jax_keeps_values(model):
    _, jp, _, tp = model
    np.testing.assert_array_equal(tp["blocks"]["qkv_w"].numpy(),
                                  np.asarray(jp["blocks"]["qkv_w"]))
    assert tp["blocks"]["qkv_w"].shape == (2, 64, 192)


def test_prefill_and_decode_logits_match_jax(model):
    jm, jp, tm, tp = model
    cfg_j, cfg_t = jm.config, tm.config
    prompt = _prompts(0, 2, 9)
    jcache = jgen.init_kv_cache(cfg_j, 2, 20)
    jl, jcache = jgen.prefill(cfg_j, jp, jcache, jnp.asarray(prompt))
    tcache = tgen.init_kv_cache(cfg_t, 2, 20, device="cpu")
    tl, tcache = tgen.prefill(cfg_t, tp, tcache,
                              torch.from_numpy(prompt).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5,
                                   rtol=0)
    tok = np.array([3, 7], np.int32)
    jl, jcache = jgen.decode_step(cfg_j, jp, jcache, jnp.asarray(tok), 9)
    tl, tcache = tgen.decode_step(cfg_t, tp, tcache,
                                  torch.from_numpy(tok).long(), 9)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed,batch,length,new", [(0, 3, 7, 16),
                                                   (1, 1, 1, 12)])
def test_generate_greedy_tokens_equal_jax(model, seed, batch, length, new):
    jm, jp, tm, tp = model
    prompt = _prompts(seed, batch, length)
    want = np.asarray(jgen.generate(jm, jp, jnp.asarray(prompt), new))
    got = tgen.generate(tm, tp, prompt, new, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(got[0, length:].tolist())) > 1  # not one repeated token


def test_generate_eos_freezes_rows_like_jax(model):
    jm, jp, tm, tp = model
    prompt = _prompts(3, 2, 6)
    free = tgen.generate(tm, tp, prompt, 12, device="cpu").numpy()
    eos = int(free[0, 8])  # a token row 0 emits mid-stream
    want = np.asarray(jgen.generate(jm, jp, jnp.asarray(prompt), 12,
                                    eos_token_id=eos))
    got = tgen.generate(tm, tp, prompt, 12, eos_token_id=eos,
                        device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 8:] == eos).all()


def test_top_k_one_sampling_is_greedy(model):
    _, _, tm, tp = model
    prompt = _prompts(4, 2, 5)
    greedy = tgen.generate(tm, tp, prompt, 10, device="cpu")
    sampled = tgen.generate(tm, tp, prompt, 10, temperature=0.7, top_k=1,
                            generator=torch.Generator().manual_seed(5),
                            device="cpu")
    assert torch.equal(greedy, sampled)


def test_sampling_is_reproducible_from_the_generator(model):
    _, _, tm, tp = model
    prompt = _prompts(5, 2, 5)

    def run(seed):
        return tgen.generate(tm, tp, prompt, 10, temperature=1.0,
                             top_p=0.9,
                             generator=torch.Generator().manual_seed(seed),
                             device="cpu")

    assert torch.equal(run(1), run(1))
    assert run(1).shape == (2, 15)


def test_generate_validates_arguments(model):
    _, _, tm, tp = model
    prompt = _prompts(0, 1, 4)
    with pytest.raises(ValueError, match="temperature"):
        tgen.generate(tm, tp, prompt, 4, top_k=2, device="cpu")
    with pytest.raises(ValueError, match="top_p"):
        tgen.generate(tm, tp, prompt, 4, temperature=1.0, top_p=0.0,
                      device="cpu")
    with pytest.raises(ValueError, match="positional table"):
        tgen.generate(tm, tp, prompt, 64, device="cpu")
    with pytest.raises(ValueError, match="eos_token_id"):
        tgen.generate(tm, tp, prompt, 4, eos_token_id=128, device="cpu")
    assert tgen.generate(tm, tp, prompt, 0, device="cpu").shape == (1, 4)


def test_entry_points_default_to_cuda(model):
    _, _, tm, tp = model
    if torch.cuda.is_available():
        assert GPT(GPTConfig(**CFG)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPT(GPTConfig(**CFG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.generate(tm, tp, _prompts(0, 1, 4), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"wte": np.zeros((2, 2), np.float32)})


def test_merge_lora_and_synthetic_adapter_match_jax(model):
    jm, jp, tm, tp = model
    L, d, r = CFG["n_layer"], CFG["d_model"], 4
    rng = np.random.default_rng(7)
    factors = {
        "qkv_a": rng.standard_normal((L, d, r)) * 0.02,
        "qkv_b": rng.standard_normal((L, r, 3 * d)) * 0.3,
        "proj_a": rng.standard_normal((L, d, r)) * 0.02,
        "proj_b": rng.standard_normal((L, r, d)) * 0.3,
    }
    factors = {k: v.astype(np.float32) for k, v in factors.items()}
    lora_cfg_j = dataclasses.replace(jm.config, lora_rank=r)
    want = jax_merge_lora({**jp, "blocks": {
        **jp["blocks"],
        **{f"lora_{k}": jnp.asarray(v) for k, v in factors.items()}}},
        lora_cfg_j)
    t_adapter = adapter_from_jax({**factors, "scale": 16.0 / r}, "cpu")
    assert t_adapter["scale"] == pytest.approx(4.0)
    lora_cfg_t = dataclasses.replace(tm.config, lora_rank=r)

    def with_factors(adapter):
        return {**tp, "blocks": {
            **tp["blocks"],
            **{f"lora_{k}": adapter[k] for k in factors}}}

    ours = merge_lora(with_factors(t_adapter), lora_cfg_t)
    assert not has_lora_adapters(ours)
    for key in ("qkv_w", "proj_w"):
        np.testing.assert_allclose(ours["blocks"][key].numpy(),
                                   np.asarray(want["blocks"][key]),
                                   atol=1e-6, rtol=0)
    # The port's own synthetic tenant: distinct from the base, and its
    # merged tree is the merge of its adapter.
    t_ad, t_merged = synthetic_lora_adapter(
        tp, lora_cfg_t, torch.Generator().manual_seed(3), scale=0.3)
    again = merge_lora(with_factors(t_ad), lora_cfg_t)
    torch.testing.assert_close(again["blocks"]["qkv_w"],
                               t_merged["blocks"]["qkv_w"])
    assert not torch.equal(t_merged["blocks"]["qkv_w"],
                           tp["blocks"]["qkv_w"])


def test_lora_tree_guards(model):
    _, _, tm, tp = model
    lora_cfg = dataclasses.replace(tm.config, lora_rank=4)
    tree = add_lora_adapters(tp, lora_cfg, torch.Generator().manual_seed(0))
    assert has_lora_adapters(tree)
    assert (tree["blocks"]["lora_qkv_b"] == 0).all()  # zero delta at init
    with pytest.raises(ValueError, match="already contain"):
        add_lora_adapters(tree, lora_cfg, torch.Generator())
    with pytest.raises(ValueError, match="merge_lora"):
        tgen.generate(tm, tree, _prompts(0, 1, 3), 2, device="cpu")
    with pytest.raises(ValueError, match="no LoRA adapters"):
        extract_lora(tp, lora_cfg)
    adapter, base = extract_lora(tree, lora_cfg)
    assert set(adapter) == {"qkv_a", "qkv_b", "proj_a", "proj_b", "scale"}
    assert not has_lora_adapters(base)


def test_resolve_weight_rejects_int8_trees():
    """int8 storage is ported (``models/quant.py``): a payload resolves
    with its per-output-channel scales; a payload without its scales is
    refused."""
    tree = {"qkv_w_q8": torch.tensor([[1, -2], [127, 0]], dtype=torch.int8),
            "qkv_w_sc": torch.tensor([0.5, 2.0])}
    w = resolve_weight(tree, "qkv_w", torch.float32)
    torch.testing.assert_close(w, torch.tensor([[0.5, -4.0], [63.5, 0.0]]),
                               rtol=0, atol=0)
    with pytest.raises(KeyError, match="qkv_w_sc"):
        resolve_weight({"qkv_w_q8": tree["qkv_w_q8"]}, "qkv_w",
                       torch.float32)
    w = resolve_weight({"qkv_w": torch.ones(2, 2)}, "qkv_w", torch.bfloat16)
    assert w.dtype == torch.bfloat16


def test_entry_points_reject_int8_trees(model):
    """``generate()`` takes an int8 tree (dequantized once per call) and
    refuses one whose payload lacks its scales."""
    from ray_lightning_tpu_torch.models.quant import quantize_decode_params

    _, _, tm, tp = model
    q8 = {k: v for k, v in tp.items() if k != "wte"}
    q8["wte_q8"] = torch.zeros(tp["wte"].shape, dtype=torch.int8)
    with pytest.raises(KeyError, match="wte_sc"):
        tgen.generate(tm, q8, _prompts(0, 1, 3), 2, device="cpu")
    out = tgen.generate(tm, quantize_decode_params(tp), _prompts(0, 1, 3),
                        2, device="cpu")
    assert out.shape == (1, 5)
