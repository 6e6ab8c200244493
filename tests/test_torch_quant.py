"""The port's int8 decode storage held against the JAX package (CPU).

``quantize_decode_params`` of the same numpy tree must give the JAX
package's int8 payloads and f32 scales bit for bit, and
``dequantize_decode_params`` the same dense weights; ``generate()`` and
``ServeEngine`` on an int8 tree must emit the JAX ``generate()``'s greedy
tokens on that tree (both dequantize once per call off the TPU, so the
same f32 products run on the same weights).  Every guard of the JAX
module refuses the same trees with the same error type.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models import quant as jquant
from ray_lightning_tpu.models.generate import generate as jax_generate
from ray_lightning_tpu.models.gpt import GPT as JaxGPT
from ray_lightning_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_lightning_tpu_torch.core.trainer import Trainer
from ray_lightning_tpu_torch.models import quant
from ray_lightning_tpu_torch.models.convert import params_from_jax
from ray_lightning_tpu_torch.models.generate import generate
from ray_lightning_tpu_torch.models.gpt import (
    GPT, GPTConfig, SyntheticLMDataModule, resolve_weight,
)
from ray_lightning_tpu_torch.parallel.strategies import LocalStrategy
from ray_lightning_tpu_torch.serve.engine import ServeConfig, ServeEngine

CFG = dict(vocab_size=128, n_layer=2, n_head=4, d_model=64, seq_len=64)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.cpu() if isinstance(
                v, torch.Tensor) else v)
    return out


@pytest.fixture(scope="module")
def trees():
    """A JAX GPT's params (block matrices scaled so greedy streams vary),
    the JAX int8 tree of them, and the port's trees."""
    jm = JaxGPT(JaxGPTConfig(**CFG, warmup_steps=1), attn_impl="xla")
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    for key in ("qkv_w", "proj_w", "mlp_in_w", "mlp_out_w"):
        tree["blocks"][key] = tree["blocks"][key] * 10.0
    jq = jax.tree.map(np.asarray, jquant.quantize_decode_params(
        jax.tree.map(jnp.asarray, tree), jm.config))
    tp = params_from_jax(tree, "cpu")
    return dict(jm=jm, tree=tree, jq=jq, tp=tp,
                tm=GPT(GPTConfig(**CFG), device="cpu"))


def test_quantized_tree_is_bitwise_jax(trees):
    got = _flat(quant.quantize_decode_params(trees["tp"]))
    want = _flat(trees["jq"])
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["wte_q8"].dtype == np.int8 and got["wte_sc"].ndim == 1
    assert got["blocks/qkv_w_sc"].shape == (CFG["n_layer"],
                                            3 * CFG["d_model"])


def test_int8_tree_converts_both_ways(trees):
    """The JAX int8 tree read into the port keeps its int8 and f32
    leaves, and the port's tree read back as numpy is the JAX tree."""
    tq = params_from_jax(trees["jq"], "cpu")
    assert tq["wte_q8"].dtype == torch.int8
    assert tq["blocks"]["mlp_in_w_sc"].dtype == torch.float32
    back = _flat(tq)
    for key, want in _flat(trees["jq"]).items():
        assert back[key].dtype == want.dtype, key
        np.testing.assert_array_equal(back[key], want, err_msg=key)


def test_dequantized_tree_is_bitwise_jax(trees):
    tq = params_from_jax(trees["jq"], "cpu")
    got = _flat(quant.dequantize_decode_params(tq))
    want = _flat(jax.tree.map(np.asarray, jquant.dequantize_decode_params(
        jax.tree.map(jnp.asarray, trees["jq"]))))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # resolve_weight is the same arithmetic, in any compute dtype.
    w = resolve_weight(tq["blocks"], "qkv_w", torch.float32)
    np.testing.assert_array_equal(w.numpy(), want["blocks/qkv_w"])
    assert resolve_weight(tq["blocks"], "qkv_w",
                          torch.bfloat16).dtype == torch.bfloat16
    # A float tree passes through.
    assert quant.dequantize_decode_params(trees["tp"]) is trees["tp"]


def test_generate_on_an_int8_tree_matches_jax(trees):
    prompts = np.random.default_rng(3).integers(1, CFG["vocab_size"],
                                                size=(2, 7))
    want = np.asarray(jax_generate(
        trees["jm"], jax.tree.map(jnp.asarray, trees["jq"]),
        jnp.asarray(prompts, jnp.int32), 12))
    tq = params_from_jax(trees["jq"], "cpu")
    got = generate(trees["tm"], tq, prompts, 12, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_engine_serves_an_int8_tree_as_generate(trees):
    tq = params_from_jax(trees["jq"], "cpu")
    engine = ServeEngine(trees["tm"], tq, ServeConfig(num_slots=2,
                                                      block_size=8),
                         device="cpu")
    # Built once: dense weights in the compute dtype, no int8 left.
    assert not quant.is_quantized(engine.params)
    assert engine.params["wte"].dtype == torch.float32
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, CFG["vocab_size"], size=(n,)).tolist()
               for n in (5, 11, 3)]
    handles = [engine.submit(p, 10) for p in prompts]
    engine.run_until_idle()
    for p, h in zip(prompts, handles):
        want = np.asarray(jax_generate(
            trees["jm"], jax.tree.map(jnp.asarray, trees["jq"]),
            jnp.asarray([p], jnp.int32), 10))[0, len(p):].tolist()
        assert h.result(0) == want


def test_bf16_engine_casts_the_weights_once(trees):
    """A bf16 engine holds its weights in bf16 (LayerNorm parameters
    stay f32), cast once at build: the same bits as the per-use cast."""
    tm16 = GPT(GPTConfig(**CFG), precision="bf16", device="cpu")
    engine = ServeEngine(tm16, trees["tp"],
                         ServeConfig(num_slots=2, block_size=8),
                         device="cpu")
    p = engine.params
    assert p["wte"].dtype == p["blocks"]["qkv_w"].dtype == torch.bfloat16
    assert p["ln_f_g"].dtype == p["blocks"]["ln1_g"].dtype == torch.float32
    torch.testing.assert_close(
        p["blocks"]["mlp_out_w"],
        trees["tp"]["blocks"]["mlp_out_w"].to(torch.bfloat16),
        rtol=0, atol=0)
    assert engine.generate([3, 4, 5], 4)


def test_guards_match_jax(trees):
    tq = quant.quantize_decode_params(trees["tp"])
    jq = jax.tree.map(jnp.asarray, trees["jq"])
    # An already quantized tree.
    with pytest.raises(ValueError, match="already int8"):
        quant.quantize_decode_params(tq)
    with pytest.raises(ValueError, match="already int8"):
        jquant.quantize_decode_params(jq, None)
    # A tree with LoRA adapters.
    lora = dict(trees["tp"])
    lora["blocks"] = {**lora["blocks"],
                      "lora_qkv_a": torch.zeros(CFG["n_layer"], 64, 4)}
    with pytest.raises(ValueError, match="merge_lora"):
        quant.quantize_decode_params(lora)
    jlora = dict(trees["tree"])
    jlora["blocks"] = {**jlora["blocks"],
                       "lora_qkv_a": np.zeros((CFG["n_layer"], 64, 4))}
    with pytest.raises(ValueError, match="merge_lora"):
        jquant.quantize_decode_params(jlora, None)
    assert quant.is_quantized(tq) and not quant.is_quantized(trees["tp"])
    # A fit warm-started from an int8 tree.
    tm = GPT(GPTConfig(**CFG), device="cpu")
    tm.initial_params = tq
    tr = Trainer(LocalStrategy(device="cpu"), max_steps=1,
                 enable_checkpointing=False)
    with pytest.raises(ValueError, match="int8-quantized"):
        tr.fit(tm, SyntheticLMDataModule(tm.config, batch_size=2,
                                         num_batches=1))
    # The per-row wte scales: both consumers contract over d_model.
    assert tq["wte_sc"].shape == (CFG["vocab_size"],)
