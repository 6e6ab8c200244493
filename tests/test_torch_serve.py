"""The PyTorch port's serving plane held against the JAX package (CPU, f32).

One JAX GPT at test size (block matrices scaled up so greedy streams
vary), converted leaf for leaf into the port, and three rank-4 LoRA
tenants made with numpy and served by both packages.  The paged
prefill/decode functions are compared on the same numpy pool, block
tables and adapter buffers (logits and pool contents atol 1e-5: f32 sums
in another order through two layers); the engine's greedy tokens for a
mixed-tenant batch must equal the JAX ``ServeEngine``'s and the port's
static ``generate()`` on each tenant's merged weights.
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
from ray_lightning_tpu.serve.engine import ServeConfig as JaxServeConfig
from ray_lightning_tpu.serve.engine import ServeEngine as JaxServeEngine
from ray_lightning_tpu_torch.models.convert import (
    adapter_from_jax, params_from_jax,
)
from ray_lightning_tpu_torch.models.generate import generate
from ray_lightning_tpu_torch.models.gpt import GPT, GPTConfig, merge_lora
from ray_lightning_tpu_torch.serve.engine import (
    ServeConfig, ServeEngine, ServeRejected,
)
from ray_lightning_tpu_torch.serve.kv_cache import (
    BlockAllocator, paged_decode_step, paged_prefill, sample_tokens,
)
from ray_lightning_tpu_torch.serve.lora import AdapterPool, validate_adapter
from ray_lightning_tpu_torch.serve.scheduler import Request, Scheduler

jkv = importlib.import_module("ray_lightning_tpu.serve.kv_cache")

CFG = dict(vocab_size=128, n_layer=2, n_head=4, d_model=64, seq_len=64)
RANK = 4
TENANTS = ("t0", "t1", "t2")
# A mixed-tenant batch: more requests than slots, base rows among them.
REQUESTS = [(5, "t0"), (9, None), (12, "t1"), (3, "t2"), (17, "t0"),
            (8, None)]
NEW = 10


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _prompt(seed, length):
    rng = np.random.default_rng(seed)
    return rng.integers(1, CFG["vocab_size"], size=(length,)).tolist()


@pytest.fixture(scope="module")
def world():
    """Both packages' model and base params, and three tenants: random
    non-zero factors made with numpy (served by both engines), merged by
    the port's ``merge_lora`` for the ``generate()`` reference."""
    jm = JaxGPT(JaxGPTConfig(**CFG, warmup_steps=1), attn_impl="xla")
    tree = _np_tree(jm.init_params(jax.random.PRNGKey(0)))
    for key in ("qkv_w", "proj_w", "mlp_in_w", "mlp_out_w"):
        tree["blocks"][key] = tree["blocks"][key] * 10.0
    tm = GPT(GPTConfig(**CFG), device="cpu")
    tp = params_from_jax(tree, "cpu")
    lora_cfg = dataclasses.replace(tm.config, lora_rank=RANK)
    L, d = CFG["n_layer"], CFG["d_model"]
    rng = np.random.default_rng(10)
    j_adapters, t_adapters, t_merged = {}, {}, {None: tp}
    for name in TENANTS:
        factors = {
            "qkv_a": rng.standard_normal((L, d, RANK)) * 0.02,
            "qkv_b": rng.standard_normal((L, RANK, 3 * d)) * 0.3,
            "proj_a": rng.standard_normal((L, d, RANK)) * 0.02,
            "proj_b": rng.standard_normal((L, RANK, d)) * 0.3,
        }
        adapter = {k: v.astype(np.float32) for k, v in factors.items()}
        adapter["scale"] = lora_cfg.lora_alpha / RANK
        j_adapters[name] = adapter
        t_adapters[name] = adapter_from_jax(adapter, "cpu")
        t_merged[name] = merge_lora({**tp, "blocks": {
            **tp["blocks"],
            **{f"lora_{k}": t_adapters[name][k] for k in factors}}},
            lora_cfg)
    return dict(jm=jm, jp=jax.tree.map(jnp.asarray, tree),
                j_adapters=j_adapters, tm=tm, tp=tp, t_adapters=t_adapters,
                t_merged=t_merged)


@pytest.fixture(scope="module")
def jax_tokens(world):
    """The JAX engine's greedy tokens for REQUESTS (computed once)."""
    engine = JaxServeEngine(
        world["jm"], world["jp"],
        JaxServeConfig(num_slots=4, block_size=8, max_adapters=3,
                       adapter_rank=RANK),
        adapters=world["j_adapters"],
    )
    handles = [engine.submit(_prompt(i, n), NEW, adapter=a)
               for i, (n, a) in enumerate(REQUESTS)]
    engine.run_until_idle()
    return [h.result() for h in handles]


def _engine(world, **kw):
    cfg = dict(num_slots=4, block_size=8, max_adapters=3, adapter_rank=RANK)
    cfg.update(kw)
    return ServeEngine(world["tm"], world["tp"], ServeConfig(**cfg),
                       adapters=world["t_adapters"], device="cpu")


def _stacked_buffers(world):
    """Numpy adapter-pool buffers (L, N+1, ...) with tenant i in slot
    i + 1 and the scale folded into B, as both pools lay them out."""
    L, d = CFG["n_layer"], CFG["d_model"]
    n1 = len(TENANTS) + 1
    bufs = {"qkv_a": np.zeros((L, n1, d, RANK), np.float32),
            "qkv_b": np.zeros((L, n1, RANK, 3 * d), np.float32),
            "proj_a": np.zeros((L, n1, d, RANK), np.float32),
            "proj_b": np.zeros((L, n1, RANK, d), np.float32)}
    for i, name in enumerate(TENANTS):
        ad = _np_tree(world["j_adapters"][name])
        scale = np.float32(ad["scale"])
        for key in bufs:
            f = ad[key] * scale if key.endswith("_b") else ad[key]
            bufs[key][:, i + 1] = f
    return bufs


# ---------------------------------------------------------------------------
# Paged cache functions vs JAX
# ---------------------------------------------------------------------------

def test_paged_prefill_matches_jax_with_adapter(world):
    cfg_j, cfg_t = world["jm"].config, world["tm"].config
    L, H, Dh = CFG["n_layer"], CFG["n_head"], 16
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((L, 9, 8, H, Dh)).astype(np.float32)
    bufs = _stacked_buffers(world)
    tokens = np.zeros((16,), np.int32)
    tokens[:11] = _prompt(4, 11)
    block_ids = np.array([5, 2], np.int32)
    jl, jpool = jkv.paged_prefill(
        cfg_j, world["jp"], {"k": jnp.asarray(pool), "v": jnp.asarray(pool)},
        jnp.asarray(tokens), jnp.int32(11), jnp.asarray(block_ids),
        adapters={k: jnp.asarray(v) for k, v in bufs.items()},
        adapter_id=jnp.int32(2),
    )
    tpool = {"k": torch.from_numpy(pool.copy()),
             "v": torch.from_numpy(pool.copy())}
    tl, tpool = paged_prefill(
        cfg_t, world["tp"], tpool, torch.from_numpy(tokens).long(), 11,
        torch.from_numpy(block_ids).long(),
        adapters={k: torch.from_numpy(v) for k, v in bufs.items()},
        adapter_id=torch.tensor([2], dtype=torch.int32), lora_impl="kernel",
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(tpool[key].numpy(), np.asarray(jpool[key]),
                                   atol=1e-5, rtol=0)


def test_paged_decode_step_matches_jax_with_adapters(world):
    cfg_j, cfg_t = world["jm"].config, world["tm"].config
    L, H, Dh = CFG["n_layer"], CFG["n_head"], 16
    rng = np.random.default_rng(5)
    pool = rng.standard_normal((L, 12, 8, H, Dh)).astype(np.float32)
    bufs = _stacked_buffers(world)
    # Slot 0: 13 cached tokens in blocks 3, 7; slot 1: 8 tokens, its next
    # write opens block 9; slot 2 inactive (trash); slot 3: 1 token.
    tables = np.array([[3, 7, 0, 0], [4, 9, 0, 0], [0, 0, 0, 0],
                       [11, 0, 0, 0]], np.int32)
    seq_lens = np.array([13, 8, 0, 1], np.int32)
    tokens = np.array([5, 17, 0, 99], np.int32)
    ad_ids = np.array([1, 0, 0, 3], np.int32)
    jl, jpool = jkv.paged_decode_step(
        cfg_j, world["jp"], {"k": jnp.asarray(pool), "v": jnp.asarray(pool)},
        jnp.asarray(tables), jnp.asarray(seq_lens), jnp.asarray(tokens),
        adapters={k: jnp.asarray(v) for k, v in bufs.items()},
        adapter_ids=jnp.asarray(ad_ids),
    )
    tpool = {"k": torch.from_numpy(pool.copy()),
             "v": torch.from_numpy(pool.copy())}
    tl, tpool = paged_decode_step(
        cfg_t, world["tp"], tpool, torch.from_numpy(tables),
        torch.from_numpy(seq_lens), torch.from_numpy(tokens),
        adapters={k: torch.from_numpy(v) for k, v in bufs.items()},
        adapter_ids=torch.from_numpy(ad_ids),
    )
    active = [0, 1, 3]
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                               atol=1e-5, rtol=0)
    # Every block but the trash block (the inactive slot's write target)
    # holds the same content.
    for key in ("k", "v"):
        np.testing.assert_allclose(tpool[key].numpy()[:, 1:],
                                   np.asarray(jpool[key])[:, 1:],
                                   atol=1e-5, rtol=0)


def test_sample_tokens_greedy_rows_and_row_streams():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((3, 50)).astype(np.float32))
    out = sample_tokens(logits, [0.0, 1.0, 1.0], [0, 0, 5], [7, 7, 7],
                        [4, 4, 4])
    assert out[0] == torch.argmax(logits[0])
    # Same (seed, position) and logits → same draw; top-k keeps the draw
    # among the 5 best tokens.
    again = sample_tokens(logits[1:2].clone(), [1.0], [0], [7], [4])
    assert again[0] == out[1]
    assert out[2] in torch.topk(logits[2], 5).indices


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def test_engine_greedy_equals_jax_engine_and_merged_generate(world,
                                                             jax_tokens):
    engine = _engine(world)
    handles = [engine.submit(_prompt(i, n), NEW, adapter=a)
               for i, (n, a) in enumerate(REQUESTS)]
    engine.run_until_idle()
    got = [h.result(0) for h in handles]
    assert got == jax_tokens
    for i, ((n, a), toks) in enumerate(zip(REQUESTS, got)):
        prompt = _prompt(i, n)
        ref = generate(world["tm"], world["t_merged"][a], [prompt], NEW,
                       device="cpu")[0, n:].tolist()
        assert toks == ref, (i, a)
    # Tenants decode distinct streams from the base on the same prompt.
    assert len({tuple(t) for t in got}) == len(got)
    snap = engine.snapshot()
    assert snap["counters"]["completed"] == len(REQUESTS)
    assert snap["counters"]["tokens_out"] == NEW * len(REQUESTS)
    assert snap["adapters"]["t0"] == {"tokens_out": 2 * NEW, "completed": 2}
    assert snap["gauges"]["blocks_live"] == 0


def test_undersized_pool_preempts_and_finishes_every_request(world):
    engine = _engine(world, num_slots=3, block_size=4, num_blocks=9,
                     max_model_len=32)
    reqs = [(6, "t1"), (6, None), (6, "t2")]
    handles = [engine.submit(_prompt(20 + i, n), 14, adapter=a)
               for i, (n, a) in enumerate(reqs)]
    engine.run_until_idle()
    assert engine.snapshot()["counters"]["preempted"] >= 1
    for i, ((n, a), h) in enumerate(zip(reqs, handles)):
        assert h.status == "finished"
        ref = generate(world["tm"], world["t_merged"][a],
                       [_prompt(20 + i, n)], 14, device="cpu")[0, n:]
        assert h.result(0) == ref.tolist()
    assert engine.cache.allocator.free_blocks == 8


def test_temperature_stream_is_independent_of_the_batch(world):
    prompt = _prompt(40, 7)
    alone = _engine(world).generate(prompt, 12, temperature=1.0,
                                    adapter="t1", sample_seed=3)
    engine = _engine(world)
    others = [engine.submit(_prompt(41 + i, 5 + i), 12, temperature=0.8,
                            adapter=a)
              for i, a in enumerate((None, "t0", "t2"))]
    mine = engine.submit(prompt, 12, temperature=1.0, adapter="t1",
                         sample_seed=3)
    engine.run_until_idle()
    assert mine.result(0) == alone
    assert all(h.done() for h in others)


def test_engine_default_device_is_cuda(world):
    if torch.cuda.is_available():
        return  # the default names the card; test_torch_gpu.py serves on it
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(world["tm"], world["tp"], ServeConfig())


def test_engine_typed_rejections(world):
    engine = _engine(world, max_queue=3, max_queue_per_adapter=1)
    with pytest.raises(ValueError, match="unknown adapter"):
        engine.submit([1, 2], 2, adapter="ghost")
    plain = ServeEngine(world["tm"], world["tp"], ServeConfig(),
                        device="cpu")
    with pytest.raises(ValueError, match="no adapter pool"):
        plain.submit([1, 2], 2, adapter="t0")
    first = engine.submit([1, 2], 2, adapter="t0")
    burst = engine.submit([3, 4], 2, adapter="t0")
    assert first.status == "queued" and burst.status == "rejected"
    with pytest.raises(ServeRejected):
        burst.result(0)
    assert engine.submit([5], 2).status == "queued"  # base keeps its seat
    with pytest.raises(RuntimeError, match="drain"):
        engine.remove_adapter("t0")
    with pytest.raises(RuntimeError, match="drain"):
        engine.add_adapter("t0", world["t_adapters"]["t1"])
    assert engine.cancel(first.rid) and not engine.cancel(first.rid)
    engine.remove_adapter("t0")
    with pytest.raises(ValueError, match="unknown adapter"):
        engine.submit([1, 2], 2, adapter="t0")
    engine.run_until_idle()
    with pytest.raises(ValueError, match="max_model_len"):
        engine.submit([1] * 60, 10)


def test_hot_added_adapter_serves_its_merged_model(world):
    engine = _engine(world)
    engine.remove_adapter("t2")
    engine.add_adapter("late", world["t_adapters"]["t2"])
    prompt = _prompt(50, 9)
    got = engine.generate(prompt, NEW, adapter="late")
    ref = generate(world["tm"], world["t_merged"]["t2"], [prompt], NEW,
                   device="cpu")[0, 9:].tolist()
    assert got == ref


# ---------------------------------------------------------------------------
# Adapter pool and scheduler (host-side)
# ---------------------------------------------------------------------------

class TestAdapterPool:
    @pytest.fixture()
    def pool(self, world):
        return AdapterPool(world["tm"].config, max_adapters=2, rank=RANK,
                           device="cpu")

    def test_capacity_and_lifo_reuse(self, pool, world):
        ads = world["t_adapters"]
        s0, s1 = pool.add("a", ads["t0"]), pool.add("b", ads["t1"])
        assert 0 not in (s0, s1)  # slot 0 = the null/base adapter
        with pytest.raises(RuntimeError, match="pool full"):
            pool.add("c", ads["t2"])
        pool.remove("b")
        assert pool.add("c", ads["t2"]) == s1  # LIFO reuse
        assert pool.names() == ["a", "c"]
        assert pool.loaded == 2 and pool.slots_free == 0
        assert pool.loads == 3 and pool.unloads == 1

    def test_replace_reuses_slot_and_folds_the_scale(self, pool, world):
        ads = world["t_adapters"]
        slot = pool.add("a", ads["t0"])
        assert pool.add("a", ads["t1"]) == slot and pool.loaded == 1
        want = ads["t1"]["qkv_b"] * ads["t1"]["scale"]
        torch.testing.assert_close(pool.buffers["qkv_b"][:, slot], want)
        torch.testing.assert_close(pool.buffers["proj_a"][:, slot],
                                   ads["t1"]["proj_a"])
        assert (pool.buffers["qkv_a"][:, 0] == 0).all()

    def test_typed_misuse(self, pool, world):
        cfg = world["tm"].config
        with pytest.raises(KeyError):
            pool.remove("ghost")
        with pytest.raises(KeyError):
            pool.slot_of("ghost")
        with pytest.raises(ValueError, match="missing factor"):
            pool.add("a", {"qkv_a": np.zeros((1,))})
        bad = dict(world["t_adapters"]["t0"])
        bad["qkv_b"] = torch.zeros(cfg.n_layer, RANK + 1, 3 * cfg.d_model)
        with pytest.raises(ValueError, match="rank"):
            pool.add("a", bad)
        with pytest.raises(ValueError, match="dict"):
            validate_adapter([1, 2], cfg, RANK)
        with pytest.raises(ValueError, match="impl"):
            AdapterPool(cfg, 1, RANK, device="cpu", impl="xla")

    def test_snapshot(self, pool, world):
        pool.add("a", world["t_adapters"]["t0"])
        snap = pool.snapshot()
        assert snap["loaded"] == 1 and snap["slots_free"] == 1
        assert snap["max_adapters"] == 2 and snap["rank"] == RANK
        assert snap["impl"] == "kernel"


def test_scheduler_round_robin_across_tenants():
    sched = Scheduler(1, BlockAllocator(40), 4, 8, [4, 8])
    for i, a in enumerate(["x", "x", "x", None, "y"]):
        sched.submit(Request(rid=str(i), prompt=[1, 2], max_new_tokens=1,
                             adapter=a))
    order = []
    while sched.queue:
        ((slot, req, bucket),), _ = sched.poll()
        assert bucket == 4
        order.append(req.rid)
        sched.finish(slot)
    # Base (None) first, then the names in order, cycling; FIFO per key.
    assert order == ["3", "0", "4", "1", "2"]


def test_block_allocator_rejects_double_free():
    alloc = BlockAllocator(4)
    ids = alloc.alloc(3)
    assert 0 not in ids and alloc.alloc(1) is None
    alloc.free(ids)
    with pytest.raises(RuntimeError, match="double-free"):
        alloc.free(ids[:1])
