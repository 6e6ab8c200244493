"""The port's prefix cache and chunked prefill held against the JAX
package (CPU, f32): the counterparts of ``tests/test_prefix_cache.py``.

The allocator's refcounts, the radix index (claim, insert, mid-edge
split, LRU eviction under refcount pins, drop) and the scheduler's claim,
reclaim and copy-on-write run the same operations on both packages'
host objects, which must agree step for step.  The engines: a request
served from a claimed prefix, or chunk by chunk, emits the JAX engine's
and ``generate()``'s greedy tokens, and at temperature > 0 the tokens a
cache-less port engine draws for the same seed; a long prompt chunking
in never stalls a resident slot; cache pressure evicts chains instead of
preempting; replacing or removing an adapter makes its chains
unclaimable.
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
from ray_lightning_tpu_torch.serve import kv_cache as tkv
from ray_lightning_tpu_torch.serve.engine import ServeConfig, ServeEngine
from ray_lightning_tpu_torch.serve.scheduler import Request, Scheduler

jkv = importlib.import_module("ray_lightning_tpu.serve.kv_cache")
jsched = importlib.import_module("ray_lightning_tpu.serve.scheduler")

CFG = dict(vocab_size=128, n_layer=2, n_head=4, d_model=64, seq_len=64)
PACKAGES = (jkv, tkv)


def _tok(n, base=0):
    return [base + i + 1 for i in range(n)]


def _rand_prompt(seed, length):
    rng = np.random.default_rng(seed)
    return rng.integers(1, CFG["vocab_size"], size=(length,)).tolist()


@pytest.fixture(scope="module")
def model():
    jm = JaxGPT(JaxGPTConfig(**CFG, warmup_steps=1), attn_impl="xla")
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    for key in ("qkv_w", "proj_w", "mlp_in_w", "mlp_out_w"):
        tree["blocks"][key] = tree["blocks"][key] * 10.0
    return dict(jm=jm, jp=jax.tree.map(jnp.asarray, tree),
                tm=GPT(GPTConfig(**CFG), device="cpu"),
                tp=params_from_jax(tree, "cpu"))


def _ref(model, prompt, n, params=None):
    return generate(model["tm"], params or model["tp"], [prompt], n,
                    device="cpu")[0, len(prompt):].tolist()


def _both(fn):
    """``fn(kv_module)`` on the JAX and the port's module; the two
    results must agree."""
    got = [fn(kv) for kv in PACKAGES]
    assert got[0] == got[1], got
    return got[1]


# ---------------------------------------------------------------------------
# BlockAllocator refcounts
# ---------------------------------------------------------------------------

def test_allocator_lifecycle_matches_jax():
    def run(kv):
        a = kv.BlockAllocator(6)
        ids = a.alloc(2)
        b = ids[0]
        log = [a.refcount(b), a.is_shared(b)]
        a.retain([b])
        log += [a.refcount(b), a.is_shared(b), a.free_blocks]
        a.free([b])
        log += [a.refcount(b), a.free_blocks]
        a.free([b])
        log += [a.refcount(b), a.free_blocks, a.live_blocks]
        # The chain-resident case: the index's reference keeps blocks
        # out of the free list after their request frees them.
        rest = a.alloc(a.free_blocks)
        a.retain(rest)
        a.free(rest)
        log += [a.alloc(1), [a.refcount(x) for x in rest]]
        return log

    assert _both(run)[:4] == [1, False, 2, True]


@pytest.mark.parametrize("kv", PACKAGES, ids=("jax", "port"))
def test_allocator_refuses_what_jax_refuses(kv):
    a = kv.BlockAllocator(4)
    (b,) = a.alloc(1)
    a.retain([b])
    a.free([b])
    a.free([b])
    with pytest.raises(RuntimeError, match="double-free"):
        a.free([b])
    with pytest.raises(RuntimeError, match="not live"):
        a.retain([b])


# ---------------------------------------------------------------------------
# PrefixIndex
# ---------------------------------------------------------------------------

def _insert(a, idx, key, tokens):
    ids = a.alloc(len(tokens) // idx.block_size)
    idx.insert(key, tokens, ids)
    a.free(ids)
    return ids


def test_index_claim_split_and_isolation_match_jax():
    def run(kv):
        a = kv.BlockAllocator(24)
        idx = kv.PrefixIndex(a, 4)
        log = []
        long = _tok(16)
        ids = _insert(a, idx, None, long)
        got = idx.claim(None, long, max_blocks=4)
        log += [got == ids, [a.refcount(b) for b in got]]
        a.free(got)
        got = idx.claim(None, long, max_blocks=2)  # the cap
        log.append(got == ids[:2])
        a.free(got)
        fork = long[:8] + _tok(8, base=50)         # a mid-edge split
        fork_ids = a.alloc(4)
        log.append(idx.insert(None, fork, fork_ids))
        a.free(fork_ids)
        for toks in (long, fork):
            got = idx.claim(None, toks, max_blocks=4)
            log.append(len(got))
            a.free(got)
        ids3 = a.alloc(4)
        log.append(idx.insert(None, long, ids3))   # covered: nothing new
        a.free(ids3)
        _insert(a, idx, "tenant-a", _tok(8, base=90))
        log += [idx.claim("tenant-b", _tok(8, base=90), 2),
                idx.claim(None, _tok(8, base=90), 2),
                idx.claim(None, _tok(8), max_blocks=0)]
        with pytest.raises(ValueError, match="full blocks"):
            idx.insert(None, _tok(12), a.alloc(2))
        log.append(idx.stats())
        return log

    log = _both(run)
    assert log[0] is True and log[3] == 2 and log[4:6] == [4, 4]


def test_index_eviction_and_drop_match_jax():
    def run(kv):
        a = kv.BlockAllocator(16)
        idx = kv.PrefixIndex(a, 4)
        cold = _insert(a, idx, None, _tok(8))
        hot = _insert(a, idx, None, _tok(8, base=40))
        held = idx.claim(None, _tok(8, base=40), max_blocks=2)
        log = [held == hot, idx.evict(4),
               [a.refcount(b) for b in cold + hot]]
        a.free(held)
        log += [idx.evict(4), idx.stats()["cached_blocks"]]
        toks = _tok(16, base=60)
        ids = _insert(a, idx, None, toks)
        log.append(idx.evict(1))                   # tail first
        got = idx.claim(None, toks, max_blocks=4)
        log.append(got == ids[:3])
        a.free(got)
        _insert(a, idx, "t0", _tok(8))
        log += [idx.drop("t0"), idx.claim("t0", _tok(8), 2),
                idx.drop_all(), a.free_blocks, idx.drop("t0"),
                idx.stats()]
        return log

    log = _both(run)
    assert log[:2] == [True, 2] and log[6] is True


# ---------------------------------------------------------------------------
# Scheduler: claim admission, reclaim before preemption, copy-on-write
# ---------------------------------------------------------------------------

def _sched(S, BA, num_blocks=16, **kw):
    args = dict(block_size=4, max_blocks_per_seq=4, buckets=[4, 8, 16],
                max_queue=4)
    args.update(kw)
    return S(2, BA(num_blocks), **args)


def _poll(s):
    return s.poll()[0]


PAIRS = ((jsched.Scheduler, jsched.Request, jkv.BlockAllocator),
         (Scheduler, Request, tkv.BlockAllocator))


def test_claimed_admission_and_reclaim_match_jax():
    logs = []
    for S, R, BA in PAIRS:
        log = []
        s = _sched(S, BA)
        claimed = s.allocator.alloc(2)
        s.allocator.retain(claimed)
        s.claim_fn = lambda req: list(claimed)
        s.submit(R(rid="r1", prompt=_tok(11), max_new_tokens=4))
        (slot, req, bucket), = _poll(s)
        log += [bucket, req.claimed_tokens, s._blocks[slot][:2] == claimed,
                len(s._blocks[slot]), int(s.block_tables[slot][3])]
        s.finish(slot)
        log.append([s.allocator.refcount(b) for b in claimed])
        # Pool dry at admission: the reclaim hook runs before the grant
        # stalls.
        s = _sched(S, BA, num_blocks=5)
        resident = s.allocator.alloc(3)
        calls = []

        def reclaim(n, s=s, resident=resident, calls=calls):
            calls.append(n)
            s.allocator.free(resident[:n])
            return n

        s.reclaim = reclaim
        s.submit(R(rid="r2", prompt=_tok(16), max_new_tokens=4))
        (adm,) = _poll(s)
        log += [adm[2], calls]
        # A claim that cannot cover its suffix drops its references.
        s = _sched(S, BA, num_blocks=4)
        chain = s.allocator.alloc(2)
        s.allocator.retain(chain)
        s.claim_fn = lambda req, s=s, chain=chain: (
            s.allocator.retain(chain), list(chain))[1]
        s.allocator.alloc(1)
        s.submit(R(rid="r3", prompt=_tok(16), max_new_tokens=4))
        log += [_poll(s), [s.allocator.refcount(b) for b in chain]]
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[1][:2] == [0, 8]


def test_cow_slot_matches_jax():
    logs = []
    for S, R, BA in PAIRS:
        s = _sched(S, BA)
        s.submit(R(rid="r1", prompt=_tok(16), max_new_tokens=4))
        ((slot, _, _),) = _poll(s)
        log = [s.cow_slot(slot, 4)]
        shared = s._blocks[slot][:2]
        s.allocator.retain(shared)
        src, dst = s.cow_slot(slot, 2)
        log += [src == shared, s._blocks[slot][:2] == dst,
                list(s.block_tables[slot][:2]) == dst,
                [s.allocator.refcount(b) for b in shared]]
        s.allocator.free(shared)
        s = _sched(S, BA, num_blocks=5)
        s.submit(R(rid="r2", prompt=_tok(16), max_new_tokens=4))
        ((slot, _, _),) = _poll(s)
        one = s._blocks[slot][:1]
        s.allocator.retain(one)
        before = list(s._blocks[slot])
        log += [s.cow_slot(slot, 4), s._blocks[slot] == before,
                s.allocator.refcount(one[0])]
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[1][0] == ([], []) and logs[1][5] is None


def test_cow_slot_and_copy_blocks_on_a_claimed_admission(model):
    """``Scheduler.cow_slot`` then ``kv_cache.copy_blocks`` give a slot
    admitted on a claimed prefix private copies of its shared blocks,
    whose k/v equal the originals'; the request's stream is unchanged."""
    engine = ServeEngine(model["tm"], model["tp"],
                         ServeConfig(num_slots=2, block_size=8,
                                     prefix_cache=True), device="cpu")
    prompt = _rand_prompt(5, 26)
    engine.generate(prompt, 2)
    h = engine.submit(prompt, 6)
    engine.step()                        # admitted on a claimed prefix
    slot = h.request.slot
    blocks = list(engine.scheduler._blocks[slot])
    assert engine.cache.allocator.is_shared(blocks[0])
    before = engine._pool["k"][:, blocks[:2]].clone()
    src, dst = engine.scheduler.cow_slot(slot, 2)
    assert src == blocks[:2]
    engine._pool = tkv.copy_blocks(engine._pool, torch.tensor(src),
                                   torch.tensor(dst))
    after = engine.scheduler._blocks[slot]
    assert after[:2] == dst and after[2:] == blocks[2:]
    assert not engine.cache.allocator.is_shared(after[0])
    assert torch.equal(engine._pool["k"][:, after[:2]], before)
    engine.run_until_idle()
    assert h.result(0) == _ref(model, prompt, 6)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

def test_shared_prefix_parity_greedy_and_sampled(model):
    shared = _rand_prompt(5, 18)               # 2 full blocks at Bs 8
    p1 = shared + _rand_prompt(6, 4)
    p2 = shared + _rand_prompt(7, 6)
    jeng = JaxServeEngine(model["jm"], model["jp"],
                          JaxServeConfig(num_slots=2, block_size=8,
                                         prefix_cache=True))
    want = [jeng.generate(p1, 8), jeng.generate(p2, 8)]
    eng = ServeEngine(model["tm"], model["tp"],
                      ServeConfig(num_slots=2, block_size=8,
                                  prefix_cache=True), device="cpu")
    t1 = eng.generate(p1, 8)
    assert eng.prefix_cache.stats()["cached_blocks"] >= 2
    t2 = eng.generate(p2, 8)
    assert eng.prefix_cache.stats() == jeng.prefix_cache.stats()
    t2s = eng.generate(p2, 8, temperature=0.8, sample_seed=11)
    st = eng.prefix_cache.stats()
    assert st["hits"] >= 2 and st["blocks_claimed"] >= 4
    assert [t1, t2] == want
    assert [t1, t2] == [_ref(model, p1, 8), _ref(model, p2, 8)]
    assert eng.snapshot()["prefix"]["hits"] == st["hits"]
    ref = ServeEngine(model["tm"], model["tp"],
                      ServeConfig(num_slots=2, block_size=8), device="cpu")
    assert t2s == ref.generate(p2, 8, temperature=0.8, sample_seed=11)


def test_mixed_traffic_equals_jax_engine_with_every_feature(model):
    """prefix_cache + prefill_chunk on mixed traffic sharing a prefix:
    the same streams as the JAX engine's with the same knobs, and the
    same cache counters."""
    shared = _rand_prompt(50, 24)
    prompts = [shared + _rand_prompt(60 + i, n)
               for i, n in enumerate((3, 20, 9, 30))] + [_rand_prompt(70, 40)]
    knobs = dict(num_slots=3, block_size=8, prefix_cache=True,
                 prefill_chunk=16)
    jeng = JaxServeEngine(model["jm"], model["jp"], JaxServeConfig(**knobs))
    hs = [jeng.submit(p, 6) for p in prompts]
    jeng.run_until_idle()
    want = [h.result() for h in hs]
    eng = ServeEngine(model["tm"], model["tp"], ServeConfig(**knobs),
                      device="cpu")
    hs = [eng.submit(p, 6) for p in prompts]
    eng.run_until_idle()
    assert [h.result(0) for h in hs] == want
    assert eng.prefix_cache.stats() == jeng.prefix_cache.stats()
    assert eng.stats.counters["prefill_chunks"] == \
        jeng.stats.counters["prefill_chunks"]


def test_chunked_prefill_never_stalls_residents(model):
    eng = ServeEngine(model["tm"], model["tp"],
                      ServeConfig(num_slots=3, block_size=8,
                                  prefill_chunk=16), device="cpu")
    long_prompt = _rand_prompt(9, 48)
    emitted = {0: 0, 1: 0}
    residents = [
        eng.submit(_rand_prompt(12 + i, 12), 40,
                   on_token=lambda idx, tok, i=i:
                   emitted.__setitem__(i, emitted[i] + 1))
        for i in (0, 1)
    ]
    while not all(emitted.values()):
        eng.step()
    first_long = []
    h = eng.submit(long_prompt, 4,
                   on_token=lambda idx, tok: first_long.append(tok))
    stall, max_stall, steps = {0: 0, 1: 0}, 0, 0
    while not first_long:
        seen = dict(emitted)
        assert eng.step()
        steps += 1
        for i in (0, 1):
            stall[i] = 0 if emitted[i] > seen[i] else stall[i] + 1
            max_stall = max(max_stall, stall[i])
    assert max_stall == 0, f"a resident stalled {max_stall} steps"
    assert steps >= 3                      # 48 tokens in chunks of 16
    eng.run_until_idle()
    assert h.result(0) == _ref(model, long_prompt, 4)
    assert all(r.result(0) == _ref(model, _rand_prompt(12 + i, 12), 40)
               for i, r in enumerate(residents))
    assert eng.stats.counters["prefill_chunks"] >= 3


def test_chunked_prefill_admits_past_the_largest_bucket(model):
    prompt = _rand_prompt(13, 44)
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServeEngine(model["tm"], model["tp"],
                    ServeConfig(num_slots=2, block_size=8,
                                prefill_buckets=[8, 16]),
                    device="cpu").submit(prompt, 4)
    eng = ServeEngine(model["tm"], model["tp"],
                      ServeConfig(num_slots=2, block_size=8,
                                  prefill_buckets=[8, 16], prefill_chunk=16),
                      device="cpu")
    assert eng.generate(prompt, 4) == _ref(model, prompt, 4)


def test_cache_pressure_evicts_not_preempts(model):
    eng = ServeEngine(model["tm"], model["tp"],
                      ServeConfig(num_slots=2, block_size=8, num_blocks=11,
                                  prefix_cache=True), device="cpu")
    for s in range(4):
        eng.generate(_rand_prompt(20 + s, 17), 2)
    assert eng.prefix_cache.stats()["cached_blocks"] >= 4
    prompt = _rand_prompt(30, 17)
    assert eng.generate(prompt, 4) == _ref(model, prompt, 4)
    assert eng.prefix_cache.stats()["blocks_evicted"] > 0
    assert eng.stats.counters["preempted"] == 0


@pytest.mark.parametrize("how", ("replace", "remove"))
def test_adapter_drop_invalidates_chains(model, how):
    rng = np.random.default_rng(31)
    L, d, r = CFG["n_layer"], CFG["d_model"], 4

    def adapter(scale):
        ad = {"qkv_a": rng.standard_normal((L, d, r)) * 0.02,
              "qkv_b": rng.standard_normal((L, r, 3 * d)) * scale,
              "proj_a": rng.standard_normal((L, d, r)) * 0.02,
              "proj_b": rng.standard_normal((L, r, d)) * scale}
        ad = {k: v.astype(np.float32) for k, v in ad.items()}
        ad["scale"] = lora_cfg.lora_alpha / r
        return adapter_from_jax(ad, "cpu")

    lora_cfg = dataclasses.replace(model["tm"].config, lora_rank=r)
    ad_a, ad_b = adapter(0.3), adapter(0.3)
    merged_b = merge_lora({**model["tp"], "blocks": {
        **model["tp"]["blocks"], **{f"lora_{k}": ad_b[k] for k in
                                    ("qkv_a", "qkv_b", "proj_a", "proj_b")}}},
        lora_cfg)
    eng = ServeEngine(model["tm"], model["tp"],
                      ServeConfig(num_slots=2, block_size=8, max_adapters=2,
                                  adapter_rank=r, prefix_cache=True),
                      adapters={"t": ad_a}, device="cpu")
    prompt = _rand_prompt(40, 18)
    eng.generate(prompt, 6, adapter="t")
    eng.generate(prompt, 6)                   # the base chain
    assert "t" in eng.prefix_cache._roots
    if how == "replace":
        eng.add_adapter("t", ad_b)
    else:
        eng.remove_adapter("t")
    eng.generate(prompt, 2)                   # a step drains the drops
    assert "t" not in eng.prefix_cache._roots
    assert None in eng.prefix_cache._roots    # the base chain stays
    if how == "remove":
        eng.add_adapter("t", ad_b)
    hits = eng.prefix_cache.stats()["hits"]
    got = eng.generate(prompt, 6, adapter="t")
    assert eng.prefix_cache.stats()["hits"] == hits   # a miss
    assert got == _ref(model, prompt, 6, merged_b)
