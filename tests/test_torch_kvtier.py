"""The port's host KV tier against the JAX package's, on the CPU.

- Block records (ops/kvblock_quant.py) equal the JAX package's bitwise on
  the same numpy pages, f32, f16 and bf16 (``ml_dtypes.bfloat16`` in JAX,
  the port's ``BF16`` words), with int8 pages and scale leaves passed
  through raw; dequantized pages too; and ``block_from_wire`` refuses
  every malformed meta that the JAX one refuses.
- Token and text chain digests, the digest advertisement and the
  master's estimate equal the JAX package's.
- The arena obeys its LRU bound, native and int8, with the JAX arena's
  stats after the same puts.
- The block pool's eviction log equals the JAX pure-Python pool's.
- Through the batcher (tiny-llama f32, a pool small enough to evict): a
  prompt served again after its blocks were evicted restores them from
  the arena, and its tokens equal its cold serving's, greedy and
  seeded-sampled, on a native and on an int8 pool.
- Through the worker: ``kv_host_mb`` sizes the tier, and its counters
  reach ``/metrics``.
"""

import ml_dtypes
import numpy as np
import pytest

from distributed_llm_inferencing_tpu.native import _PyPool as JaxPyPool
from distributed_llm_inferencing_tpu.ops import kvblock_quant as jkvq
from distributed_llm_inferencing_tpu.runtime import kvtier as jtier
from distributed_llm_inferencing_tpu_torch.models.registry import get_config
from distributed_llm_inferencing_tpu_torch.ops import kvblock_quant as kvq
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.runtime import kvtier
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.block_pool import (
    BlockPool)
from distributed_llm_inferencing_tpu_torch.runtime.worker import WorkerAgent
from test_torch_families import one_torch_thread  # noqa: F401

RNG = np.random.default_rng(3)


def _page(shape=(2, 8, 2, 4)):
    return (RNG.standard_normal(shape) * RNG.uniform(0.1, 3.0)).astype(
        np.float32)


def _pages(kind):
    """(JAX pages, port pages) of one block in each package's host form."""
    a, b = _page(), _page()
    if kind == "bf16":
        j = [x.astype(ml_dtypes.bfloat16) for x in (a, b)]
        return j, [x.view(np.uint16).view(kvq.BF16) for x in j]
    if kind == "f16":
        a, b = a.astype(np.float16), b.astype(np.float16)
    if kind == "int8pool":
        q = RNG.integers(-127, 128, a.shape).astype(np.int8)
        s = RNG.random(a.shape[:-1]).astype(np.float32)
        return [q, q, s, s], [q, q, s, s]
    return [a, b], [a, b]


def _same(x, y):
    return x.dtype.itemsize == y.dtype.itemsize and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("kind", ["f32", "f16", "bf16", "int8pool"])
def test_block_records_equal_jax_bitwise(kind):
    jp, pp = _pages(kind)
    jrec, prec = jkvq.quantize_block(jp), kvq.quantize_block(pp)
    for je, pe in zip(jrec["pages"], prec["pages"]):
        assert je["kind"] == pe["kind"]
        if je["kind"] == "q8":
            assert _same(je["q"], pe["q"]) and _same(je["scale"], pe["scale"])
            assert je["dtype"] == pe["dtype"]
        else:
            assert _same(je["data"], pe["data"])
    for jd, pd in zip(jkvq.dequantize_block(jrec), kvq.dequantize_block(prec)):
        assert _same(jd, pd)
    assert kvq.stored_nbytes(prec) == jkvq.stored_nbytes(jrec)
    assert kvq.logical_nbytes(prec) == jkvq.logical_nbytes(jrec)
    assert [s for s, _ in kvq.logical_specs(prec)] == \
        [s for s, _ in jkvq.logical_specs(jrec)]
    assert kvq.wire_meta(prec) == jkvq.wire_meta(jrec)


@pytest.mark.parametrize("mangle", [
    "kind", "dtype", "q_dtype", "scale_dtype", "scale_shape",
    "nonfinite", "short", "long", "low_rank"])
def test_block_from_wire_rejects_as_jax_does(mangle):
    rec = kvq.quantize_block([_page()])
    meta, arrs = kvq.wire_meta(rec), kvq.wire_arrays(rec)
    if mangle == "kind":
        meta = [{"kind": "zstd"}]
    elif mangle == "dtype":
        meta = [{"kind": "q8", "dtype": "int64"}]
    elif mangle == "q_dtype":
        arrs = [arrs[0].astype(np.int16), arrs[1]]
    elif mangle == "scale_dtype":
        arrs = [arrs[0], arrs[1].astype(np.float64)]
    elif mangle == "scale_shape":
        arrs = [arrs[0], arrs[1][:1]]
    elif mangle == "nonfinite":
        bad = arrs[1].copy()
        bad.flat[0] = np.nan
        arrs = [arrs[0], bad]
    elif mangle == "short":
        arrs = arrs[:1]
    elif mangle == "long":
        arrs = arrs + [arrs[1]]
    else:
        arrs = [arrs[0][0], arrs[1]]
    with pytest.raises(ValueError):
        kvq.block_from_wire(meta, arrs)
    with pytest.raises(ValueError):
        jkvq.block_from_wire(meta, arrs)


def test_digests_and_advertisement_equal_jax():
    for n in (0, 7, 8, 41, 200):
        toks = RNG.integers(0, 50000, n).tolist()
        for bs in (1, 8, 16):
            assert kvtier.token_chain_digests(toks, bs) == \
                jtier.token_chain_digests(toks, bs)
    text = "The quick brown fox jumps over the lazy dog. " * 40 + "é✓"
    for chunk in (1, 16, 256):
        assert kvtier.text_chain_digests(text, chunk) == \
            jtier.text_chain_digests(text, chunk)
    mine, ref = (mod.PrefixDigestIndex(chunk=8, top_k=4)
                 for mod in (kvtier, jtier))
    for g in range(12):
        for idx in (mine, ref):
            idx.note(f"<{g:03d}>" + "s" * (28 + 9 * g), 32 + g)
    adv = mine.advertise()
    assert adv == ref.advertise()
    for prompt in ("<011>" + "s" * 200, "<002>" + "s" * 40, "zzz" * 30):
        assert kvtier.estimate_cached_tokens(prompt, adv) == \
            jtier.estimate_cached_tokens(prompt, adv)


@pytest.mark.parametrize("dtype", ["native", "int8"])
def test_arena_lru_bound_equals_jax(dtype):
    page = _page()
    mine = kvtier.HostKVArena(4 * page.nbytes, dtype=dtype)
    ref = jtier.HostKVArena(4 * page.nbytes, dtype=dtype)
    for i in range(16):
        for a in (mine, ref):
            assert a.put(f"d{i}", [page * (i + 1)])
        if i % 5 == 4:
            for a in (mine, ref):
                assert a.get(f"d{i - 3}") is not None   # LRU touch
    st = mine.stats()
    assert st == ref.stats()
    assert st["bytes"] <= st["capacity_bytes"] and st["dropped"] > 0
    for i in range(16):
        got, want = mine.peek_pages(f"d{i}"), ref.peek_pages(f"d{i}")
        assert (got is None) == (want is None)
        if got is not None:
            assert _same(got[0], want[0])
    assert not mine.put("huge", [np.zeros((1 << 12,), np.float64)])


def test_evict_log_equals_jax_pool():
    mine, ref = BlockPool(4, 2), JaxPyPool(4, 2)
    ref.set_evict_log(4)
    got = []
    mine.set_evict_hook(got.extend)
    seqs = [[1, 2, 3, 4], [1, 2, 5, 6], [7, 8, 9, 10], [11, 12, 13, 14]]
    want = []
    for toks in seqs:
        b_mine, b_ref = mine.alloc(2), ref.alloc(2)
        want.extend(ref.drain_evictions())
        assert b_mine == b_ref
        mine.insert_prefix(toks, b_mine, 0)
        ref.insert(toks, b_ref, 0)
        mine.release(b_mine)
        ref.release(b_ref)
    assert got == want and len(got) >= 2


CFG = get_config("tiny-llama").replace(dtype="float32")


def _serve(b, prompt, sampled=False, seed=3):
    sp = (SamplingParams(temperature=0.8, top_k=20, do_sample=True)
          if sampled else SamplingParams.greedy())
    r = b.submit(prompt, max_new_tokens=6, sampling=sp, seed=seed)
    for _ in range(200):
        b.step()
        if r.done.is_set():
            break
    return r.wait(), r.cost


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_restore_equals_cold_prefill(kv_quant):
    b = ContinuousBatcher(CFG.replace(kv_quant=kv_quant), num_blocks=12,
                          block_size=8, slots=2, max_seq=96, device="cpu",
                          kv_host_mb=8)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 256, 41).tolist()
    cold = [_serve(b, prompt, s)[0] for s in (False, True)]
    for sampled in (False, True):
        for _ in range(3):   # three 40-token prompts evict its blocks
            _serve(b, rng.integers(0, 256, 40).tolist())
        toks, cost = _serve(b, prompt, sampled)
        assert toks == cold[sampled]
        assert cost["prefill_cached_tokens"] == 40
        assert cost["arena_restored_bytes"] > 0
    c = b.metrics.snapshot()["counters"]
    assert c["kvtier_restored_blocks"] == 10 and \
        c["kvtier_offloaded_blocks"] > 10
    assert b.stats()["kvtier"]["restored"] == 10


def test_worker_kv_host_mb_and_counters_reach_metrics():
    agent = WorkerAgent(device="cpu")
    body = {"model_name": "tiny-llama", "allow_random_init": True,
            "dtype": "float32", "serving": "batched", "kv_blocks": 12,
            "kv_block_size": 8, "slots": 2, "max_seq": 96}
    assert agent.load_model(dict(body, kv_host_mb=4))[0] == 200
    off = {**body, "model_name": "tiny-llama-long", "kv_host_mb": 0}
    assert agent.load_model(off)[0] == 200
    try:
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, 256, 40).tolist() for _ in range(4)]
        for p in prompts + prompts[:1]:
            res = agent.inference({"model_name": "tiny-llama",
                                   "prompt_tokens": p, "max_new_tokens": 4,
                                   "sampling": {"do_sample": False}})
            assert res["status"] == "success", res
        assert res["cost"]["prefill_cached_tokens"] == 32
        models = {m["name"]: m for m in agent.health({})["loaded_models"]}
        assert models["tiny-llama"]["scheduler"]["kvtier"][
            "capacity_bytes"] == 4 << 20
        assert models["tiny-llama-long"]["scheduler"]["kvtier"] is None
        text = agent.prometheus({})[0].decode()
        for name in ("kvtier_offloaded_blocks", "kvtier_restored_blocks",
                     "kvtier_host_bytes", "kvtier_occupancy",
                     "kv_transfer_failures", "kv_fetch_requests"):
            assert f"\ndli_{name}" in text, name
        restored = [ln for ln in text.splitlines()
                    if ln.startswith("dli_kvtier_restored_blocks_total ")]
        assert restored and float(restored[0].split()[1]) == 4
    finally:
        agent.shutdown()
