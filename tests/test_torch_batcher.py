"""The port's continuous batcher and its batched worker mode, on the CPU.

- Greedy parity with the JAX ``ContinuousBatcher``: tiny-llama f32,
  weights bridged from the JAX tree, 4 slots over a 128-block pool of
  8-token blocks, three prompts of tests/test_pallas_parity.py plus a
  fourth that shares the first's first 16 tokens (a radix-prefix hit),
  12 greedy tokens each. Equal tokens with ``DLI_FUSED_DECODE`` off and
  on; both batchers run one decode-chunk size so the JAX side compiles
  few programs, once per module.
- Port-internal invariants: a pool small enough to force preemption and
  chunked prefill gives the large pool's greedy tokens; a seeded sampled
  request gives the same tokens alone and inside a wave of four;
  ``cancel`` frees the slot.
- The worker with ``"serving": "batched"`` on ``device="cpu"``:
  concurrent /inference calls equal direct ``submit`` calls, /health
  reports the scheduler, and the fields the port does not implement get
  a 400.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import requests

from distributed_llm_inferencing_tpu.models.params import (
    init_params as jax_init_params)
from distributed_llm_inferencing_tpu.models.registry import (
    get_config as jax_config)
from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.runtime.batcher import (
    ContinuousBatcher as JaxBatcher)
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.models.registry import get_config
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.worker import WorkerAgent
from test_torch_families import one_torch_thread  # noqa: F401

CHUNKS = (4,)   # one decode program on the JAX side


def _prompts():
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, 4).tolist()
    prompts = [(base * 6)[:20], rng.integers(0, 256, 9).tolist(),
               rng.integers(0, 256, 13).tolist()]
    return prompts + [prompts[0][:16] + rng.integers(0, 256, 7).tolist()]


def _drive(b, prompts, sampling, max_new=12, seeds=None, steps=300):
    reqs = [b.submit(p, max_new_tokens=max_new, sampling=sampling,
                     seed=(seeds or [50 + i for i in range(len(prompts))])[i])
            for i, p in enumerate(prompts)]
    for _ in range(steps):
        b.step()
        if all(r.done.is_set() for r in reqs):
            break
    return reqs


@pytest.fixture(scope="module")
def jax_run():
    """The JAX batcher's greedy tokens, with the fused gate off and on,
    and its parameter tree (computed once per module)."""
    jcfg = jax_config("tiny-llama").replace(dtype="float32",
                                            attn_backend="xla")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    out = {}
    old = os.environ.get("DLI_FUSED_DECODE")
    try:
        for fused in (False, True):
            os.environ["DLI_FUSED_DECODE"] = "1" if fused else "0"
            b = JaxBatcher(jcfg, params, num_blocks=128, block_size=8,
                           slots=4, max_seq=96, seed=0)
            b.DECODE_CHUNKS = CHUNKS
            reqs = _drive(b, _prompts(), JaxSamplingParams.greedy())
            out[fused] = ([r.wait() for r in reqs],
                          [r.cost["prefill_cached_tokens"] for r in reqs])
    finally:
        if old is None:
            os.environ.pop("DLI_FUSED_DECODE", None)
        else:
            os.environ["DLI_FUSED_DECODE"] = old
    return out, jax.tree.map(np.asarray, params)


def _port_batcher(np_params=None, **kw):
    cfg = get_config("tiny-llama").replace(dtype="float32")
    params = (params_from_jax(np_params, cfg, "cpu")
              if np_params is not None else None)
    args = dict(num_blocks=128, block_size=8, slots=4, max_seq=96, seed=0,
                device="cpu")
    args.update(kw)
    b = ContinuousBatcher(cfg, params, **args)
    b.DECODE_CHUNKS = CHUNKS
    return b


@pytest.mark.parametrize("fused", [False, True])
def test_greedy_tokens_match_the_jax_batcher(monkeypatch, jax_run, fused):
    monkeypatch.setenv("DLI_FUSED_DECODE", "1" if fused else "0")
    (ref, np_params) = jax_run
    want_tokens, want_cached = ref[fused]
    b = _port_batcher(np_params)
    reqs = _drive(b, _prompts(), SamplingParams.greedy())
    assert [r.wait() for r in reqs] == want_tokens
    cached = [r.cost["prefill_cached_tokens"] for r in reqs]
    assert cached == want_cached and cached[3] == 16   # the prefix hit
    assert b.stats()["pool"]["prefix_hits"] >= 1
    c = b.metrics.snapshot()["counters"]
    # decode chunks emit all but each request's first (admission) token
    assert c["batcher_tokens_emitted"] == 4 * 11
    assert c["prefill_cached_tokens"] == 16


def test_small_pool_preempts_and_chunks_with_the_same_tokens():
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).tolist() for n in (30, 9, 21, 17)]

    def run(**kw):
        b = _port_batcher(max_seq=64, **kw)
        b.DECODE_CHUNKS = (8, 4, 2, 1)
        reqs = _drive(b, prompts, SamplingParams.greedy(), max_new=14,
                      steps=400)
        return [r.wait() for r in reqs], b

    big, _ = run(num_blocks=128)
    small, b = run(num_blocks=7, prefill_chunk=1)
    assert small == big
    assert b.metrics.snapshot()["counters"]["batcher_preemptions"] >= 1
    assert b.stats()["chunked_admissions"] >= 1
    # every request finished: no block still referenced (the dummy aside)
    assert not any(b.active)
    assert all(b.pool.refcount(i) == 0 for i in range(1, 8))


def test_sampled_request_alone_equals_inside_a_wave():
    sp = SamplingParams(temperature=0.9, top_k=20, top_p=0.9)
    prompts = _prompts()
    alone = _drive(_port_batcher(), prompts[2:3], sp, seeds=[77])[0].wait()
    wave = _drive(_port_batcher(), prompts, sp, seeds=[1, 2, 77, 3])
    assert wave[2].wait() == alone
    assert len(alone) == 12


def test_cancel_frees_the_slot():
    b = _port_batcher()
    free0 = b.pool.free_count()
    [req] = _drive(b, _prompts()[:1], SamplingParams.greedy(), max_new=60,
                   steps=1)
    assert not req.done.is_set() and b.active[0] is req
    req.cancel()
    b.step()
    assert req.done.is_set() and req.error == "cancelled"
    assert b.active == [None] * 4
    # the prompt's full blocks stay in the radix cache, evictable
    assert b.pool.free_count() + len(req.prompt) // 8 == free0
    with pytest.raises(RuntimeError):
        req.wait(0)


# ---- the worker, batched mode ---------------------------------------

@pytest.fixture(scope="module")
def worker():
    w = WorkerAgent(device="cpu")
    w.serve("127.0.0.1", 0, background=True)
    url = f"http://127.0.0.1:{w.service.port}"
    r = requests.post(url + "/load_model", json={
        "model_name": "tiny-llama", "allow_random_init": True,
        "dtype": "float32", "serving": "batched", "kv_blocks": 64,
        "kv_block_size": 8, "slots": 4, "max_seq": 96, "prefill_chunk": 2,
        "decode_chunk_cap": 8}, timeout=120)
    assert r.status_code == 200 and r.json()["status"] == "success", r.text
    yield w, url
    w.shutdown()


def test_worker_concurrent_inference_equals_direct_submit(worker):
    w, url = worker
    prompts = _prompts()
    bodies = [{"model_name": "tiny-llama", "prompt_tokens": p,
               "max_new_tokens": 10, "seed": 60 + i,
               "sampling": {"do_sample": i % 2 == 0, "temperature": 0.9}}
              for i, p in enumerate(prompts)]
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        got = list(ex.map(lambda b: requests.post(
            url + "/inference", json=b, timeout=120), bodies))
    b = w.models["tiny-llama"].batcher
    for body, r in zip(bodies, got):
        assert r.status_code == 200, r.text
        res = r.json()
        sp = body["sampling"]
        direct = b.submit(body["prompt_tokens"], max_new_tokens=10,
                          sampling=SamplingParams(
                              temperature=sp["temperature"],
                              do_sample=sp["do_sample"]),
                          seed=body["seed"]).wait(120)
        assert res["tokens"] == direct
        assert res["ttft_ms"] > 0 and res["cost"]["weight_passes"] >= 9
        assert res["scheduler"]["slots"] == 4
    health = requests.get(url + "/health", timeout=30).json()
    [m] = health["loaded_models"]
    assert m["serving"] == "batched" and m["scheduler"]["block_size"] == 8


@pytest.mark.parametrize("route,extra", [
    ("/load_model", {"kv_quantize": "fp8"}),
    ("/load_model", {"kv_digest_chunk": "wide"}),
    ("/inference", {"adapter": "never-loaded"}),
    ("/inference", {"resume": {"tokens": [1, 2]}}),
    ("/inference", {"speculative": "ngram"}),
    ("/load_model", {"speculative": "medusa"}),
    ("/load_model", {"kv_host_mb": "lots"}),
])
def test_worker_refuses_unported_batched_fields(worker, route, extra):
    _, url = worker
    if route == "/load_model":
        body = {"model_name": "tiny-llama", "allow_random_init": True,
                "serving": "batched", **extra}
    else:
        body = {"model_name": "tiny-llama", "prompt_tokens": [1, 2],
                "max_new_tokens": 2, **extra}
    r = requests.post(url + route, json=body, timeout=30)
    assert r.status_code == 400 and r.json()["status"] == "error"


def test_worker_refuses_an_unknown_serving_mode(worker):
    _, url = worker
    r = requests.post(url + "/load_model", json={
        "model_name": "tiny-llama-long", "allow_random_init": True,
        "serving": "pipelined"}, timeout=30)
    assert r.status_code == 400
