"""Batched serving and speculation under tensor parallelism, held against
the JAX package's batcher and engine on the CPU's virtual mesh (f32).

- The port's tp=2 batcher (the leader's scheduler, one gloo follower
  replaying its device programs) gives the JAX tp=2 batcher's greedy
  tokens on the tiny qwen2 variant (GQA, q/k/v biases) with float, int8
  and int4 weights and on an int8 KV pool, over prompts that share a
  two-block prefix (a prefix hit) and admit in 16-token chunks (chunked
  prefill; a 40-token prompt too with float weights); every rank ran
  the same programs and ended each
  with the same outputs (``rank_stats``: programs run and an outputs
  digest per rank); per-rank collectives follow the count rule (2L + 1
  all-reduces and 1 gather per forward, no broadcast).
- The scheduler's own programs at tp=2 against tp=1 on the same weights
  (int4 weights; an int8 KV pool): every logits row the leader computed
  within 1e-4, the same tokens, and the ranks' pool shards side by side
  equal to tp=1's pool (an int8 pool's levels at most one step apart).
- tp=4 with concurrent requests and prefix reuse: the counterpart of the
  JAX package's ``test_tp_sharded_batcher_concurrent_and_prefix_reuse``.
- The speculative chunk (wave off) and wave mode (on) at tp=2 give the
  JAX tp=2 batcher's greedy tokens, drafts accepted; the
  tp=2 speculative engine gives the JAX tp=2 speculative engine's, with
  fewer verify steps than tokens and one broadcast (the leader's
  outcome) per weight pass.
- The worker: a batched load with ``"mesh": {"tp": 2}`` answers 200 and
  ``/inference_batch`` texts equal a JAX worker's on the same
  checkpoint; what tp does not serve yet is a 400 naming its ROADMAP
  item (the host tier, ``kv_export`` / ``kv_source`` and ``/kv_fetch``,
  ``resume`` and ``/migrate_out``, ``/load_adapter``); the unload leaves
  no follower alive.
- A follower killed between requests fails the next request, marks the
  group broken, and every later request fails at once.
- A kept group (``DLI_TP_KEEP_GROUPS``) serves the next model of its
  size, unless its follower died.

Each batcher but the worker's and the killed follower's loads on a kept
tp group (``DLI_TP_KEEP_GROUPS``), so the module spawns one group per
size for them.
"""

import json
import os
import signal
import time

import numpy as np
import pytest
import requests
import torch

from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.parallel.mesh import (
    MeshSpec as JaxMeshSpec)
from distributed_llm_inferencing_tpu.runtime.batcher import (
    ContinuousBatcher as JaxBatcher)
from distributed_llm_inferencing_tpu.runtime.engine import (
    InferenceEngine as JaxEngine)
from distributed_llm_inferencing_tpu.runtime.worker import (
    WorkerAgent as JaxWorkerAgent)
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.parallel.mesh import MeshSpec
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from distributed_llm_inferencing_tpu_torch.runtime.worker import WorkerAgent
from test_torch_families import family_pair, one_torch_thread  # noqa: F401
from test_torch_tp_families import _idle_groups, kept_groups  # noqa: F401

# chunked prefill at 2 blocks: the 40-token prompt admits in 3 chunks
POOL = dict(num_blocks=128, block_size=8, slots=4, max_seq=96, seed=0,
            prefill_chunk=2, kv_host_mb=0)
NEW = 10
GREEDY = SamplingParams.greedy()


def workload():
    """Two prompts over one 16-token system prompt (two full blocks: the
    second reuses the first's), a 40-token prompt and a repetitive one
    (drafts accept); under POOL's 2-block prefill chunk every prompt but
    the first admits in chunks."""
    rng = np.random.default_rng(11)
    system = rng.integers(1, 256, 16).tolist()
    rep = rng.integers(1, 256, 4).tolist()
    return [system + rng.integers(1, 256, 3).tolist(),
            system + rng.integers(1, 256, 6).tolist(),
            rng.integers(1, 256, 40).tolist(), (rep * 6)[:22]]


def drive(b, chunks=(4,), prompts=None):
    """Every prompt submitted at once, then one step at a time: the
    tokens per request."""
    b.DECODE_CHUNKS = chunks
    sp = (JaxSamplingParams.greedy() if isinstance(b, JaxBatcher)
          else GREEDY)
    reqs = [b.submit(p, max_new_tokens=NEW, sampling=sp, seed=30 + i)
            for i, p in enumerate(prompts or workload())]
    for _ in range(400):
        b.step()
        if all(r.done.is_set() for r in reqs):
            break
    return [r.wait() for r in reqs]


def _same_on_every_rank(b):
    """Every rank ran the leader's programs and ended each with the
    leader's outputs; the per-rank collectives are equal."""
    stats = b.rank_stats()
    assert len(stats) == b.mesh_spec.tp
    lead = stats[0]
    assert lead["programs_run"] > 0
    for s in stats[1:]:
        assert s["programs_run"] == lead["programs_run"]
        assert s["outputs_digest"] == lead["outputs_digest"]
        assert s["collectives"] == lead["collectives"]
    return lead


_CASES = {"float": {}, "int8_weights": {"quant": "int8"},
          "int4_weights": {"quant": "int4"}, "int8_kv": {"kv_quant": "int8"}}
# all but the float case skip the 40-token prompt (its three chunks'
# shapes to compile); their 22-token prompts still admit in two chunks
_PROMPTS = {"int8_weights": [0, 1, 3], "int4_weights": [0, 1, 3],
            "int8_kv": [0, 1, 3]}
_JAX_REF = {}


def _jax_ref(case):
    """(numpy tree, port model) of a case and the JAX tp=2 batcher's
    greedy tokens over ``workload()``, once per module (the speculative
    tests share the float case's: greedy speculation keeps plain decode's
    tokens, whatever the chunking)."""
    jcfg, jparams, tree, model = family_pair("qwen2-7b", **_CASES[case])
    if case not in _JAX_REF:
        _JAX_REF[case] = drive(JaxBatcher(
            jcfg, jparams, mesh_spec=JaxMeshSpec(tp=2), **POOL),
            prompts=_prompts(case))
    return tree, model, _JAX_REF[case]


def _prompts(case):
    return [workload()[i] for i in _PROMPTS.get(case, range(4))]


@pytest.mark.parametrize("case", list(_CASES))
def test_tp2_batcher_matches_the_jax_tp2_batcher(case, kept_groups):
    tree, model, ref = _jax_ref(case)
    b = ContinuousBatcher(model.cfg, params_from_jax(tree, model.cfg, "cpu"),
                          device="cpu", mesh_spec=MeshSpec(tp=2),
                          **POOL)
    try:
        b.reset_counts()
        assert drive(b, prompts=_prompts(case)) == ref
        lead = _same_on_every_rank(b)
        st = b.stats()
        assert st["mesh"]["tp"] == 2 and st["backend"] == "gloo"
        assert st["chunked_admissions"] > 0
        assert st["pool"]["prefix_hits"] >= 1
        assert st["kvtier"] is None and not st["decode_overlap"]
        # every program is one forward per weight pass or admission
        # program: 2L + 1 all-reduces and one gather each, and no
        # broadcast (every rank samples from the gathered logits)
        c = lead["collectives"]
        L = model.cfg.num_layers
        assert c["broadcast"] == 0 and c["gather"] > 0
        assert c["all_reduce"] == (2 * L + 1) * c["gather"]
        assert b.model.layers[0].kv_heads == 1        # of Hkv=2
    finally:
        b.stop()


def _served(b, prompts):
    """``prompts`` through ``b``'s scheduler (``drive``): the tokens and
    every logits row its programs computed on the leader
    (``Transformer.unembed``: an admission wave's rows, each decode
    step's slots)."""
    rows, unembed = [], b.model.unembed

    def recorded(x):
        out = unembed(x)
        rows.append(out.reshape(-1, out.shape[-1]).clone())
        return out

    b.model.unembed = recorded
    try:
        toks = drive(b, prompts=prompts)
    finally:
        del b.model.unembed
    return toks, torch.cat(rows).numpy()


@pytest.mark.parametrize("case", ["int4_weights", "int8_kv"])
def test_scheduler_logits_tp2_equal_tp1(case, kept_groups):
    """The scheduler's admission waves and decode chunks (an int8 pool's
    through its side buffers and flush) at tp=2 against tp=1 on the
    same weights: every logits row within 1e-4, the same tokens, and
    the ranks' pool shards (``rank_stats(pool_blocks)``) side by side
    equal to tp=1's pool, an int8 pool's levels at most one step apart
    on at most 1% of them."""
    _, _, tree, model = family_pair("qwen2-7b", **_CASES[case])
    prompts, blocks = workload()[1:3], range(1, POOL["num_blocks"] + 1)
    out = []
    for spec in (MeshSpec(), MeshSpec(tp=2)):
        b = ContinuousBatcher(model.cfg,
                              params_from_jax(tree, model.cfg, "cpu"),
                              device="cpu", mesh_spec=spec,
                              decode_overlap=False, **POOL)
        try:
            toks, rows = _served(b, prompts)
            pools = [s["pool"] for s in b.rank_stats(pool_blocks=blocks)]
        finally:
            b.stop()
        # k, v (and the scales) with every rank's kv heads side by side
        out.append((toks, rows, [torch.cat(ls, dim=3).numpy()
                                 for ls in zip(*pools)]))
    (toks1, rows1, pool1), (toks2, rows2, pool2) = out
    assert toks2 == toks1 and len(toks1[0]) == NEW
    assert rows2.shape == rows1.shape and rows1.shape[-1] == 256
    np.testing.assert_allclose(rows2, rows1, rtol=1e-4, atol=1e-4)
    assert len(pool2) == (4 if case == "int8_kv" else 2)
    for got, want in zip(pool2, pool1):
        assert got.shape == want.shape and np.abs(want).max() > 0
        if got.dtype == np.int8:
            off = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert off.max() <= 1 and (off > 0).mean() <= 0.01
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_tp4_concurrent_requests_and_prefix_reuse(kept_groups):
    """The JAX package's tp=4 batcher test, on the port: four requests
    over one two-block system prompt, all at once."""
    jcfg, jparams, tree, model = family_pair("tiny-gpt2")
    rng = np.random.default_rng(5)
    system = rng.integers(0, 256, 16).tolist()
    prompts = [system + rng.integers(0, 256, 3 + i).tolist()
               for i in range(4)]
    pool = dict(POOL, prefill_chunk=32)
    ref = drive(JaxBatcher(jcfg, jparams, mesh_spec=JaxMeshSpec(tp=4),
                           **pool), prompts=prompts)
    b = ContinuousBatcher(model.cfg, params_from_jax(tree, model.cfg, "cpu"),
                          device="cpu", mesh_spec=MeshSpec(tp=4),
                          **pool)
    try:
        assert drive(b, prompts=prompts) == ref
        assert b.pool.stats()["prefix_hits"] >= 1
        _same_on_every_rank(b)
    finally:
        b.stop()


# ---- speculation ------------------------------------------------------------

def test_tp2_speculative_batcher_matches_the_jax_one(kept_groups):
    """The chunk (wave off) and wave mode (on), adaptive off, against the
    JAX tp=2 batcher's greedy tokens (its speculative batcher's equal
    them: tests/test_torch_spec_batcher.py)."""
    tree, model, ref = _jax_ref("float")
    spec = dict(speculative="ngram", spec_gamma=3, spec_adaptive=False)
    for wave in (True, False):
        b = ContinuousBatcher(
            model.cfg, params_from_jax(tree, model.cfg, "cpu"),
            device="cpu", mesh_spec=MeshSpec(tp=2), spec_wave=wave,
            **spec, **POOL)
        try:
            assert drive(b, chunks=(8, 4)) == ref, wave
            assert b.stats()["spec_accepted_tokens"] > 0
            _same_on_every_rank(b)
        finally:
            b.stop()


def test_tp2_speculative_engine_matches_the_jax_one(kept_groups,
                                                    monkeypatch):
    monkeypatch.setenv("DLI_SPEC_ADAPTIVE", "0")
    jcfg, jparams, tree, model = family_pair("qwen2-7b")
    prompt = workload()[3]
    jeng = JaxEngine(jcfg, jparams, mesh_spec=JaxMeshSpec(tp=2), max_seq=96)
    ref = jeng.generate([prompt], 16, sampling=JaxSamplingParams.greedy(),
                        speculative="ngram", spec_gamma=3).tokens
    eng = InferenceEngine(model.cfg, params_from_jax(tree, model.cfg, "cpu"),
                          mesh_spec=MeshSpec(tp=2), max_seq=96,
                          device="cpu")
    try:
        eng.reset_counts()
        res = eng.generate([prompt], 16, sampling=GREEDY,
                           speculative="ngram", spec_gamma=3)
        assert res.tokens == ref
        assert res.steps < len(res.tokens[0])          # drafts accepted
        L = model.cfg.num_layers
        want = {"all_reduce": (2 * L + 1) * res.steps,
                "gather": res.steps, "broadcast": res.steps}
        assert all(s["collectives"] == want for s in eng.rank_stats())
        plain = eng.generate([prompt], 16, sampling=GREEDY).tokens
        assert plain == ref
    finally:
        eng.close()


def test_a_kept_group_serves_the_next_model(kept_groups):
    """``DLI_TP_KEEP_GROUPS``: a stopped batcher's group stays up, idle,
    and the next tp model of its size (an engine) loads on it and gives
    tp=1's greedy tokens; a kept group whose follower died is not
    taken."""
    _, _, tree, model = family_pair("qwen2-7b")
    cfg, prompt = model.cfg, workload()[0]
    b = ContinuousBatcher(cfg, params_from_jax(tree, cfg, "cpu"),
                          device="cpu", mesh_spec=MeshSpec(tp=2), **POOL)
    group = b._leader
    [pid] = group.alive()
    b.stop()
    assert group.alive() == [pid] and not group.broken
    one = InferenceEngine(cfg, params_from_jax(tree, cfg, "cpu"),
                          max_seq=96, device="cpu")
    ref = one.generate([prompt], 4, sampling=GREEDY).tokens
    eng = InferenceEngine(cfg, params_from_jax(tree, cfg, "cpu"),
                          mesh_spec=MeshSpec(tp=2), max_seq=96,
                          device="cpu")
    try:
        assert eng._leader is group
        assert eng.generate([prompt], 4, sampling=GREEDY).tokens == ref
    finally:
        eng.close()
    os.kill(pid, signal.SIGKILL)
    deadline = time.monotonic() + 30
    while group.alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    eng = InferenceEngine(cfg, params_from_jax(tree, cfg, "cpu"),
                          mesh_spec=MeshSpec(tp=2), max_seq=96,
                          device="cpu")
    try:
        assert eng._leader is not group and group.broken
        assert eng.generate([prompt], 4, sampling=GREEDY).tokens == ref
    finally:
        eng.close()


# ---- the worker -------------------------------------------------------------

def _url(agent, path):
    return f"http://127.0.0.1:{agent.service.port}{path}"


def _post(agent, path, body, **kw):
    return requests.post(_url(agent, path), json=body,
                         timeout=kw.pop("timeout", 180), **kw)


def test_worker_batched_tp2_serves_like_the_jax_worker():
    """The same checkpoint (f32) through a port worker with ``"mesh":
    {"tp": 2}, "serving": "batched"`` and a JAX worker with the same
    body: /inference_batch texts equal; the refusals; the unload stops
    the follower."""
    from test_torch_convert import with_tokenizer
    ckpt = with_tokenizer("llama")
    body = {"model_name": "m", "checkpoint_path": ckpt, "dtype": "float32",
            "serving": "batched", "mesh": {"tp": 2}, "kv_blocks": 64,
            "kv_block_size": 8, "slots": 4, "max_seq": 64}
    subs = [{"prompt": p, "max_new_tokens": 6, "seed": i,
             "request_tag": f"t{i}", "sampling": {"do_sample": False}}
            for i, p in enumerate(["hello world", "the quick brown fox",
                                   "distributed llm inference"])]
    port, jax_agent = WorkerAgent(device="cpu"), JaxWorkerAgent()
    texts = {}
    try:
        for side, agent in (("port", port), ("jax", jax_agent)):
            agent.serve("127.0.0.1", 0, background=True)
            r = _post(agent, "/load_model", dict(body, kv_host_mb=0))
            assert r.status_code == 200, r.text
            r = _post(agent, "/inference_batch",
                      {"model_name": "m", "requests": subs}, stream=True)
            assert r.status_code == 200
            lines = [json.loads(x) for x in r.iter_lines() if x]
            assert all(x["status"] == 200 for x in lines), lines
            texts[side] = {x["request_tag"]: x["body"]["result"]
                           for x in lines}
        assert texts["port"] == texts["jax"]
        [m] = requests.get(_url(port, "/health"),
                           timeout=30).json()["loaded_models"]
        assert m["scheduler"]["mesh"]["tp"] == 2
        assert m["scheduler"]["backend"] == "gloo"
        # what the followers cannot replay yet: 400s naming the item
        for path, extra, item in (
                ("/inference", {"kv_export": True}, "9.13"),
                ("/inference", {"kv_source": {"url": "http://127.0.0.1:9",
                                              "model": "m"}}, "9.13"),
                ("/inference", {"resume": {"tokens": [5]}}, "9.14"),
                ("/kv_fetch", {"digests": ["x"]}, "9.13"),
                ("/migrate_out", {"request_tag": "t0"}, "9.14"),
                ("/load_adapter", {"adapter": "a",
                                   "source": "synth:rank=2,seed=1"},
                 "9.11")):
            r = _post(port, path, {"model_name": "m", "prompt": "hello",
                                   "max_new_tokens": 2, **extra})
            assert r.status_code == 400, (path, extra, r.text)
            assert f"item {item}" in r.json()["message"], r.text
        r = _post(port, "/load_model", dict(body, model_name="m2",
                                            kv_host_mb=8))
        assert r.status_code == 400 and "9.12" in r.json()["message"]
        pids = port.models["m"].batcher._leader.alive()
        assert len(pids) == 1
        r = _post(port, "/unload_model", {"model_name": "m"})
        assert r.status_code == 200
        for pid in pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
    finally:
        port.shutdown()
        jax_agent.service.shutdown()


def test_a_killed_follower_fails_the_next_request_and_breaks_the_group():
    _, _, tree, model = family_pair("qwen2-7b")
    b = ContinuousBatcher(model.cfg, params_from_jax(tree, model.cfg, "cpu"),
                          device="cpu", mesh_spec=MeshSpec(tp=2), **POOL)
    b.start()
    try:
        first = b.submit([5, 6, 7], max_new_tokens=3, sampling=GREEDY)
        assert len(first.wait(timeout=120)) == 3
        [pid] = b._leader.alive()
        os.kill(pid, signal.SIGKILL)
        deadline = time.monotonic() + 30
        while b._leader.alive() and time.monotonic() < deadline:
            time.sleep(0.05)
        nxt = b.submit([8, 9, 10], max_new_tokens=3, sampling=GREEDY)
        with pytest.raises(RuntimeError, match="follower"):
            nxt.wait(timeout=120)
        assert b._leader.broken
        t0 = time.monotonic()
        later = b.submit([1, 2], max_new_tokens=2, sampling=GREEDY)
        with pytest.raises(RuntimeError, match="scheduler error"):
            later.wait(timeout=5)
        assert time.monotonic() - t0 < 5
    finally:
        b.stop()
