"""Batched serving under pipeline parallelism, held against the JAX
package's pipelined batcher on the CPU's virtual mesh (f32).

- The port's pp=2 batcher (the leader's scheduler on stage 0, a follower
  stage replaying its programs) gives the JAX pp=2 batcher's greedy
  tokens on the tiny qwen2 variant (one layer per stage) over prompts
  that share a two-block prefix (a prefix hit) and admit in chunks, with
  a float and an int8 KV pool, on the paged and on the fused decode
  route; every rank ran the same programs with the same outputs, and
  each program is one broadcast of the last stage's outputs.
- Sampled tokens (the port's hash-keyed streams), an eos stop, the
  budget and requests admitted while others decode equal the port's pp=1
  batcher's on the same weights, with the slots rounded up to a multiple
  of pp; the stages' pool slices side by side equal pp=1's pool (an
  int8 pool's levels at most one step apart).
- The speculative chunk (wave off) and wave mode (on) at pp=2 give the
  JAX pp=2 batcher's greedy tokens, drafts accepted.
- pp=2 × tp=2 (four ranks) gives the same tokens.
- The worker: a batched load with ``"mesh": {"pp": 2}`` and an
  engine-mode one answer with a JAX worker's texts; what pp does not
  serve is a 400 naming its item; the unload leaves no follower.
- A killed stage fails the next request and breaks the group.
"""

import json
import os
import signal
import time

import numpy as np
import pytest
import requests
import torch

from distributed_llm_inferencing_tpu.parallel.mesh import (
    MeshSpec as JaxMeshSpec)
from distributed_llm_inferencing_tpu.runtime.batcher import (
    ContinuousBatcher as JaxBatcher)
from distributed_llm_inferencing_tpu.runtime.worker import (
    WorkerAgent as JaxWorkerAgent)
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.parallel.mesh import MeshSpec
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.worker import WorkerAgent
from test_torch_families import family_pair, one_torch_thread  # noqa: F401
from test_torch_tp_batcher import POOL, drive, workload
from test_torch_tp_families import _idle_groups, kept_groups  # noqa: F401

GREEDY = SamplingParams.greedy()
_CASES = {"float": {}, "int8_kv": {"kv_quant": "int8"}}
_REF = {}


def _ref(case):
    """(numpy tree, port config) of a case and the JAX pp=2 batcher's
    greedy tokens over ``workload()``, once per module."""
    jcfg, jparams, tree, model = family_pair("qwen2-7b", **_CASES[case])
    if case not in _REF:
        _REF[case] = drive(JaxBatcher(jcfg, jparams,
                                      mesh_spec=JaxMeshSpec(pp=2), **POOL))
    return tree, model.cfg, _REF[case]


def _batcher(cfg, tree, spec, **kw):
    return ContinuousBatcher(cfg, params_from_jax(tree, cfg, "cpu"),
                             device="cpu", mesh_spec=spec,
                             **dict(POOL, **kw))


def _same_on_every_rank(b):
    """Every rank ran the leader's programs with the leader's outputs; one
    broadcast (the last stage's outputs) per program."""
    stats = b.rank_stats()
    assert len(stats) == b.mesh_spec.world
    lead = stats[0]
    assert lead["programs_run"] > 0
    for s in stats:
        assert s["programs_run"] == lead["programs_run"]
        assert s["outputs_digest"] == lead["outputs_digest"]
        assert s["collectives"]["broadcast"] == lead["programs_run"]
    return stats


@pytest.mark.parametrize("case,fused", [("float", False), ("float", True),
                                        ("int8_kv", False)])
def test_pp2_batcher_matches_the_jax_pp2_batcher(case, fused, kept_groups,
                                                 monkeypatch):
    monkeypatch.setenv("DLI_FUSED_DECODE", "1" if fused else "0")
    tree, cfg, ref = _ref(case)
    b = _batcher(cfg, tree, MeshSpec(pp=2))
    try:
        assert drive(b) == ref
        stats = _same_on_every_rank(b)
        assert [s["layers"] for s in stats] == [[0, 1], [1, 2]]
        st = b.stats()
        assert st["mesh"]["pp"] == 2 and st["backend"] == "gloo"
        assert st["chunked_admissions"] > 0
        assert st["pool"]["prefix_hits"] >= 1
        assert st["kvtier"] is None and not st["decode_overlap"]
        assert len(b.model.layers) == 1 and b.model.lm_head is None
    finally:
        b.stop()


def _mixed(b, late):
    """Greedy and sampled requests, one with eos, two admitted while the
    first decode: the tokens per request."""
    b.DECODE_CHUNKS = (4,)
    ps = workload()
    sampled = SamplingParams(temperature=0.8, top_k=40, top_p=0.9)
    reqs = [b.submit(ps[0], 9, sampling=GREEDY, seed=1),
            b.submit(ps[1], 7, sampling=sampled, seed=2),
            b.submit(ps[3], 12, sampling=GREEDY, seed=3, eos_token_id=late)]
    for _ in range(3):
        b.step()
    reqs += [b.submit(ps[2], 5, sampling=sampled, seed=4),
             b.submit(ps[0][:9], 6, sampling=GREEDY, seed=5)]
    for _ in range(400):
        b.step()
        if all(r.done.is_set() for r in reqs):
            break
    return [r.wait() for r in reqs]


@pytest.mark.parametrize("case", list(_CASES))
def test_sampled_eos_and_inflight_admission_equal_pp1(case, kept_groups):
    _, _, tree, model = family_pair("qwen2-7b", **_CASES[case])
    cfg = model.cfg
    out = []
    for spec in (MeshSpec(), MeshSpec(pp=2)):
        b = _batcher(cfg, tree, spec, slots=3)
        try:
            toks = _mixed(b, late=None)
            eos = toks[2][4]
            toks_eos = _mixed(b, late=eos)
            pools = [s["pool"] for s in b.rank_stats(
                pool_blocks=range(1, POOL["num_blocks"] + 1))]
        finally:
            b.stop()
        assert b.slots == (3 if spec.pp == 1 else 4)
        out.append((toks, toks_eos, [torch.cat(ls, dim=0).numpy()
                                     for ls in zip(*pools)]))
    (t1, e1, pool1), (t2, e2, pool2) = out
    assert t2 == t1 and e2 == e1
    assert len(e1[2]) < 12 and len(t1[3]) == 5      # eos, the budget
    for got, want in zip(pool2, pool1):
        assert got.shape == want.shape and np.abs(want).max() > 0
        if got.dtype == np.int8:
            off = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert off.max() <= 1 and (off > 0).mean() <= 0.01
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_pp2_speculative_chunk_and_wave_match_the_jax_batcher(kept_groups):
    tree, cfg, ref = _ref("float")
    for wave in (True, False):
        b = _batcher(cfg, tree, MeshSpec(pp=2), speculative="ngram",
                     spec_gamma=3, spec_adaptive=False, spec_wave=wave)
        try:
            assert drive(b, chunks=(8, 4)) == ref, wave
            assert b.stats()["spec_accepted_tokens"] > 0
            _same_on_every_rank(b)
        finally:
            b.stop()


def test_pp2_tp2_batcher_gives_the_same_tokens(kept_groups):
    tree, cfg, ref = _ref("float")
    b = _batcher(cfg, tree, MeshSpec(pp=2, tp=2))
    try:
        assert drive(b) == ref
        stats = _same_on_every_rank(b)
        assert [tuple(s["grid"].values()) for s in stats] == \
            [(0, 0, 0), (0, 0, 1), (1, 0, 0), (1, 0, 1)]
        assert b.model.layers[0].kv_heads == 1        # of Hkv=2
    finally:
        b.stop()


# ---- the worker -------------------------------------------------------------

def _post(agent, path, body, **kw):
    return requests.post(f"http://127.0.0.1:{agent.service.port}{path}",
                         json=body, timeout=kw.pop("timeout", 180), **kw)


def test_worker_pp2_serves_like_the_jax_worker():
    """The same checkpoint (f32) through a port worker and a JAX worker
    with ``"mesh": {"pp": 2}``, batched and in engine mode: the texts of
    /inference_batch equal; the refusals; unloads stop the followers."""
    from test_torch_convert import with_tokenizer
    ckpt = with_tokenizer("llama")
    body = {"checkpoint_path": ckpt, "dtype": "float32", "mesh": {"pp": 2},
            "kv_blocks": 64, "kv_block_size": 8, "slots": 3, "max_seq": 64}
    subs = [{"prompt": p, "max_new_tokens": 6, "seed": i,
             "request_tag": f"t{i}", "sampling": {"do_sample": False}}
            for i, p in enumerate(["hello world", "the quick brown fox",
                                   "distributed llm inference"])]
    port, jax_agent = WorkerAgent(device="cpu"), JaxWorkerAgent()
    texts = {}
    try:
        for side, agent in (("port", port), ("jax", jax_agent)):
            agent.serve("127.0.0.1", 0, background=True)
            for name, mode in (("b", "batched"), ("e", "engine")):
                r = _post(agent, "/load_model", dict(
                    body, model_name=name, serving=mode, kv_host_mb=0))
                assert r.status_code == 200, r.text
                r = _post(agent, "/inference_batch",
                          {"model_name": name, "requests": subs},
                          stream=True)
                assert r.status_code == 200
                lines = [json.loads(x) for x in r.iter_lines() if x]
                assert all(x["status"] == 200 for x in lines), lines
                texts[side, name] = {x["request_tag"]: x["body"]["result"]
                                     for x in lines}
        assert texts["port", "b"] == texts["jax", "b"]
        assert texts["port", "e"] == texts["jax", "e"]
        health = requests.get(f"http://127.0.0.1:{port.service.port}/health",
                              timeout=30).json()
        by = {m["name"]: m for m in health["loaded_models"]}
        assert by["b"]["scheduler"]["mesh"]["pp"] == 2
        assert by["b"]["scheduler"]["backend"] == "gloo"
        assert by["e"]["mesh"]["pp"] == 2 and by["e"]["backend"] == "gloo"
        for path, extra, item in (
                ("/inference", {"kv_export": True}, "9.13"),
                ("/inference", {"resume": {"tokens": [5]}}, "9.14"),
                ("/kv_fetch", {"digests": ["x"]}, "9.13"),
                ("/migrate_out", {"request_tag": "t0"}, "9.14")):
            r = _post(port, path, {"model_name": "b", "prompt": "hello",
                                   "max_new_tokens": 2, **extra})
            assert r.status_code == 400, (path, extra, r.text)
            assert f"item {item}" in r.json()["message"], r.text
        r = _post(port, "/load_adapter", {"model_name": "b", "adapter": "a",
                                          "source": "synth:rank=2,seed=1"})
        assert r.status_code == 400 and "pp > 1" in r.text
        r = _post(port, "/load_model", dict(body, model_name="b2",
                                            serving="batched", kv_host_mb=8))
        assert r.status_code == 400 and "9.12" in r.json()["message"]
        pids = (port.models["b"].batcher._leader.alive()
                + port.models["e"].engine._leader.alive())
        assert len(pids) == 2
        for name in ("b", "e"):
            assert _post(port, "/unload_model",
                         {"model_name": name}).status_code == 200
        for pid in pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
    finally:
        port.shutdown()
        jax_agent.service.shutdown()


def test_a_killed_stage_fails_the_next_request_and_breaks_the_group():
    _, _, tree, model = family_pair("qwen2-7b")
    b = _batcher(model.cfg, tree, MeshSpec(pp=2))
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
        later = b.submit([1, 2], max_new_tokens=2, sampling=GREEDY)
        with pytest.raises(RuntimeError, match="scheduler error"):
            later.wait(timeout=5)
    finally:
        b.stop()
