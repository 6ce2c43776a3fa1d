"""Sequence parallelism in the port's engine, held against the JAX
package's ring attention and sp engine on the CPU's virtual mesh (f32).

- ``ring_attend_prefill`` / ``ring_attend_decode`` at sp=2 and sp=4
  (ranks on threads of this process, each its own gloo rank of an sp
  ring) give the JAX ring's output within 1e-5: ragged lengths, a
  window across chunk edges, ALiBi slopes and the score softcap.
- The sp engine: greedy tokens at sp=2, sp=4, sp=2 × tp=2 and pp=2 ×
  sp=2 equal the JAX sp engines'; the prefill's logits (every valid
  position) and each decode step's within 1e-4 of the port's sp=1 on
  the same weights; per rank sp − 1 ring hops per layer per prefill and
  one combine per layer per decode step, and ``max_seq`` rounded down
  and the cache cut into sp slices of positions.
- Rows under sp against sp=1: a window across a chunk edge (qwen2),
  bloom's ALiBi, gemma-2's caps, an int8 KV cache.
- The worker: ``"mesh": {"sp": 2}`` in engine mode answers with a JAX
  worker's texts; batched sp is a 400; the unload leaves no follower.
- The refusals: sp with sinks, sp with tp above the kv heads,
  speculation under sp.
"""

import os
import tempfile
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import requests
import torch

from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.parallel import ring as jring
from distributed_llm_inferencing_tpu.parallel.mesh import (
    MeshSpec as JaxMeshSpec, create_mesh)
from distributed_llm_inferencing_tpu.runtime.engine import (
    InferenceEngine as JaxEngine)
from distributed_llm_inferencing_tpu.runtime.worker import (
    WorkerAgent as JaxWorkerAgent)
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.models.registry import get_config
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.parallel import ring
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    MeshSpec, TPGroup, validate_spec)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from distributed_llm_inferencing_tpu_torch.runtime.worker import WorkerAgent
from test_torch_families import family_pair, one_torch_thread  # noqa: F401
from test_torch_pp import MAX_SEQ, PROMPTS, llama
from test_torch_tp_families import _idle_groups, kept_groups  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
GREEDY = SamplingParams.greedy()
LONG = [list(np.random.default_rng(3).integers(1, 256, 37)), PROMPTS[1]]
_REF = {}


# ---- the ring bodies --------------------------------------------------------

def _on_threads(n, fn):
    """``fn(group)`` on n threads, each rank of an sp=n group over gloo on
    the CPU; the results in rank order."""
    out, errors = [None] * n, []
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")

        def run(r):
            try:
                g = TPGroup(r, n, torch.device("cpu"), store)
                g.configure(MeshSpec(sp=n))
                out[r] = fn(g)
                g.close()
            except Exception as e:   # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(r,))
                   for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    assert not errors, errors
    return out


@pytest.mark.parametrize("sp,window,alibi,softcap", [
    (2, 5, True, None),
    (4, 7, False, None),          # the window crosses chunk edges
    (4, None, False, 0.5)])
def test_ring_bodies_match_the_jax_ring(sp, window, alibi, softcap):
    B, S, H, Hkv, hd = 2, 32, 4, 2, 8
    rng = np.random.default_rng(sp * 10 + (window or 0))
    q, k, v = (rng.normal(0, 1, (B, S, h, hd)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    qd = rng.normal(0, 1, (B, 1, H, hd)).astype(np.float32)
    lengths = np.asarray([S, 21], np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    slopes = (np.asarray([0.5, 0.25, 0.125, 0.0625], np.float32)
              if alibi else None)
    kw = dict(sliding_window=window, softcap=softcap)
    mesh = create_mesh(JaxMeshSpec(sp=sp))
    with mesh:
        jal = None if slopes is None else jnp.asarray(slopes)
        want = np.asarray(jring.ring_attend_prefill(
            *map(jnp.asarray, (q, k, v, pos, lengths)), mesh=mesh,
            alibi=jal, **kw))
        want_d = np.asarray(jring.ring_attend_decode(
            *map(jnp.asarray, (qd, k, v, lengths)), mesh=mesh, alibi=jal,
            **kw))
    c = S // sp
    tal = None if slopes is None else torch.from_numpy(slopes)

    def rank(g):
        r = g.coords[1]
        sh = ring.SeqShard(g.sp_ring, g.sp, r, sp, c)
        part = slice(r * c, (r + 1) * c)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a[:, part]))
        tpos = t(pos).long()
        pre = ring.ring_attend_prefill(
            t(q), t(k), t(v), tpos, tpos < torch.from_numpy(lengths)[:, None],
            sh, alibi=tal, **kw)
        dec = ring.ring_attend_decode(
            torch.from_numpy(qd), t(k), t(v), torch.from_numpy(lengths), sh,
            alibi=tal, **kw)
        return pre.numpy(), dec.numpy(), dict(g.counts)

    outs = _on_threads(sp, rank)
    got = np.concatenate([o[0] for o in outs], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for _, dec, counts in outs:
        np.testing.assert_allclose(dec, want_d, rtol=1e-5, atol=1e-5)
        assert counts["ring"] == sp - 1 and counts["combine"] == 1


# ---- the engine -------------------------------------------------------------

def _jax_tokens(spec):
    if spec not in _REF:
        jcfg, jparams, _, _ = llama()
        _REF[spec] = JaxEngine(jcfg, jparams, mesh_spec=spec,
                               max_seq=MAX_SEQ).generate(
            LONG, 6, sampling=JaxSamplingParams.greedy()).tokens
    return _REF[spec]


def _sp1():
    if "sp1" not in _REF:
        _, _, tree, cfg = llama()
        one = InferenceEngine(cfg, params_from_jax(tree, cfg, "cpu"),
                              max_seq=MAX_SEQ, device="cpu")
        _REF["sp1"] = one.teacher_forced(LONG, [[7, 9], [250, 3]])
    return _REF["sp1"]


@pytest.mark.parametrize("pp,sp,tp,ref", [
    (1, 2, 1, JaxMeshSpec(sp=2)), (1, 4, 1, JaxMeshSpec(sp=2)),
    (1, 2, 2, JaxMeshSpec(sp=2, tp=2)), (2, 2, 1, JaxMeshSpec(pp=2, sp=2))])
def test_sp_engine_matches_the_jax_sp_engine(pp, sp, tp, ref, kept_groups):
    want = _jax_tokens(ref)
    want_pre, want_dec = _sp1()
    _, _, tree, cfg = llama()
    eng = InferenceEngine(cfg, params_from_jax(tree, cfg, "cpu"),
                          mesh_spec=MeshSpec(pp=pp, sp=sp, tp=tp),
                          max_seq=MAX_SEQ - 2, device="cpu")
    try:
        assert eng.max_seq == MAX_SEQ - 2 - (MAX_SEQ - 2) % sp
        eng.reset_counts()
        pre, dec = eng.teacher_forced(LONG, [[7, 9], [250, 3]])
        for i, p in enumerate(LONG):
            np.testing.assert_allclose(pre[i, :len(p)].numpy(),
                                       want_pre[i, :len(p)].numpy(), **TOL)
        np.testing.assert_allclose(dec.numpy(), want_dec.numpy(), **TOL)
        layers = cfg.num_layers // pp
        micro = 2 if pp > 1 else 1   # the batch of two, microbatched
        for s in eng.rank_stats():
            c = s["collectives"]
            assert c["ring"] == (sp - 1) * layers * micro, s
            head = micro if s["grid"]["pp"] == pp - 1 else 0
            assert c["combine"] == 2 * layers * micro + head, s
        assert eng.generate(LONG, 6, sampling=GREEDY).tokens == want
        assert tuple(eng._state(2).cache.k.shape[1:3]) == \
            (2, eng.max_seq // sp)
    finally:
        eng.close()


_ROWS = {
    "window": ("qwen2-7b", {"sliding_window": 5}),
    "alibi": ("bloom-7b1", {}),
    "softcap": ("gemma-2b", {"attn_softcap": 0.05, "logit_softcap": 0.1,
                             "attn_windows": (6, None)}),
    "int8_kv": ("qwen2-7b", {"kv_quant": "int8"}),
}


@pytest.mark.parametrize("row", list(_ROWS))
def test_rows_under_sp2_equal_sp1(row, kept_groups):
    name, over = _ROWS[row]
    _, _, tree, model = family_pair(name, **over)
    cfg = model.cfg
    forced = [[7, 9], [250, 3]]
    out = []
    for spec in (MeshSpec(), MeshSpec(sp=2)):
        eng = InferenceEngine(cfg, params_from_jax(tree, cfg, "cpu"),
                              mesh_spec=spec, max_seq=MAX_SEQ, device="cpu")
        try:
            out.append((eng.teacher_forced(LONG, forced),
                        eng.generate(LONG, 5, sampling=GREEDY).tokens))
        finally:
            eng.close()
    ((pre1, dec1), t1), ((pre2, dec2), t2) = out
    for i, p in enumerate(LONG):
        np.testing.assert_allclose(pre2[i, :len(p)].numpy(),
                                   pre1[i, :len(p)].numpy(), **TOL)
    np.testing.assert_allclose(dec2.numpy(), dec1.numpy(), **TOL)
    assert t2 == t1


# ---- the worker and the refusals --------------------------------------------

def _post(agent, path, body):
    return requests.post(f"http://127.0.0.1:{agent.service.port}{path}",
                         json=body, timeout=180)


def test_worker_sp2_engine_serves_like_the_jax_worker():
    from test_torch_convert import with_tokenizer
    body = {"model_name": "m", "checkpoint_path": with_tokenizer("llama"),
            "dtype": "float32", "mesh": {"sp": 2}, "max_seq": 64}
    req = {"model_name": "m", "prompt": "the quick brown fox",
           "max_new_tokens": 6, "seed": 1, "sampling": {"do_sample": False}}
    port, jax_agent = WorkerAgent(device="cpu"), JaxWorkerAgent()
    texts = {}
    try:
        for side, agent in (("port", port), ("jax", jax_agent)):
            agent.serve("127.0.0.1", 0, background=True)
            r = _post(agent, "/load_model", body)
            assert r.status_code == 200, r.text
            r = _post(agent, "/inference", req)
            assert r.status_code == 200, r.text
            texts[side] = r.json()["result"]
        assert texts["port"] == texts["jax"]
        r = _post(port, "/load_model", dict(body, model_name="b",
                                            serving="batched"))
        assert r.status_code == 400 and "dp/sp" in r.text
        m = port.models["m"].engine
        assert m.stats()["mesh"]["sp"] == 2
        pids = m._leader.alive()
        assert len(pids) == 1
        assert _post(port, "/unload_model",
                     {"model_name": "m"}).status_code == 200
        for pid in pids:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
    finally:
        port.shutdown()
        jax_agent.service.shutdown()


def test_the_refusals_under_sp(kept_groups):
    cfg = get_config("tiny-llama")
    with pytest.raises(NotImplementedError, match="sinks"):
        validate_spec(MeshSpec(sp=2), cfg.replace(attn_sinks=True))
    with pytest.raises(ValueError, match="num_kv_heads"):
        validate_spec(MeshSpec(sp=2, tp=8), cfg)
    _, _, tree, tcfg = llama()
    eng = InferenceEngine(tcfg, params_from_jax(tree, tcfg, "cpu"),
                          mesh_spec=MeshSpec(sp=2), max_seq=MAX_SEQ,
                          device="cpu")
    try:
        with pytest.raises(ValueError, match="not sp or pp"):
            eng.generate([PROMPTS[0]], 4, speculative="ngram")
        with pytest.raises(ValueError, match="9.11"):
            eng.load_adapter(name="a", source="synth:rank=2,seed=1")
    finally:
        eng.close()
