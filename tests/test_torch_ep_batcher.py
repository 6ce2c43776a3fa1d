"""Batched serving and the worker under tp × ep, held against the JAX
package's batcher and worker on the CPU's virtual mesh (f32).

- The port's tp=2 × ep=2 batcher (the leader's scheduler, three gloo
  followers replaying its device programs) gives the JAX tp=2 × ep=2
  batcher's greedy tokens for tiny-mixtral and tiny-deepseek (latent
  attention on the materialized pool, shared experts, a dense prefix),
  with float and int4 weights, over prompts that share a two-block
  prefix and admit in chunks; every rank ran the same programs with the
  same outputs, routed the same router inputs bit for bit (the
  ``route_digest``) and counted one ``expert_all_reduce`` per MoE layer
  per weight pass. The int4 rows take dense dispatch on both sides: the JAX
  capacity arm raises on quantized experts (ROADMAP Queue C).
- The speculative chunk and wave mode at tp=2 × ep=2 give plain greedy
  tokens, drafts accepted (the sublayers scaled by 1e-3).
- pp=2 × ep=2: the pipelined batcher over the expert groups of each
  stage gives the port's pp=1 batcher's tokens on the same weights.
- The worker: ``"mesh": {"tp": 2, "ep": 2}`` on a mixtral checkpoint in
  engine and in batched mode answers with a JAX worker's text; /health
  shows the mesh with ep and every rank's ``param_bytes`` (the ep ranks'
  expert halves); the unload leaves no follower alive.
"""

import os

import pytest
import requests

from distributed_llm_inferencing_tpu.parallel.mesh import (
    MeshSpec as JaxMeshSpec)
from distributed_llm_inferencing_tpu.runtime.batcher import (
    ContinuousBatcher as JaxBatcher)
from distributed_llm_inferencing_tpu.runtime.worker import (
    WorkerAgent as JaxWorkerAgent)
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.parallel.mesh import MeshSpec
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.worker import WorkerAgent
from test_torch_ep import model
from test_torch_families import one_torch_thread  # noqa: F401
from test_torch_tp_batcher import POOL, drive, workload
from test_torch_tp_families import _idle_groups, kept_groups  # noqa: F401

# the workload's three short prompts (the 40-token one would add three
# chunk shapes to compile on the JAX side)
PROMPTS = [0, 1, 3]
_REF = {}


def _case(key, quant):
    """(port config, numpy tree) of a row in weight form ``quant`` and the
    JAX tp=2 × ep=2 batcher's greedy tokens, once per module."""
    jcfg, jp, tree, cfg = model(key, quant)
    if quant is not None:   # the JAX capacity arm raises on int4 experts
        jcfg, cfg = (c.replace(moe_dispatch="dense") for c in (jcfg, cfg))
    if (key, quant) not in _REF:
        _REF[key, quant] = drive(
            JaxBatcher(jcfg, jp, mesh_spec=JaxMeshSpec(tp=2, ep=2), **POOL),
            prompts=[workload()[i] for i in PROMPTS])
    return cfg, tree, _REF[key, quant]


def _batcher(cfg, tree, spec):
    return ContinuousBatcher(cfg, params_from_jax(tree, cfg, "cpu"),
                             device="cpu", mesh_spec=spec, **POOL)


@pytest.mark.parametrize("key,quant", [("mixtral", None), ("mixtral", "int4"),
                                       ("deepseek", None),
                                       ("deepseek", "int4")])
def test_tp2_ep2_batcher_matches_the_jax_batcher(key, quant, kept_groups):
    cfg, tree, want = _case(key, quant)
    b = _batcher(cfg, tree, MeshSpec(tp=2, ep=2))
    try:
        b.reset_counts()
        assert drive(b, prompts=[workload()[i] for i in PROMPTS]) == want
        stats = b.rank_stats()
        lead = stats[0]
        assert len(stats) == 4 and lead["programs_run"] > 0
        for s in stats:
            assert s["programs_run"] == lead["programs_run"]
            assert s["outputs_digest"] == lead["outputs_digest"]
            assert s["route_digest"] == lead["route_digest"]
            assert s["collectives"] == lead["collectives"]
        moe_layers = cfg.num_layers - cfg.dense_prefix_layers
        c = lead["collectives"]
        # per weight pass: under tp an embedding, o and down/shared_down
        # sums, one gather; one expert sum per MoE layer
        passes = c["gather"]
        assert c["expert_all_reduce"] == moe_layers * passes
        per_layer = 2 if cfg.moe_shared_experts else 1
        assert c["all_reduce"] == passes * (
            1 + per_layer * moe_layers + 2 * cfg.dense_prefix_layers)
        assert b.model.layers[-1].kv_heads == (
            cfg.num_heads if cfg.mla else cfg.num_kv_heads) // 2
        assert b.stats()["mesh"]["ep"] == 2
    finally:
        b.stop()


def test_pp2_ep2_batcher_gives_the_pp1_tokens(kept_groups):
    cfg, tree, _ = _case("mixtral", None)
    prompts = [workload()[i] for i in PROMPTS]
    out = []
    for spec in (MeshSpec(), MeshSpec(pp=2, ep=2)):
        b = _batcher(cfg, tree, spec)
        try:
            out.append(drive(b, prompts=prompts))
            if spec.ep > 1:
                stats = b.rank_stats()
                assert [tuple(s["grid"].values()) for s in stats] == \
                    [(0, 0, 0, 0), (0, 0, 0, 1), (1, 0, 0, 0), (1, 0, 0, 1)]
                assert all(s["collectives"]["expert_all_reduce"] > 0
                           for s in stats)
        finally:
            b.stop()
    assert out[0] == out[1]


def test_tp2_ep2_speculation_gives_plain_greedy(kept_groups):
    """The speculative chunk (wave off) and wave mode (on), adaptive off,
    at tp=2 × ep=2 give the plain tp=2 × ep=2 batcher's greedy tokens,
    with drafts accepted, and every rank ends with the leader's outputs.
    The prompt is p + c + p, c the plain run's continuation of p, with
    the sublayers scaled by 1e-3 (``residual_scale``): the next token is
    then mostly the current one's, as a trained model's continuation of
    repeated text repeats, and the drafts from c accept (tiny-mixtral's
    random weights accept none otherwise)."""
    cfg, tree, _ = _case("mixtral", None)
    cfg = cfg.replace(residual_scale=1e-3)
    p = workload()[0]
    out = {}
    for mode in ("plain", "chunk", "wave"):
        extra = ({} if mode == "plain" else dict(
            speculative="ngram", spec_gamma=3, spec_adaptive=False,
            spec_wave=mode == "wave"))
        b = ContinuousBatcher(cfg, params_from_jax(tree, cfg, "cpu"),
                              device="cpu", mesh_spec=MeshSpec(tp=2, ep=2),
                              **extra, **POOL)
        try:
            if mode == "plain":
                [c] = drive(b, chunks=(8, 4), prompts=[p])
            out[mode] = drive(b, chunks=(8, 4), prompts=[p + c + p])
            if mode != "plain":
                assert b.stats()["spec_accepted_tokens"] > 0, mode
            assert len({s["outputs_digest"] for s in b.rank_stats()}) == 1
        finally:
            b.stop()
    assert out["chunk"] == out["plain"] and out["wave"] == out["plain"]


def _post(agent, path, body):
    return requests.post(f"http://127.0.0.1:{agent.service.port}{path}",
                         json=body, timeout=180)


def test_worker_tp2_ep2_serves_like_the_jax_worker():
    """The JAX worker's engine-mode text; the port's batched load greedy
    gives its engine's."""
    from test_torch_convert import with_tokenizer
    body = {"model_name": "m", "checkpoint_path": with_tokenizer("mixtral"),
            "dtype": "float32", "mesh": {"tp": 2, "ep": 2}, "max_seq": 64}
    req = {"model_name": "m", "prompt": "the quick brown fox",
           "max_new_tokens": 6, "seed": 1, "sampling": {"do_sample": False}}
    port, jax_agent = WorkerAgent(device="cpu"), JaxWorkerAgent()
    texts = {}
    try:
        jax_agent.serve("127.0.0.1", 0, background=True)
        assert _post(jax_agent, "/load_model", body).status_code == 200
        texts["jax"] = _post(jax_agent, "/inference", req).json()["result"]
        port.serve("127.0.0.1", 0, background=True)
        for mode in ("engine", "batched"):
            extra = ({"serving": "batched", "kv_blocks": 32,
                      "kv_block_size": 8, "slots": 2}
                     if mode == "batched" else {})
            r = _post(port, "/load_model", dict(body, **extra))
            assert r.status_code == 200, r.text
            r = _post(port, "/inference", req)
            assert r.status_code == 200, r.text
            texts[mode] = r.json()["result"]
            health = requests.get(
                f"http://127.0.0.1:{port.service.port}/health",
                timeout=60).json()
            [desc] = health["loaded_models"]
            info = desc if mode == "engine" else desc["scheduler"]
            assert info["mesh"]["ep"] == 2
            per_rank = info["rank_param_bytes"]
            assert len(per_rank) == 4 and per_rank[0] == desc["param_bytes"]
            pids = (port.models["m"].engine or
                    port.models["m"].batcher)._leader.alive()
            assert len(pids) == 3
            assert _post(port, "/unload_model",
                         {"model_name": "m"}).status_code == 200
            for pid in pids:
                with pytest.raises(ProcessLookupError):
                    os.kill(pid, 0)
        assert texts["engine"] == texts["batched"] == texts["jax"]
    finally:
        port.shutdown()
        jax_agent.service.shutdown()
