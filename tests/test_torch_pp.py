"""Pipeline parallelism in the port's engine, held against the JAX
package's pipelined engine on the CPU's virtual mesh (f32).

- ``pick_n_micro`` equals the JAX rule over a grid of batches, stage
  counts and requested microbatches.
- The pipelined forward: the port's engine at pp=2 (two microbatches),
  pp=4 (one and four) and pp=2 × tp=2 gives the logits of the JAX
  ``pipelined_prefill`` / ``pipelined_decode_step`` on the same weights
  (every valid prefill position and each forced decode step, 1e-4), and
  every stage counts its hops by the rule: per forward, stage 0 sends one
  hop per microbatch and receives the logits once, the last stage the
  reverse.
- Generation at pp=2: greedy tokens equal the JAX pp=2 engine's; sampled
  tokens (the port's own hash-keyed streams) and an eos stop equal the
  port's pp=1 engine's on the same weights.
- Family rows under pp=2 against the JAX engine: gemma-2's switches
  (per-layer windows, score and logit caps, sandwich norms) over a tied
  head, tiny-mixtral's experts, and latent attention, which serves
  materialized under pp as in the JAX engine.
- The seeded draw: each stage's leaves (and under pp × tp each rank's
  cut of them) are pp=1's bits; a native checkpoint's stage reads only
  its own tensors.
- The refusals: pp over a mixed dense/MoE stack, LoRA and speculation
  under pp.
- A killed stage fails the next request and breaks the group.

The port's groups are kept per world size (``kept_groups``), so the
module spawns one pair and one group of four; the JAX references are
shared per module.
"""

import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.models.params import (
    init_params as jax_init_params)
from distributed_llm_inferencing_tpu.models.registry import (
    get_config as jax_config)
from distributed_llm_inferencing_tpu.ops.kvcache import (
    init_cache as jax_init_cache)
from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.parallel import pipeline as jpipe
from distributed_llm_inferencing_tpu.parallel import sharding as jsh
from distributed_llm_inferencing_tpu.parallel.mesh import (
    MeshSpec as JaxMeshSpec, create_mesh)
from distributed_llm_inferencing_tpu.runtime.engine import (
    InferenceEngine as JaxEngine)
from distributed_llm_inferencing_tpu_torch.models import checkpoint
from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.models.registry import get_config
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.parallel import pipeline
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    MeshSpec, validate_spec)
from distributed_llm_inferencing_tpu_torch.parallel.sharding import (
    shard_tensor)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine, latent_cache, rank_params)
from test_torch_families import (  # noqa: F401
    _perturb, family_pair, one_torch_thread)
from test_torch_tp_families import _idle_groups, kept_groups  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
PROMPTS = [[3, 17, 52, 9, 1, 30, 44], list(range(5, 17)), [9, 8, 7],
           list(range(40, 50))]
FORCED = [[7, 11, 250, 31], [0, 64, 5, 2]]   # [steps][B]
MAX_SEQ = 64
GREEDY = SamplingParams.greedy()
_REF = {}


def llama():
    """(JAX config, JAX params, numpy tree, port config) of tiny-llama in
    f32 (four layers, H=8, Hkv=4), its biases and norms moved."""
    if "llama" not in _REF:
        jcfg = jax_config("tiny-llama").replace(dtype="float32",
                                                attn_backend="xla")
        tree = _perturb(jax.tree.map(np.asarray, jax_init_params(
            jcfg, jax.random.PRNGKey(0))), 0)
        import dataclasses
        tcfg = ModelConfig(**dataclasses.asdict(jcfg))
        _REF["llama"] = (jcfg, jax.tree.map(jnp.asarray, tree), tree, tcfg)
    return _REF["llama"]


def _padded(prompts):
    """The port engine's right-padded block (bucket 16) and lengths."""
    s0 = 16
    toks = np.zeros((len(prompts), s0), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return toks, np.asarray([len(p) for p in prompts], np.int32)


def jax_pipelined(spec, n_micro):
    """The JAX pipelined prefill's logits [B, 16, V] and each forced
    decode step's [steps, B, V] (FORCED rows fed per step)."""
    key = ("pipelined", spec, n_micro)
    if key not in _REF:
        jcfg, jparams, _, _ = llama()
        toks, lens = _padded(PROMPTS)
        mesh = create_mesh(spec)
        with mesh:
            pp_params = jsh.shard_params(jparams, mesh, jcfg, spec)
            cache = jax.device_put(
                jax_init_cache(jcfg, len(PROMPTS), MAX_SEQ,
                               dtype=jnp.float32),
                jsh.named(mesh, jsh.cache_specs(jcfg, spec)))
            pre, cache = jax.jit(
                lambda p, t, ln, c: jpipe.pipelined_prefill(
                    p, jcfg, t, ln, c, mesh=mesh, n_micro=n_micro))(
                pp_params, jnp.asarray(toks), jnp.asarray(lens), cache)
            dec = jax.jit(lambda p, t, c: jpipe.pipelined_decode_step(
                p, jcfg, t, c, mesh=mesh, n_micro=n_micro))
            steps = []
            for row in np.asarray(FORCED):
                lg, cache = dec(pp_params, jnp.asarray(row[:, None],
                                                       jnp.int32), cache)
                steps.append(np.asarray(lg[:, 0]))
        _REF[key] = (np.asarray(pre), np.stack(steps))
    return _REF[key]


def _engine(spec, n_micro=None, cfg=None, tree=None, **kw):
    jcfg, _, jtree, tcfg = llama()
    cfg, tree = cfg or tcfg, tree if tree is not None else jtree
    return InferenceEngine(cfg, params_from_jax(tree, cfg, "cpu"),
                           mesh_spec=spec, max_seq=MAX_SEQ, device="cpu",
                           pipeline_microbatches=n_micro, **kw)


# ---- the schedule -----------------------------------------------------------

def test_pick_n_micro_is_the_jax_rule():
    for batch in range(1, 13):
        for pp in (1, 2, 3, 4):
            for req in (None, 0, 1, 2, 3, 5, 8):
                assert pipeline.pick_n_micro(batch, pp, req) == \
                    jpipe.pick_n_micro(batch, pp, req), (batch, pp, req)


@pytest.mark.parametrize("pp,tp,n_micro", [(2, 1, 2), (4, 1, 1), (4, 1, 4),
                                           (2, 2, 2)])
def test_pipelined_forward_matches_the_jax_pipeline(pp, tp, n_micro,
                                                    kept_groups):
    want_pre, want_dec = jax_pipelined(JaxMeshSpec(pp=pp, tp=tp), n_micro)
    eng = _engine(MeshSpec(pp=pp, tp=tp), n_micro)
    try:
        eng.reset_counts()
        pre, dec = eng.teacher_forced(PROMPTS, FORCED)
        for i, p in enumerate(PROMPTS):
            np.testing.assert_allclose(pre[i, :len(p)].numpy(),
                                       want_pre[i, :len(p)], **TOL)
        np.testing.assert_allclose(dec.numpy(), want_dec, **TOL)
        forwards = 1 + len(FORCED)
        stats = eng.rank_stats()
        assert len(stats) == pp * tp
        for s in stats:
            p = s["grid"]["pp"]
            c = s["collectives"]
            sends = (n_micro if p < pp - 1 else 1) * forwards
            recvs = (1 if p == 0 else n_micro) * forwards
            assert (c["send"], c["recv"]) == (sends, recvs), s
            assert s["layers"] == [p * 4 // pp, (p + 1) * 4 // pp]
        assert len(eng.model.layers) == 4 // pp
    finally:
        eng.close()


# ---- generation -------------------------------------------------------------

def test_pp2_engine_tokens_match_the_jax_pp2_engine(kept_groups):
    jcfg, jparams, tree, tcfg = llama()
    want = JaxEngine(jcfg, jparams, mesh_spec=JaxMeshSpec(pp=2),
                     max_seq=MAX_SEQ).generate(
        PROMPTS, 8, sampling=JaxSamplingParams.greedy()).tokens
    one = _engine(MeshSpec())
    sampled = SamplingParams(temperature=0.8, top_k=30, top_p=0.9)
    eos = want[1][3]
    ref_s = one.generate(PROMPTS, 8, sampling=sampled, seed=7).tokens
    ref_e = one.generate(PROMPTS, 8, sampling=GREEDY, eos_token_id=eos)
    eng = _engine(MeshSpec(pp=2))
    try:
        eng.reset_counts()
        res = eng.generate(PROMPTS, 8, sampling=GREEDY)
        assert res.tokens == want
        for s in eng.rank_stats():   # the leader's tokens, per pass
            assert s["collectives"]["broadcast"] == res.steps
        assert eng.generate(PROMPTS, 8, sampling=sampled,
                            seed=7).tokens == ref_s
        got_e = eng.generate(PROMPTS, 8, sampling=GREEDY, eos_token_id=eos)
        assert got_e.tokens == ref_e.tokens
        assert len(got_e.tokens[1]) < 8           # the eos stop
        st = eng.stats()
        assert st["mesh"]["pp"] == 2 and st["backend"] == "gloo"
        assert st["decode_graphs_captured"] == 0
    finally:
        eng.close()


_ROWS = {
    # gemma-2: per-layer windows (the global index on each stage), the
    # score and logit caps and the sandwich norms, over a tied head
    "gemma2": ("gemma-2b", {"attn_windows": (6, None), "attn_softcap": 0.05,
                            "logit_softcap": 0.1, "post_block_norms": True}),
    "mixtral": ("tiny-mixtral", {}),
}


@pytest.mark.parametrize("row", list(_ROWS))
def test_family_rows_under_pp2_match_the_jax_engine(row, kept_groups):
    name, over = _ROWS[row]
    if name == "tiny-mixtral":
        jcfg = jax_config(name).replace(dtype="float32", attn_backend="xla")
        tree = _perturb(jax.tree.map(np.asarray, jax_init_params(
            jcfg, jax.random.PRNGKey(2))), 2)
        jparams = jax.tree.map(jnp.asarray, tree)
        import dataclasses
        tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    else:
        jcfg, jparams, tree, model = family_pair(name, **over)
        tcfg = model.cfg
    prompts = [PROMPTS[1], [4, 4, 8, 15, 16, 23, 42, 4, 8, 15]]
    want = JaxEngine(jcfg, jparams, max_seq=MAX_SEQ).generate(
        prompts, 6, sampling=JaxSamplingParams.greedy()).tokens
    eng = _engine(MeshSpec(pp=2), cfg=tcfg, tree=tree)
    try:
        assert eng.generate(prompts, 6, sampling=GREEDY).tokens == want
        if tcfg.tie_word_embeddings:   # the last stage's copy of the table
            assert eng.model.embed is not None and eng.model.lm_head is None
        assert [b.window for b in eng.model.layers] == \
            [(tcfg.attn_windows or (None,) * 2)[0]]
    finally:
        eng.close()


def test_latent_attention_serves_materialized_under_pp(kept_groups):
    cfg = get_config("tiny-deepseek").replace(dtype="float32",
                                              dense_prefix_layers=0,
                                              num_layers=2)
    assert latent_cache(cfg) and not latent_cache(cfg, MeshSpec(pp=2))
    assert not latent_cache(cfg, MeshSpec(sp=2))
    os.environ["DLI_MLA_LATENT"] = "0"
    try:
        one = InferenceEngine(cfg, max_seq=MAX_SEQ, device="cpu", seed=4)
    finally:
        del os.environ["DLI_MLA_LATENT"]
    want_pre, _ = one.teacher_forced(PROMPTS[:2], [])
    want = one.generate(PROMPTS[:2], 5, sampling=GREEDY).tokens
    eng = InferenceEngine(cfg, mesh_spec=MeshSpec(pp=2), max_seq=MAX_SEQ,
                          device="cpu", seed=4)
    try:
        assert not eng.cfg.mla_latent_cache
        pre, _ = eng.teacher_forced(PROMPTS[:2], [])
        for i, p in enumerate(PROMPTS[:2]):
            np.testing.assert_allclose(pre[i, :len(p)].numpy(),
                                       want_pre[i, :len(p)].numpy(), **TOL)
        assert eng.generate(PROMPTS[:2], 5, sampling=GREEDY).tokens == want
    finally:
        eng.close()


# ---- the weights ------------------------------------------------------------

def test_each_stage_draws_pp1s_bits():
    cfg = get_config("tiny-gpt2").replace(dtype="float32")   # tied, learned
    full = rank_params(cfg, MeshSpec(), 0, torch.device("cpu"), seed=5)
    spec = MeshSpec(pp=2, tp=2)
    seen = set()
    for rank in range(4):
        mine = rank_params(cfg, spec, rank, torch.device("cpu"), seed=5)
        stage, t = divmod(rank, 2)
        lo, hi = 2 * stage, 2 * stage + 2
        for name, t_ in mine.items():
            if name.startswith("layers."):
                assert lo <= int(name.split(".")[1]) < hi, name
            want = shard_tensor(name, full[name], cfg, spec, t)
            torch.testing.assert_close(t_, want, rtol=0, atol=0)
        seen |= set(mine)
        names = set(mine)
        assert ("embed.positions" in names) == (stage == 0)
        assert ("final_norm.scale" in names) == (stage == 1)
        assert "embed.tokens" in names    # stage 0 embeds, stage 1's head
    assert seen == set(full)


def test_a_stage_reads_only_its_tensors(tmp_path, monkeypatch):
    cfg = get_config("tiny-llama").replace(dtype="float32")
    full = rank_params(cfg, MeshSpec(), 0, torch.device("cpu"), seed=2)
    checkpoint.save_checkpoint(str(tmp_path), cfg, full)
    src = checkpoint.CheckpointSource("native", str(tmp_path))
    read = []
    real_get = checkpoint.SafetensorsFile.get

    def spy(self, name):
        read.append(name)
        return real_get(self, name)

    monkeypatch.setattr(checkpoint.SafetensorsFile, "get", spy)
    mine = rank_params(cfg, MeshSpec(pp=2), 1, torch.device("cpu"),
                       loader=src.load)
    assert set(read) == set(mine)
    assert all(not n.startswith(("layers.0.", "layers.1.", "embed."))
               for n in mine)
    for n, t in mine.items():
        torch.testing.assert_close(t, full[n], rtol=0, atol=0)


# ---- refusals and failure ---------------------------------------------------

def test_the_refusals_under_pp(kept_groups):
    with pytest.raises(NotImplementedError, match="pp=2"):
        validate_spec(MeshSpec(pp=2), get_config("tiny-deepseek"))
    eng = _engine(MeshSpec(pp=2))
    try:
        with pytest.raises(ValueError, match="pp > 1"):
            eng.load_adapter(name="a", source="synth:rank=2,seed=1")
        with pytest.raises(ValueError, match="not sp or pp"):
            eng.generate([PROMPTS[0]], 4, speculative="ngram")
    finally:
        eng.close()


def test_a_killed_stage_fails_the_next_request():
    eng = _engine(MeshSpec(pp=2))
    try:
        assert len(eng.generate([PROMPTS[0]], 3,
                                sampling=GREEDY).tokens[0]) == 3
        [pid] = eng._leader.alive()
        os.kill(pid, signal.SIGKILL)
        deadline = time.monotonic() + 30
        while eng._leader.alive() and time.monotonic() < deadline:
            time.sleep(0.05)
        with pytest.raises(RuntimeError):
            eng.generate([PROMPTS[0]], 3, sampling=GREEDY)
        assert eng._leader.broken
        with pytest.raises(RuntimeError, match="broken"):
            eng.generate([PROMPTS[0]], 3, sampling=GREEDY)
    finally:
        eng.close()
