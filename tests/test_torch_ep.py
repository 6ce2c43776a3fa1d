"""Expert parallelism, and tp for the experts, latent attention, dbrx's
clip and gpt-oss's sinks, in the port's engine, held against the JAX
package on the CPU's virtual mesh (f32).

- The grid: rank = ((p·sp + s)·tp + t)·ep + e, ep innermost as in the JAX
  ``create_mesh``; ep refused on a dense model and where it does not
  divide the experts, as the JAX ``validate_spec`` refuses it.
- parallel/sharding.py: every rank's cut of every tensor at tp=2 × ep=2
  equals that rank's shard of the JAX ``shard_params`` placement (its
  ``param_specs``), bit for bit, for tiny-mixtral (float and int4),
  tiny-deepseek (latent attention, shared experts, a dense prefix) and a
  gpt-oss variant (sinks, expert biases); an int4 expert down, which the
  port repacks chunk-locally where the JAX package keeps the global
  layout, unpacks to the global leaf's rows.
- The engine's logits (every valid prefill position and each forced
  decode step) for tiny-mixtral at ep=2, tp=2 × ep=2 and pp=2 × ep=2
  within 1e-4 of the JAX forward on the same mesh, with dense dispatch
  and with capacity dispatch that drops (factor 0.5); every rank's
  collectives exact by the count rule (models/transformer.py: the
  head's gather under tp only; under ep every rank computes the whole
  head).
- Greedy tokens of the engine equal the JAX engine's on the same mesh:
  tiny-mixtral, the GLM-4.5 tiny model (dense prefix, shared experts,
  q/k norms) and tiny-deepseek on the latent and on the materialized
  cache at tp=2 × ep=2; the gpt-oss variant and a dbrx variant (a
  ``qkv_clip`` that bites) at tp=2. The latent cache holds its one row
  whole on every rank, and every rank takes the leader's cache layout
  (a kept group's followers were spawned under another
  ``DLI_MLA_LATENT``).
- sp with experts: the JAX package routes the MLP over the whole block
  (only attention is sharded over sp), so "auto" dispatch and the
  capacity count every position. At sp=2 a 40-token prompt (a block of
  64, 32 per rank) under a capacity factor that drops gives the JAX sp
  engine's prefill logits and greedy tokens; each rank assembles the
  block once per MoE layer (``expert_gather``).

The port's groups are kept per world size (``kept_groups``): the module
spawns one pair and one group of four. The JAX references are shared per
module and run jitted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.models import transformer as jtf
from distributed_llm_inferencing_tpu.ops import quant as jq
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
from distributed_llm_inferencing_tpu_torch.models import registry as treg
from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.ops import quant as tq
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.parallel import sharding as tsh
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    MeshSpec, grid_coords, grid_rank, validate_spec)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from test_torch_families import (  # noqa: F401
    jit_decode_step, jit_prefill, one_torch_thread)
from test_torch_routers import cfgs, trees
from test_torch_sinks import GPT_OSS
from test_torch_tp_families import _idle_groups, kept_groups  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
PROMPTS = [[3, 17, 52, 9, 1, 30, 44], list(range(5, 45))]
FORCED = [[7, 11], [250, 0], [31, 64]]          # [steps][B]
MAX_SEQ = 64
GREEDY = SamplingParams.greedy()
_REF = {}

# the models under test: (base row, its switches); "glm45" is the JAX
# package's own tiny GLM-4.5 (tests/conftest.py tiny_glm45_moe_model)
MODELS = {
    "mixtral": ("tiny-mixtral", {}),
    "dense_drop": ("tiny-mixtral", {"moe_dispatch": "dense"}),
    "capacity_drop": ("tiny-mixtral", {"moe_dispatch": "capacity",
                                       "moe_capacity_factor": 0.5}),
    "deepseek": ("tiny-deepseek", {}),
    "gpt_oss": ("tiny-mixtral", GPT_OSS),
    "dbrx": ("tiny-mixtral", {"qkv_clip": 0.1}),
    "sp_drop": ("tiny-mixtral", {"moe_capacity_factor": 0.5}),
}


def model(key, quant=None):
    """(JAX config, JAX params, numpy tree, port config) of ``key``, its
    zero leaves perturbed (router and expert biases, sinks), once per
    module."""
    if (key, quant) not in _REF:
        if key == "glm45":
            from conftest import tiny_glm45_moe_model
            from distributed_llm_inferencing_tpu.models import convert
            jcfg, jp = convert.load_hf_model(tiny_glm45_moe_model(seed=64),
                                             dtype=jnp.float32)
            jcfg = jcfg.replace(dtype="float32", attn_backend="xla")
            tcfg = ModelConfig(**dataclasses.asdict(jcfg))
        else:
            base, over = MODELS[key]
            jcfg, tcfg = cfgs(base, **over)
            jp, _ = trees(jcfg, tcfg, quant)
            jcfg, tcfg = jcfg.replace(quant=quant), tcfg.replace(quant=quant)
        _REF[key, quant] = (jcfg, jp, jax.tree.map(np.asarray, jp), tcfg)
    return _REF[key, quant]


def _engine(key, spec, quant=None, **kw):
    _, _, tree, cfg = model(key, quant)
    return InferenceEngine(cfg, params_from_jax(tree, cfg, "cpu"),
                           mesh_spec=spec, max_seq=MAX_SEQ, device="cpu",
                           **kw)


# ---- the grid and the refusals ----------------------------------------------

def test_grid_puts_ep_innermost_and_refuses_as_jax():
    spec = MeshSpec(pp=2, sp=2, tp=2, ep=2)
    assert spec.world == 16
    jax_order = np.arange(16).reshape(1, 2, 2, 2, 2)   # dp pp sp tp ep
    for r in range(16):
        p, s, t, e = grid_coords(spec, r)
        assert jax_order[0, p, s, t, e] == r == grid_rank(spec, p, s, t, e)
    mixtral = treg.get_config("tiny-mixtral")          # 4 experts
    for ok in (MeshSpec(ep=4), MeshSpec(tp=2, ep=2), MeshSpec(pp=2, ep=2),
               MeshSpec(sp=2, ep=2)):
        validate_spec(ok, mixtral)
    with pytest.raises(ValueError, match="num_experts"):
        validate_spec(MeshSpec(ep=3), mixtral)
    with pytest.raises(ValueError, match="dense model"):
        validate_spec(MeshSpec(ep=2), treg.get_config("tiny-llama"))
    with pytest.raises(ValueError, match="vocab_size"):   # item 9.17
        validate_spec(MeshSpec(tp=2), mixtral.replace(vocab_size=255))


# ---- parallel/sharding.py against the JAX placement -------------------------

@pytest.mark.parametrize("key,quant", [("mixtral", None), ("mixtral", "int4"),
                                       ("deepseek", None), ("gpt_oss", None)])
def test_cut_matches_the_jax_placement(key, quant):
    jcfg, jp, tree, tcfg = model(key, quant)
    spec = JaxMeshSpec(tp=2, ep=2)
    mesh = create_mesh(spec)
    with mesh:
        placed = jsh.shard_params(jp, mesh, jcfg, spec)
    full = params_from_jax(tree, tcfg, "cpu")
    devices = list(mesh.devices.flat)
    flat = jax.tree_util.tree_flatten_with_path(placed)[0]
    dense = tcfg.dense_prefix_layers
    for rank in range(4):
        _, _, t, e = grid_coords(MeshSpec(tp=2, ep=2), rank)
        mine = tsh.shard_params(dict(full), tcfg, MeshSpec(tp=2, ep=2), rank)
        seen = set()
        for path, arr in flat:
            keys = [p.key for p in path]
            [shard] = [s for s in arr.addressable_shards
                       if s.device == devices[rank]]
            local = np.asarray(shard.data)
            if keys[-1] in ("attn_window", "rope_on"):
                continue   # the port's blocks hold them as static values
            if keys[0] in ("layers", "layers_dense"):
                first = dense if keys[0] == "layers" else 0
                for j in range(local.shape[0]):
                    name = ".".join(["layers", str(first + j)] + keys[1:])
                    seen.add(name)
                    if keys[1:3] == ["experts", "down"] and \
                            keys[3] == "p4":
                        # the port's chunk-local pack: its rows of the
                        # global leaf, unpacked
                        glob = tq.unpack_int4(full[name])
                        i4 = glob.shape[1] // 2
                        want = glob[2 * e:2 * e + 2, t * i4:(t + 1) * i4]
                        got = tq.unpack_int4(mine[name])
                        assert torch.equal(got, want), name
                        continue
                    np.testing.assert_array_equal(
                        mine[name].numpy(), local[j], err_msg=name)
            else:
                name = ".".join(keys)
                seen.add(name)
                np.testing.assert_array_equal(mine[name].numpy(), local,
                                              err_msg=name)
        markers = {n for n in mine if n.endswith(".chunked")}
        assert seen | markers == set(mine)
        if quant == "int4":
            assert tuple(mine["layers.0.experts.down.chunked"].shape) == \
                (2, 2, 0)
            assert tuple(mine["layers.0.o.chunked"].shape) == (2, 0)
        if key == "deepseek":   # latent attention: whole heads per rank
            assert mine["layers.1.kv_b_k.w"].shape[1] == \
                tcfg.num_heads // 2 * tcfg.qk_nope_head_dim
            assert torch.equal(mine["layers.1.kv_a.w"],
                               full["layers.1.kv_a.w"])


def test_an_int4_expert_down_unpacks_to_jax_rows():
    """JAX's own unpack of the global expert down, sliced to a rank's
    experts and rows, equals the port rank's chunk-local leaf unpacked;
    the bridge of the tree the JAX package placed (its o chunked for
    tp=2) cuts to the same bytes as the unplaced one; a leaf chunked for
    another tp raises."""
    jcfg, jp, tree, tcfg = model("mixtral", "int4")
    glob = np.asarray(jq.unpack_int4(jp["layers"]["experts"]["down"]["p4"]))
    spec = MeshSpec(tp=2, ep=2)
    full = params_from_jax(tree, tcfg, "cpu")
    mesh = create_mesh(JaxMeshSpec(tp=2, ep=2))
    with mesh:
        placed = jsh.shard_params(jp, mesh, jcfg, JaxMeshSpec(tp=2, ep=2))
    bridged = params_from_jax(jax.tree.map(np.asarray, placed), tcfg, "cpu")
    assert "layers.0.o.chunked" in bridged
    for rank in range(4):
        _, _, t, e = grid_coords(spec, rank)
        mine = tsh.shard_params(dict(full), tcfg, spec, rank)
        again = tsh.shard_params(dict(bridged), tcfg, spec, rank)
        assert set(again) == set(mine)
        for name, x in mine.items():
            assert torch.equal(again[name], x), name
        for i in range(tcfg.num_layers):
            got = tq.unpack_int4(mine[f"layers.{i}.experts.down.p4"])
            i2 = glob.shape[2] // 2
            np.testing.assert_array_equal(
                got.numpy(), glob[i, 2 * e:2 * e + 2, t * i2:(t + 1) * i2])
    four = dict(full)
    packed = tq.repack_int4_rows({"p4": full["layers.0.experts.down.p4"]}, 4)
    four.update({f"layers.0.experts.down.{k}": v for k, v in packed.items()})
    with pytest.raises(ValueError, match="chunked x4"):
        tsh.shard_params(four, tcfg, spec, 0)


# ---- the forward against the JAX forward on the same mesh -------------------

def _padded():
    s0 = 64   # the port engine's bucket for a 40-token prompt
    toks = np.zeros((len(PROMPTS), s0), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, :len(p)] = p
    return toks, np.asarray([len(p) for p in PROMPTS], np.int32)


def jax_forward(key, spec, n_micro=None):
    """The JAX forward on ``spec``'s mesh: prefill logits [B, 64, V] and
    each forced decode step's [steps, B, V]."""
    ref = ("forward", key, spec, n_micro)
    if ref not in _REF:
        jcfg, jp, _, _ = model(key)
        toks, lens = _padded()
        mesh = create_mesh(spec)
        with mesh:
            params = jsh.shard_params(jp, mesh, jcfg, spec)
            cache = jax.device_put(
                jax_init_cache(jcfg, len(PROMPTS), MAX_SEQ,
                               dtype=jnp.float32),
                jsh.named(mesh, jsh.cache_specs(jcfg, spec)))
            if spec.pp > 1:
                pre_fn = jax.jit(lambda p, t, ln, c: jpipe.pipelined_prefill(
                    p, jcfg, t, ln, c, mesh=mesh, n_micro=n_micro))
                dec_fn = jax.jit(lambda p, t, c: jpipe.pipelined_decode_step(
                    p, jcfg, t, c, mesh=mesh, n_micro=n_micro))
            else:
                pre_fn = lambda p, t, ln, c: jit_prefill(p, jcfg, t, ln, c)
                dec_fn = lambda p, t, c: jit_decode_step(p, jcfg, t, c)
            pre, cache = pre_fn(params, jnp.asarray(toks), jnp.asarray(lens),
                                cache)
            steps = []
            for row in np.asarray(FORCED):
                lg, cache = dec_fn(params, jnp.asarray(row[:, None],
                                                       jnp.int32), cache)
                steps.append(np.asarray(lg[:, 0]))
        _REF[ref] = (np.asarray(pre), np.stack(steps))
    return _REF[ref]


@pytest.mark.parametrize("key", ["dense_drop", "capacity_drop"])
@pytest.mark.parametrize("pp,tp,ep", [(1, 1, 2), (1, 2, 2), (2, 1, 2)])
def test_logits_match_the_jax_forward_on_the_mesh(key, pp, tp, ep,
                                                  kept_groups):
    n_micro = 2 if pp > 1 else None
    want_pre, want_dec = jax_forward(key, JaxMeshSpec(pp=pp, tp=tp, ep=ep),
                                     n_micro)
    eng = _engine(key, MeshSpec(pp=pp, tp=tp, ep=ep),
                  pipeline_microbatches=n_micro)
    try:
        eng.reset_counts()
        pre, dec = eng.teacher_forced(PROMPTS, FORCED)
        stats = eng.rank_stats()
    finally:
        eng.close()
    for i, p in enumerate(PROMPTS):
        np.testing.assert_allclose(pre[i, :len(p)].numpy(),
                                   want_pre[i, :len(p)], **TOL)
    np.testing.assert_allclose(dec.numpy(), want_dec, **TOL)
    # the count rule per forward (a prefill and three steps), per rank:
    # one expert_all_reduce per MoE layer and microbatch; under tp one
    # all-reduce for the embedding and one per layer (o); under tp one
    # gather on the last stage
    forwards, layers = 1 + len(FORCED), 2 // pp
    micro = n_micro or 1
    assert len(stats) == pp * tp * ep
    for s in stats:
        c = s["collectives"]
        assert c["expert_all_reduce"] == forwards * layers * micro, s
        embeds = forwards * micro if s["grid"]["pp"] == 0 else 0
        assert c["all_reduce"] == ((embeds + forwards * layers * micro)
                                   if tp > 1 else 0), s
        assert c["gather"] == (forwards * micro if tp > 1
                               and s["grid"]["pp"] == pp - 1 else 0), s
        assert s["grid"]["ep"] == s["rank"] % ep
        # every rank of a stage's expert group routed the same bits
        stage = [o for o in stats if o["grid"]["pp"] == s["grid"]["pp"]]
        assert {o["route_digest"] for o in stage} == {s["route_digest"]}


# ---- greedy tokens against the JAX engine ----------------------------------

_ENGINES = {
    "mixtral": ("mixtral", (2, 2), None),
    "glm45": ("glm45", (2, 2), None),
    "deepseek_latent": ("deepseek", (2, 2), "1"),
    "deepseek_materialized": ("deepseek", (2, 2), "0"),
    "gpt_oss": ("gpt_oss", (2, 1), None),
    "dbrx": ("dbrx", (2, 1), None),
}


@pytest.mark.parametrize("case", list(_ENGINES))
def test_engine_tokens_equal_the_jax_engine(case, kept_groups, monkeypatch):
    key, (tp, ep), latent = _ENGINES[case]
    if latent is not None:
        monkeypatch.setenv("DLI_MLA_LATENT", latent)
    jcfg, jp, _, cfg = model(key)
    prompts = [PROMPTS[0], PROMPTS[1][:20]]
    want = JaxEngine(jcfg, jp, mesh_spec=JaxMeshSpec(tp=tp, ep=ep),
                     max_seq=MAX_SEQ).generate(
        prompts, 6, sampling=JaxSamplingParams.greedy()).tokens
    eng = _engine(key, MeshSpec(tp=tp, ep=ep))
    try:
        assert eng.generate(prompts, 6, sampling=GREEDY).tokens == want
        if key == "deepseek":
            cache = eng._state(2).cache
            if latent == "1":   # one [k_rot | c] row, whole on each rank
                assert tuple(cache.k.shape[3:]) == (
                    1, cfg.qk_rope_head_dim + cfg.kv_lora_rank)
            else:               # the rank's H/tp heads
                assert cache.k.shape[3] == cfg.num_heads // tp
        for s in eng.rank_stats():
            assert s["param_bytes"] == eng.stats()["param_bytes"]
            # a follower takes the leader's layout, whatever its own
            # environment said when the kept group was spawned
            assert s["latent_cache"] == eng.cfg.mla_latent_cache
    finally:
        eng.close()


# ---- sp with experts --------------------------------------------------------

def test_sp_routes_over_the_whole_block_as_jax(kept_groups):
    """The JAX package's MLP is GSPMD-global under sp: a 64-position block
    takes capacity dispatch (N > 32) and its C counts all 64 positions,
    with drops at factor 0.5; the port's ranks, 32 positions each, route
    the assembled block and keep their rows."""
    jcfg, jp, tree, cfg = model("sp_drop")
    spec = JaxMeshSpec(sp=2)
    toks, lens = _padded()
    jeng = JaxEngine(jcfg, jp, mesh_spec=spec, max_seq=MAX_SEQ)
    want_tokens = jeng.generate(PROMPTS, 6,
                                sampling=JaxSamplingParams.greedy()).tokens
    mesh = create_mesh(spec)
    with mesh:
        cache = jax.device_put(
            jax_init_cache(jcfg, len(PROMPTS), MAX_SEQ, dtype=jnp.float32),
            jsh.named(mesh, jsh.cache_specs(jcfg, spec)))
        want_pre = np.asarray(jax.jit(
            lambda p, t, ln, c: jtf.prefill(
                p, jcfg, t, ln, c, mesh=mesh)[0])(
            jsh.shard_params(jp, mesh, jcfg, spec), jnp.asarray(toks),
            jnp.asarray(lens), cache))
    eng = _engine("sp_drop", MeshSpec(sp=2))
    try:
        eng.reset_counts()
        pre, _ = eng.teacher_forced(PROMPTS, [])
        for s in eng.rank_stats():
            assert s["collectives"]["expert_gather"] == cfg.num_layers, s
        for i, p in enumerate(PROMPTS):
            np.testing.assert_allclose(pre[i, :len(p)].numpy(),
                                       want_pre[i, :len(p)], **TOL)
        assert eng.generate(PROMPTS, 6, sampling=GREEDY).tokens == \
            want_tokens
    finally:
        eng.close()
