"""The other routers, the clamped GLU, expert biases and shared experts of
the port against the JAX package's (CPU, f32).

- ``moe_gates`` for the deepseek_v3, ernie and topk_softmax routers (and
  the softmax one beside them) against the JAX ``_moe_gates`` within
  1e-6, with the same experts picked: on seeded inputs, with planted ties
  (two experts with the same router column, so every position ties them
  exactly: ``>= kth`` keeps both), and with biased scores that are all
  negative (the JAX package masks an ineligible group with -inf, where HF
  fills 0 and would pick from it).
- ``glu_h`` (gpt-oss's clamped swish GLU, and the plain act(gate) * up)
  against ``_glu_h`` within 1e-6, on values past the limit.
- Expert biases (gpt-oss) in the dense and the capacity arm of ``moe``
  against ``_moe`` within 1e-4.
- Shared experts (the deepseek_v3 router) in float, int8 and int4: the
  block's MLP against ``_moe`` within 1e-4 in the dense arm; in the
  capacity arm the quantized experts are held to the JAX arm over the
  dequantized experts (the JAX capacity arm raises on quantized experts,
  ROADMAP Queue C), the shared experts staying quantized on both sides.
- The refusals that stay: LoRA on an expert or latent-attention base, tp
  for experts and latent attention, ``kv_quant`` with the latent cache.

Zero leaves of the JAX init (router biases, expert biases, sinks) are
drawn from a seeded normal before the bridge (``perturb_zeros``), so the
bias adds are under test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.models import transformer as jtf
from distributed_llm_inferencing_tpu.models.params import (
    init_params as jax_init_params)
from distributed_llm_inferencing_tpu.models.registry import (
    get_config as jax_config)
from distributed_llm_inferencing_tpu.ops.quant import (
    dequantize_weight, quantize_params)
from distributed_llm_inferencing_tpu_torch.models import lora as tlora
from distributed_llm_inferencing_tpu_torch.models import registry as treg
from distributed_llm_inferencing_tpu_torch.models import transformer as ttf
from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    MeshSpec, validate_spec)
from test_torch_families import one_torch_thread  # noqa: F401

GATE_TOL = dict(rtol=0, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-4)
FORMS = [None, "int8", "int4"]
# the routers' switches over tiny-mixtral (4 experts, top-2): 2 groups of
# 2, one group eligible, for the group-limited routers
ROUTERS = {
    "softmax": {},
    "deepseek_v3": dict(moe_router="deepseek_v3", moe_n_group=2,
                        moe_topk_group=1, moe_routed_scale=2.5),
    "ernie": dict(moe_router="ernie", moe_n_group=2, moe_topk_group=1),
    "topk_softmax": dict(moe_router="topk_softmax"),
}


def perturb_zeros(tree, seed=0, scale=0.5):
    """The JAX tree with every all-zero float leaf (the init's biases,
    router biases and sinks) drawn from a seeded normal."""
    rng = np.random.default_rng(seed)

    def draw(a):
        a = np.asarray(a)
        if a.dtype.kind == "f" and a.size and not a.any():
            return jnp.asarray(rng.normal(0, scale, a.shape).astype(a.dtype))
        return jnp.asarray(a)
    return jax.tree.map(draw, tree)


def cfgs(base="tiny-mixtral", **over):
    jcfg = jax_config(base).replace(dtype="float32", attn_backend="xla",
                                    **over)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def trees(jcfg, tcfg, q=None, seed=0):
    """(JAX params, port params) of ``jcfg`` in weight form ``q``, the
    zero leaves perturbed, bridged bit for bit."""
    jp = perturb_zeros(jax_init_params(jcfg.replace(quant=None),
                                       jax.random.PRNGKey(seed),
                                       dtype=jnp.float32), seed)
    if q is not None:
        jp = quantize_params(jp, jcfg, mode=q)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp),
                               tcfg.replace(quant=q), "cpu")


def layer(tree, i=0, seg="layers"):
    return jax.tree.map(lambda a: a[i], tree[seg])


@pytest.mark.parametrize("case", ["seeded", "ties", "negative"])
@pytest.mark.parametrize("router", list(ROUTERS))
def test_router_gates_match_jax(router, case):
    jcfg, tcfg = cfgs(**ROUTERS[router])
    jp, _ = trees(jcfg, tcfg)
    lp = layer(jp)
    w = np.array(lp["router"]["w"])
    bias = (np.array(lp["router"]["bias"]) if "bias" in lp["router"]
            else None)
    # the tied pair: experts 1 and 2, or for the group-limited routers
    # experts 0 and 1 (one group, eligible together)
    a, b = (0, 1) if router in ("deepseek_v3", "ernie") else (1, 2)
    if case == "ties":   # identical columns: every row ties the pair
        w[:, b] = w[:, a]
        if bias is not None:
            bias[b] = bias[a]
    if case == "negative" and bias is not None:
        bias = bias - 10.0   # every biased score < 0
    if bias is not None:
        lp = dict(lp, router={"w": jnp.asarray(w), "bias": jnp.asarray(bias)})
    else:
        lp = dict(lp, router={"w": jnp.asarray(w)})
    x = np.random.default_rng(["seeded", "ties", "negative"].index(
        case)).standard_normal((3, 17, 64)).astype(np.float32)
    want = np.asarray(jtf._moe_gates(jnp.asarray(x), lp, jcfg))
    got = ttf.moe_gates(torch.from_numpy(x), torch.from_numpy(w), tcfg,
                        None if bias is None else torch.from_numpy(bias))
    got = got.numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, **GATE_TOL)
    if case == "ties":   # both tied experts kept together, or neither
        np.testing.assert_array_equal(got[..., a] > 0, got[..., b] > 0)
        assert (got[..., a] > 0).any()
    if router in ("deepseek_v3", "ernie"):   # one group of two eligible
        picked = (got > 0).reshape(*got.shape[:-1], 2, 2).any(-1)
        assert (picked.sum(-1) == 1).all()


@pytest.mark.parametrize("limit", [None, 0.5])
def test_glu_h_matches_jax(limit):
    jcfg, tcfg = cfgs(moe_swiglu_limit=limit)
    rng = np.random.default_rng(3)
    g, u = (rng.normal(0, 2.0, (5, 4, 16)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jtf._glu_h(jnp.asarray(g), jnp.asarray(u), jcfg))
    got = ttf.glu_h(torch.from_numpy(g), torch.from_numpy(u), tcfg,
                    ttf._ACT[tcfg.activation]).numpy()
    np.testing.assert_allclose(got, want, **GATE_TOL)
    if limit is not None:   # the clamp bites on these values
        assert (np.abs(u) > limit).any() and (g > limit).any()


GPT_OSS_MOE = dict(ROUTERS["topk_softmax"], mlp_bias=True,
                   moe_swiglu_limit=0.5)


@pytest.mark.parametrize("mode", ["dense", "capacity"])
def test_expert_biases_match_jax(mode):
    jcfg, tcfg = cfgs(moe_dispatch=mode, **GPT_OSS_MOE)
    jp, tp = trees(jcfg, tcfg)
    lp = layer(jp)
    assert "b" in lp["experts"]["down"] and float(
        np.abs(lp["experts"]["down"]["b"]).max()) > 0
    blk = ttf.Transformer(tcfg, tp).layers[0]
    x = np.random.default_rng(4).standard_normal((2, 40, 64)).astype(
        np.float32)
    want = np.asarray(jtf._moe(jnp.asarray(x), lp, jcfg))
    got = blk._mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


SHARED = dict(ROUTERS["deepseek_v3"], moe_shared_experts=1)


@pytest.mark.parametrize("mode", ["dense", "capacity"])
@pytest.mark.parametrize("q", FORMS, ids=["float", "int8", "int4"])
def test_shared_experts_match_jax(q, mode):
    jcfg, tcfg = cfgs(moe_dispatch=mode, quant=q, **SHARED)
    jp, tp = trees(jcfg, tcfg, q)
    lp = layer(jp)
    blk = ttf.Transformer(tcfg, tp).layers[0]
    for n in ("shared_gate", "shared_up", "shared_down"):
        assert getattr(blk, n).form == (q or "float")
    x = np.random.default_rng(5).standard_normal((2, 40, 64)).astype(
        np.float32)
    if q is not None and mode == "capacity":
        with pytest.raises(ValueError, match="broadcast"):
            jtf._moe(jnp.asarray(x), lp, jcfg)       # the JAX fault
        # the JAX arm over the dequantized experts, shared ones quantized
        lp = dict(lp, experts={k: {"w": dequantize_weight(v)}
                               for k, v in lp["experts"].items()})
    want = np.asarray(jtf._moe(jnp.asarray(x), lp, jcfg))
    got = blk._mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["tiny-deepseek", "deepseek-proxy"])
def test_registry_rows_match_reference(name):
    assert dataclasses.asdict(treg.get_config(name)) == \
        dataclasses.asdict(jax_config(name))


@pytest.mark.parametrize("name,over", [
    ("tiny-deepseek", {}), ("tiny-mixtral", ROUTERS["topk_softmax"]),
    ("tiny-mixtral", {"moe_shared_experts": 1}),
])
def test_lora_refuses_expert_and_latent_bases(name, over):
    cfg = treg.get_config(name).replace(**over)
    with pytest.raises(ValueError, match="MLA|MoE"):
        tlora.validate_base_model(cfg)


@pytest.mark.parametrize("name,field", [
    ("tiny-deepseek", "kv_lora_rank"), ("deepseek-proxy", "q_lora_rank"),
    ("tiny-mixtral", "num_experts"),
])
def test_tp_refuses_experts_and_latent_attention_by_name(name, field):
    """tp and ep serve the experts and latent attention since ROADMAP
    item 9.8 (tests/test_torch_ep.py); an ep that does not divide the
    experts stays refused, as the JAX package refuses it."""
    cfg = treg.get_config(name)
    assert getattr(cfg, field)
    validate_spec(MeshSpec(tp=2, ep=2), cfg)
    with pytest.raises(ValueError, match="num_experts"):
        validate_spec(MeshSpec(ep=3), cfg)


def test_pp_refuses_a_mixed_stack():
    """The JAX package refuses pp for a dense-prefix stack, and so does
    the port, whose pp serves every uniform stack."""
    with pytest.raises(NotImplementedError, match="pp=2"):
        validate_spec(MeshSpec(pp=2), treg.get_config("tiny-deepseek"))


def test_kv_quant_excludes_the_latent_cache():
    """The latent row is the compressed form already: the config refuses
    an int8 cache beside it, and the engine's rule keeps the materialized
    cache for an int8-cache MLA model (as the JAX engine's)."""
    from distributed_llm_inferencing_tpu_torch.runtime.engine import (
        latent_cache)
    cfg = treg.get_config("tiny-deepseek")
    with pytest.raises(AssertionError, match="kv_quant"):
        cfg.replace(mla_latent_cache=True, kv_quant="int8")
    assert latent_cache(cfg) and not latent_cache(
        cfg.replace(kv_quant="int8"))
    assert not latent_cache(treg.get_config("tiny-mixtral"))
