"""Experts behind the softmax router in the port against the JAX package
(CPU, f32, tiny-mixtral: 4 experts, top-2; the JAX init bridged bit for
bit).

- The MoE layer: gates within 1e-6 and the routed MLP within 1e-4 of the
  JAX ``_moe_gates`` / ``_moe`` in dense, capacity and auto dispatch, on
  80 positions where capacity dispatch drops choices; the whole model's
  prefill and decode logits within 1e-4 in each dispatch mode.
- Quantized experts: the JAX capacity arm raises on them (it multiplies
  an [E, C, I] product by the [E, I] scale; ROADMAP Queue C), so the
  port's int8 / int4 capacity dispatch is held to the JAX dispatch over
  the dequantized experts, within 1e-4.
- Serving: engine and batcher greedy tokens equal to the JAX engine's and
  batcher's (the batcher on the paged and on the fused decode route) in
  float (prompts whose prefill overflows an expert) and in
  int8 / int4 (prompts whose prefill the JAX package keeps dense); the
  mixtral and qwen3_moe checkpoints' tokens equal the JAX package's
  (their params are bitwise in tests/test_torch_convert.py).
- The registry rows, tp's refusal by name, the refused routers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.models import convert as jconvert
from distributed_llm_inferencing_tpu.models import transformer as jtf
from distributed_llm_inferencing_tpu.models.params import (
    init_params as jax_init_params)
from distributed_llm_inferencing_tpu.models.registry import (
    get_config as jax_config)
from distributed_llm_inferencing_tpu.ops.kvcache import (
    init_cache as jax_init_cache)
from distributed_llm_inferencing_tpu.ops.quant import (
    dequantize_weight, quantize_params)
from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.runtime.batcher import (
    ContinuousBatcher as JaxBatcher)
from distributed_llm_inferencing_tpu.runtime.engine import (
    InferenceEngine as JaxEngine)
from distributed_llm_inferencing_tpu_torch.models import convert
from distributed_llm_inferencing_tpu_torch.models import registry as treg
from distributed_llm_inferencing_tpu_torch.models import transformer as ttf
from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from distributed_llm_inferencing_tpu_torch.ops.kvcache import init_cache
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    MeshSpec, validate_spec)
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from test_torch_convert import saved
from test_torch_families import (  # noqa: F401
    jit_decode_step, jit_prefill, one_torch_thread)

TOL = dict(rtol=1e-4, atol=1e-4)
MODES = ["dense", "capacity", "auto"]
FORMS = [None, "int8", "int4"]
POOL = dict(num_blocks=128, block_size=8, slots=4, max_seq=96, seed=0)


def _cfgs(**over):
    jcfg = jax_config("tiny-mixtral").replace(dtype="float32",
                                              attn_backend="xla", **over)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _cfgs()
    return jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)


def _trees(jparams, q):
    """(JAX params, port params) in weight form ``q``."""
    jcfg, tcfg = _cfgs(quant=q)
    jp = jparams if q is None else quantize_params(jparams, jcfg, mode=q)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree["layers"])


def _dropped(gate, cfg):
    """Choices past their expert's capacity (the JAX arithmetic)."""
    n, e, k = gate.shape[0], cfg.num_experts, cfg.num_experts_per_tok
    c = max(1, int(cfg.moe_capacity_factor * k * n / e))
    idx = np.argsort(-gate, axis=-1, kind="stable")[:, :k]
    counts = np.zeros(e, int)
    dropped = 0
    for row in idx:
        for ex in row:
            dropped += counts[ex] >= c
            counts[ex] += 1
    return dropped


@pytest.mark.parametrize("mode", MODES)
def test_moe_layer_and_logits_match_jax(jparams, mode):
    jcfg, tcfg = _cfgs(moe_dispatch=mode)
    jp, tp = _trees(jparams, None)
    model = ttf.Transformer(tcfg, tp)
    blk = model.layers[0]
    # near one direction: most positions rank the experts alike
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(64) + 0.3 * rng.standard_normal((2, 40, 64))
         ).astype(np.float32)
    jg = np.asarray(jtf._moe_gates(jnp.asarray(x), _layer0(jp), jcfg))
    tg = ttf.moe_gates(torch.from_numpy(x), blk.router, tcfg).numpy()
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-6)
    assert _dropped(jg.reshape(-1, 4), jcfg) > 0   # capacity drops here
    np.testing.assert_allclose(
        ttf.moe(torch.from_numpy(x), blk.router, blk.experts, tcfg,
                blk.act).numpy(),
        np.asarray(jtf._moe(jnp.asarray(x), _layer0(jp), jcfg)), **TOL)
    # the model: a 40-token prefill (N = 80 over two rows) and decode
    B, S0, max_seq = 2, 40, 64
    lens = np.asarray([33, 40], np.int32)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (B, S0)).astype(np.int32)
    toks[0, 33:] = 0
    jlog, jcache = jit_prefill(jp, jcfg, jnp.asarray(toks),
                               jnp.asarray(lens),
                               jax_init_cache(jcfg, B, max_seq))
    with torch.inference_mode():
        tcache = init_cache(tcfg, B, max_seq, device="cpu")
        tlog, tcache = model.prefill(torch.from_numpy(toks).long(),
                                     torch.from_numpy(lens), tcache)
        for b, n in enumerate(lens):
            np.testing.assert_allclose(tlog[b, :n].numpy(),
                                       np.asarray(jlog)[b, :n], **TOL)
        for _ in range(3):
            nxt = rng.integers(0, 256, (B, 1)).astype(np.int32)
            jlog, jcache = jit_decode_step(jp, jcfg, jnp.asarray(nxt),
                                           jcache)
            tlog, tcache = model.decode_step(torch.from_numpy(nxt).long(),
                                             tcache)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


@pytest.mark.parametrize("q", ["int8", "int4"])
def test_quantized_capacity_matches_the_dequantized_reference(jparams, q):
    jcfg, tcfg = _cfgs(moe_dispatch="capacity", quant=q)
    jp, tp = _trees(jparams, q)
    lq = _layer0(jp)
    x = np.random.default_rng(2).standard_normal((2, 40, 64)).astype(
        np.float32)
    with pytest.raises(ValueError, match="broadcast"):
        jtf._moe(jnp.asarray(x), lq, jcfg)           # the JAX fault
    deq = dict(lq, experts={k: {"w": dequantize_weight(v)}
                            for k, v in lq["experts"].items()})
    want = np.asarray(jtf._moe(jnp.asarray(x), deq, jcfg.replace(quant=None)))
    blk = ttf.Transformer(tcfg, tp).layers[0]
    got = ttf.moe(torch.from_numpy(x), blk.router, blk.experts, tcfg,
                  blk.act).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # and the dense arm, which the JAX package runs quantized, agrees
    dense = jcfg.replace(moe_dispatch="dense")
    np.testing.assert_allclose(
        ttf.moe(torch.from_numpy(x), blk.router, blk.experts,
                tcfg.replace(moe_dispatch="dense"), blk.act).numpy(),
        np.asarray(jtf._moe(jnp.asarray(x), lq, dense)), **TOL)


class _Drops:
    """Counts the choices the port's capacity dispatch drops (wraps
    ``moe_gates``, whose capacity caller passes the flat [N, D] input)."""

    def __init__(self, monkeypatch, cfg):
        self.n, self.cfg = 0, cfg
        real = ttf.moe_gates

        def gates(x, w, c, b=None):
            g = real(x, w, c, b)
            if x.dim() == 2:
                self.n += _dropped(g.numpy(), c)
            return g
        monkeypatch.setattr(ttf, "moe_gates", gates)


def _greedy_engines(jp, tp, q, prompts):
    jcfg, tcfg = _cfgs(quant=q)
    # 5 new tokens: one 4-step decode program on the JAX side
    want = JaxEngine(jcfg, jp, max_seq=96).generate(
        prompts, max_new_tokens=5,
        sampling=JaxSamplingParams.greedy()).tokens
    got = InferenceEngine(tcfg, tp, max_seq=96, device="cpu").generate(
        prompts, max_new_tokens=5, sampling=SamplingParams.greedy()).tokens
    return got, want


def _drive(b, sp, prompts):
    """Greedy tokens of ``prompts`` through batcher ``b`` (4-step decode
    chunks, 8 new tokens each)."""
    b.DECODE_CHUNKS = (4,)
    reqs = [b.submit(p, max_new_tokens=8, sampling=sp.greedy(),
                     seed=50 + i) for i, p in enumerate(prompts)]
    for _ in range(300):
        b.step()
        if all(r.done.is_set() for r in reqs):
            break
    return [r.wait() for r in reqs]


# the JAX batcher's tokens per weight form, shared by the paged and the
# fused route's cases
_JAX_BATCHED: dict = {}


def _greedy_batchers(jp, tp, q, prompts):
    jcfg, tcfg = _cfgs(quant=q)
    if q not in _JAX_BATCHED:
        _JAX_BATCHED[q] = _drive(JaxBatcher(jcfg, jp, **POOL),
                                 JaxSamplingParams, prompts)
    got = _drive(ContinuousBatcher(tcfg, tp, device="cpu", **POOL),
                 SamplingParams, prompts)
    return got, _JAX_BATCHED[q]


def _prompts(q):
    """Two rows per engine batch (a one-row JAX engine on a multi-device
    CPU pads a dummy row, doubling the capacity count). Float: 20- and
    40-token prompts, prefill N = 128 with drops; quantized: prompts of
    at most 8 tokens, whose engine (N = 32) and batcher admission (4 rows
    of one 8-token block) the JAX package keeps dense."""
    rng = np.random.default_rng(9)
    if q is None:   # runs of one token: positions route alike
        return [[int(t)] * n + rng.integers(0, 256, 3).tolist()
                for t, n in zip(rng.integers(0, 256, 4), (17, 37, 10, 24))]
    return [rng.integers(0, 256, n).tolist() for n in (8, 5, 7, 6)]


@pytest.mark.parametrize("q", FORMS, ids=["float", "int8", "int4"])
def test_engine_and_batcher_tokens_match_jax(jparams, q, monkeypatch):
    jp, tp = _trees(jparams, q)
    prompts = _prompts(q)
    drops = _Drops(monkeypatch, _cfgs()[1])
    got, want = _greedy_engines(jp, tp, q, prompts[:2])
    assert got == want and all(len(t) == 5 for t in want)
    monkeypatch.setenv("DLI_FUSED_DECODE", "0")
    got, want = _greedy_batchers(jp, tp, q, prompts)
    assert got == want and all(len(t) == 8 for t in want)
    assert (drops.n > 0) == (q is None)   # float prefills overflow


@pytest.mark.parametrize("q", FORMS, ids=["float", "int8", "int4"])
def test_fused_route_batcher_tokens_match_jax(jparams, q, monkeypatch):
    """``DLI_FUSED_DECODE=1``: the port's gate takes the MoE rows as the
    JAX gate does (experts sit after attention, which the fused kernel
    owns), and the batcher's decode through the fused route gives the JAX
    batcher's greedy tokens in each weight form."""
    from distributed_llm_inferencing_tpu.ops.pallas import (
        fused_decode as jfd)
    from distributed_llm_inferencing_tpu_torch.ops import (
        fused_decode as tfd)
    for name in ("tiny-mixtral", "moe-proxy-8e", "mixtral-8x7b"):
        assert tfd.supported(treg.get_config(name))
        assert jfd.supported(jax_config(name))
    jp, tp = _trees(jparams, q)
    monkeypatch.setenv("DLI_FUSED_DECODE", "1")
    _, tcfg = _cfgs(quant=q)
    assert tfd.eligible(tcfg, False)
    calls, real = [], tfd.fused_decode_step

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tfd, "fused_decode_step", counted)
    got, want = _greedy_batchers(jp, tp, q, _prompts(q))
    assert got == want and all(len(t) == 8 for t in want)
    # one call per layer per decode step
    assert calls and len(calls) % tcfg.num_layers == 0


@pytest.mark.parametrize("mt", ["mixtral", "qwen3_moe"])
def test_moe_checkpoints_tokens_match_jax(mt):
    d = saved(mt)
    jcfg, jp = jconvert.load_hf_model(d, dtype=jnp.float32)
    jcfg = jcfg.replace(dtype="float32")
    cfg, tp = convert.load_hf_model(d, dtype="float32", device="cpu")
    cfg = cfg.replace(dtype="float32")
    assert cfg.num_experts == 4 and cfg.moe_norm_topk
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, n).tolist() for n in (20, 22)]
    want = JaxEngine(jcfg, jp, max_seq=96).generate(
        prompts, max_new_tokens=5,
        sampling=JaxSamplingParams.greedy()).tokens
    got = InferenceEngine(cfg, tp, max_seq=96, device="cpu").generate(
        prompts, max_new_tokens=5, sampling=SamplingParams.greedy()).tokens
    assert got == want
    out = []
    for b, sp in ((JaxBatcher(jcfg, jp, **POOL), JaxSamplingParams),
                  (ContinuousBatcher(cfg, tp, device="cpu", **POOL),
                   SamplingParams)):
        b.DECODE_CHUNKS = (4,)
        reqs = [b.submit(p, max_new_tokens=8, sampling=sp.greedy(), seed=1)
                for p in prompts]
        for _ in range(300):
            b.step()
            if all(r.done.is_set() for r in reqs):
                break
        out.append([r.wait() for r in reqs])
    assert out[1] == out[0]


@pytest.mark.parametrize("q", ["int8", "int4"])
def test_quantized_expert_bytes_equal_jax(jparams, q):
    """The port's ``maybe_quantize`` of the float tree gives the JAX
    quantizer's expert (and every other) bytes; the router stays float."""
    from distributed_llm_inferencing_tpu_torch.ops.quant import (
        maybe_quantize)
    jcfg, tcfg = _cfgs(quant=q)
    want = params_from_jax(jax.tree.map(np.asarray, quantize_params(
        jparams, jcfg, mode=q)), tcfg, "cpu")
    got = maybe_quantize(params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg.replace(quant=None), "cpu"),
        tcfg)
    assert set(got) == set(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    assert got["layers.0.router.w"].dtype == torch.float32
    assert got["layers.1.experts.down.scale"].shape == (4, 64)


@pytest.mark.parametrize("name", ["tiny-mixtral", "moe-proxy-8e",
                                  "mixtral-8x7b"])
def test_registry_rows_match_reference_and_tp_refuses(name):
    """tp and ep serve the rows (tests/test_torch_ep.py); what the mesh
    still refuses is the JAX package's refusal: an ep that does not
    divide the experts."""
    assert dataclasses.asdict(treg.get_config(name)) == \
        dataclasses.asdict(jax_config(name))
    cfg = treg.get_config(name)
    for spec in (MeshSpec(), MeshSpec(tp=2), MeshSpec(tp=2, ep=2)):
        validate_spec(spec, cfg)
    with pytest.raises(ValueError, match="num_experts"):
        validate_spec(MeshSpec(ep=3), cfg)


@pytest.mark.parametrize("over", [
    {"moe_dispatch": "all_to_all"},
])
def test_other_routers_and_expert_switches_stay_refused(over):
    cfg = treg.get_config("tiny-mixtral").replace(**over)
    with pytest.raises(NotImplementedError):
        ttf.check_supported(cfg)
