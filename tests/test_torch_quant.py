"""The port's weight-only int8/int4 path against the JAX package's, on
the CPU.

- ops/quant.py: ``quantize_weight``, ``quantize_weight_int4``,
  ``pack_int4``, ``unpack_int4`` and ``quantize_embed`` give the JAX
  functions' bytes exactly, over every nibble value and over weights that
  land exactly between two levels (both round half to even).
- ``q4_matmul_ref`` against the JAX ``q4_matmul`` Pallas kernel in
  interpret mode over tests/test_pallas_parity.py's four shapes: f32 within
  2e-5 (summation order only); bf16 within one bf16 ulp of the larger of
  the two plus 2^-8 of the row's largest |output| (the JAX bf16 kernel
  folds the -8 bias into an f32 correction of 8*sum(x) and rounds there).
- ``q4_linear``: rows <= 32 go through ``q4_matmul`` (its plain version on
  the CPU, bit for bit), more rows through the plain unpack; both equal
  the JAX ``q4_linear`` in f32 within 2e-5.
- ``params_from_jax`` on trees from the JAX ``init_params`` with int8,
  int4 and int4 + embed int8: bit for bit; the port's own quantized init
  draws what the JAX init draws (levels, nibbles, scales).
- ``fused_decode_step_ref`` in its int8 and int4 forms against the JAX
  fused kernel in interpret mode: f32, 3e-5 (the float form's bar); the
  CUDA kernel's cluster decomposition (``fused_decode_step_cluster_model``)
  in both forms against the same kernel and the plain version.
- Greedy tokens of tiny-llama (f32) with int8, int4 and int4 + embed
  int8 equal the JAX engine's and the JAX batcher's; the port's batcher
  with the fused gate off and on.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from distributed_llm_inferencing_tpu.models.params import (
    init_params as jax_init_params)
from distributed_llm_inferencing_tpu.models.registry import (
    get_config as jax_config)
from distributed_llm_inferencing_tpu.ops import quant as jq
from distributed_llm_inferencing_tpu.ops.pallas import fused_decode as jfd
from distributed_llm_inferencing_tpu.ops.pallas import quant_matmul as jqm
from distributed_llm_inferencing_tpu.ops.sampling import (
    SamplingParams as JaxSamplingParams)
from distributed_llm_inferencing_tpu.runtime.batcher import (
    ContinuousBatcher as JaxBatcher)
from distributed_llm_inferencing_tpu.runtime.engine import (
    InferenceEngine as JaxEngine)
from distributed_llm_inferencing_tpu_torch.models.params import (
    init_params, param_bytes, param_shapes, params_from_jax)
from distributed_llm_inferencing_tpu_torch.models.registry import get_config
from distributed_llm_inferencing_tpu_torch.ops import fused_decode as tfd
from distributed_llm_inferencing_tpu_torch.ops import quant as tq
from distributed_llm_inferencing_tpu_torch.ops import quant_matmul as tqm
from distributed_llm_inferencing_tpu_torch.ops.sampling import SamplingParams
from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
    ContinuousBatcher)
from distributed_llm_inferencing_tpu_torch.runtime.engine import (
    InferenceEngine)
from test_torch_families import one_torch_thread  # noqa: F401

Q4_SHAPES = [(1, 64, 128), (4, 64, 192), (8, 128, 384), (3, 96, 160)]
# the three weight configurations of the slice: (quant, embed_quant)
MODES = [("int8", None), ("int4", None), ("int4", "int8")]


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(rng, din, dout):
    """Normal weights, plus one column whose values sit exactly halfway
    between int8 levels and one exactly halfway between int4 levels
    (amax fixes each scale; k + 0.5 levels tie)."""
    w = rng.normal(size=(din, dout)).astype(np.float32)
    w[:, 0] = np.where(np.arange(din) % 2, 127.0, 0.5 + np.arange(din) % 9)
    w[:, 1] = np.where(np.arange(din) % 2, 7.0, 0.5 + np.arange(din) % 5)
    return w


# ---- ops/quant.py: the same bytes --------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("din,dout", [(64, 128), (96, 160), (2, 8)])
def test_quantized_bytes_match_jax(dtype, din, dout):
    rng = np.random.default_rng(din * dout)
    w = _weights(rng, din, dout)
    jw = jnp.asarray(w).astype(dtype)
    tw = _t(np.asarray(jw.astype(jnp.float32))).to(getattr(torch, dtype))
    j8, t8 = jq.quantize_weight(jw), tq.quantize_weight(tw)
    np.testing.assert_array_equal(t8["q"].numpy(), np.asarray(j8["q"]))
    np.testing.assert_array_equal(t8["scale"].numpy(),
                                  np.asarray(j8["scale"]))
    j4, t4 = jq.quantize_weight_int4(jw), tq.quantize_weight_int4(tw)
    np.testing.assert_array_equal(t4["p4"].numpy(), np.asarray(j4["p4"]))
    np.testing.assert_array_equal(t4["scale"].numpy(),
                                  np.asarray(j4["scale"]))
    if dtype == "float32" and din > 2:   # the tie columns: half to even
        assert set(np.unique(t8["q"][0::2, 0].numpy())) <= set(
            range(0, 128, 2))
    je, te = jq.quantize_embed(jw.T), tq.quantize_embed(tw.T)
    np.testing.assert_array_equal(te["q8"].numpy(), np.asarray(je["q8"]))
    np.testing.assert_array_equal(te["rscale"].numpy(),
                                  np.asarray(je["rscale"]))
    for j, t in ((j8, t8), (j4, t4)):
        np.testing.assert_array_equal(
            tq.dequantize_weight(t).numpy(),
            np.asarray(jq.dequantize_weight(j)))
    np.testing.assert_array_equal(tq.dequantize_embed(te).numpy(),
                                  np.asarray(jq.dequantize_embed(je)))


def test_round_half_to_even_in_both():
    x = np.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    np.testing.assert_array_equal(torch.round(_t(x)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))
    np.testing.assert_array_equal(torch.round(_t(x)).numpy(),
                                  [-2, -2, -0, 0, 2, 2, 4])


def test_every_nibble_packs_and_unpacks_as_in_jax():
    levels = np.arange(-8, 8, dtype=np.int8)
    # every (low, high) pair of levels once: din = 2 * 256 rows, 3 columns
    lo, hi = np.meshgrid(levels, levels, indexing="ij")
    q = np.concatenate([lo.reshape(-1), hi.reshape(-1)])[:, None]
    q = np.repeat(q, 3, axis=1)
    jp, tp = jq.pack_int4(jnp.asarray(q)), tq.pack_int4(_t(q))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert sorted(set(tp[:, 0].tolist())) == list(range(256))
    np.testing.assert_array_equal(tq.unpack_int4(tp).numpy(), q)
    np.testing.assert_array_equal(tq.unpack_int4(tp).numpy(),
                                  np.asarray(jq.unpack_int4(jp)))
    # the chunk-local layout (tensor parallelism's o and down) as well
    np.testing.assert_array_equal(tq.unpack_int4(tp, chunks=2).numpy(),
                                  np.asarray(jq.unpack_int4(jp, 2)))


def test_maybe_quantize_on_the_flat_dict():
    cfg = get_config("tiny-llama").replace(dtype="float32")
    p = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    w_q = p["layers.1.q.w"].clone()
    tq.maybe_quantize(p, cfg.replace(quant="int4"))
    assert set(p) == set(param_shapes(cfg.replace(quant="int4")))
    ref = tq.quantize_weight_int4(w_q)
    assert torch.equal(p["layers.1.q.p4"], ref["p4"])
    assert tq.is_quantized(ref) and not tq.is_quantized({"w": w_q})
    assert tq.leaf_form(ref) == "int4"
    tq.maybe_quantize(p, cfg.replace(quant="int8"))   # already quantized
    assert "layers.1.q.q" not in p
    tq.maybe_quantize_embed(p, cfg.replace(embed_quant="int8"))
    assert set(p) == set(param_shapes(cfg.replace(quant="int4",
                                                  embed_quant="int8")))
    with pytest.raises(ValueError):
        tq.maybe_quantize(p, cfg.replace(quant="int3"))
    with pytest.raises(ValueError):
        tq.maybe_quantize_embed(p, cfg.replace(embed_quant="int4"))


# ---- q4_matmul and q4_linear -------------------------------------------

def _q4_case(rows, din, dout, seed):
    rng = np.random.default_rng(seed)
    leaf = jq.quantize_weight_int4(
        jnp.asarray(rng.normal(size=(din, dout)).astype(np.float32)))
    x = rng.normal(size=(rows, din)).astype(np.float32)
    return x, leaf


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,din,dout", Q4_SHAPES)
def test_q4_matmul_ref_matches_pallas_interpret(dtype, rows, din, dout):
    x, leaf = _q4_case(rows, din, dout, rows * din)
    jx = jnp.asarray(x).astype(dtype)
    ref = jqm.q4_matmul(jx, leaf["p4"], leaf["scale"], interpret=True)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    out = tqm.q4_matmul_ref(tx, _t(leaf["p4"]), _t(leaf["scale"]))
    assert out.dtype == getattr(torch, dtype) and out.shape == (rows, dout)
    # the CPU wrapper is the plain version
    torch.testing.assert_close(
        tqm.q4_matmul(tx, _t(leaf["p4"]), _t(leaf["scale"])), out,
        rtol=0, atol=0)
    o, r = out.float().numpy(), np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(o, r, rtol=2e-5, atol=2e-5)
    else:
        row_max = np.abs(r).max(axis=1, keepdims=True)
        bound = 2 ** -7 * np.maximum(np.abs(o), np.abs(r)) + 2 ** -8 * row_max
        assert (np.abs(o - r) <= bound).all(), np.abs(o - r).max()


@pytest.mark.parametrize("lead", [(3,), (2, 16), (2, 17), (40,)])
def test_q4_linear_routes(lead):
    din, dout = 64, 192
    rows = int(np.prod(lead))
    x, leaf = _q4_case(rows, din, dout, rows)
    x = x.reshape(*lead, din)
    tleaf = {"p4": _t(leaf["p4"]), "scale": _t(leaf["scale"])}
    out = tqm.q4_linear(_t(x), tleaf)
    assert out.shape == (*lead, dout)
    kernel_route = tqm.supported(rows, din, dout)
    assert kernel_route == (rows <= tqm.MAX_PALLAS_ROWS)
    if kernel_route:
        want = tqm.q4_matmul_ref(_t(x).reshape(rows, din), tleaf["p4"],
                                 tleaf["scale"]).reshape(out.shape)
    else:
        want = torch.matmul(_t(x), tq.unpack_int4(tleaf["p4"]).float()) \
            * tleaf["scale"]
    assert torch.equal(out, want)
    ref = jqm.q4_linear(jnp.asarray(x), leaf)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_q4_gate_is_the_kernels_own():
    assert tqm.supported(1, 2, 8) and tqm.supported(32, 14336, 4096)
    assert not tqm.supported(33, 4096, 4096)      # prefill-sized
    assert not tqm.supported(0, 4096, 4096)
    assert not tqm.supported(4, 63, 128)          # odd din
    assert not tqm.supported(4, 64, 100)          # dout % 8
    # the TPU tiling limits do not apply: din/2 < 32 and dout < 128 run
    assert tqm.supported(4, 16, 64)
    # contraction split: about two blocks per SM, >= 64 packed rows each
    assert tqm.ksplit(8, 4096, 1024, 132) == 32
    assert tqm.ksplit(8, 4096, 128256, 132) == 1
    assert tqm.ksplit(1, 128, 8, 132) == 1


@pytest.mark.parametrize("rows,din,dout,chunks", [
    (8, 128, 256, 1), (8, 128, 256, 2), (8, 256, 384, 4),
    (3, 96, 160, 1), (4, 64, 192, 1),          # the parity file's odd shapes
    (3, 96, 160, 2), (4, 64, 192, 4),
])
def test_q4_mma_slot_map_matches_pallas_interpret(rows, din, dout, chunks):
    """The tensor-core form's k-slot map (low nibbles of 8 packed rows on
    slots 0-7, high nibbles on 8-15, the chunk pairing in x's rows) and
    its bf16 levels, as ``q4_matmul_mma_model`` computes them, against the
    JAX q4_matmul (chunks 1) or q4_matmul_row sharded over ``chunks``
    devices (each shard's kernel in interpret mode, then psum), f32."""
    x, leaf = _q4_case(rows, din, dout, rows * din + chunks)
    if chunks == 1:
        ref = jqm.q4_matmul(jnp.asarray(x), leaf["p4"], leaf["scale"],
                            interpret=True)
    else:
        leaf = jq.repack_int4_rows(leaf, chunks)
        mesh = Mesh(np.array(jax.devices()[:chunks]), ("tp",))
        args = (jax.device_put(jnp.asarray(x),
                               NamedSharding(mesh, P(None, "tp"))),
                jax.device_put(leaf["p4"], NamedSharding(mesh, P("tp", None))),
                jax.device_put(leaf["scale"], NamedSharding(mesh, P(None))))
        ref = jax.jit(lambda a, p, sc: jqm.q4_matmul_row(
            a, p, sc, interpret=True, chunks=chunks))(*args)
    tp4, tsc = _t(leaf["p4"]), _t(leaf["scale"])
    out = tqm.q4_matmul_mma_model(_t(x), tp4, tsc, chunks)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(
        out.numpy(), tqm.q4_matmul_row_ref(_t(x), tp4, tsc, chunks).numpy(),
        rtol=2e-5, atol=2e-5)
    # every din row sits on exactly one k-slot
    slots = tqm.mma_slot_rows(din, chunks)
    assert sorted(slots[slots >= 0].tolist()) == list(range(din))


@pytest.mark.parametrize("dtype,rows,form", [
    (torch.bfloat16, 1, "mma"), (torch.bfloat16, 8, "mma"),
    (torch.bfloat16, 32, "mma"), (torch.float32, 1, "simt"),
    (torch.float32, 8, "simt"),
])
def test_q4_form_picks_by_dtype(dtype, rows, form):
    """bf16 x takes the tensor-core kernel at every row count; f32 the
    CUDA-core one (the f32 cross-checks' kernel)."""
    assert tqm.q4_form(dtype, rows) == form


def test_q4_mma_split_fills_the_card():
    """The tensor-core form's contraction split: about two blocks per SM,
    at least 256 packed rows each, cut on the 8-row k-step, at most 8
    splits (one cluster)."""
    assert tqm.mma_split(8, 4096, 4096, 132) == (256, 8)    # q/o
    assert tqm.mma_split(8, 4096, 1024, 132) == (256, 8)    # k/v
    assert tqm.mma_split(8, 14336, 4096, 132) == (896, 8)   # down
    assert tqm.mma_split(8, 4096, 128256, 132) == (2048, 1)  # head
    assert tqm.mma_split(3, 96, 160, 132) == (48, 1)
    assert tqm.mma_split(1, 2, 8, 132) == (8, 1)
    for b, din, dout in ((8, 4096, 14336), (1, 7168, 4096), (2, 90, 136)):
        kchunk, ks = tqm.mma_split(b, din, dout, 132)
        assert kchunk % 8 == 0 and -(-(din // 2) // kchunk) == ks <= 8


# ---- the bridge and the quantized init -----------------------------------

def _jax_tree(quant, embed_quant, seed=0):
    cfg = jax_config("tiny-llama").replace(dtype="float32", quant=quant,
                                           embed_quant=embed_quant)
    return cfg, jax_init_params(cfg, jax.random.PRNGKey(seed))


@pytest.mark.parametrize("quant,embed_quant", MODES)
def test_params_from_jax_quantized_is_bitwise(quant, embed_quant):
    _, params = _jax_tree(quant, embed_quant, seed=3)
    tree = jax.tree.map(np.asarray, params)
    cfg = get_config("tiny-llama").replace(dtype="float32", quant=quant,
                                           embed_quant=embed_quant)
    port = params_from_jax(tree, cfg, device="cpu")
    assert set(port) == set(param_shapes(cfg))
    keys = {"int8": ("q", "scale"), "int4": ("p4", "scale")}[quant]
    for i in range(cfg.num_layers):
        for n in ("q", "k", "v", "o", "gate", "up", "down"):
            for k in keys:
                np.testing.assert_array_equal(
                    port[f"layers.{i}.{n}.{k}"].numpy(),
                    tree["layers"][n][k][i])
    for k in keys:
        np.testing.assert_array_equal(port[f"lm_head.{k}"].numpy(),
                                      tree["lm_head"][k])
    table = tree["embed"]["tokens"]
    if embed_quant:
        for k in ("q8", "rscale"):
            np.testing.assert_array_equal(
                port[f"embed.tokens.{k}"].numpy(), table[k])
    else:
        np.testing.assert_array_equal(port["embed.tokens"].numpy(), table)
    assert param_bytes(port) == sum(a.nbytes for a in jax.tree.leaves(tree))


@pytest.mark.parametrize("quant,embed_quant", MODES)
def test_quantized_init_draws_what_jax_draws(quant, embed_quant):
    cfg = get_config("tiny-llama").replace(dtype="float32", quant=quant,
                                           embed_quant=embed_quant)
    p = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    _, jp = _jax_tree(quant, embed_quant)
    jflat = jax.tree.map(np.asarray, jp)
    assert set(p) == set(param_shapes(cfg))
    # dtypes and the constant scales as the JAX init emits them
    for name, t in p.items():
        assert tuple(t.shape) == param_shapes(cfg)[name]
    jq_leaf = jflat["layers"]["q"]
    for k in jq_leaf:
        assert p[f"layers.0.q.{k}"].numpy().dtype == jq_leaf[k].dtype
        if k == "scale":
            np.testing.assert_array_equal(p["layers.0.q.scale"].numpy(),
                                          jq_leaf[k][0])
    if quant == "int4":
        nib = torch.cat([p["layers.0.gate.p4"] & 0xF,
                         p["layers.0.gate.p4"] >> 4])
        assert int(nib.min()) == 1 and int(nib.max()) == 15
    else:
        q = p["layers.0.gate.q"]
        assert int(q.min()) == -127 and int(q.max()) == 127
    if embed_quant:
        np.testing.assert_array_equal(p["embed.tokens.rscale"].numpy(),
                                      jflat["embed"]["tokens"]["rscale"])
    with pytest.raises(ValueError):
        init_params(cfg.replace(quant="int2"), torch.Generator(), "cpu")


# ---- fused_decode_step: the quantized forms ------------------------------

@pytest.mark.parametrize("form", ["int8", "int4"])
@pytest.mark.parametrize("gqa,rope", [("gqa", True), ("mqa", True),
                                      ("mha", False)])
def test_fused_quantized_forms_match_pallas_interpret(form, gqa, rope):
    cfg_j = jax_config("tiny-llama").replace(dtype="float32")
    cfg_t = get_config("tiny-llama").replace(dtype="float32")
    rng = np.random.default_rng({"gqa": 1, "mqa": 2, "mha": 3}[gqa]
                                + 10 * (form == "int4"))
    hkv = {"gqa": 2, "mqa": 1, "mha": 4}[gqa]
    r, nb, bs, mb, h, hd, d = 3, 16, 8, 3, 4, 16, 32
    k_pool = rng.normal(size=(nb, bs, hkv, hd)).astype(np.float32)
    v_pool = rng.normal(size=(nb, bs, hkv, hd)).astype(np.float32)
    bt = (rng.permutation(nb - 1)[:r * mb] + 1).reshape(r, mb) \
        .astype(np.int32)
    lens = np.asarray([7, 21, 12], np.int32)
    x = rng.normal(size=(r, d)).astype(np.float32)
    w = (rng.normal(size=(d, h * hd)) / np.sqrt(d)).astype(np.float32)
    jleaf = (jq.quantize_weight if form == "int8"
             else jq.quantize_weight_int4)(jnp.asarray(w))
    tleaf = {k: _t(v) for k, v in jleaf.items()}
    kw_j, kw_t = {}, {}
    if rope:
        cos, sin = jfd.rope_cos_sin(cfg_j, jnp.asarray(lens - 1), hd)
        kw_j = dict(rope_cos=cos, rope_sin=sin)
        kw_t = dict(zip(("rope_cos", "rope_sin"),
                        tfd.rope_cos_sin(cfg_t, _t(lens - 1), hd)))
    ref = jfd.fused_decode_step(
        jnp.asarray(x), jleaf, jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(bt), jnp.asarray(lens), interpret=True, **kw_j)
    args = (_t(x), tleaf, _t(k_pool), _t(v_pool), _t(bt), _t(lens))
    out = tfd.fused_decode_step(*args, **kw_t)
    assert out.shape == (r, h, hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-5,
                               atol=3e-5)
    plain = tfd.fused_decode_step_ref(*args, **kw_t)
    assert torch.equal(out, plain)
    assert tfd.supported(cfg_t, tleaf) == jfd.supported(cfg_j, jleaf)


# The cluster kernel's decomposition in the quantized forms: R=1, R above
# one row group with length 0 and item edges, a window across items with
# D=40, and MQA with two head groups (the float form's cases:
# tests/test_torch_paged.py).
def _cluster_case(rng, lens, h, hkv, d, hd=16, bs=8):
    """Pools, tables, x and an f32 q weight for one cluster-model case."""
    r = len(lens)
    mb = max(1, -(-max(lens) // bs))
    nb = r * mb + 1
    k_pool, v_pool = (rng.normal(size=(nb, bs, hkv, hd)).astype(np.float32)
                      for _ in range(2))
    bt = (rng.permutation(nb - 1)[:r * mb] + 1).reshape(r, mb) \
        .astype(np.int32)
    x = rng.normal(size=(r, d)).astype(np.float32)
    w = (rng.normal(size=(d, h * hd)) / np.sqrt(d)).astype(np.float32)
    return x, w, k_pool, v_pool, bt, np.asarray(lens, np.int32)


QUANT_CLUSTER_CASES = [
    ([21], 4, 2, 32, None, True, 16, 2, 16),
    ([0, 7, 15, 16, 17, 33, 3, 30, 12], 4, 2, 32, None, True, 3, 2, 16),
    ([45, 33, 20], 4, 4, 40, 20, False, 16, 1, 16),
    ([25, 9, 18], 8, 1, 32, 10, True, 3, 2, 8),
]


@pytest.mark.parametrize("form", ["int8", "int4"])
@pytest.mark.parametrize("lens,h,hkv,d,window,rope,cluster,teams,split",
                         QUANT_CLUSTER_CASES)
def test_fused_cluster_model_quantized_matches_pallas_and_ref(
        form, lens, h, hkv, d, window, rope, cluster, teams, split):
    rng = np.random.default_rng(100 * len(lens) + d + 7 * h + hkv
                                + 50 * (form == "int4"))
    x, w, k_pool, v_pool, bt, lens_a = _cluster_case(rng, lens, h, hkv, d)
    jleaf = (jq.quantize_weight if form == "int8"
             else jq.quantize_weight_int4)(jnp.asarray(w))
    tleaf = {k: _t(v) for k, v in jleaf.items()}
    kw_j, kw_t = {}, {}
    if rope:
        cfg_j = jax_config("tiny-llama").replace(dtype="float32")
        cfg_t = get_config("tiny-llama").replace(dtype="float32")
        cos, sin = jfd.rope_cos_sin(cfg_j, jnp.asarray(lens_a - 1), 16)
        kw_j = dict(rope_cos=cos, rope_sin=sin)
        kw_t = dict(zip(("rope_cos", "rope_sin"),
                        tfd.rope_cos_sin(cfg_t, _t(lens_a - 1), 16)))
    ref = jfd.fused_decode_step(
        jnp.asarray(x), jleaf, jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(bt), jnp.asarray(lens_a), sliding_window=window,
        interpret=True, **kw_j)
    args = (_t(x), tleaf, _t(k_pool), _t(v_pool), _t(bt), _t(lens_a))
    out = tfd.fused_decode_step_cluster_model(
        *args, sliding_window=window, cluster=cluster, teams=teams,
        split=split, **kw_t)
    plain = tfd.fused_decode_step_ref(*args, sliding_window=window, **kw_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-5,
                               atol=3e-5)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=3e-5,
                               atol=3e-5)
    for i, n in enumerate(lens):
        assert (torch.count_nonzero(out[i]) == 0) == (n == 0)


# ---- greedy tokens: engine and batcher -----------------------------------

PROMPTS = [[3, 17, 52, 9, 1, 30, 44], list(range(5, 45))]


@pytest.fixture(scope="module", params=MODES, ids=lambda m: "+".join(
    f"{k}={v}" for k, v in zip(("quant", "embed"), m) if v))
def quant_trees(request):
    quant, embed_quant = request.param
    jcfg, params = _jax_tree(quant, embed_quant)
    tcfg = get_config("tiny-llama").replace(dtype="float32", quant=quant,
                                            embed_quant=embed_quant)
    return jcfg, params, tcfg, jax.tree.map(np.asarray, params)


def test_greedy_tokens_match_jax_engine(quant_trees):
    jcfg, params, tcfg, tree = quant_trees
    jeng = JaxEngine(jcfg, params, max_seq=96)
    teng = InferenceEngine(tcfg, params_from_jax(tree, tcfg, "cpu"),
                           max_seq=96, device="cpu")
    ref = jeng.generate(PROMPTS, max_new_tokens=10,
                        sampling=JaxSamplingParams.greedy()).tokens
    res = teng.generate(PROMPTS, max_new_tokens=10,
                        sampling=SamplingParams.greedy())
    assert res.tokens == ref
    assert teng.stats()["param_bytes"] == sum(
        a.nbytes for a in jax.tree.leaves(tree))


def _batch_prompts():
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, 4).tolist()
    prompts = [(base * 6)[:20], rng.integers(0, 256, 9).tolist(),
               rng.integers(0, 256, 13).tolist()]
    return prompts + [prompts[0][:16] + rng.integers(0, 256, 7).tolist()]


def _drive(b, prompts, max_new=10, steps=300):
    reqs = [b.submit(p, max_new_tokens=max_new,
                     sampling=(JaxSamplingParams.greedy()
                               if isinstance(b, JaxBatcher)
                               else SamplingParams.greedy()), seed=50 + i)
            for i, p in enumerate(prompts)]
    for _ in range(steps):
        b.step()
        if all(r.done.is_set() for r in reqs):
            break
    return [r.wait() for r in reqs]


def test_greedy_tokens_match_jax_batcher(monkeypatch, quant_trees):
    """The JAX batcher's fused route never runs here (its gate wants one
    device; the tests run eight), so its unfused tokens are the reference
    for the port's batcher with the fused gate off and on."""
    jcfg, params, tcfg, tree = quant_trees
    monkeypatch.setenv("DLI_FUSED_DECODE", "0")
    jb = JaxBatcher(jcfg.replace(attn_backend="xla"), params, num_blocks=128,
                    block_size=8, slots=4, max_seq=96, seed=0)
    jb.DECODE_CHUNKS = (4,)
    want = _drive(jb, _batch_prompts())
    for fused in ("0", "1"):
        monkeypatch.setenv("DLI_FUSED_DECODE", fused)
        n0 = tfd.fused_decode_step.launches
        tb = ContinuousBatcher(tcfg, params_from_jax(tree, tcfg, "cpu"),
                               num_blocks=128, block_size=8, slots=4,
                               max_seq=96, seed=0, device="cpu")
        tb.DECODE_CHUNKS = (4,)
        assert _drive(tb, _batch_prompts()) == want, f"fused={fused}"
        assert tfd.fused_decode_step.launches == n0   # CPU: plain version
    assert os.environ["DLI_FUSED_DECODE"] == "1"


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-gpt2"])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_smoke_host_levels_widened_once_are_bitwise(monkeypatch, name,
                                                    quant):
    """The host side of the smoke's quantized cross-checks
    (``chip_smoke._widen_levels_once``: each int8/int4 linear widens its
    levels to f32 once) gives the plain path's logits bit for bit: the
    dense prefill (the int4 unpack branch), decode steps (q4_matmul's
    plain version) and the paged path."""
    import chip_smoke
    monkeypatch.setenv("DLI_FUSED_DECODE", "0")   # _paged_run sets it
    from distributed_llm_inferencing_tpu_torch.models.params import (
        init_params)
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        Transformer)
    from distributed_llm_inferencing_tpu_torch.ops.kvcache import (
        init_cache)
    cfg = get_config(name).replace(dtype="float32", quant=quant)
    params = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    outs = []
    for widen in (False, True):
        model = Transformer(cfg, params)
        if widen:
            chip_smoke._widen_levels_once(torch, model)
        g = torch.Generator().manual_seed(8)
        toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=g)
        lens = torch.tensor([25, 40], dtype=torch.int32)
        with torch.inference_mode():
            cache = init_cache(cfg, 2, 64, device="cpu")
            lg, cache = model.prefill(toks, lens, cache)
            seq = [lg]
            for _ in range(4):
                lg, cache = model.decode_step(torch.randint(
                    0, cfg.vocab_size, (2, 1), generator=g), cache)
                seq.append(lg)
            seq.append(chip_smoke._paged_run(torch, model, "cpu"))
        outs.append(seq)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
