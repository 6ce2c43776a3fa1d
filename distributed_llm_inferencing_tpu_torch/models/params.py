"""Parameters of the port's transformer: random init and the JAX bridge.

The port keeps one flat dict ``name -> tensor`` whose names follow the
reference pytree with the stacked layer axis unrolled (``?``: only where
the config has the feature; E = ``embed_proj_dim`` or D):

    embed.tokens [V,E]            (embed_quant int8: embed.tokens.q8 [V,E]
                                   int8 + embed.tokens.rscale [V] f32)
    embed.positions [P,D]?        (learned positions)
    embed.norm.{scale,bias} [E]?  (embed_norm)
    embed.project_in.w [E,D]?, embed.project_out.w [D,E]?
    layers.{i}.attn_norm.scale [D] (+ .bias [D] for layernorm)
    layers.{i}.{q,k,v,o}.<leaf> (+ .b [dout] where biased)
    layers.{i}.{q_a,q_b|q,kv_a,kv_b_k,kv_b_v,o}.<leaf>, .{q_a,kv_a}_norm
                                  .scale (MLA, in place of q/k/v/o: q and
                                   k per head [rope | nope]; o from
                                   H*v_head_dim)
    layers.{i}.sinks [H]?         (attn_sinks: one logit per head)
    layers.{i}.mlp_norm.{scale,bias?} (absent with shared_attn_mlp_norm)
    layers.{i}.{attn,mlp}_post_norm.{scale,bias?} [D]? (post_block_norms)
    layers.{i}.{q,k}_norm.scale?  (qk_norm: [hd] for "rms_head", else
                                   the flat [H*hd] / [Hkv*hd])
    layers.{i}.{gate?,up,down}.<leaf> (+ .b; gate only in a gated MLP;
                                   absent in an MoE block)
    layers.{i}.router.w [D,E]?    (MoE: the router, kept float; with
                                   .bias [E] for the deepseek_v3, ernie
                                   and topk_softmax routers)
    layers.{i}.experts.{gate,up}.<leaf> [E,D,I], .down.<leaf> [E,I,D]?
                                  (MoE: stacked expert weights; int8 q
                                   [E,din,dout] + scale [E,dout], int4
                                   p4 [E,din/2,dout] + scale [E,dout];
                                   + .b [E,dout] with mlp_bias, gpt-oss)
    layers.{i}.shared_{gate,up,down}.<leaf>? (moe_shared_experts)
    final_norm.{scale,bias?} [D]  (absent with post_norm)
    lm_head.<leaf> (+ .b)         (absent with tie_word_embeddings)

where a linear's ``<leaf>`` is, by ``cfg.quant``, ``w`` [din,dout] (float),
``q`` [din,dout] int8 + ``scale`` [dout] f32 (int8), or ``p4``
[din/2,dout] uint8 + ``scale`` [dout] f32 (int4; ops/quant.py has the
layouts), the last with a ``chunked`` marker where the leaf is packed
chunk-locally. A mixed stack's first ``dense_prefix_layers`` layers are
dense-MLP layers of ``cfg.dense_segment_cfg()`` (the reference's
``layers_dense`` tree, laid out here as layers 0..k-1). Biases, norms,
positions and the opt-350m projections stay
float in the model's dtype. Weights keep the reference's [din, dout]
layout (y = x @ w), so the bridge from a JAX tree is a copy, bitwise,
with no transpose. The reference's int32 per-layer leaves
(``attn_window``, -1 for a global layer, and ``rope_on``) are no tensors
here: each ``Block`` holds its window and rope switch as static values
from ``cfg.attn_windows`` / ``cfg.rope_layers``, and the bridge checks
that the leaves say the same.

Under tensor or pipeline parallelism every rank draws every leaf of the
whole model in the same order from the same seeded generator, keeps its
share (``init_params``'s ``shard``; parallel/sharding.py: its tp cut of
its pp stage's leaves) and frees the rest: each rank holds exactly what
pp=1 and tp=1 would hold for its layers, cut, and the peak is one whole
leaf plus the shares.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.ops.quant import (
    EMBED, LEAF_KEYS, check_modes)
from distributed_llm_inferencing_tpu_torch.utils.device import torch_dtype

LAYER_LINEARS = ("q", "k", "v", "o", "gate", "up", "down")
# latent attention's bottlenecks and expansions, and the shared experts'
# MLP: linears like the others (the reference's _LINEAR_LEAVES)
MLA_LINEARS = ("q_a", "q_b", "kv_a", "kv_b_k", "kv_b_v")
SHARED_LINEARS = ("shared_gate", "shared_up", "shared_down")
EXPERT_LEAVES = ("gate", "up", "down")
LAYER_NORMS = ("attn_norm", "mlp_norm")
POST_NORMS = ("attn_post_norm", "mlp_post_norm")
QK_NORMS = ("q_norm", "k_norm")
MLA_NORMS = ("q_a_norm", "kv_a_norm")
# routers whose leaf carries a bias (deepseek_v3 / ernie: the selection
# correction; topk_softmax: the router linear's own bias)
BIASED_ROUTERS = ("deepseek_v3", "ernie", "topk_softmax")


def _leaf_shapes(prefix: str, din: int, dout: int, bias: bool = False,
                 quant: Optional[str] = None, lead: tuple = ()):
    """A linear leaf's tensors; ``lead``: stacked leading axes (the
    experts' [E], whose biases are [E, dout])."""
    if quant == "int4" and din % 2:
        raise ValueError(f"{prefix}: int4 packing needs even din, got {din}")
    rows = din // 2 if quant == "int4" else din
    out = {f"{prefix}.{k}": lead + ((dout,) if k == "scale" else (rows, dout))
           for k in LEAF_KEYS[quant or "float"]}
    if bias:
        out[f"{prefix}.b"] = lead + (dout,)
    return out


def _norm_shapes(cfg: ModelConfig, prefix: str, dim: int):
    keys = ("scale", "bias") if cfg.norm_type == "layernorm" else ("scale",)
    return {f"{prefix}.{k}": (dim,) for k in keys}


def attn_linears(cfg: ModelConfig):
    """(name, din, dout, biased) of each attention linear of a block: q,
    k, v and o, or latent attention's (q_a, q_b or q, kv_a, kv_b_k,
    kv_b_v, o from H*v_head_dim)."""
    D = cfg.hidden_size
    if not cfg.mla:
        return [("q", D, cfg.q_dim, cfg.attn_bias),
                ("k", D, cfg.kv_dim, cfg.attn_bias),
                ("v", D, cfg.kv_dim, cfg.attn_bias),
                ("o", cfg.q_dim, D, cfg.o_bias_effective)]
    H, r, rd = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    vd = cfg.v_head_dim_effective
    qr = cfg.q_lora_rank
    out = ([("q_a", D, qr, cfg.attn_bias), ("q_b", qr, cfg.q_dim, False)]
           if qr else [("q", D, cfg.q_dim, False)])
    return out + [("kv_a", D, r + rd, cfg.attn_bias),
                  ("kv_b_k", r, H * (cfg.head_dim - rd), False),
                  ("kv_b_v", r, H * vd, False),
                  ("o", H * vd, D, cfg.o_bias_effective)]


def layer_linears(cfg: ModelConfig):
    """(name, din, dout, biased) of each linear of a block under ``cfg``
    (a layer's config, ``ModelConfig.layer_cfg``): the attention's, then
    the dense MLP's or, in an MoE block, the shared experts' (the routed
    experts are ``expert_leaves``)."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    out = attn_linears(cfg)
    if cfg.is_moe:
        if cfg.moe_shared_experts:
            si = I * cfg.moe_shared_experts
            out += [("shared_gate", D, si, cfg.mlp_bias),
                    ("shared_up", D, si, cfg.mlp_bias),
                    ("shared_down", si, D, cfg.mlp_bias)]
        return out
    if cfg.gated_mlp:   # biased with mlp_bias, as the JAX converter's
        out.append(("gate", D, I, cfg.mlp_bias))   # llama branch makes it
    return out + [("up", D, I, cfg.mlp_bias), ("down", I, D, cfg.mlp_bias)]


def expert_leaves(cfg: ModelConfig):
    """(name, din, dout) of each stacked expert leaf of an MoE block."""
    D, I = cfg.hidden_size, cfg.intermediate_size
    return [("gate", D, I), ("up", D, I), ("down", I, D)]


def _layer_shapes(cfg: ModelConfig, i: int) -> Dict[str, tuple]:
    """Layer i's tensors under its config (``ModelConfig.layer_cfg``)."""
    lc = cfg.layer_cfg(i)
    D = cfg.hidden_size
    o = f"layers.{i}."
    shapes = {}
    norms = LAYER_NORMS[:1] if cfg.shared_attn_mlp_norm else LAYER_NORMS
    if cfg.post_block_norms:
        norms += POST_NORMS
    for n in norms:
        shapes.update(_norm_shapes(cfg, o + n, D))
    if cfg.qk_norm:   # one [hd] scale shared by every head, or flat
        shared = cfg.qk_norm == "rms_head"
        for n, dim in zip(QK_NORMS, (cfg.q_dim, cfg.kv_dim)):
            shapes[f"{o}{n}.scale"] = (cfg.head_dim if shared else dim,)
    if cfg.mla:   # the bottlenecks' RMSNorms
        if cfg.q_lora_rank:
            shapes[o + "q_a_norm.scale"] = (cfg.q_lora_rank,)
        shapes[o + "kv_a_norm.scale"] = (cfg.kv_lora_rank,)
    if cfg.attn_sinks:   # one sink logit per head
        shapes[o + "sinks"] = (cfg.num_heads,)
    for n, din, dout, bias in layer_linears(lc):
        shapes.update(_leaf_shapes(o + n, din, dout, bias, cfg.quant))
    if lc.is_moe:
        shapes[o + "router.w"] = (D, lc.num_experts)
        if lc.moe_router in BIASED_ROUTERS:
            shapes[o + "router.bias"] = (lc.num_experts,)
        for n, din, dout in expert_leaves(lc):
            shapes.update(_leaf_shapes(
                f"{o}experts.{n}", din, dout, lc.mlp_bias, cfg.quant,
                (lc.num_experts,)))
    return shapes


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Name -> shape of every stored tensor of ``cfg`` under
    ``cfg.quant`` / ``cfg.embed_quant``, in init order."""
    check_modes(cfg)
    D, V = cfg.hidden_size, cfg.vocab_size
    E = cfg.embed_proj_dim or D
    shapes = ({f"{EMBED}.q8": (V, E), f"{EMBED}.rscale": (V,)}
              if cfg.embed_quant else {EMBED: (V, E)})
    if cfg.position_embedding == "learned":
        shapes["embed.positions"] = (cfg.max_position_embeddings, D)
    if cfg.embed_norm:
        shapes.update(_norm_shapes(cfg, "embed.norm", E))
    if cfg.embed_proj_dim:
        shapes.update(_leaf_shapes("embed.project_in", E, D))
        shapes.update(_leaf_shapes("embed.project_out", D, E))
    for i in range(cfg.num_layers):
        shapes.update(_layer_shapes(cfg, i))
    if not cfg.post_norm:
        shapes.update(_norm_shapes(cfg, "final_norm", D))
    if not cfg.tie_word_embeddings:
        shapes.update(_leaf_shapes("lm_head", D, V, cfg.lm_head_bias,
                                   cfg.quant))
    return shapes


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype=None, shard: Optional[Callable] = None
                ) -> Dict[str, torch.Tensor]:
    """Random weights, drawn on ``device`` from ``generator`` (which must
    live on that device): float weights, biases and positions normal with
    std 0.02 (the JAX package draws biases, sinks and the router's bias
    as zeros; random ones put them to the test), the router's bias in
    f32 as there, norm scales 1. With ``cfg.quant`` the linears
    come out quantized directly, as the JAX package's init does, and the
    float tree never exists: int8 levels uniform in [-127, 127] with
    scale 0.02/127; int4 biased nibbles uniform in [1, 15] (levels [-7,
    7], what quantization can produce) with scale 0.02/7.
    ``cfg.embed_quant`` draws the table as int8 levels with row scale
    0.02/127. Drawing on the card matters at full width: 8B weights drawn
    on the host and copied over would take minutes. ``shard(name,
    tensor)`` (a tp rank's cut) replaces each tensor as soon as it is
    drawn."""
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        check_supported)
    check_supported(cfg)
    dtype = torch_dtype(dtype or cfg.dtype)
    gen = dict(generator=generator, device=device)
    out = {}
    for name, shape in param_shapes(cfg).items():
        kind = name.rsplit(".", 1)[1]
        if name.endswith("norm.scale"):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif name.endswith("router.bias"):   # kept f32, as the JAX init
            out[name] = torch.randn(shape, dtype=torch.float32,
                                    **gen).mul_(0.02)
        elif kind in ("q", "q8"):
            out[name] = torch.randint(-127, 128, shape, dtype=torch.int8,
                                      **gen)
        elif kind == "p4":
            lo, hi = (torch.randint(1, 16, shape, dtype=torch.uint8, **gen)
                      for _ in range(2))
            out[name] = lo | (hi << 4)
            del lo, hi
        elif kind in ("scale", "rscale"):
            levels = 7.0 if kind == "scale" and cfg.quant == "int4" else 127.0
            out[name] = torch.full(shape, 0.02 / levels, dtype=torch.float32,
                                   device=device)
        else:
            w = torch.randn(shape, dtype=torch.float32, **gen)
            out[name] = w.mul_(0.02).to(dtype)
            del w
        if shard is not None:
            out[name] = shard(name, out[name])
            if out[name] is None:   # not this rank's (another stage's)
                del out[name]
    return out


def _tensor(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:   # jax-backed views are read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(np_tree, cfg: ModelConfig, device=None
                    ) -> Dict[str, torch.Tensor]:
    """The reference's parameter pytree, after
    ``jax.tree.map(np.asarray, params)``, as the port's flat dict.

    Every leaf copies bit for bit (bf16 through its raw 16-bit pattern;
    int8 levels, packed int4 bytes, f32 scales, biases, positions and
    norms as they are). Stacked ``[L, ...]`` layer leaves split into
    per-layer tensors; a mixed stack's ``layers_dense`` tree gives layers
    0..k-1 and its ``layers`` tree the rest. ``cfg.quant`` and
    ``cfg.embed_quant`` must describe the tree. A chunk-local int4 leaf (the JAX package's tp
    layout of o and down) keeps its ``chunked`` marker. The int32
    ``attn_window`` / ``rope_on`` leaves must be present exactly when
    ``cfg.attn_windows`` / ``cfg.rope_layers`` are set, and say the
    same, or the bridge raises.
    """
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        check_supported)
    check_supported(cfg)
    expect = param_shapes(cfg)
    lin_keys = LEAF_KEYS[cfg.quant or "float"]

    def leaf(p, prefix, keys, stacked, optional=("b",)):
        if not isinstance(p, dict):
            raise ValueError(f"{prefix}: expected a leaf dict, got "
                             f"{type(p).__name__}")
        if "chunked" in p and "p4" in keys:
            keys = keys + ("chunked",)
        keys = keys + tuple(k for k in optional if k in p)
        if set(p) != set(keys):
            raise ValueError(f"{prefix}: leaf {sorted(p)} does not match "
                             f"{cfg.name} with quant={cfg.quant!r}, "
                             f"embed_quant={cfg.embed_quant!r}")
        for k in keys:
            a = np.asarray(p[k])
            if stacked:   # (first layer, count) of a stacked segment
                start, count = stacked
                for i in range(count):
                    out[f"layers.{start + i}.{prefix}.{k}"] = _tensor(
                        a[i], device)
            else:
                out[f"{prefix}.{k}"] = _tensor(a, device)

    def norm(p, prefix, stacked):
        leaf(p, prefix, ("scale",), stacked, optional=("bias",))

    out = {}
    embed = np_tree["embed"]
    tokens = embed["tokens"]
    if isinstance(tokens, dict) or cfg.embed_quant:
        leaf(tokens, EMBED, ("q8", "rscale"), False, ())
    else:
        out[EMBED] = _tensor(tokens, device)
    for k, p in embed.items():
        if k == "positions":
            out["embed.positions"] = _tensor(p, device)
        elif k == "norm":
            norm(p, "embed.norm", False)
        elif k in ("project_in", "project_out"):
            leaf(p, f"embed.{k}", ("w",), False, ())
        elif k != "tokens":
            raise ValueError(f"embed.{k}: not a leaf the port serves")
    static = {"attn_window": None if cfg.attn_windows is None else
              [-1 if w is None else w for w in cfg.attn_windows],
              "rope_on": None if cfg.rope_layers is None else
              list(cfg.rope_layers)}
    for n, want in static.items():
        got = np_tree["layers"].get(n)
        got = None if got is None else np.asarray(got).tolist()
        if got != want:
            raise ValueError(f"layers.{n}: leaf {got} does not match "
                             f"{cfg.name}'s config ({want})")
    k = cfg.dense_prefix_layers
    if ("layers_dense" in np_tree) != bool(k):
        raise ValueError(f"{cfg.name}: a layers_dense tree goes with "
                         f"dense_prefix_layers={k}")
    segments = [(np_tree["layers"], k, cfg.num_layers - k)]
    if k:
        segments.insert(0, (np_tree["layers_dense"], 0, k))
    for tree, start, count in segments:
        stacked = (start, count)
        for n, p in tree.items():
            if n in LAYER_NORMS + POST_NORMS:
                norm(p, n, stacked)
            elif n in QK_NORMS + MLA_NORMS:
                leaf(p, n, ("scale",), stacked, ())
            elif n in LAYER_LINEARS + MLA_LINEARS + SHARED_LINEARS:
                leaf(p, n, lin_keys, stacked)
            elif n == "sinks":
                for i in range(count):
                    out[f"layers.{start + i}.sinks"] = _tensor(
                        np.asarray(p)[i], device)
            elif n == "router" and cfg.is_moe:
                leaf(p, n, ("w",), stacked, ("bias",))
            elif n == "experts" and cfg.is_moe:
                if set(p) != set(EXPERT_LEAVES):
                    raise ValueError(f"layers.experts: leaves {sorted(p)}")
                for e in EXPERT_LEAVES:
                    leaf(p[e], f"experts.{e}", lin_keys, stacked)
            elif n not in static:
                raise ValueError(f"layers.{n}: not a leaf the port serves")
    if "final_norm" in np_tree:
        norm(np_tree["final_norm"], "final_norm", False)
    if "lm_head" in np_tree:
        leaf(np_tree["lm_head"], "lm_head", lin_keys, False)
    markers = {n for n in out if n.endswith(".chunked")}
    if set(out) - markers != set(expect):
        raise ValueError(f"{cfg.name}: tree names differ from the config's: "
                         f"{sorted((set(out) - markers) ^ set(expect))[:6]}")
    for name, t in out.items():
        if name not in markers and tuple(t.shape) != expect[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{expect[name]} for {cfg.name}")
    return out


def param_count(params: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() for t in params.values())


def param_bytes(params: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in params.values())
