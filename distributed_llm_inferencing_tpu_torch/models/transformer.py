"""Causal transformer, every family of the reference, as torch ``nn.Module``s.

Port of the reference's ``models/transformer.py``: llama/mistral (and
the experts of mixtral, qwen3_moe, glm4_moe, ernie4_5_moe,
hunyuan_v1_moe, dbrx and gpt-oss), deepseek's latent attention, gpt2,
opt, qwen2, gemma, gpt-neox/pythia, phi, falcon, bloom, mpt and gpt-j.
One block
covers them through ModelConfig switches, as in the reference: RMSNorm
or LayerNorm; gated or plain MLP with silu, relu or gelu (tanh or
exact); biases on any linear; tied or untied head (the tied one reads
the embedding table, int8 or not); learned, rotary (full, partial or
interleaved) or ALiBi positions; sequential, parallel (one or two norms)
or post-norm residuals; gemma's embedding scale, bloom's embedding norm
and opt-350m's embedding projections. And the dense switches of the
later families (gemma2, qwen3, olmo2, glm4, cohere, granite, gpt-neo,
smollm3, exaone4, hunyuan, nemotron): q/k norms (per head, per head with
per-head scales, or over the flat projection; before or after RoPE),
per-layer windows (``attn_windows``) and per-layer NoPE
(``rope_layers``), the attention score softcap (in the kernels' cap arm)
and the final logit softcap, gemma2's sandwich norms
(``post_block_norms``) and olmo2's post-only norms
(``sublayer_postnorm_only``), granite's residual and cohere's logit
scales, and nemotron's squared ReLU. The reference runs its stacked
``[L, ...]`` layers under ``lax.scan`` and carries per-layer windows and
rope switches as traced leaves; here each layer is its own ``Block``
holding its window and rope switch as static values, and the stack is a
Python loop. The reference's two stacked segments of a mixed stack
(``layer_segments``: the dense-MLP prefix ``layers_dense`` ahead of the
MoE layers) are here the first ``dense_prefix_layers`` Blocks, each
built from ``cfg.dense_segment_cfg()``. dbrx's ``qkv_clip`` clamps q, k
and v after projection; gpt-oss's sinks join every softmax as a column
(ops/flash_attention.py ``masked_attention``), by the plain formulation
in every regime, as the reference routes them. A config outside the
served choices is refused at construction rather than served wrong
(``check_supported``).

Experts (the reference's ``_moe``): each MoE block holds a float router
[D, E] (with an f32 bias [E] for the deepseek_v3, ernie and topk_softmax
routers) and the stacked expert leaves gate/up [E, D, I] and down [E, I,
D] in the weights' stored form (``_ew``: float, or int8 / int4 levels
times the per-column scale applied to the product), with gpt-oss's [E,
out] biases; the four routers of ``moe_gates``; gpt-oss's clamped swish
GLU (``glu_h``); an always-on shared-experts MLP (``shared_gate/up/down``
linears) added outside the routing; then every expert for every token
weighted by its gate (``_moe_dense``), or GShard capacity dispatch
(``_moe_capacity``: C = max(1, int(cf * k * N / E)) slots per expert,
token-then-choice priority, a choice past its expert's C dropped) where N
counts every position of the padded input, as the reference's does;
``moe_dispatch="auto"`` is dense at N <= ``MOE_AUTO_DENSE_MAX_TOKENS``
(decode) and capacity above. Plain torch, as the reference's plain XLA.
The reference's capacity arm fails on quantized experts (it multiplies an
[E, C, I] product by the [E, I] scale); the port broadcasts the scale over
C (ROADMAP Queue C).

Multi-LoRA (the reference's ``_lora_apply``): a forward given ``lora``
(``LoRARows``: a stacked pack per projection and a slot per row) adds
each row's adapter delta (ops/lora.py ``gathered_delta``) after the q, k,
v, o, gate, up and down linears, over any weight form (an adapter over an
int4 base adds after ``q4_matmul``). A forward without it runs no delta
code at all. The fused decode kernel owns q end to end, so a pass with
adapter rows always takes the unfused route, as the reference's gate.

The int8 KV cache (``kv_quant="int8"``, the reference's): each block
quantizes its fresh K/V per (token, head) (ops/kvcache.py ``quant_kv``)
and writes levels and scales in place, in every cache regime. Prefill
attends the fresh K/V through the prefill kernel; decode attends the
dequantized cache by the plain formulation (dense: ``attend_decode``;
paged: ``gather_attend_decode``), where the reference pins a quantized
cache, so an int8 decode launches no ``flash_decode``,
``paged_flash_decode`` or ``fused_decode_step``. An int8 pool's decode
chunk keeps the reference's chunk semantics (its side-buffer
formulation, which for an int8 pool is not only a layout): the chunk's
own K/V stays in full-precision side buffers that its later steps
attend, and is quantized into the pool once, at the chunk's end
(``paged_chunk_flush``); a native pool's chunk writes every step in
place, as before.

Weight-only quantization (ops/quant.py): each linear (``Linear``, the
reference's ``_linear``) holds its leaf in the stored form — float
``w``, int8 ``q`` + ``scale`` (plain torch, as the reference leaves it
to XLA) or int4 ``p4`` + ``scale`` (``q4_linear``: the ``q4_matmul``
kernel at decode, ops/quant_matmul.py) — and its bias, added after the
product; ``Embed`` takes the per-row int8 table of ``embed_quant``.

Two attention regimes, as in the reference: prefill attends the fresh K/V
block (``attend_prefill``), decode attends the cache (``attend_decode``);
both write the new K/V into the cache in place first. ALiBi slopes and a
scaled RoPE ladder (``rope_inv_freq``: llama3, yarn, linear, longrope)
are built once per model, on its device, so a captured decode step
(runtime/graphs.py) copies nothing from the host.

Tensor parallelism (the model on one rank of a ``TPGroup``,
parallel/mesh.py, holding its shard of the weights, parallel/sharding.py;
every family): each ``Block`` runs its local heads, H/tp q heads and the
kv heads they read (``local_heads``; replicated when tp > Hkv), through
the same kernels, with the rank's slice of the ALiBi slopes and of the
sinks; latent attention runs its heads' columns of q_b (or q), kv_b_k and
kv_b_v over the replicated bottlenecks, its latent cache row whole on
every rank; dbrx's clip is elementwise. The row-parallel o, down and
``shared_down`` sum their partial products over the ranks in x's dtype
(the JAX package's ``psum``; int4 partials come from ``q4_matmul_row``)
and then add their replicated biases once; ``Embed`` looks up the rank's
vocabulary rows, zeros the rest and sums over the ranks; the head's
vocabulary columns (an untied head's bias with them) are gathered before
the logit scale and softcap. In bf16 an o or down output thus rounds
twice (each rank's partial, then their sum), where one device rounds
once: up to one more bf16 ulp per row-parallel linear, as in the JAX
package. chip_smoke.py holds tp=2 to tp=1 within its f32 cross-check
tolerance (the sums' order only) and, at full depth in bf16, within 1.5x
tp=1's error against f32.

Expert parallelism (``experts``: the expert group of the rank's tp × ep
cell, parallel/mesh.py): every rank computes the gates over all E
experts, and capacity dispatch's C and dispatch tensors over all E, as
one device does; it runs only its E/ep experts (``ExpertCut``), each on
its I/tp slice of the hidden width, adds down's expert bias on one tp
rank per ep slice, and the f32 partials are summed over the expert group
before the cast to the activation dtype (the reference's combine einsum
is f32). Everything else replicates over ep. Under sp a prefill chunk's
routed MLP runs over the whole block's positions (``Block._routed``), so
"auto" dispatch and C count them as the reference's GSPMD-global MLP
does.

The count rule per weight pass, on every rank of a tp or ep group: one
all-reduce for the embedding under tp; per layer, under tp, one for o and
one for down or, in an MoE block with shared experts, ``shared_down``
(none for an MoE block without them), or one for both in a
parallel-residual block (gpt-neox, gpt-j, phi, falcon: the sum of o's and
down's partials reduced at once, ``Block._tail_parallel_tp``), plus one
for "rms_full" q/k norms (q's and k's sums of squares together); per MoE
layer under tp or ep one ``expert_all_reduce`` over the expert group (and
under sp one ``expert_gather`` per prefill); and one gather of the head's
logits under tp.

The paged entry points serve the continuous batcher (runtime/batcher.py)
over the block pool (ops/paged_kvcache.py): ``paged_prefill_tail`` (a
wave of prompt tails, each attending its cached prefix),
``paged_decode_step`` (one token per slot; the fused q-projection kernel
behind ``DLI_FUSED_DECODE``, ops/fused_decode.py; ALiBi families decode
through the gather formulation, as in the reference) and
``paged_chunk_step`` (one step of a K-step chunk with sampling and the
per-slot budget/eos lifecycle on the device, over a static
``PagedChunkState``; one host sync per chunk) and ``paged_spec_step``
(one verify iteration of a speculative chunk over a static
``SpecChunkState``: on-device prompt-lookup drafts, gamma + 1 query rows
per slot attending the pool (gathered once per chunk under
``PREGATHER_MAX_BYTES``, else per layer) and the chunk's side buffers by
the plain formulation, as the reference's ``paged_speculative_chunk``
does, whose verify attention reaches no Pallas kernel; the kept entries
go to the pool in one scatter, ``paged_spec_flush``). The engine's
verify step (ops/speculative.py ``verify_step``) runs ``forward`` over a
block of gamma + 1 tokens, attended by ``attend_decode``'s multi-query
formulation.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.models.params import (
    EXPERT_LEAVES, layer_linears)
from distributed_llm_inferencing_tpu_torch.ops.quant import (
    leaf_form, leaf_keys, pack_chunks, unpack_int4)
from distributed_llm_inferencing_tpu_torch.ops import fused_decode
from distributed_llm_inferencing_tpu_torch.ops.attention import (
    alibi_slopes, attend_decode, attend_prefill)
from distributed_llm_inferencing_tpu_torch.ops.flash_attention import (
    masked_attention)
from distributed_llm_inferencing_tpu_torch.ops.kvcache import (
    KVCache, block_slots, dequant_kv, quant_kv, write_block)
from distributed_llm_inferencing_tpu_torch.ops.lora import gathered_delta
from distributed_llm_inferencing_tpu_torch.ops.norms import (
    Norm, qk_normalize)
from distributed_llm_inferencing_tpu_torch.ops.paged_kvcache import (
    PagedKVCache, gather_seq, one_per_place, paged_attend_decode,
    paged_attend_prefix, token_writers, write_block_run, write_token)
from distributed_llm_inferencing_tpu_torch.ops.quant_matmul import q4_linear
from distributed_llm_inferencing_tpu_torch.ops.rope import (
    apply_rope, rope_cos_sin, rotary_dim)
from distributed_llm_inferencing_tpu_torch.ops.sampling import sample_batch
from distributed_llm_inferencing_tpu_torch.ops.speculative import (
    accept_rejection_batch, propose_ngram_device)
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    MeshSpec, TPGroup)
from distributed_llm_inferencing_tpu_torch.parallel.ring import (
    SeqShard, ring_attend_decode, ring_attend_prefill)
from distributed_llm_inferencing_tpu_torch.parallel.sharding import (
    kv_weights, local_heads)
from distributed_llm_inferencing_tpu_torch.utils.device import torch_dtype

# The speculative chunk gathers the pool once per chunk when the gathered
# [L, R, MB*bs, Hkv, hd] K and V fit this (the JAX package's
# _PREGATHER_MAX_BYTES), else per layer inside each iteration.
PREGATHER_MAX_BYTES = 256 * 1024 * 1024

# the reference's token count at or below which "auto" dispatch runs the
# dense MoE path (_MOE_AUTO_DENSE_MAX_TOKENS): decode steps stay dense
MOE_AUTO_DENSE_MAX_TOKENS = 32


def _relu2(x):
    """Squared ReLU (nemotron)."""
    return torch.square(F.relu(x))


_ACT = {"silu": F.silu, "relu": F.relu, "relu2": _relu2,
        "gelu": functools.partial(F.gelu, approximate="tanh"),
        "gelu_exact": functools.partial(F.gelu, approximate="none")}
# field -> the values the port serves
_CHOICES = {"norm_type": ("rmsnorm", "layernorm"), "activation": tuple(_ACT),
            "position_embedding": ("rope", "learned", "alibi"),
            "qk_norm": (None, "rms_head", "ln_head", "rms_full"),
            "kv_quant": (None, "int8"),
            "moe_router": ("softmax", "deepseek_v3", "ernie", "topk_softmax"),
            "moe_dispatch": ("auto", "dense", "capacity")}


def check_supported(cfg: ModelConfig):
    """Raise for any config feature outside the ported families."""
    bad = [f"{f}={getattr(cfg, f)!r}" for f, ok in _CHOICES.items()
           if getattr(cfg, f) not in ok]
    for f in ("attn_windows", "rope_layers"):
        if getattr(cfg, f) is not None and \
                len(getattr(cfg, f)) != cfg.num_layers:
            bad.append(f"{f} of {len(getattr(cfg, f))} layers for "
                       f"num_layers={cfg.num_layers}")
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: not in the ported model families: {', '.join(bad)}")


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _leaf(params: Dict[str, torch.Tensor], prefix: str
          ) -> Dict[str, torch.Tensor]:
    """The tensors of one leaf of the flat dict: ``prefix.k`` -> ``k``."""
    n = len(prefix) + 1
    return {k[n:]: t for k, t in params.items()
            if k.startswith(prefix + ".")}


def _norm(cfg: ModelConfig, params, prefix: str) -> Norm:
    return Norm(_leaf(params, prefix), cfg.norm_type, cfg.norm_eps)


def _dtype_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: the reference multiplies a weakly
    typed Python scalar in the activation dtype."""
    return float(torch.tensor(value, dtype=dtype))


def layer_window(cfg: ModelConfig, i: int) -> Optional[int]:
    """Layer i's attention window (None: global): its ``attn_windows``
    entry, else the uniform ``sliding_window`` (the reference's
    ``_layer_window``, whose -1 is None here)."""
    if cfg.attn_windows is not None:
        return cfg.attn_windows[i]
    return cfg.sliding_window


def layer_rope(cfg: ModelConfig, i: int) -> bool:
    """Whether layer i rotates q/k (``rope_layers``: 0 = NoPE)."""
    return cfg.position_embedding == "rope" and (
        cfg.rope_layers is None or bool(cfg.rope_layers[i]))


@dataclasses.dataclass
class LoRARows:
    """The adapter of every row of a forward: ``pack`` maps each targeted
    projection to its stacked device pack ``{"a": [L, S, din, rmax], "b":
    [L, S, rmax, dout]}`` (the alpha / rank scale folded into B), ``ids``
    [B] each row's slot (0: the base model's zero slot). The batcher's
    pack holds every target at (slots + 1, ``DLI_LORA_MAX_RANK``); the
    engine's one adapter's targets at slot 0 and its own rank."""
    pack: Dict[str, Dict[str, torch.Tensor]]
    ids: torch.Tensor

    def layer(self, i: int, target: str) -> Dict[str, torch.Tensor]:
        p = self.pack[target]
        return {"a": p["a"][i], "b": p["b"][i]}


def _ew(operand, leaf: Dict[str, torch.Tensor], eq: str, scale_at=None,
        shards: int = 1):
    """Expert einsum ``eq`` of ``operand`` with a stacked expert leaf in
    its stored form (the reference's ``_ew``): float ``w``, or int8 /
    int4 levels in the operand's dtype with the [E, out] scale on the
    product, ``scale_at`` reshaping it to the product's layout. A
    chunk-local int4 down of which this rank holds one of ``shards`` din
    slices unpacks as that one chunk."""
    if "w" in leaf:
        return torch.einsum(eq, operand, leaf["w"])
    if "p4" in leaf:
        qw = unpack_int4(leaf["p4"], pack_chunks(leaf) // shards)
    else:
        qw = leaf["q"]
    y = torch.einsum(eq, operand, qw.to(operand.dtype))
    scale = leaf["scale"].to(operand.dtype)
    return y * (scale if scale_at is None else scale_at(scale))


def _wfull(leaf: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    """A linear leaf's weight in ``dtype`` with its scale applied (the
    reference's ``_wfull``): what latent attention's absorbed einsums
    read from ``kv_b_k`` / ``kv_b_v`` in any stored form."""
    if "w" in leaf:
        return leaf["w"].to(dtype)
    levels = (unpack_int4(leaf["p4"], pack_chunks(leaf)) if "p4" in leaf
              else leaf["q"])
    return levels.to(dtype) * leaf["scale"].to(dtype)


def moe_gates(x, router_w, cfg: ModelConfig, router_b=None):
    """Router gates [..., E] f32 (the reference's ``_moe_gates``).

    "softmax" (mixtral): softmax over the router logits, every expert
    whose probability reaches the k-th largest kept, renormalized over
    the kept ones with ``moe_norm_topk``. "deepseek_v3" (sigmoid scores)
    and "ernie" (softmax scores): the selection ranks scores + the
    router's bias ``router_b`` under group-limited top-k (groups scored
    by their top-2 sum, the top ``moe_topk_group`` groups eligible, the
    others masked with -inf, as the reference does where HF fills 0);
    the weights are the unbiased scores, renormalized with
    ``moe_norm_topk``, times ``moe_routed_scale``. "topk_softmax"
    (gpt-oss): the bias is part of the router linear; softmax over the k
    picks. Every tie with the k-th value is kept (``>=``), as there."""
    logits = torch.matmul(x.float(), router_w.float())
    k = cfg.num_experts_per_tok
    if cfg.moe_router in ("deepseek_v3", "ernie"):
        scores = (torch.sigmoid(logits) if cfg.moe_router == "deepseek_v3"
                  else torch.softmax(logits, dim=-1))
        choice = scores + router_b.float()
        g = cfg.moe_n_group
        gs = choice.reshape(*choice.shape[:-1], g, cfg.num_experts // g)
        group_scores = torch.topk(gs, 2, dim=-1).values.sum(dim=-1)
        gkth = torch.topk(group_scores, cfg.moe_topk_group,
                          dim=-1).values[..., -1:]
        eligible = (group_scores >= gkth)[..., None].expand(
            gs.shape).reshape(choice.shape)
        ranked = torch.where(eligible, choice, float("-inf"))
        kth = torch.topk(ranked, k, dim=-1).values[..., -1:]
        gate = torch.where((ranked >= kth) & eligible, scores, 0.0)
        if cfg.moe_norm_topk:
            gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-20)
        return gate * cfg.moe_routed_scale
    if cfg.moe_router == "topk_softmax":
        logits = logits + router_b.float()
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        sel = logits >= kth
        picked = torch.softmax(torch.where(sel, logits, float("-inf")),
                               dim=-1)
        return torch.where(sel, picked, 0.0)
    probs = torch.softmax(logits, dim=-1)
    kth = torch.topk(probs, k, dim=-1).values[..., -1:]
    gate = torch.where(probs >= kth, probs, 0.0)
    if cfg.moe_norm_topk:
        gate = gate / gate.sum(dim=-1, keepdim=True)
    return gate


def glu_h(gate, up, cfg: ModelConfig, act):
    """An expert's hidden activation (the reference's ``_glu_h``):
    act(gate) * up, or gpt-oss's clamped swish GLU — gate clamped above
    at ``moe_swiglu_limit``, up to +-limit, then (up + 1) * gate *
    sigmoid(alpha * gate)."""
    if cfg.moe_swiglu_limit is not None:
        lim = cfg.moe_swiglu_limit
        gate = torch.clamp(gate, max=lim)
        up = torch.clamp(up, -lim, lim)
        return (up + 1.0) * (gate * torch.sigmoid(
            cfg.moe_swiglu_alpha * gate))
    return act(gate) * up


def _expert_bias(y, leaf, at=None, on: bool = True):
    """``y`` plus the expert leaf's [E, out] bias (gpt-oss), ``at``
    reshaping it to y's layout; y as it is without one, or when not
    ``on``."""
    if "b" not in leaf or not on:
        return y
    return y + (leaf["b"] if at is None else at(leaf["b"]))


@dataclasses.dataclass(frozen=True)
class ExpertCut:
    """What of the routed experts one rank holds (parallel/sharding.py):
    experts [lo, lo + E/ep) of the gates' columns, each one ``shards``-th
    of their hidden width (tp), and whether it adds down's expert bias
    (``down_bias``: one tp rank per ep slice, so the sum over the
    expert group counts it once)."""
    lo: int = 0
    shards: int = 1
    down_bias: bool = True


WHOLE = ExpertCut()


def _expert_hidden(xin, experts, cfg, act, eq, at=None, cut=WHOLE):
    """down(glu(gate(x), up(x))) of every held expert, before the gate
    weights: [..., E_l, D] in xin's dtype (this rank's partial product
    under tp)."""
    g = _expert_bias(_ew(xin, experts["gate"], eq[0], at), experts["gate"],
                     at)
    u = _expert_bias(_ew(xin, experts["up"], eq[0], at), experts["up"], at)
    return _expert_bias(_ew(glu_h(g, u, cfg, act), experts["down"], eq[1],
                            at, cut.shards), experts["down"], at,
                        cut.down_bias)


def _held(experts) -> int:
    """The experts a rank holds: the leading axis of its leaves."""
    return next(iter(experts["down"].values())).shape[0]


def moe_dense(x, router_w, experts, cfg: ModelConfig, act, router_b=None,
              cut: ExpertCut = WHOLE):
    """Every expert for every token, weighted by its gate (the
    reference's ``_moe_dense``): no permutation and no drops, E/k times
    the FLOPs of a dispatch, the trade at decode's token counts. The
    gates span every expert; the rank's ``cut`` runs its own. Returns
    the f32 combine [..., D] (under ep or tp this rank's partial)."""
    gate = moe_gates(x, router_w, cfg, router_b)
    out = _expert_hidden(x, experts, cfg, act,
                         ("...d,edi->...ei", "...ei,eid->...ed"), cut=cut)
    return torch.einsum("...ed,...e->...d", out.float(),
                        gate[..., cut.lo:cut.lo + _held(experts)])


def moe_capacity(x, router_w, experts, cfg: ModelConfig, act,
                 router_b=None, cut: ExpertCut = WHOLE):
    """GShard capacity dispatch (the reference's ``_moe_capacity``): each
    expert takes at most C = max(1, int(cf * k * N / E)) of the N
    positions of ``x`` (padding positions compete too), in token order,
    then choice order; a choice past its expert's capacity is dropped
    (the token's other choices still apply). C and the dispatch count
    every expert; the rank's ``cut`` runs its own slots. Returns the f32
    combine [..., D] (under ep or tp this rank's partial)."""
    *lead, d = x.shape
    xf = x.reshape(-1, d)
    n = xf.shape[0]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    c = max(1, int(cfg.moe_capacity_factor * k * n / e))
    gate = moe_gates(xf, router_w, cfg, router_b)            # [N, E]
    gate_vals, gate_idx = torch.topk(gate, k, dim=-1)        # [N, k]
    onehot = F.one_hot(gate_idx, e).float()                  # [N, k, E]
    flat = onehot.reshape(n * k, e)
    pos = (torch.cumsum(flat, dim=0) * flat - 1.0).reshape(n, k, e)
    keep = (pos >= 0) & (pos < c)
    slot = pos.clamp(0, c - 1).long()
    combine = torch.einsum("nke,nkec->nec",
                           onehot * gate_vals[..., None] * keep,
                           F.one_hot(slot, c).float())       # [N, E, C]
    combine = combine[:, cut.lo:cut.lo + _held(experts)]
    dispatch = (combine > 0).to(x.dtype)
    ex_in = torch.einsum("nec,nd->ecd", dispatch, xf)        # [E, C, D]
    per_slot = functools.partial(torch.unsqueeze, dim=1)     # [E, 1, out]
    out = _expert_hidden(ex_in, experts, cfg, act,
                         ("ecd,edi->eci", "eci,eid->ecd"), per_slot, cut)
    y = torch.einsum("ecd,nec->nd", out.float(), combine)
    return y.reshape(*lead, d)


def moe(x, router_w, experts, cfg: ModelConfig, act, router_b=None,
        group=None):
    """The routed MLP by ``cfg.moe_dispatch``: "auto" is dense at N <=
    ``MOE_AUTO_DENSE_MAX_TOKENS`` positions and capacity above. Under ep
    or tp (``group``: the expert group, parallel/mesh.py) each rank runs
    its cut and the f32 partials are summed over the group before the
    cast to x's dtype, as the reference's f32 combine einsum sums every
    expert before its cast."""
    mode = cfg.moe_dispatch
    if mode == "auto":
        n = 1
        for size in x.shape[:-1]:
            n *= size
        mode = "dense" if n <= MOE_AUTO_DENSE_MAX_TOKENS else "capacity"
    fn = moe_capacity if mode == "capacity" else moe_dense
    if group is None:
        return fn(x, router_w, experts, cfg, act, router_b).to(x.dtype)
    group.note_route(x)
    cut = ExpertCut(lo=group.ep_rank * _held(experts),
                    shards=group.world // group.ep,
                    down_bias=group.tp_rank == 0)
    y = fn(x, router_w, experts, cfg, act, router_b, cut)
    y = group.all_reduce(y, key="expert_all_reduce")
    return y.to(x.dtype)


class Linear(nn.Module):
    """y = x @ W (+ b) in x's dtype, W [din, dout] (the reference layout)
    held in its stored form (the reference's ``_linear``): ``{"w"}``
    float, ``{"q", "scale"}`` int8 — ``x @ q.to(x.dtype) *
    scale.to(x.dtype)``, or ``{"p4", "scale"[, "chunked"]}`` int4 —
    ``q4_linear``; a bias ``b`` is added after the product. A
    row-parallel linear under tp (``tp`` given) holds a din shard: its
    ``partial`` product is summed over the ranks, and ``finish`` adds the
    replicated bias once, after the sum."""

    def __init__(self, leaf: Dict[str, torch.Tensor],
                 tp: Optional[TPGroup] = None):
        super().__init__()
        self.form = leaf_form(leaf)
        self.keys = leaf_keys(leaf)
        self.tp = tp
        self.b = None
        for k, t in leaf.items():
            setattr(self, k, _param(t))

    def leaf(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in self.keys}

    def partial(self, x):
        """x @ W in x's dtype, no bias: under tp, this rank's share of a
        row-parallel product."""
        if self.form == "int4":
            return q4_linear(x, self.leaf(), self.tp.world if self.tp else 1)
        if self.form == "int8":
            y = torch.matmul(x, self.q.to(x.dtype))
            return (y * self.scale.to(x.dtype)).to(x.dtype)
        return torch.matmul(x, self.w).to(x.dtype)

    def finish(self, y):
        """The sum of ``y`` over the ranks (under tp), then the bias."""
        if self.tp is not None:
            y = self.tp.all_reduce(y)
        return y if self.b is None else (y + self.b).to(y.dtype)

    def forward(self, x):
        return self.finish(self.partial(x))


class Embed(nn.Module):
    """Token embedding (the reference's ``embed``): from a float table, or
    from the per-row int8 table ``{"q8", "rscale"}`` (whole int8 rows
    gathered, then one scalar multiply per row); then gemma's
    ``embed_scale``, opt-350m's ``project_in``, the learned positions
    (clipped to the table) and bloom's embedding norm. Under tp the rank
    holds rows [rank·V/tp, (rank+1)·V/tp): ids outside them give zero
    rows, and one sum over the ranks (exact: one rank's row is not zero)
    assembles the embedding; the scale, the projection, the positions and
    the norm (all replicated) follow the sum."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, torch.Tensor],
                 dtype: torch.dtype, tp: Optional[TPGroup] = None,
                 table_only: bool = False):
        super().__init__()
        self.quantized = "embed.tokens" not in params
        if self.quantized:
            table = _leaf(params, "embed.tokens")
            self.q8, self.rscale = (_param(table[k]) for k in ("q8", "rscale"))
        else:
            self.tokens = _param(params["embed.tokens"])
        self.dtype = dtype
        self.tp = tp
        self.rows = (self.q8 if self.quantized else self.tokens).shape[0]
        # the reference multiplies by the scale in the activation dtype
        self.scale = (None if cfg.embed_scale is None else
                      float(torch.tensor(cfg.embed_scale, dtype=dtype)))
        # the last pp stage of a tied head holds the table alone
        self.project_in = (Linear(_leaf(params, "embed.project_in"))
                           if cfg.embed_proj_dim and not table_only else None)
        self.positions = (_param(params["embed.positions"])
                          if cfg.position_embedding == "learned"
                          and not table_only else None)
        self.norm = (_norm(cfg, params, "embed.norm")
                     if cfg.embed_norm and not table_only else None)

    def forward(self, token_ids, positions):
        inside = None
        if self.tp is not None:
            token_ids = token_ids - self.tp.rank * self.rows
            inside = (token_ids >= 0) & (token_ids < self.rows)
            token_ids = torch.where(inside, token_ids, 0)
        if self.quantized:
            x = self.q8[token_ids].to(self.dtype)
            x = x * self.rscale[token_ids][..., None].to(self.dtype)
        else:
            x = F.embedding(token_ids, self.tokens).to(self.dtype)
        if inside is not None:
            x = self.tp.all_reduce(torch.where(inside[..., None], x, 0))
        if self.scale is not None:   # the embedding output only
            x = x * self.scale
        if self.project_in is not None:
            x = self.project_in(x)
        if self.positions is not None:
            pos = positions.long().clamp(0, self.positions.shape[0] - 1)
            x = x + self.positions[pos].to(x.dtype)
        return x if self.norm is None else self.norm(x)


class Block(nn.Module):
    """Norm -> QKV (q/k norms, RoPE) -> cache write + attend -> o ->
    residual and MLP (the reference's ``_block_body`` + ``_block_tail``).
    One method per cache regime; each writes its K/V in place, and all
    share ``_tail``, so the regimes cannot drift apart. Layer ``index``'s
    window (``layer_window``) and rope switch (``layer_rope``) are static
    values of the block: a captured decode step bakes them in. ``cfg`` is
    the layer's config (``ModelConfig.layer_cfg``): a dense-prefix layer
    of a mixed stack is a dense-MLP block.

    Latent attention (``cfg.mla``, the reference's ``_mla_qkv``): q and
    kv pass through low-rank bottlenecks with an RMSNorm at each, per-head
    dims ordered [rope | nope], k's rope part computed once and shared by
    every head, v zero-padded from ``v_head_dim`` to ``head_dim`` so every
    cache and attention path keeps one width, and sliced back before o.
    Its attention takes the plain formulation in every regime, as the
    reference's ``_cfg_backend`` routes it. Over the engine's latent cache
    (``cfg.mla_latent_cache``) the block writes one [k_rot | c] row per
    token: prefill attends materialized K/V, decode the absorbed
    formulation (``_latent_attend``). Sinks (``cfg.attn_sinks``) ride
    every attention call, which then takes the plain formulation too."""

    def __init__(self, cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 tp: Optional[TPGroup] = None, alibi=None, index: int = 0,
                 dtype: torch.dtype = torch.float32,
                 seq: Optional[SeqShard] = None, experts=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.seq = seq
        spec = MeshSpec(tp=tp.world if tp else 1)
        # this rank's q heads and the kv heads they read
        self.heads, self.kv_heads = local_heads(cfg, spec)
        # "rms_full" under replication: each global kv head's square
        # counted once in the sum over the ranks
        self.k_weight = None
        if tp is not None and cfg.qk_norm == "rms_full":
            w = kv_weights(cfg, tp.world, tp.rank)
            if any(x != 1.0 for x in w):
                self.k_weight = torch.tensor(
                    w, dtype=torch.float32,
                    device=p["attn_norm.scale"].device)[:, None]
        self.attn_norm = _norm(cfg, p, "attn_norm")
        self.mlp_norm = (None if cfg.shared_attn_mlp_norm
                         else _norm(cfg, p, "mlp_norm"))
        self.attn_post_norm = self.mlp_post_norm = None
        if cfg.post_block_norms:   # gemma2 / glm4 sandwich
            self.attn_post_norm = _norm(cfg, p, "attn_post_norm")
            self.mlp_post_norm = _norm(cfg, p, "mlp_post_norm")
        self.q_norm = self.k_norm = None
        if cfg.qk_norm:
            self.q_norm = _param(p["q_norm.scale"])
            self.k_norm = _param(p["k_norm.scale"])
        self.q_a_norm = self.kv_a_norm = None
        if cfg.mla:   # the bottlenecks' RMSNorms
            if cfg.q_lora_rank:
                self.q_a_norm = Norm(_leaf(p, "q_a_norm"), "rmsnorm",
                                     cfg.norm_eps)
            self.kv_a_norm = Norm(_leaf(p, "kv_a_norm"), "rmsnorm",
                                  cfg.norm_eps)
        self.sinks = _param(p["sinks"]) if cfg.attn_sinks else None
        # the plain attention formulation on every device (latent
        # attention; sinks pass their column and take it by themselves)
        self.plain = cfg.mla
        self.gate = None
        for n, *_ in layer_linears(cfg):
            setattr(self, n, Linear(_leaf(p, n), tp if n in (
                "o", "down", "shared_down") else None))
        self.router = self.router_b = self.experts = None
        # the tp x ep ranks that sum the routed experts' partials
        self.expert_group = experts if cfg.is_moe else None
        if cfg.is_moe:
            self.router = _param(p["router.w"])
            if "router.bias" in p:
                self.router_b = _param(p["router.bias"])
            self.experts = {n: _leaf(p, f"experts.{n}")
                            for n in EXPERT_LEAVES}
        self.index = index
        self.act = _ACT[cfg.activation]
        self.alibi = alibi                # [H] f32 on the device, or None
        self.window = layer_window(cfg, index)
        self.rope_on = layer_rope(cfg, index)
        self.residual_scale = (None if cfg.residual_scale is None else
                               _dtype_scalar(cfg.residual_scale, dtype))

    def _rope(self, t, cos_sin):
        if not self.rope_on:
            return t
        cfg = self.cfg
        return apply_rope(t, None, cfg.rope_theta, cfg.rope_pct,
                          cfg.rope_interleaved, cos_sin=cos_sin)

    def _norm_qk(self, q, k):
        """The q/k norms of q and k [B,s,heads,hd]. "rms_full" under tp
        normalizes over every rank's heads: one all-reduce carries the
        sums of squares of both (k's weighted per kv head under
        replication, ``kv_weights``)."""
        cfg = self.cfg
        if cfg.qk_norm != "rms_full" or self.tp is None:
            return (qk_normalize(q, self.q_norm, cfg.qk_norm, cfg.norm_eps),
                    qk_normalize(k, self.k_norm, cfg.qk_norm, cfg.norm_eps))
        kk = k.float().square()
        if self.k_weight is not None:
            kk = kk * self.k_weight
        ss = self.tp.all_reduce(torch.stack(
            [q.float().square().sum(dim=(-2, -1)), kk.sum(dim=(-2, -1))],
            dim=-1))
        return (qk_normalize(q, self.q_norm, "rms_full", cfg.norm_eps,
                             ms=ss[..., 0:1] / cfg.q_dim),
                qk_normalize(k, self.k_norm, "rms_full", cfg.norm_eps,
                             ms=ss[..., 1:2] / cfg.kv_dim))

    def _qk_pos(self, q, k, cos_sin):
        """q and k after their projections: the q/k norms (before RoPE,
        or after it with ``qk_norm_after_rope``) and this layer's RoPE."""
        cfg = self.cfg
        norm = cfg.qk_norm is not None
        if norm and not cfg.qk_norm_after_rope:
            q, k = self._norm_qk(q, k)
        q, k = self._rope(q, cos_sin), self._rope(k, cos_sin)
        if norm and cfg.qk_norm_after_rope:
            q, k = self._norm_qk(q, k)
        return q, k

    def _proj(self, name: str, x, lora: Optional[LoRARows]):
        """Linear ``name`` of x, plus the rows' adapter delta when
        ``lora`` targets it (the reference's ``_lora_apply``)."""
        y = getattr(self, name)(x)
        if lora is None or name not in lora.pack:
            return y
        return y + gathered_delta(x, lora.layer(self.index, name), lora.ids)

    def _clip(self, t):
        """dbrx's ``clip_qkv``: q, k and v clamped after projection,
        before the q/k norms and RoPE."""
        c = self.cfg.qkv_clip
        return t if c is None else torch.clamp(t, -c, c)

    def _kv_raw(self, h, lora=None):
        cfg = self.cfg
        B, s, _ = h.shape
        k = self._proj("k", h, lora).view(B, s, self.kv_heads, cfg.head_dim)
        v = self._proj("v", h, lora).view(B, s, self.kv_heads, cfg.head_dim)
        return self._clip(k), self._clip(v)

    def _kv(self, h, cos_sin):
        """k (RoPE'd) and v alone: the fused decode route, whose kernel
        owns q (no q/k norms there, ``fused_decode.supported``)."""
        k, v = self._kv_raw(h)
        return self._rope(k, cos_sin), v

    def _qkv(self, h, cos_sin, lora=None):
        if self.cfg.mla:
            return self._mla_qkv(h, cos_sin)
        B, s, _ = h.shape
        q = self._clip(self._proj("q", h, lora).view(B, s, self.heads,
                                                     self.cfg.head_dim))
        k, v = self._kv_raw(h, lora)
        q, k = self._qk_pos(q, k, cos_sin)
        return q, k, v

    def _rope_rot(self, t, cos_sin):
        """RoPE over the whole (rope-wide) last axis of ``t``."""
        return apply_rope(t, None, self.cfg.rope_theta, 1.0,
                          self.cfg.rope_interleaved, cos_sin=cos_sin)

    def _mla_q(self, h, cos_sin):
        """Latent attention's q [B,s,H,hd], per-head [rope | nope], the
        rope slice rotated (the reference's ``_mla_q``)."""
        cfg = self.cfg
        B, s, _ = h.shape
        rd = cfg.qk_rope_head_dim
        if cfg.q_lora_rank:
            q = self.q_b(self.q_a_norm(self.q_a(h)))
        else:
            q = self.q(h)
        q = q.view(B, s, self.heads, cfg.head_dim)
        return torch.cat([self._rope_rot(q[..., :rd], cos_sin), q[..., rd:]],
                         dim=-1)

    def _mla_kv_latent(self, h, cos_sin):
        """(k_rot [B,s,1,rd] rotated, c [B,s,r] normed): the kv
        bottleneck (the reference's ``_mla_kv_latent``)."""
        r = self.cfg.kv_lora_rank
        ckv = self.kv_a(h)
        return (self._rope_rot(ckv[..., r:][:, :, None, :], cos_sin),
                self.kv_a_norm(ckv[..., :r]))

    def _mla_qkv(self, h, cos_sin):
        """Materialized latent attention: q, k, v [B,s,H,hd], k's rope
        part shared by the heads, v zero-padded to hd."""
        cfg = self.cfg
        B, s, _ = h.shape
        H, hd, rd = self.heads, cfg.head_dim, cfg.qk_rope_head_dim
        vd = cfg.v_head_dim_effective
        q = self._mla_q(h, cos_sin)
        k_rot, c = self._mla_kv_latent(h, cos_sin)
        k = torch.cat([k_rot.expand(B, s, H, rd),
                       self.kv_b_k(c).view(B, s, H, hd - rd)], dim=-1)
        v = self.kv_b_v(c).view(B, s, H, vd)
        if vd < hd:
            v = F.pad(v, (0, hd - vd))
        return q, k, v

    def _latent_attend(self, h, cache, slots, cos_sin, new_lengths,
                       is_prefill: bool, q_positions=None):
        """Latent attention over the latent cache (the reference's
        ``_mla_latent_attn``): write the block's [k_rot | c] rows, then
        attend — prefill with materialized per-head K/V over the fresh
        block, decode by the absorbed formulation: q_nope folded through
        kv_b_k, MQA over the (rd + r)-wide rows with v their c slice, at
        the materialized head_dim's score scale, and the context lifted
        through kv_b_v. Returns attn [B,s,H,v_head_dim]."""
        cfg = self.cfg
        B, s, _ = h.shape
        H, hd, rd = self.heads, cfg.head_dim, cfg.qk_rope_head_dim
        r, nd = cfg.kv_lora_rank, cfg.qk_nope_head_dim
        vd = cfg.v_head_dim_effective
        q = self._mla_q(h, cos_sin)
        k_rot, c = self._mla_kv_latent(h, cos_sin)
        ck = cache[0]
        write_block(ck, torch.cat([k_rot, c[:, :, None, :]], dim=-1), None,
                    slots)
        wk = _wfull(self.kv_b_k.leaf(), q.dtype).view(r, H, nd)
        wv = _wfull(self.kv_b_v.leaf(), q.dtype).view(r, H, vd)
        if is_prefill:
            k = torch.cat([k_rot.expand(B, s, H, rd),
                           torch.einsum("bsr,rhn->bshn", c, wk)], dim=-1)
            v = torch.einsum("bsr,rhv->bshv", c, wv)
            if vd < hd:
                v = F.pad(v, (0, hd - vd))
            return attend_prefill(q, k, v, plain=True)[..., :vd]
        q_eff = torch.cat([q[..., :rd], torch.einsum(
            "bshn,rhn->bshr", q[..., rd:], wk)], dim=-1)
        ctx = attend_decode(q_eff, ck, ck[..., rd:], new_lengths,
                            q_positions=q_positions, plain=True,
                            scale=1.0 / float(hd) ** 0.5)     # [B,s,H,r]
        return torch.einsum("bshr,rhv->bshv", ctx, wv)

    def _in(self, x):
        """The attention input: the block input, normed first unless the
        block is post-norm or normalizes its sublayer outputs only."""
        cfg = self.cfg
        if cfg.post_norm or cfg.sublayer_postnorm_only:
            return x
        return self.attn_norm(x)

    def _scaled(self, y):
        return y if self.residual_scale is None else y * self.residual_scale

    def _routed(self, h, whole: bool):
        """The routed experts of h. ``whole`` (an sp prefill, h this
        rank's chunk of the block): the dispatch decides dense or
        capacity, and counts capacity, over the whole block's positions,
        as the reference's GSPMD-global MLP does; the chunks are
        assembled over the sp group (one exact sum of zero-padded
        chunks, ``expert_gather``), routed, and this rank keeps its own
        rows."""
        route = functools.partial(moe, router_w=self.router,
                                  experts=self.experts, cfg=self.cfg,
                                  act=self.act, router_b=self.router_b,
                                  group=self.expert_group)
        if not whole:
            return route(h)
        sh = self.seq
        B, c, D = h.shape
        full = h.new_zeros(B, c * sh.world, D)
        full[:, sh.rank * c:(sh.rank + 1) * c] = h
        full = sh.group.all_reduce(full, key="expert_gather")
        return route(full)[:, sh.rank * c:(sh.rank + 1) * c]

    def _mlp(self, h, lora=None, partial: bool = False,
             whole: bool = False):
        """The MLP of h; with ``partial`` (tp's fused parallel residual)
        down's partial product, before its sum and bias; ``whole``: the
        routed experts count an sp prefill's whole block
        (``_routed``)."""
        if self.router is not None:
            out = self._routed(h, whole)
            if self.cfg.moe_shared_experts:   # always on, outside routing
                out = out + self.shared_down(
                    self.act(self.shared_gate(h)) * self.shared_up(h))
            return out
        if self.gate is not None:
            a = (self.act(self._proj("gate", h, lora))
                 * self._proj("up", h, lora))
        else:
            a = self.act(self._proj("up", h, lora))
        if partial:
            return self.down.partial(a)
        return self._proj("down", a, lora)

    def _tail(self, x, h, attn, lora=None, whole: bool = False):
        """o projection, then the residual topology and the MLP (the
        reference's ``_block_tail``): parallel (attention and MLP read
        the same input, one residual add; one shared norm or two),
        sequential pre-norm, or post-norm (each residual sum normed).
        Each sublayer output is normed by the sandwich norm
        (``post_block_norms``) or, post-only, by the block's own norm
        (``sublayer_postnorm_only``: x + norm(f(x))), then scaled by
        ``residual_scale``, before its residual add. Under tp a parallel
        block with no sublayer norm and no residual scale (every parallel
        family) sums o's and down's partial products over the ranks in
        one all-reduce (``_tail_parallel_tp``). ``whole``: an sp prefill
        chunk, whose routed experts count the whole block (``_routed``)."""
        cfg = self.cfg
        B, s = attn.shape[:2]
        vd = cfg.v_head_dim_effective   # latent attention's v rode padded
        attn = attn[..., :vd].reshape(B, s, self.heads * vd)
        if (self.tp is not None and cfg.parallel_residual
                and self.attn_post_norm is None
                and not cfg.sublayer_postnorm_only
                and self.residual_scale is None):
            return self._tail_parallel_tp(x, h, attn)
        attn = self._proj("o", attn, lora)
        if self.attn_post_norm is not None:
            attn = self.attn_post_norm(attn)
        elif cfg.sublayer_postnorm_only:
            attn = self.attn_norm(attn)
        attn = self._scaled(attn)
        if cfg.parallel_residual:
            h2 = h if self.mlp_norm is None else self.mlp_norm(x)
            return x + attn + self._scaled(self._mlp(h2, lora, whole=whole))
        x = x + attn
        if cfg.post_norm:
            x = self.attn_norm(x)
        m = self._mlp(x if cfg.post_norm or cfg.sublayer_postnorm_only
                      else self.mlp_norm(x), lora, whole=whole)
        if self.mlp_post_norm is not None:
            m = self.mlp_post_norm(m)
        elif cfg.sublayer_postnorm_only:
            m = self.mlp_norm(m)
        x = x + self._scaled(m)
        return self.mlp_norm(x) if cfg.post_norm else x

    def _tail_parallel_tp(self, x, h, attn):
        """A parallel-residual block under tp: x + o(attn) + mlp(h2), with
        the sum of o's and down's partial products reduced over the ranks
        at once (one all-reduce per layer where two sublayers would take
        two, and half the bytes of reducing both), then o's and down's
        biases added once each."""
        h2 = h if self.mlp_norm is None else self.mlp_norm(x)
        y = self.tp.all_reduce(self.o.partial(attn)
                               + self._mlp(h2, partial=True))
        for b in (self.o.b, self.down.b):
            if b is not None:
                y = (y + b).to(x.dtype)
        return x + y

    @staticmethod
    def _write(write, cache, k, v):
        """Write fresh K/V [B,s,Hkv,hd] into ``cache`` (k, v, k_scale,
        v_scale; the scales None for a native cache) through ``write(layer,
        new)``; an int8 cache gets ``quant_kv``'s levels and scales."""
        ck, cv, cks, cvs = cache
        if cks is not None:
            k, ks = quant_kv(k)
            v, vs = quant_kv(v)
            write(cks, ks)
            write(cvs, vs)
        write(ck, k)
        write(cv, v)

    def forward(self, x, cache, slots, cos_sin, new_lengths,
                is_prefill: bool, q_positions=None, lora=None,
                positions=None):
        """``cache``: this layer's (k, v, k_scale, v_scale) views;
        ``q_positions`` [B, s]: a multi-token decode block's positions
        (speculative verification); ``lora``: the rows' adapters;
        ``positions`` [B, s]: the block's positions (under sp, this
        rank's chunk's)."""
        h = self._in(x)
        if self.cfg.mla_latent_cache:
            attn = self._latent_attend(h, cache, slots, cos_sin, new_lengths,
                                       is_prefill, q_positions)
            return self._tail(x, h, attn, lora)
        q, k, v = self._qkv(h, cos_sin, lora)
        if self.seq is not None:
            return self._tail(x, h, self._seq_attend(
                q, k, v, cache, new_lengths, is_prefill, positions), lora,
                whole=is_prefill)
        self._write(lambda c, n: write_block(c, n, None, slots), cache, k, v)
        cap = self.cfg.attn_softcap
        if is_prefill:
            attn = attend_prefill(q, k, v, sliding_window=self.window,
                                  alibi=self.alibi, softcap=cap,
                                  sinks=self.sinks, plain=self.plain)
        else:
            attn = attend_decode(q, cache[0], cache[1], new_lengths,
                                 sliding_window=self.window,
                                 alibi=self.alibi, softcap=cap,
                                 k_scale=cache[2], v_scale=cache[3],
                                 q_positions=q_positions, sinks=self.sinks,
                                 plain=self.plain)
        return self._tail(x, h, attn, lora)

    def _seq_attend(self, q, k, v, cache, new_lengths, is_prefill: bool,
                    positions):
        """Attention under sp (parallel/ring.py) over this rank's cache
        shard, which holds positions [lo, lo + cache_len): a prefill
        chunk's ring, each visiting chunk written where its positions
        fall in the shard; or one decode token, written on the rank
        that owns its position (the others keep their slot's bits), then
        the combined partials. The prefill attends the fresh K/V, the
        decode the (dequantized) shard, as the single-rank regimes do."""
        sh, cap = self.seq, self.cfg.attn_softcap
        if is_prefill:
            c = q.shape[1]
            valid = positions < new_lengths.long()[:, None]

            def write_chunk(kc, vc, origin):
                at = sh.owned(origin, c)
                if at is not None:
                    src, dst = at
                    self._write(lambda t, n: t[:, dst].copy_(
                        n[:, src].to(t.dtype)), cache, kc, vc)

            return ring_attend_prefill(
                q, k, v, positions, valid, sh, sliding_window=self.window,
                alibi=self.alibi, softcap=cap, on_chunk=write_chunk)
        B = q.shape[0]
        slot = new_lengths.long() - 1 - sh.lo
        own = (slot >= 0) & (slot < sh.cache_len)
        slot = slot.clamp(0, sh.cache_len - 1)
        rows = torch.arange(B, device=q.device)

        def write_token(t, n):
            keep = own.view(-1, *([1] * (n.dim() - 2)))
            t[rows, slot] = torch.where(keep, n[:, 0].to(t.dtype),
                                        t[rows, slot])

        self._write(write_token, cache, k, v)
        ck, cv, cks, cvs = cache
        if cks is not None:
            ck, cv = (dequant_kv(ck, cks, q.dtype),
                      dequant_kv(cv, cvs, q.dtype))
        return ring_attend_decode(q, ck, cv, new_lengths, sh,
                                  sliding_window=self.window,
                                  alibi=self.alibi, softcap=cap)

    def paged_prefill(self, x, cache, cos_sin, tail_blocks, prefix_blocks,
                      prefix_len, q_positions, tail_valid, lora=None):
        """A wave of prompt tails: write their K/V into ``tail_blocks``,
        attend the cached prefix plus the tail (plain torch, as in the
        reference). ``cache``: this layer's pool views (``PagedKVCache.
        layer``)."""
        h = self._in(x)
        q, k, v = self._qkv(h, cos_sin, lora)
        self._write(lambda c, n: write_block_run(c, n, tail_blocks), cache,
                    k, v)
        attn = paged_attend_prefix(q, k, v, cache[0], cache[1],
                                   prefix_blocks, prefix_len, q_positions,
                                   tail_valid, sliding_window=self.window,
                                   alibi=self.alibi,
                                   softcap=self.cfg.attn_softcap,
                                   k_scale_layer=cache[2],
                                   v_scale_layer=cache[3], sinks=self.sinks)
        return self._tail(x, h, attn, lora)

    def paged_decode(self, x, cache, cos_sin, block_tables, context_lens,
                     fused: bool = False, fused_rope=None, lora=None,
                     writers=None):
        """One token per slot at position ``context_lens``. With ``fused``
        and a q leaf the fused kernel takes (``fused_decode.supported``:
        no bias), the q projection (in the leaf's stored form), RoPE
        (``fused_rope``: (cos, sin) rows of ops/fused_decode.py, None
        without rotary) and attention run in that kernel, which reads
        this token's K/V back from the pool (the reference's
        ``fused_q_attend``); otherwise ``paged_attend_decode`` attends
        q."""
        h = self._in(x)
        q_leaf = self.q.leaf() if fused else None
        fused = fused and fused_decode.supported(self.cfg, q_leaf)
        if fused:
            k, v = self._kv(h, cos_sin)
        else:
            q, k, v = self._qkv(h, cos_sin, lora)
        self._write(lambda c, n: write_token(c, n[:, 0], block_tables,
                                             context_lens, writers),
                    cache, k, v)
        ck, cv = cache[:2]
        new_lens = context_lens + 1
        if fused:
            cos, sin = fused_rope or (None, None)
            attn = fused_decode.fused_decode_step(
                h[:, 0], q_leaf, ck, cv, block_tables, new_lens,
                rope_cos=cos, rope_sin=sin,
                sliding_window=self.window)[:, None]
        else:
            attn = paged_attend_decode(q, ck, cv, block_tables, new_lens,
                                       sliding_window=self.window,
                                       alibi=self.alibi,
                                       softcap=self.cfg.attn_softcap,
                                       k_scale_layer=cache[2],
                                       v_scale_layer=cache[3],
                                       sinks=self.sinks, plain=self.plain)
        return self._tail(x, h, attn, lora)

    def paged_side(self, x, cache, cos_sin, block_tables, q_pos, side_k,
                   side_v, off, kv_pos, kv_valid, pool=None, lora=None):
        """A decode chunk's step for this layer in the side-buffer
        formulation (an int8 pool's plain chunk, the speculative chunk):
        the block's fresh K/V [R, s, Hkv, hd] goes to entries ``off`` [s]
        of the chunk's side buffers ``side_k``/``side_v`` [R, E, Hkv, hd]
        (compute dtype); q attends the pool's blocks (``pool``: this
        layer's (k, v) gathered once per chunk, else gathered here, an
        int8 pool dequantized) and then the side entries, by the plain
        formulation over ``kv_pos``/``kv_valid`` (the pool below the
        chunk's start, the side entries it keeps). The pool is not
        written: the chunk's flush does that."""
        h = self._in(x)
        q, k, v = self._qkv(h, cos_sin, lora)
        side_k.index_copy_(1, off, k.to(side_k.dtype))
        side_v.index_copy_(1, off, v.to(side_v.dtype))
        if pool is not None:
            kp, vp = pool
        else:
            kp, vp = gather_pool(cache, block_tables, side_k.dtype)
        attn = masked_attention(q, torch.cat([kp, side_k], dim=1),
                                torch.cat([vp, side_v], dim=1), q_pos,
                                kv_pos, kv_valid, self.window, self.alibi,
                                softcap=self.cfg.attn_softcap,
                                sinks=self.sinks)
        return self._tail(x, h, attn, lora)


def gather_pool(cache, block_tables, dtype):
    """One layer's pool (k, v[, k_scale, v_scale]) gathered through
    ``block_tables`` [R, MB] into [R, MB*bs, Hkv, hd] each, an int8 pool
    dequantized to ``dtype``."""
    ck, cv, cks, cvs = cache
    if cks is None:
        return (gather_seq(ck, block_tables).to(dtype),
                gather_seq(cv, block_tables).to(dtype))
    return (dequant_kv(gather_seq(ck, block_tables),
                       gather_seq(cks, block_tables), dtype),
            dequant_kv(gather_seq(cv, block_tables),
                       gather_seq(cvs, block_tables), dtype))


class Transformer(nn.Module):
    """The whole model over the dense cache. ``params`` is the port's flat
    dict (models/params.py); the modules hold those tensors, no copy.
    With ``tp``, ``params`` is this rank's shard (parallel/sharding.py)
    and every forward runs in lockstep with the other ranks.

    A pp stage (``layers``: the global indices it holds) builds each of
    its blocks with its global index, so every per-layer switch (window,
    rope, a mixed stack's segment) is pp=1's; the first stage embeds, the
    last holds the final norm and the head (and, tied, the table).
    ``forward`` is ``embed``, ``run_layers`` and ``head``, which
    parallel/pipeline.py calls per microbatch on each stage. Under sp
    (``seq``, parallel/ring.py) a prefill block's tokens are cut to this
    rank's chunk, each block attends by the ring, and the head assembles
    the chunks' logits over the sp group."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, torch.Tensor],
                 tp: Optional[TPGroup] = None, *,
                 layers: Optional[range] = None,
                 seq: Optional[SeqShard] = None, experts=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.tp = tp
        self.seq = seq
        self.layer_range = (range(cfg.num_layers) if layers is None
                            else layers)
        self.first = self.layer_range.start == 0
        self.last = self.layer_range.stop == cfg.num_layers
        self.dtype = torch_dtype(cfg.dtype)
        # [H] slopes and a scaled RoPE ladder (llama3, yarn, ...), built
        # once on the model's device: a captured step must not copy them
        # from the host
        device = next(iter(params.values())).device
        self.alibi = None
        if cfg.position_embedding == "alibi":
            self.alibi = alibi_slopes(cfg.num_heads, device) \
                * cfg.alibi_scale
            if tp is not None:   # the rank's q heads' slice of the [H]
                hl = cfg.num_heads // tp.world
                self.alibi = self.alibi[tp.rank * hl:(tp.rank + 1) * hl]
        self.rope_inv_freq = None
        if cfg.rope_inv_freq is not None:
            self.rope_inv_freq = torch.tensor(
                cfg.rope_inv_freq, dtype=torch.float32, device=device)
        self.embed = None
        if self.first or (self.last and cfg.tie_word_embeddings):
            self.embed = Embed(cfg, params, self.dtype, tp,
                               table_only=not self.first)
        self.layers = nn.ModuleList([
            Block(cfg.layer_cfg(i),
                  {k[len(f"layers.{i}."):]: t for k, t in params.items()
                   if k.startswith(f"layers.{i}.")}, tp, self.alibi,
                  i, self.dtype, seq, experts)
            for i in self.layer_range])
        last = self.last
        self.final_norm = (None if cfg.post_norm or not last
                           else _norm(cfg, params, "final_norm"))
        self.project_out = (Linear(_leaf(params, "embed.project_out"))
                            if cfg.embed_proj_dim and last else None)
        self.lm_head = (None if cfg.tie_word_embeddings or not last
                        else Linear(_leaf(params, "lm_head")))

    def unembed(self, x):
        """Final norm (none post-norm), opt-350m's ``project_out``, then the
        logits head: the untied ``lm_head`` (bias included) or the tied
        embedding table, whose int8 form applies its row scale to the
        vocabulary columns (under tp: the rank's vocabulary columns,
        gathered); then, in the compute dtype as the reference's
        ``_head_post``, ``logit_scale`` and ``logit_softcap``, after the
        gather, so every rank holds the same logits; f32 out."""
        if self.final_norm is not None:
            x = self.final_norm(x)
        if self.project_out is not None:
            x = self.project_out(x)
        if self.lm_head is not None:
            logits = self.lm_head(x)
        elif self.embed.quantized:
            logits = torch.matmul(x, self.embed.q8.to(x.dtype).t())
            logits = logits * self.embed.rscale.to(x.dtype)
        else:
            logits = torch.matmul(x, self.embed.tokens.to(x.dtype).t())
        if self.tp is not None:
            logits = self.tp.gather(logits)
        cfg = self.cfg
        if cfg.logit_scale is not None:
            logits = logits * _dtype_scalar(cfg.logit_scale, logits.dtype)
        if cfg.logit_softcap is not None:
            cap = _dtype_scalar(cfg.logit_softcap, logits.dtype)
            logits = torch.tanh(logits / cap) * cap
        return logits.float()

    def _cos_sin(self, positions):
        """The rows every rotating layer's RoPE shares, over the rotated
        width; None without rotary positions."""
        cfg = self.cfg
        if cfg.position_embedding != "rope":
            return None
        rot = (cfg.qk_rope_head_dim if cfg.mla   # the decoupled rope head
               else rotary_dim(cfg.head_dim, cfg.rope_pct))
        return rope_cos_sin(positions, rot, cfg.rope_theta,
                            self.rope_inv_freq, cfg.rope_attn_factor)

    def forward(self, tokens, cache: KVCache, write_starts, q_positions,
                new_lengths, is_prefill: bool = False, gather=None,
                lora: Optional[LoRARows] = None):
        """Run the model over a block of tokens [B, s], updating the cache
        in place. ``write_starts`` [B]: first slot of the block;
        ``q_positions`` [B, s]: absolute positions; ``new_lengths`` [B]:
        cache lengths after the block. ``gather`` [B] (optional) keeps
        only that position's row before the head — the engine's
        last-logit gather, without the [B, s, V] logits. ``lora``: each
        row's adapter (``LoRARows``), None for the base model. Returns
        (logits [B, s or 1, V] f32, cache). Invariant, as in the
        reference: slot index == absolute position."""
        if self.seq is not None and is_prefill:
            tokens, q_positions = (self.seq.chunk(tokens),
                                   self.seq.chunk(q_positions))
        x = self.embed(tokens, q_positions)
        x = self.run_layers(x, cache, write_starts, q_positions, new_lengths,
                            is_prefill, lora)
        return (self.head(x, gather, is_prefill),
                dataclasses.replace(cache, lengths=new_lengths))

    def run_layers(self, x, cache: KVCache, write_starts, q_positions,
                   new_lengths, is_prefill: bool = False,
                   lora: Optional[LoRARows] = None):
        """This model's (or stage's) blocks over hidden states x [B, s,
        D], its cache holding its layers: ``forward``'s arguments."""
        s = x.shape[1]
        cos_sin = self._cos_sin(q_positions)
        slots = (None if self.seq is not None
                 else block_slots(write_starts, s, cache.max_seq))
        q_multi = None if is_prefill or s == 1 else q_positions
        for i, layer in enumerate(self.layers):
            x = layer(x, cache.layer(i), slots, cos_sin, new_lengths,
                      is_prefill, q_multi, lora, positions=q_positions)
        return x

    def head(self, x, gather=None, is_prefill: bool = False):
        """Logits of the last blocks' output x [B, s, D]: of position
        ``gather`` [B] per row (else of every position). Under sp a
        prefill's x is this rank's chunk: a gathered row's logits come
        from the rank whose chunk holds its position, every row's over
        the sp group (one combine), as do a whole block's chunks."""
        B = x.shape[0]
        rows = torch.arange(B, device=x.device)
        sharded = self.seq is not None and is_prefill
        if gather is not None and sharded:
            c = x.shape[1]
            idx = gather.long() - self.seq.rank * c
            own = (idx >= 0) & (idx < c)
            logits = self.unembed(x[rows, idx.clamp(0, c - 1)][:, None])
            return self.seq.group.all_reduce(
                torch.where(own[:, None, None], logits, 0.0), key="combine")
        if gather is not None:
            x = x[rows, gather][:, None]
        logits = self.unembed(x)
        if sharded:
            c = logits.shape[1]
            full = logits.new_zeros(B, c * self.seq.world, logits.shape[-1])
            full[:, self.seq.rank * c:(self.seq.rank + 1) * c] = logits
            logits = self.seq.group.all_reduce(full, key="combine")
        return logits

    def prefill(self, tokens, lengths, cache: KVCache, gather=None,
                lora: Optional[LoRARows] = None):
        """Prefill a right-padded prompt block: tokens [B, S0], lengths
        [B]. Padding lands in slots the masks exclude and later decode
        steps overwrite."""
        B, s = tokens.shape
        pos = torch.arange(s, device=tokens.device).expand(B, s)
        return self.forward(
            tokens, cache,
            torch.zeros(B, dtype=torch.int32, device=tokens.device), pos,
            lengths, is_prefill=True, gather=gather, lora=lora)

    def decode_step(self, tokens, cache: KVCache,
                    lora: Optional[LoRARows] = None):
        """One decode step: tokens [B, 1], each sequence writing at its
        own length; ``cache.lengths`` advances by one in place, so the
        engine's captured step keeps its addresses. Returns (logits,
        cache)."""
        new_lengths = cache.lengths + 1
        logits, _ = self.forward(tokens, cache, cache.lengths,
                                 cache.lengths[:, None], new_lengths,
                                 lora=lora)
        cache.lengths.copy_(new_lengths)
        return logits, cache

    # ------------------------------------------------------------------
    # Paged cache (continuous-batching serving path)
    # ------------------------------------------------------------------

    def paged_prefill_tail(self, tokens, tail_len, tail_blocks,
                           prefix_blocks, prefix_len, paged: PagedKVCache,
                           lora: Optional[LoRARows] = None):
        """Prefill a wave of prompt tails into paged blocks, each row
        attending its own cached prefix (never recomputed).

        tokens [B,T] right-padded tails (T a multiple of block_size);
        tail_len [B] real tail tokens (>= 1; padding rows use 1);
        tail_blocks [B, T // bs] int32 (padding rows all-dummy);
        prefix_blocks [B,PB] (dummy-padded); prefix_len [B]. Writes the
        pool in place. Returns (last-token logits [B,V] f32, paged)."""
        b, t = tokens.shape
        ar = torch.arange(t, device=tokens.device)
        q_pos = prefix_len.long()[:, None] + ar
        tail_valid = ar[None, :] < tail_len.long()[:, None]
        x = self.embed(tokens, q_pos)
        cos_sin = self._cos_sin(q_pos)
        for i, layer in enumerate(self.layers):
            x = layer.paged_prefill(x, paged.layer(i), cos_sin,
                                    tail_blocks, prefix_blocks, prefix_len,
                                    q_pos, tail_valid, lora)
        last = (tail_len.long() - 1).clamp(min=0)
        x = x[torch.arange(b, device=x.device), last][:, None]
        return self.unembed(x)[:, 0], paged

    def paged_decode_step(self, tokens, paged: PagedKVCache, block_tables,
                          context_lens, lora: Optional[LoRARows] = None):
        """One decode step for R slots. tokens [R] next token per slot;
        block_tables [R,MB] int32; context_lens [R] int32 — cached tokens
        BEFORE this step (the new token writes there). Inactive slots
        point at the reserved dummy block with context_len 0; their
        outputs are discarded. Writes the pool in place. A pass with
        adapter rows (``lora``) never takes the fused kernel, which owns
        q end to end. Returns (logits [R,V] f32, paged)."""
        pos = context_lens.long()[:, None]
        x = self.embed(tokens[:, None], pos)
        cos_sin = self._cos_sin(pos)
        fused = (fused_decode.eligible(self.cfg, paged.quantized,
                                       self.tp.world if self.tp else 1)
                 and lora is None)
        fused_rope = (fused_decode.rope_rows(cos_sin)
                      if fused and cos_sin is not None else None)
        writers = token_writers(block_tables, context_lens,
                                paged.block_size)
        for i, layer in enumerate(self.layers):
            x = layer.paged_decode(x, paged.layer(i), cos_sin,
                                   block_tables, context_lens, fused,
                                   fused_rope, lora, writers)
        return self.unembed(x)[:, 0], paged

    def paged_chunk_step(self, s: "PagedChunkState", paged: PagedKVCache,
                         dummy_block: int, lora: Optional[LoRARows] = None):
        """Step ``s.t`` of a K-step decode chunk with sampling on the
        device for R slots — the reference's stepwise formulation
        (``_paged_decode_chunk_stepwise``): the step writes the pool and
        runs the paged (or fused) kernel.

        Per-slot lifecycle as device tensors: ``s.budget[r]`` tokens slot
        r may still emit this chunk (0 = inactive); ``s.eos[r]`` its eos
        (-1 = none; eos is not emitted). A slot is alive until its budget
        is spent or it samples eos; dead slots keep running with their
        writes redirected to ``dummy_block`` and context length 0.
        Sampling keys on ``s.steps0 + s.t`` per slot, so tokens do not
        depend on the chunk size. Every state tensor of ``s`` is updated
        in place and the step's token and emit flag land in row ``s.t``
        of ``s.toks``/``s.emits``; slot r emitted
        ``toks[:emits[:, r].sum(), r]``. The step touches nothing but
        ``s`` and the pool and never syncs with the host, so the batcher
        captures it once and replays it K times (runtime/graphs.py).
        ``lora``: the slots' adapters, whose ids (``s.aids``) ride the
        chunk's inputs."""
        alive = s.alive.bool()
        t = s.t.long()
        if paged.quantized:
            logits = self._paged_chunk_logits_q8(s, paged, alive, t, lora)
            s.wrote.index_copy_(0, t, alive[None])
        else:
            bt_eff = torch.where(alive[:, None], s.bt, dummy_block)
            cl_eff = torch.where(alive, s.cl, 0)
            logits, _ = self.paged_decode_step(s.cur, paged, bt_eff, cl_eff,
                                               lora)
        nxt = sample_batch(logits, s.seeds, s.steps0 + t, s.temps, s.tks,
                           s.tps, s.ds.bool())
        emit = alive & ~((s.eos >= 0) & (nxt == s.eos))
        s.cl.add_(alive.to(s.cl.dtype))
        s.alive.copy_(emit & (t + 1 < s.budget))
        s.cur.copy_(nxt)
        s.toks.index_copy_(0, t, nxt[None])
        s.emits.index_copy_(0, t, emit[None])
        s.t.add_(1)

    def _paged_chunk_logits_q8(self, s, paged, alive, t, lora=None):
        """An int8 pool's chunk step (the reference's side-buffer
        formulation): every slot's query at its position (0 once dead)
        attends its table's blocks below the chunk's start ``s.cl0``,
        dequantized, and the chunk's side rows up to ``t``; the pool is
        not written until ``paged_chunk_flush``."""
        r, mb = s.bt.shape
        dev = s.bt.device
        q_pos = torch.where(alive, s.cl, 0).long()[:, None]
        x = self.embed(s.cur[:, None], q_pos)
        cos_sin = self._cos_sin(q_pos)
        cl0 = s.cl0.long()[:, None]
        pool_pos = torch.arange(mb * paged.block_size, device=dev).expand(
            r, -1)
        side = torch.arange(s.side_k.shape[2], device=dev)
        kv_pos = torch.cat([pool_pos, cl0 + side], dim=1)
        kv_valid = torch.cat([pool_pos < cl0, (side <= t).expand(r, -1)],
                             dim=1)
        for i, layer in enumerate(self.layers):
            x = layer.paged_side(x, paged.layer(i), cos_sin, s.bt, q_pos,
                                 s.side_k[i], s.side_v[i], t, kv_pos,
                                 kv_valid, lora=lora)
        return self.unembed(x)[:, 0]

    def paged_chunk_flush(self, s: "PagedChunkState", paged: PagedKVCache,
                          dummy_block: int, k: int):
        """The end of an int8 pool's K-step chunk: the side buffers'
        first ``k`` rows quantized (``quant_kv``) and written into the
        pool at each step's position, the steps a slot did not write
        (``s.wrote``) into ``dummy_block`` (the reference's one scatter
        after its scan)."""
        r, mb = s.bt.shape
        bs = paged.block_size
        pos = s.cl0.long()[None, :] + torch.arange(
            k, device=s.bt.device)[:, None]                      # [K, R]
        blk = torch.gather(s.bt.long(), 1,
                           (pos // bs).clamp(max=mb - 1).T).T
        blk = torch.where(s.wrote[:k], blk, dummy_block)
        off = pos % bs
        places = blk * bs + off
        for side, lv, sc in ((s.side_k, paged.k, paged.k_scale),
                             (s.side_v, paged.v, paged.v_scale)):
            q8, scale = quant_kv(side[:, :, :k].transpose(1, 2))
            lv[:, blk, off] = one_per_place(q8, places, 1)
            sc[:, blk, off] = one_per_place(scale, places, 1)

    # ------------------------------------------------------------------
    # Speculative chunk (the batcher's on-device prompt-lookup drafting)
    # ------------------------------------------------------------------

    def paged_spec_gather(self, s: "SpecChunkState", paged: PagedKVCache):
        """The once-per-chunk pool gather of a speculative chunk whose
        gathered pool fits ``PREGATHER_MAX_BYTES``: every layer's blocks
        through ``s.bt`` into ``s.pool_k``/``s.pool_v`` [L, R, MB*bs,
        Hkv, hd] (an int8 pool dequantized), in place."""
        for i in range(len(self.layers)):
            kp, vp = gather_pool(paged.layer(i), s.bt, s.pool_k.dtype)
            s.pool_k[i].copy_(kp)
            s.pool_v[i].copy_(vp)

    def paged_spec_step(self, s: "SpecChunkState", paged: PagedKVCache,
                        gamma: int, lora: Optional[LoRARows] = None):
        """Iteration ``s.t`` of a speculative chunk for R slots (the JAX
        package's ``paged_speculative_chunk`` loop body): draft ``gamma``
        tokens per slot from the history buffer
        (``propose_ngram_device``), score [cur, drafts] in one forward,
        accept per row (``accept_rejection_batch`` with the per-slot
        widths ``s.gammas``), clamp at eos and budget, and append the kept
        tokens to the history.

        K/V of the gamma+1 scored tokens go to the side buffers at the
        static entries ``t*(gamma+1) + [0, gamma]``, each entry's position
        to ``s.side_pos``; ``s.acc_mask`` marks the entries a slot keeps
        (entry i of the block iff i < n_keep, entry 0 for a live slot),
        so attention sees the pool below the chunk's start, the kept side
        entries and the current block (causally). The pool is written
        once, after the chunk (``paged_spec_flush``). Iteration t of slot
        r emitted ``s.toks[t, r, :s.keeps[t, r]]``; ``s.eos_out`` is the
        cumulative eos flag. Touches only ``s`` (and reads the pool), and
        never syncs with the host: captured once, replayed K times."""
        r, mb = s.bt.shape
        dev = s.bt.device
        g1 = gamma + 1
        alive = s.alive.bool()
        t = s.t.long()
        cl = s.cl.long()
        idx = torch.arange(g1, device=dev)
        qp = torch.where(alive, cl, 0)[:, None] + idx              # [R, G1]
        hist = s.hist[:, :-1]                   # the last column: a dump
        drafts, _ = propose_ngram_device(hist, cl + 1, gamma)
        toks_in = torch.cat([s.cur.long()[:, None], drafts], dim=1)
        x = self.embed(toks_in, qp)
        cos_sin = self._cos_sin(qp)

        off = t * g1 + idx
        s.side_pos.index_copy_(1, off, qp.to(s.side_pos.dtype))
        e = s.side_pos.shape[1]
        is_cur = (torch.arange(e, device=dev) // g1) == t
        pool_pos = torch.arange(mb * paged.block_size, device=dev).expand(
            r, -1)
        kv_pos = torch.cat([pool_pos, s.side_pos.long()], dim=1)
        kv_valid = torch.cat([pool_pos < s.cl0.long()[:, None],
                              s.acc_mask | is_cur[None, :]], dim=1)
        for i, layer in enumerate(self.layers):
            pool = (None if s.pool_k is None
                    else (s.pool_k[i], s.pool_v[i]))
            x = layer.paged_side(x, paged.layer(i), cos_sin, s.bt, qp,
                                 s.side_k[i], s.side_v[i], off, kv_pos,
                                 kv_valid, pool, lora)
        logits = self.unembed(x)                                 # [R,G1,V]

        emitted = s.emitted.long()
        toks_out, n_emit = accept_rejection_batch(
            logits, drafts, s.seeds, s.steps0.long() + emitted, s.temps,
            s.tks, s.tps, s.ds.bool(), widths=s.gammas)
        eos = s.eos.long()
        emit_sl = idx[None, :] < n_emit[:, None]
        is_eos = (toks_out == eos[:, None]) & (eos >= 0)[:, None] & emit_sl
        eos_pos = torch.where(is_eos, idx, g1).amin(dim=1)
        rem = s.budget.long() - emitted
        n_keep = torch.minimum(torch.minimum(n_emit, eos_pos), rem)
        n_keep = torch.where(alive, n_keep, 0)
        # an eos counts only if plain decode would reach it inside the
        # budget; cut by the budget first, the slot re-derives it
        hit_eos = (eos_pos < n_emit) & (eos_pos < rem)
        kept = idx[None, :] < n_keep[:, None]
        s.acc_mask.index_copy_(1, off, kept | ((idx == 0)[None, :]
                                               & alive[:, None]))
        dump = hist.shape[1]
        cols = cl[:, None] + 1 + idx
        cols = torch.where(kept & (cols < dump), cols, dump)
        rows = torch.arange(r, device=dev)[:, None].expand(r, g1)
        s.hist[rows, cols] = toks_out.to(s.hist.dtype)
        emitted2 = emitted + n_keep
        eos_seen = s.eos_seen.bool() | (hit_eos & alive)
        last = torch.gather(toks_out, 1, (n_keep - 1).clamp(min=0)[:, None])
        s.cur.copy_(torch.where(n_keep > 0, last[:, 0], s.cur.long()))
        s.cl.copy_(cl + n_keep)
        s.emitted.copy_(emitted2)
        s.eos_seen.copy_(eos_seen)
        s.alive.copy_(alive & ~hit_eos & (emitted2 < s.budget.long()))
        s.toks.index_copy_(0, t, toks_out[None])
        s.keeps.index_copy_(0, t, n_keep[None])
        s.eos_out.index_copy_(0, t, eos_seen[None])
        s.t.add_(1)

    def paged_spec_flush(self, s: "SpecChunkState", paged: PagedKVCache,
                         dummy_block: int):
        """The end of a speculative chunk: the side entries its slots kept
        (``s.acc_mask``) written into the pool at their positions in one
        scatter (an int8 pool quantized by ``quant_kv``), every other
        entry into ``dummy_block``."""
        r, mb = s.bt.shape
        bs = paged.block_size
        pos = s.side_pos.long()
        blk = torch.gather(s.bt.long(), 1, (pos // bs).clamp(max=mb - 1))
        blk = torch.where(s.acc_mask, blk, dummy_block)
        off = pos % bs
        places = blk * bs + off
        for side, lv, sc in ((s.side_k, paged.k, paged.k_scale),
                             (s.side_v, paged.v, paged.v_scale)):
            if sc is None:
                lv[:, blk, off] = one_per_place(side, places, 1).to(lv.dtype)
            else:
                q8, scale = quant_kv(side)
                lv[:, blk, off] = one_per_place(q8, places, 1)
                sc[:, blk, off] = one_per_place(scale, places, 1)


@dataclasses.dataclass
class PagedChunkState:
    """A decode chunk's inputs and carried state for R slots, as
    device tensors that ``Transformer.paged_chunk_step`` reads and updates
    in place: tables ``bt`` [R,MB]; per slot the context length ``cl``,
    the token fed next ``cur``, the sampling stream (``seeds``,
    ``steps0``) and parameters (``temps``, ``tks``, ``tps``, ``ds``),
    ``budget``, ``eos`` and ``alive``; the step counter ``t`` [1]; the
    outputs ``toks``/``emits`` [K,R]. ``ds``/``alive`` are integers
    (0 = False), as the batcher packs them (runtime/batcher.py
    ``_ChunkBuffers``). An int8 pool's chunk also carries the chunk's
    start ``cl0`` [R], its side buffers ``side_k``/``side_v`` [L, R,
    K, Hkv, hd] (compute dtype) and ``wrote`` [K, R]: which slots wrote
    at each step."""
    bt: torch.Tensor
    cl: torch.Tensor
    cur: torch.Tensor
    seeds: torch.Tensor
    steps0: torch.Tensor
    temps: torch.Tensor
    tks: torch.Tensor
    tps: torch.Tensor
    ds: torch.Tensor
    budget: torch.Tensor
    eos: torch.Tensor
    alive: torch.Tensor
    t: torch.Tensor
    toks: torch.Tensor
    emits: torch.Tensor
    cl0: Optional[torch.Tensor] = None
    side_k: Optional[torch.Tensor] = None
    side_v: Optional[torch.Tensor] = None
    wrote: Optional[torch.Tensor] = None
    aids: Optional[torch.Tensor] = None


@dataclasses.dataclass
class SpecChunkState:
    """A speculative chunk's inputs and carried state for R slots, as
    device tensors that ``Transformer.paged_spec_step`` reads and updates
    in place: tables ``bt`` [R,MB]; the token history ``hist`` [R, H+1]
    (row r valid to ``cl[r] + 1``; the last column takes dropped writes);
    per slot ``cur``, ``cl`` (and the chunk's start ``cl0``), the sampling
    stream (``seeds``, ``steps0``) and parameters (``temps``, ``tks``,
    ``tps``, ``ds``), ``budget``, ``eos``, the draft width ``gammas``,
    ``alive``, ``emitted`` and ``eos_seen``; the iteration ``t`` [1];
    the side buffers ``side_k``/``side_v`` [L, R, E, Hkv, hd] (compute
    dtype, E = K·(gamma+1)) with ``side_pos`` [R, E] and ``acc_mask``
    [R, E]; the outputs ``toks`` [K, R, gamma+1], ``keeps`` and
    ``eos_out`` [K, R]; and, when the chunk gathers the pool once,
    ``pool_k``/``pool_v`` [L, R, MB*bs, Hkv, hd]."""
    bt: torch.Tensor
    hist: torch.Tensor
    cur: torch.Tensor
    cl: torch.Tensor
    cl0: torch.Tensor
    seeds: torch.Tensor
    steps0: torch.Tensor
    temps: torch.Tensor
    tks: torch.Tensor
    tps: torch.Tensor
    ds: torch.Tensor
    budget: torch.Tensor
    eos: torch.Tensor
    gammas: torch.Tensor
    alive: torch.Tensor
    emitted: torch.Tensor
    eos_seen: torch.Tensor
    t: torch.Tensor
    side_k: torch.Tensor
    side_v: torch.Tensor
    side_pos: torch.Tensor
    acc_mask: torch.Tensor
    toks: torch.Tensor
    keeps: torch.Tensor
    eos_out: torch.Tensor
    pool_k: Optional[torch.Tensor] = None
    pool_v: Optional[torch.Tensor] = None
    aids: Optional[torch.Tensor] = None
