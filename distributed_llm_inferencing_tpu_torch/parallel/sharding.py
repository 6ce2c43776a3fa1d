"""Which part of each weight a tp rank and an ep rank hold
(megatron-style, and the experts cut over ep).

The JAX package's ``parallel/sharding.py`` assigns a ``PartitionSpec`` per
leaf (``param_specs``) and lets GSPMD place the shards; here each rank
cuts its own shard out of the port's flat dict (models/params.py), for
every family, by the same roles:

- column-parallel, the output axis split: q (by whole heads), gate, up
  and their biases; k and v (and their biases) by kv heads (``kv_map``);
  an untied ``lm_head`` over the vocabulary, with its bias (phi); the
  shared experts' ``shared_gate`` / ``shared_up``; latent attention's
  per-head expansions q_b (or q), kv_b_k and kv_b_v, by whole heads
  (each head's columns are contiguous, q's [rope | nope]-ordered); the
  sinks [H], cut with the q heads. Scales follow the columns.
- row-parallel, the input axis split: o, down and ``shared_down``; the
  partial products are summed over the ranks (models/transformer.py).
  Their scales and biases replicate: a bias is added once, after the
  sum. In int4 these leaves are first repacked chunk-locally with ``tp``
  chunks (ops/quant.py ``repack_int4_rows``) so that rank r's slice of
  the packed rows is a self-contained split-half pack of its own din
  rows; each keeps the ``chunked`` marker [tp, 0], as the JAX package
  replicates it.
- the routed experts (``experts.{gate,up,down}``, stacked [E, ...]): E
  over ep, the hidden width I over tp — gate / up [E, D, I] and their
  scales and biases [E, I] on both axes, down [E, I, D] on both, its
  scale and bias [E, D] over ep only (the bias is added on one tp rank
  of each ep slice, so the sum over the expert group counts it once).
  An int4 down is repacked chunk-locally along I first, as o is; the
  JAX package keeps its global layout there and lets GSPMD reshard, a
  port rank needs a self-contained pack. Its marker [E, tp, 0] is cut
  over ep.
- vocab-parallel: the embedding table (float, or int8 with its row
  scales). A tied head reads the rank's rows as its vocabulary columns.
- the q/k norms of kind "ln_head" and "rms_full" (per-head scales stored
  flat): cut with the heads, k's by ``kv_map``. The JAX package
  replicates them and slices inside its program; the port's rank holds
  only the heads it normalizes.
- everything else replicates, over tp and over ep: every other norm
  (bloom's embedding norm, gemma2's sandwich norms, latent attention's
  bottleneck norms), "rms_head" scales, learned positions, opt-350m's
  projections, latent attention's bottlenecks q_a and kv_a, and the
  router and its bias. Every leaf but the routed experts' replicates
  over ep: attention and the shared experts run whole on every ep rank,
  as the JAX package replicates them.

Replicated kv heads (tp > Hkv, the JAX ``kv_head_axis``'s None): rank r
holds q heads [r·H/tp, (r+1)·H/tp). The kernels map local q head h to
local kv head h // (H_l / Hkv_l), so the rank keeps one kv head per run
of g = gcd(H/tp, H/Hkv) consecutive local q heads, all of which read the
same kv head: Hkv_l = (H/tp) / g kv heads per rank (``kv_map``). When tp
is a multiple of Hkv that is one kv head per rank; otherwise a kv head
can appear twice on a rank (H=12, Hkv=3, tp=4: rank 1's q heads 3, 4, 5
read kv heads 0, 1, 1 and it holds three, 0, 1, 1). Hkv_l = lcm(H/tp,
H/Hkv) / (H/Hkv) <= Hkv, so no rank holds more than the JAX package's
whole replicated kv heads; when tp divides Hkv the same rule gives the
plain cut, Hkv/tp contiguous heads.

Every shard is a fresh contiguous tensor, so the full leaf it came from
can be freed and a packed slice is aligned for the kernels.

Pipeline stages (``stage_keep``): stage p of pp holds layers
[p·L/pp, (p+1)·L/pp) whole, under their global names. Stage 0 holds the
embedding (table, learned positions, bloom's norm, opt-350m's
``project_in``); the last stage the final norm, ``project_out`` and the
head, and with a tied head a copy of the table. The JAX package shards
the stacked layer axis over pp (its ``param_specs``) and replicates the
rest; a stage here keeps only what its layers and its end of the model
read. It composes with the tp and ep cuts unchanged.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List, Optional

import torch

from distributed_llm_inferencing_tpu_torch.ops.quant import repack_int4_rows
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    MeshSpec, grid_coords, validate_spec)

COLUMN = ("q", "gate", "up", "q_b", "kv_b_k", "kv_b_v", "shared_gate",
          "shared_up")
KV = ("k", "v")
ROW = ("o", "down", "shared_down")
QK_NORMS = ("q_norm", "k_norm")
_LAYER = re.compile(r"^layers\.\d+\.(\w+)\.(\w+)$")
_EXPERT = re.compile(r"^layers\.\d+\.experts\.(\w+)\.(\w+)$")


def kv_map(cfg, tp: int, rank: int) -> List[int]:
    """The global kv head of each of rank ``rank``'s local kv heads, in
    local order (the module docstring's rule)."""
    hl = cfg.num_heads // tp
    group = cfg.num_heads // cfg.num_kv_heads
    g = math.gcd(hl, group)
    return [(rank * hl + j * g) // group for j in range(hl // g)]


def kv_weights(cfg, tp: int, rank: int) -> List[float]:
    """1 / (how many local kv heads over all ranks copy each of this
    rank's local kv heads): the weight that makes a sum over every
    rank's kv heads count each global head once ("rms_full" k norms
    under replication)."""
    seen = Counter(h for r in range(tp) for h in kv_map(cfg, tp, r))
    return [1.0 / seen[h] for h in kv_map(cfg, tp, rank)]


def local_heads(cfg, spec: MeshSpec):
    """(q heads, kv heads) on one rank: H/tp and ``len(kv_map)``. The
    rank's KV cache and pool hold those kv heads (the JAX package's
    ``cache_specs``/``paged_cache_specs``, with its replication laid out
    per rank); latent attention's latent cache holds its one [k_rot | c]
    row per token whole on every rank (the JAX ``kv_head_axis(1, tp)`` is
    None)."""
    if spec.tp == 1:
        return cfg.num_heads, cfg.cache_kv_heads
    if cfg.mla_latent_cache:
        return cfg.num_heads // spec.tp, 1
    return cfg.num_heads // spec.tp, len(kv_map(cfg, spec.tp, 0))


def _role(name: str, cfg) -> Optional[str]:
    """column / kv / row / vocab, or None where the tensor replicates
    over tp (the routed experts' leaves: ``_expert_dims``)."""
    if name.startswith("embed.tokens"):
        return "vocab"
    if name.startswith("lm_head."):
        return "column"
    if re.match(r"^layers\.\d+\.sinks$", name):
        return "column"
    m = _LAYER.match(name)
    if m is None:
        return None
    leaf, kind = m.groups()
    if leaf in QK_NORMS:
        if cfg.qk_norm == "rms_head":
            return None
        return "column" if leaf == "q_norm" else "kv"
    if kind == "chunked":
        return None
    if leaf in COLUMN:
        return "column"
    if leaf in KV:
        return "kv"
    if leaf in ROW:
        return None if kind in ("scale", "b") else "row"
    return None


def split_dim(name: str, cfg) -> Optional[int]:
    """The dim of stored tensor ``name`` that tp splits, or None where it
    replicates (a routed expert leaf: ``_expert_dims``)."""
    m = _EXPERT.match(name)
    if m is not None:
        return _expert_dims(*m.groups())[1]
    role = _role(name, cfg)
    if role is None:
        return None
    if role in ("row", "vocab"):
        return 0
    kind = name.rsplit(".", 1)[1]
    return 0 if kind in ("scale", "b", "sinks") else -1


def _expert_dims(leaf: str, kind: str):
    """(ep dim, tp dim or None) of a stored tensor of the routed experts'
    ``leaf`` (gate, up, down): E leads every tensor; gate / up cut their
    last axis (I) over tp, down its din rows (I) and not its [E, D]
    scale, bias or marker."""
    if kind == "chunked":
        return 0, None
    if leaf == "down":
        return 0, (None if kind in ("scale", "b") else 1)
    return 0, -1


def _narrow(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Slice i of n equal ones of ``t`` along ``dim``."""
    k = t.shape[dim] // n
    return t.narrow(dim, i * k, k)


def shard_tensor(name: str, t: torch.Tensor, cfg, spec: MeshSpec, rank: int,
                 repacked: bool = False, ep_rank: int = 0) -> torch.Tensor:
    """The shard of stored tensor ``name`` of ``cfg`` that tp rank
    ``rank`` of ep slice ``ep_rank`` holds. A row-parallel ``p4`` is
    repacked chunk-locally first, unless ``repacked``."""
    tp = spec.tp
    expert = _EXPERT.match(name)
    if expert is not None:
        if tp == 1 and spec.ep == 1:
            return t
        leaf, kind = expert.groups()
        if leaf == "down" and kind == "p4" and tp > 1 and not repacked:
            t = repack_int4_rows({"p4": t}, tp)["p4"]
        e_dim, t_dim = _expert_dims(leaf, kind)
        if spec.ep > 1:
            t = _narrow(t, e_dim, spec.ep, ep_rank)
        if t_dim is not None and tp > 1:
            t = _narrow(t, t_dim, tp, rank)
        return t.clone(memory_format=torch.contiguous_format)
    if tp == 1:
        return t
    if name.endswith(".p4") and _role(name, cfg) == "row" and not repacked:
        t = repack_int4_rows({"p4": t}, tp)["p4"]
    dim = split_dim(name, cfg)
    if dim is None:
        return t
    if _role(name, cfg) == "kv":
        hd = t.shape[dim] // cfg.num_kv_heads
        cols = torch.tensor([h * hd + i for h in kv_map(cfg, tp, rank)
                             for i in range(hd)], device=t.device)
        return t.index_select(dim % t.dim(), cols).contiguous()
    return _narrow(t, dim, tp, rank).clone(
        memory_format=torch.contiguous_format)


def stage_range(cfg, spec: MeshSpec, stage: int) -> range:
    """The global indices of the layers pp stage ``stage`` holds."""
    n = cfg.num_layers // spec.pp
    return range(stage * n, (stage + 1) * n)


def stage_keep(cfg, spec: MeshSpec, stage: int):
    """Whether pp stage ``stage`` holds stored tensor ``name`` (a
    predicate on names; None at pp=1, where every rank holds all)."""
    if spec.pp == 1:
        return None
    layers = stage_range(cfg, spec, stage)
    first, last = stage == 0, stage == spec.pp - 1

    def keep(name: str) -> bool:
        if name.startswith("layers."):
            return int(name.split(".", 2)[1]) in layers
        if name.startswith("embed.tokens"):
            return first or (last and cfg.tie_word_embeddings)
        if name.startswith("embed.project_out"):
            return last
        if name.startswith("embed."):
            return first
        return last   # final_norm, lm_head
    return keep


def row_leaves(cfg, i: int) -> List[str]:
    """The row-parallel linears of layer i (its config,
    ``ModelConfig.layer_cfg``): o, and down, or in an MoE block the
    shared experts' ``shared_down`` and the routed ``experts.down``."""
    lc = cfg.layer_cfg(i)
    if not lc.is_moe:
        return ["o", "down"]
    return ["o"] + (["shared_down"] if lc.moe_shared_experts else []) + [
        "experts.down"]


def chunk_markers(cfg, spec: MeshSpec, device=None, layers=None
                  ) -> Dict[str, torch.Tensor]:
    """The ``chunked`` markers of the repacked row-parallel int4 leaves
    (of ``layers``, default every layer): [tp, 0], the routed experts'
    [E/ep, tp, 0]."""
    if cfg.quant != "int4" or spec.tp == 1:
        return {}
    out = {}
    for i in (layers if layers is not None else range(cfg.num_layers)):
        for n in row_leaves(cfg, i):
            lead = ((cfg.num_experts // spec.ep,) if n.startswith("experts.")
                    else ())
            out[f"layers.{i}.{n}.chunked"] = torch.zeros(
                (*lead, spec.tp, 0), dtype=torch.int8, device=device)
    return out


def shard_params(params: Dict[str, torch.Tensor], cfg, spec: MeshSpec,
                 rank: int) -> Dict[str, torch.Tensor]:
    """Grid rank ``rank``'s flat dict of a whole-model flat dict (a random
    init, or a tree bridged from the JAX package, chunked or not): its
    tp and ep cut of every tensor (every layer's: the caller keeps a pp
    stage's). A leaf already chunked for another tp raises
    ``ValueError``."""
    validate_spec(spec, cfg)
    if spec.tp == 1 and spec.ep == 1:
        return params
    _, _, t, e = grid_coords(spec, rank)
    out = {}
    for name, tensor in params.items():
        if name.endswith(".chunked"):
            continue
        marker = params.get(name.rsplit(".", 1)[0] + ".chunked")
        if marker is not None and marker.shape[-2] != spec.tp:
            raise ValueError(f"{name}: leaf chunked x{marker.shape[-2]}, "
                             f"served at tp={spec.tp}")
        out[name] = shard_tensor(name, tensor, cfg, spec, t,
                                 repacked=marker is not None, ep_rank=e)
    out.update(chunk_markers(cfg, spec, next(iter(params.values())).device))
    return out
