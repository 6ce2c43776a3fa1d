"""Weight-only int8 / int4 quantization (per-output-channel symmetric).

The port's copy of the JAX package's ``ops/quant.py``, on the port's flat
parameter dict. The layouts are byte for byte the JAX package's, so a JAX
tree bridges bit for bit (models/params.py ``params_from_jax``) and the
same float weights quantize to the same bytes in either package:

- int8 leaf ``{"q": int8 [din, dout], "scale": f32 [dout]}``, with
  ``scale = max(max|w| over din, 1e-8) / 127`` and
  ``q = clip(round(w / scale), -127, 127)``;
- int4 leaf ``{"p4": uint8 [din/2, dout], "scale": f32 [dout]}``, levels
  in [-7, 7] (``/ 7``), packed split-half biased: byte row i holds din
  row i (level + 8, low nibble) and din row i + din/2 (level + 8, high
  nibble);
- int8 embedding table ``{"q8": int8 [V, D], "rscale": f32 [V]}``, one
  scale per row.

``torch.round`` and ``jnp.round`` both round half to even, so a weight
that lands exactly between two levels takes the same level in both.

Because the scale is per output channel it commutes with the
contraction, ``x @ (q * scale) == (x @ q) * scale``: the linears
(models/transformer.py ``Linear``) multiply the [.., dout] output, and
int4 decode runs the ``q4_matmul`` kernel (ops/quant_matmul.py), which
never writes the unpacked weight to device memory.

In the flat dict a linear ``<prefix>.w`` becomes ``<prefix>.q`` +
``<prefix>.scale`` (int8) or ``<prefix>.p4`` + ``<prefix>.scale``
(int4); a bias ``<prefix>.b`` stays as it is, added after the product
in every form. ``embed.tokens`` becomes ``embed.tokens.q8`` +
``embed.tokens.rscale``; a tied head reads that table with the row
scale on its vocabulary columns.

Chunk-local int4 packs (``repack_int4_rows``, the JAX package's layout of
the row-parallel leaves o and down under tensor parallelism): each of C
equal din row groups is its own split-half pack, so a din shard of the
leaf is a self-contained pack. Such a leaf carries the zero-size marker
``<prefix>.chunked`` [C, 0] int8 (the JAX package's, so a tree bridges
both ways); ``pack_chunks`` reads C from it.
"""

from __future__ import annotations

import re
from typing import Dict

import torch

MODES = ("int8", "int4")

# the JAX package's _LINEAR_LEAVES (the dense linears, latent
# attention's bottlenecks and expansions, the shared experts), the MoE
# experts' stacked leaves and the untied head; embeddings (their opt-350m
# projections too), norms, biases, sinks and the MoE router stay float
LINEAR_LEAVES = ("q", "k", "v", "o", "gate", "up", "down",
                 "q_a", "q_b", "kv_a", "kv_b_k", "kv_b_v",
                 "shared_gate", "shared_up", "shared_down")
_LINEAR_W = re.compile(
    r"^(layers\.\d+\.(?:%s|experts\.(?:gate|up|down))|lm_head)\.w$"
    % "|".join(LINEAR_LEAVES))
EMBED = "embed.tokens"


def refuse_chunked(leaf):
    """Raise for a leaf carrying the ``chunked`` marker, where a consumer
    takes only the global layout (the fused decode kernel's q leaf, which
    is column-parallel and never repacked)."""
    if "chunked" in leaf:
        raise NotImplementedError(
            "a chunk-local int4 pack (a row-parallel leaf) cannot feed this "
            "consumer; it takes the global split-half layout")


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """w [..., din, dout] -> {"q": int8, "scale": f32 [..., dout]}."""
    w32 = w.float()
    scale = w32.abs().amax(dim=-2).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale[..., None, :]), -127, 127)
    return {"q": q.to(torch.int8), "scale": scale}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 levels [..., din, dout] in [-8, 7] -> uint8 [..., din/2, dout],
    split-half biased (see the module note)."""
    din = q.shape[-2]
    if din % 2:
        raise ValueError(f"int4 packing needs even din, got {din}")
    u = (q.to(torch.int16) + 8).to(torch.uint8)
    return u[..., :din // 2, :] | (u[..., din // 2:, :] << 4)


def unpack_int4(p4: torch.Tensor, chunks: int = 1) -> torch.Tensor:
    """uint8 [..., din/2, dout] -> sign-extended int8 [..., din, dout].
    ``chunks > 1``: the chunk-local layout of ``repack_int4_rows``."""
    lo = (p4 & 0xF).to(torch.int8) - 8
    hi = ((p4 >> 4) & 0xF).to(torch.int8) - 8
    if chunks == 1:
        return torch.cat([lo, hi], dim=-2)
    *lead, half, dout = p4.shape
    per = half // chunks
    lo = lo.reshape(*lead, chunks, per, dout)
    hi = hi.reshape(*lead, chunks, per, dout)
    return torch.cat([lo, hi], dim=-2).reshape(*lead, 2 * half, dout)


def pack_chunks(leaf) -> int:
    """Chunk count of an int4 leaf (1: the global split-half layout)."""
    return leaf["chunked"].shape[-2] if "chunked" in leaf else 1


def repack_int4_rows(leaf: Dict[str, torch.Tensor], chunks: int
                     ) -> Dict[str, torch.Tensor]:
    """Re-pack a split-half int4 leaf so each of ``chunks`` equal din row
    groups is a self-contained split-half pack of its own rows, and add
    the ``chunked`` marker. A pure nibble gather on the packed bytes: it
    never unpacks, and gives the JAX function's bytes. A leaf already
    chunked for ``chunks`` passes; for another count it raises."""
    if "chunked" in leaf:
        if pack_chunks(leaf) != chunks:
            raise ValueError(f"leaf already chunked x{pack_chunks(leaf)}, "
                             f"asked for x{chunks}")
        return leaf
    p4 = leaf["p4"]
    *lead, half, dout = p4.shape
    din = 2 * half
    if din % (2 * chunks):
        raise ValueError(f"din={din} not divisible into {chunks} "
                         "split-half chunks")
    per = din // chunks
    # byte (chunk c, local row j) pairs din rows c*per + j and that + per/2;
    # din row r sits in the low nibble of byte row r (r < half) or the high
    # nibble of byte row r - half
    i = torch.arange(half, device=p4.device)
    r_a = (i // (per // 2)) * per + i % (per // 2)
    r_b = r_a + per // 2

    def nib(r):
        lo_sel = r < half
        rows = torch.index_select(p4, -2, torch.where(lo_sel, r, r - half))
        return torch.where(lo_sel[:, None], rows & 0xF, (rows >> 4) & 0xF)

    out = dict(leaf)
    out["p4"] = nib(r_a) | (nib(r_b) << 4)
    out["chunked"] = torch.zeros((*lead, chunks, 0), dtype=torch.int8,
                                 device=p4.device)
    return out


def quantize_weight_int4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """w [..., din, dout] -> {"p4": packed uint8, "scale": f32 [..., dout]}."""
    w32 = w.float()
    scale = w32.abs().amax(dim=-2).clamp_min(1e-8) / 7.0
    q = torch.clamp(torch.round(w32 / scale[..., None, :]), -7, 7)
    return {"p4": pack_int4(q.to(torch.int8)), "scale": scale}


# a linear leaf's stored tensors, by form; an int4 leaf may also carry
# the ``chunked`` marker, and a leaf of any form its bias ``b`` (float,
# in the model's dtype: quantization leaves it as it is)
LEAF_KEYS = {"float": ("w",), "int8": ("q", "scale"),
             "int4": ("p4", "scale")}


def leaf_keys(leaf) -> tuple:
    """The stored tensors of ``leaf`` in their canonical order."""
    keys = LEAF_KEYS[leaf_form(leaf)]
    return keys + tuple(k for k in ("chunked", "b") if k in leaf)


def leaf_form(leaf) -> str:
    """"float", "int8" or "int4" for a linear leaf (an int4 one chunked or
    not, any of them biased or not); raises for any other set of keys."""
    keys = set(leaf) - {"b"}
    if "chunked" in keys and "p4" in keys:
        keys.discard("chunked")
    for form, want in LEAF_KEYS.items():
        if keys == set(want):
            return form
    raise ValueError(f"unknown linear leaf {sorted(leaf)}")


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and ("q" in leaf or "p4" in leaf)


def dequantize_weight(leaf: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The float weight of an int8 or int4 leaf, f32 (tests and plain
    versions)."""
    levels = (unpack_int4(leaf["p4"], pack_chunks(leaf)) if "p4" in leaf
              else leaf["q"])
    return levels.float() * leaf["scale"][..., None, :]


def quantize_embed(emb: torch.Tensor) -> Dict[str, torch.Tensor]:
    """emb [V, D] -> {"q8": int8 [V, D], "rscale": f32 [V]} (per row)."""
    w32 = emb.float()
    scale = w32.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale[..., None]), -127, 127)
    return {"q8": q.to(torch.int8), "rscale": scale}


def dequantize_embed(leaf: Dict[str, torch.Tensor]) -> torch.Tensor:
    return leaf["q8"].float() * leaf["rscale"][..., None]


def check_modes(cfg):
    """Raise ValueError for a ``cfg.quant`` or ``cfg.embed_quant`` this
    module does not implement."""
    if cfg.quant not in (None,) + MODES:
        raise ValueError(f"unknown quant mode {cfg.quant!r}; known: {MODES}")
    if cfg.embed_quant not in (None, "int8"):
        raise ValueError(f"unknown embed_quant mode {cfg.embed_quant!r}; "
                         "known: ('int8',)")


def maybe_quantize(params: Dict[str, torch.Tensor], cfg
                   ) -> Dict[str, torch.Tensor]:
    """Apply ``cfg.quant`` to the flat dict, in place: each float linear
    weight is replaced by its quantized leaf as soon as that exists, so
    the peak is the float model plus one weight. Leaves already quantized
    stay as they are (idempotent)."""
    if cfg.quant is None:
        return params
    check_modes(cfg)
    quantize = quantize_weight if cfg.quant == "int8" else quantize_weight_int4
    for name in [n for n in params if _LINEAR_W.match(n)]:
        prefix = name[:-len(".w")]
        w = params.pop(name)
        for k, t in quantize(w).items():
            params[f"{prefix}.{k}"] = t
        del w
    return params


def maybe_quantize_embed(params: Dict[str, torch.Tensor], cfg
                         ) -> Dict[str, torch.Tensor]:
    """Apply ``cfg.embed_quant`` to the token-embedding table, in place.
    Idempotent."""
    if cfg.embed_quant is None:
        return params
    check_modes(cfg)
    if EMBED in params:
        tokens = params.pop(EMBED)
        for k, t in quantize_embed(tokens).items():
            params[f"{EMBED}.{k}"] = t
    return params
