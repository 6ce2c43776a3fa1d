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
(int4); ``embed.tokens`` becomes ``embed.tokens.q8`` +
``embed.tokens.rscale``. Chunk-local int4 packs (the JAX package's
``repack_int4_rows``, for row-parallel leaves under tensor parallelism)
are not ported: they come with multi-GPU serving (ROADMAP A12).
"""

from __future__ import annotations

import re
from typing import Dict

import torch

MODES = ("int8", "int4")

# the llama arm's leaves of the JAX package's _LINEAR_LEAVES, plus the
# untied head; embeddings, norms and biases stay float
LINEAR_LEAVES = ("q", "k", "v", "o", "gate", "up", "down")
_LINEAR_W = re.compile(
    r"^(layers\.\d+\.(?:%s)|lm_head)\.w$" % "|".join(LINEAR_LEAVES))
EMBED = "embed.tokens"


_CHUNKED = ("chunk-local int4 packs (row-parallel leaves under tensor "
            "parallelism) are not ported: ROADMAP A12")


def refuse_chunked(leaf):
    """Raise for a leaf carrying the JAX package's ``chunked`` marker."""
    if "chunked" in leaf:
        raise NotImplementedError(_CHUNKED)


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
    """uint8 [..., din/2, dout] -> sign-extended int8 [..., din, dout]."""
    if chunks != 1:
        raise NotImplementedError(_CHUNKED)
    lo = (p4 & 0xF).to(torch.int8) - 8
    hi = ((p4 >> 4) & 0xF).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=-2)


def quantize_weight_int4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """w [..., din, dout] -> {"p4": packed uint8, "scale": f32 [..., dout]}."""
    w32 = w.float()
    scale = w32.abs().amax(dim=-2).clamp_min(1e-8) / 7.0
    q = torch.clamp(torch.round(w32 / scale[..., None, :]), -7, 7)
    return {"p4": pack_int4(q.to(torch.int8)), "scale": scale}


# a linear leaf's stored tensors, by form
LEAF_KEYS = {"float": ("w",), "int8": ("q", "scale"),
             "int4": ("p4", "scale")}


def leaf_form(leaf) -> str:
    """"float", "int8" or "int4" for a linear leaf; raises for a chunked
    leaf and for any other set of keys."""
    refuse_chunked(leaf)
    for form, keys in LEAF_KEYS.items():
        if set(leaf) == set(keys):
            return form
    raise ValueError(f"unknown linear leaf {sorted(leaf)}")


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and ("q" in leaf or "p4" in leaf)


def dequantize_weight(leaf: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The float weight of an int8 or int4 leaf, f32 (tests and plain
    versions)."""
    refuse_chunked(leaf)
    levels = unpack_int4(leaf["p4"]) if "p4" in leaf else leaf["q"]
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
