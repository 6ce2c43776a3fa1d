"""Rotary position embeddings (RoPE): llama/HF rotate-half, partial and
GPT-J interleaved.

Of head_dim hd, the first ``rot = int(hd * pct)`` dims rotate (GPT-NeoX
rotary_pct, Phi partial_rotary_factor, GPT-J rotary_dim) and the rest
pass through. Rotate-half pairs dim i with i + rot/2 (transformers'
LlamaRotaryEmbedding); interleaved pairs 2i with 2i + 1 (GPT-J's
rotate_every_two). Either way frequency i of the ladder over ``rot``
turns pair i.
"""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    """inv_freq: [head_dim//2] float32."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rotary_dim(head_dim: int, pct: float = 1.0) -> int:
    """The rotated width ``int(head_dim * pct)``; it must be even (a
    rotation turns pairs)."""
    rot = int(head_dim * pct)
    if rot % 2 or rot < 2:
        raise ValueError(f"rotary width int({head_dim} * {pct}) = {rot} "
                         "must be even and >= 2")
    return rot


def rope_cos_sin(positions, head_dim: int, theta: float, inv_freq=None,
                 attn_factor: float = 1.0):
    """(cos, sin), each [B, S, 1, head_dim//2] f32, for int positions
    [B, S]; ``head_dim`` is the rotated width. Computed once per forward
    and shared by every layer's q/k."""
    if inv_freq is None:
        inv_freq = rope_freqs(head_dim, theta, positions.device)
    else:
        inv_freq = torch.as_tensor(inv_freq, dtype=torch.float32,
                                   device=positions.device)
    angles = positions.float()[..., None] * inv_freq
    cos = torch.cos(angles)[:, :, None, :] * attn_factor
    sin = torch.sin(angles)[:, :, None, :] * attn_factor
    return cos, sin


def apply_rope(x, positions, theta: float, pct: float = 1.0,
               interleaved: bool = False, inv_freq=None,
               attn_factor: float = 1.0, cos_sin=None):
    """Apply RoPE. x: [B, S, H, hd]; positions: [B, S] int.

    ``cos_sin`` takes a precomputed ``rope_cos_sin`` pair over the rotated
    width (then ``positions``/``theta``/``inv_freq`` are not read).
    Returns the shape and dtype of x.
    """
    hd = x.shape[-1]
    rot = rotary_dim(hd, pct)
    cos, sin = cos_sin if cos_sin is not None else rope_cos_sin(
        positions, rot, theta, inv_freq, attn_factor)
    xf = x[..., :rot].float()
    if interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(xf.shape)
    else:
        x1, x2 = xf[..., : rot // 2], xf[..., rot // 2:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = out.to(x.dtype)
    return out if rot == hd else torch.cat([out, x[..., rot:]], dim=-1)
