"""Normalization layers, computed in float32 whatever the activation
dtype — the reference's recipe (bf16 matmuls, f32 reductions).

``norm`` / ``Norm`` pick the form by ``norm_type``: "rmsnorm" reads a
leaf ``{"scale"}``, "layernorm" ``{"scale", "bias"}``. ``qk_normalize``
is the reference's ``_qk_normalize``, the q/k norms of
``ModelConfig.qk_norm``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last axis. scale/bias: [D]."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def rms_norm(x, scale, eps: float = 1e-5):
    """RMSNorm over the last axis (llama-style). scale: [D]."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * (1.0 / torch.sqrt(ms + eps))
    y = y * scale.float()
    return y.to(x.dtype)


def norm(x, leaf: Dict[str, torch.Tensor], norm_type: str, eps: float):
    if norm_type == "rmsnorm":
        return rms_norm(x, leaf["scale"], eps)
    return layer_norm(x, leaf["scale"], leaf["bias"], eps)


class Norm(nn.Module):
    """``norm`` over a leaf held as parameters (no copy)."""

    def __init__(self, leaf: Dict[str, torch.Tensor], norm_type: str,
                 eps: float):
        super().__init__()
        self.norm_type, self.eps = norm_type, eps
        self.scale = nn.Parameter(leaf["scale"], requires_grad=False)
        self.bias = (nn.Parameter(leaf["bias"], requires_grad=False)
                     if norm_type == "layernorm" else None)

    def forward(self, x):
        return norm(x, {"scale": self.scale, "bias": self.bias},
                    self.norm_type, self.eps)


def qk_normalize(t, scale, kind: str, eps: float, ms=None):
    """``ModelConfig.qk_norm`` on a projected q or k [B,s,H,hd]:
    "rms_head" RMS-normalizes each head over hd with one shared [hd]
    scale (qwen3); "ln_head" is a bias-free LayerNorm per head with
    distinct per-head scales, stored flat [H*hd] (cohere); "rms_full"
    RMS-normalizes the flattened [H*hd] projection (olmo2), over the
    mean square ``ms`` [B,s,1] f32 when given (a tp rank's heads are a
    slice of the projection: the mean spans every rank's)."""
    B, s, H, hd = t.shape
    if kind == "rms_full":
        if ms is None:
            return rms_norm(t.reshape(B, s, H * hd), scale,
                            eps).reshape(B, s, H, hd)
        y = t.reshape(B, s, H * hd).float() * (1.0 / torch.sqrt(ms + eps))
        return (y * scale.float()).to(t.dtype).reshape(B, s, H, hd)
    if kind == "ln_head":
        return layer_norm(t, scale.reshape(H, hd),
                          torch.zeros((), dtype=t.dtype, device=t.device),
                          eps)
    return rms_norm(t, scale, eps)
