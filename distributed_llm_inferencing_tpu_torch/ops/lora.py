"""Gathered batched LoRA delta for multi-adapter waves.

The port's copy of the JAX package's ``ops/lora.py``. One shared base
weight pass serves every row of a wave; each row then adds its own
adapter's rank-r delta ``x @ A_s @ B_s``, where ``s`` is the row's
adapter slot, riding the wave's inputs as data. The slot indexes a
stacked device pack, ``A [S, din, rmax]`` / ``B [S, rmax, dout]`` per
projection and layer, so a wave mixing any assignment of the resident
adapters runs one program: adapter mixes change gather indices, never
shapes. Slot 0 is the base model (all-zero A and B: an exact-zero
delta), and the ``alpha / rank`` scale is folded into B when the pack is
built (models/lora.py), so the hot path is two batched products.

The JAX delta is plain XLA (two ``einsum``s over the gathered rows), not
a Pallas kernel, so the port's is plain torch: ``torch.bmm`` over the
rows gathered by slot.
"""

from __future__ import annotations

import torch


def gathered_delta(x: torch.Tensor, pack: dict, ids: torch.Tensor
                   ) -> torch.Tensor:
    """Per-row LoRA delta: ``out[b] = x[b] @ A[ids[b]] @ B[ids[b]]``.

    x: [B, T, din] activations (T is 1 at decode, the padded tail at
    admission). pack: ``{"a": [S, din, rmax], "b": [S, rmax, dout]}``,
    one layer's slice of the device pack, cast to x's dtype as the JAX
    function casts it. ids: [B] integer slot per row (0 = base). Returns
    [B, T, dout] in x's dtype."""
    ids = ids.long()
    a = pack["a"][ids].to(x.dtype)           # [B, din, rmax]
    b = pack["b"][ids].to(x.dtype)           # [B, rmax, dout]
    return torch.bmm(torch.bmm(x, a), b)


def merge_into_dense(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """The dense weight a LoRA pair is equivalent to, ``w + scale * (a @
    b)`` with ``scale = alpha / rank`` (the factor ``build_pack`` folds
    into B). For differential tests; serving never merges."""
    return w + scale * (a.to(w.dtype) @ b.to(w.dtype))
