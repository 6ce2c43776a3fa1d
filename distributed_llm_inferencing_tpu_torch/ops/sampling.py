"""Token sampling: greedy, temperature, top-k, then top-p (HF order).

``SamplingParams`` keeps the reference's fields and defaults (temperature
0.8, top_k 50, top_p 0.95, do_sample). ``sample`` applies the same warper
pipeline as the reference's ``sample``: temperature, then top-k, then the
nucleus filter in HF's TopPLogitsWarper order (the token that crosses the
threshold is kept), and draws from what is left.

Random streams: counter-based, in plain torch ops (``_uniform``: an
integer hash, no ``torch.Generator``). ``sample`` draws row r of a call
from the key ``(seeds[r], step)``: the engine (runtime/engine.py) folds
the row into the request seed (``row_seeds``) and counts the step on the
device, so a request's tokens are a pure function of (weights, prompt,
seed), whether its decode step runs eagerly or as a captured CUDA graph
(a graph would bake a generator's state in) and however the decode is
chunked — the property the JAX engine gets from splitting its key per
step. The bits differ from ``jax.random``'s, so sampled tokens are held
to the support of the reference's ``warp_logits`` (temperature -> top-k
-> top-p; -inf outside what may be drawn), not to its tokens. Greedy
decoding is identical on both sides.

``sample_batch`` is the continuous batcher's sampler: per-row parameters
as tensors, and per-row draws from the same counter-based generator
keyed on the row's ``(seed, step)`` alone. A request's tokens are
therefore a pure function of (params, prompt, seed), whatever its
chunk-mates and however admission and preemption interleave — the
property the JAX batcher gets from ``fold_in(PRNGKey(seed), step)``;
greedy rows are ``argmax``, bitwise.

``warp_logits`` (speculation only, ops/speculative.py) gives the warped
logits ``sample`` draws from; ``batch_support`` the masked logits
``sample_batch`` draws from, per row; ``tagged_uniform`` a second stream
per (seed, step), independent of the draws, for acceptance tests.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.8
    top_k: int = 50
    top_p: float = 0.95
    do_sample: bool = True

    @staticmethod
    def greedy() -> "SamplingParams":
        return SamplingParams(do_sample=False)


def _nucleus(sorted_vals, p: float):
    """Mask sorted-descending logits outside the top-p nucleus: position i
    is dropped when the mass before it already reaches p."""
    probs = torch.softmax(sorted_vals, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < p
    return sorted_vals.masked_fill(~keep, float("-inf"))


def _draw(probs, key):
    """One categorical draw per row of probs [R, n]: argmax(p / E) with
    E = -log(U) ~ Exp(1), which picks i with probability p_i. U comes from
    the counter-based stream of ``key`` = (seeds [R], steps [R] or [1])
    (``_uniform``), so the draw never syncs with the host."""
    seeds, steps = key
    e = -torch.log(_uniform(seeds, steps, probs.shape[-1]))
    return torch.argmax(probs / e, dim=-1, keepdim=True)


def sample(logits, key, params: SamplingParams):
    """Next tokens from logits [..., V]; returns [...] int64 on the logits'
    device. ``key`` = (seeds, steps): row r of the flattened rows draws
    from ``(seeds[r], steps[r])`` (steps may be one shared [1] counter);
    greedy reads no key (None is fine). Never syncs with the host."""
    logits = logits.float()
    if not params.do_sample:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(params.temperature, 1e-6)
    lead, V = logits.shape[:-1], logits.shape[-1]
    flat = logits.reshape(-1, V)
    if 0 < params.top_k < V:
        # top-p over the top-k subset only: after the top-k warper the
        # distribution lives on those k tokens, so this is exact
        vals, idx = torch.topk(flat, params.top_k, dim=-1)   # descending
        if params.top_p < 1.0:
            vals = _nucleus(vals, params.top_p)
        j = _draw(torch.softmax(vals, dim=-1), key)
        out = torch.gather(idx, -1, j)[:, 0]
    else:
        if params.top_p < 1.0:
            sv, si = torch.sort(flat, dim=-1, descending=True)
            j = _draw(torch.softmax(_nucleus(sv, params.top_p), dim=-1), key)
            out = torch.gather(si, -1, j)[:, 0]
        else:
            out = _draw(torch.softmax(flat, dim=-1), key)[:, 0]
    return out.reshape(lead)


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and c < 2^32, without
    overflowing int64: the high half's product only matters mod 2^16."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _hash32(x):
    """A 32-bit integer finaliser (lowbias32): every input bit moves
    every output bit. int64 tensor in [0, 2^32) -> same range."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _uniform(seeds, steps, n: int):
    """[R, n] f32 uniforms in (0, 1): entry (r, j) is a pure function of
    (seeds[r], steps[r], j) — a counter-based stream per row."""
    key = _hash32(_hash32(seeds.long() & _M32) ^ (steps.long() & _M32))
    j = torch.arange(n, dtype=torch.int64, device=seeds.device)
    h = _hash32(_hash32((key[:, None] + j * 0x9E3779B9) & _M32))
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def row_seeds(seed: int, rows: int, device=None):
    """[rows] int64 stream seeds of one request's rows: the row folded
    into the request ``seed``, so the rows of one call draw
    independently."""
    r = torch.arange(rows, dtype=torch.int64, device=device)
    return _hash32(_hash32(r) ^ (int(seed) & _M32))


def _gumbel_argmax(masked, seeds, steps):
    """One categorical draw per row from softmax(masked) (-inf entries
    are never drawn): argmax(masked + Gumbel noise)."""
    u = _uniform(seeds, steps, masked.shape[-1])
    return torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)


def nucleus_mask_sorted(sorted_vals, width, top_ps):
    """Mask sorted-descending logits to top-k and top-p (HF warper order:
    the token crossing the p threshold is kept).

    sorted_vals [..., KS] descending; width [..., 1] int (top-k cut,
    already clamped to KS); top_ps [..., 1] f32. Returns (masked [..., KS]
    with -inf outside the sampling support, thresh [..., 1] = smallest
    kept logit)."""
    ks = sorted_vals.shape[-1]
    ar = torch.arange(ks, device=sorted_vals.device)
    m = sorted_vals.masked_fill(~(ar < width), float("-inf"))
    probs = torch.softmax(m, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_ps
    num_keep = keep.sum(dim=-1, keepdim=True).clamp(min=1)
    thresh = torch.gather(m, -1, num_keep - 1)
    return m.masked_fill(m < thresh, float("-inf")), thresh


def batch_support(logits, temps, top_ks, top_ps):
    """The scaled logits [..., V] f32 masked to each row's sampling
    support (-inf outside): temperature, then the top-k cut (the k-th
    largest logit) and the nucleus threshold over the full sorted
    vocabulary. temps/top_ps f32 and top_ks int (0 disables) have the
    logits' leading shape. ``softmax`` of it is what ``sample_batch``
    draws from."""
    logits = logits.float()
    v = logits.shape[-1]
    scaled = logits / temps.float().clamp(min=1e-6)[..., None]
    k = torch.where(top_ks <= 0, v, top_ks.clamp(1, v)).long()
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, -1, (k - 1)[..., None])
    _, thresh = nucleus_mask_sorted(sorted_desc, k[..., None],
                                    top_ps.float()[..., None])
    return scaled.masked_fill((scaled < kth) | (scaled < thresh),
                              float("-inf"))


def sample_batch(logits, seeds, steps, temps, top_ks, top_ps, do_sample):
    """Per-row sampling for the continuous batcher.

    logits [R, V]; seeds/steps [R] int — each row draws from its own
    stream keyed on (seed, step); temps/top_ps [R] f32; top_ks [R] int (0
    disables); do_sample [R] bool (False -> greedy argmax). Returns [R]
    int64 on the logits' device, with no host sync.

    One draw over the full, sorted vocabulary: the top-k cut (the k-th
    largest logit) and the nucleus threshold mask the scaled logits
    (``batch_support``), and a Gumbel-max draw picks among what is left.
    The JAX package adds a top-PREFIX_K tier so that ``lax.cond`` can
    skip the sort when every row is covered; here the sort runs every
    step, so one tier gives the same support for every k.
    """
    masked = batch_support(logits, temps, top_ks, top_ps)
    sampled = _gumbel_argmax(masked, seeds, steps)
    return torch.where(do_sample, sampled, torch.argmax(logits.float(),
                                                        dim=-1))


def tagged_uniform(seeds, steps, tag: int):
    """f32 uniforms in (0, 1) of the broadcast shape of seeds and steps:
    entry i a pure function of (seeds[i], steps[i], tag), from a stream
    that ``_uniform``'s draws at the same (seed, step) never share (the
    acceptance tests of speculative verification, ops/speculative.py)."""
    key = _hash32(_hash32(seeds.long() & _M32) ^ (steps.long() & _M32))
    h = _hash32(_hash32(key ^ (int(tag) & _M32)))
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _mask_top_k(logits, k: int):
    """Keep the k largest logits per row (ties at the k-th kept)."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _mask_top_p(logits, p: float):
    """Nucleus filter over the full vocabulary: keep the smallest prefix
    of the sorted distribution reaching mass p (the crossing token kept,
    HF's TopPLogitsWarper)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < p
    num_keep = keep.sum(dim=-1, keepdim=True)
    thresh = torch.gather(sorted_logits, -1, num_keep - 1)
    return logits.masked_fill(logits < thresh, float("-inf"))


def warp_logits(logits, params: SamplingParams):
    """The HF warper pipeline (temperature -> top_k -> top_p) as masked
    logits [..., V] f32, -inf outside the sampling support: ``softmax``
    of it is the distribution ``sample`` draws from (the JAX package's
    ``warp_logits``, which only speculative verification uses). Greedy
    params return the raw logits."""
    logits = logits.float()
    if not params.do_sample:
        return logits
    logits = logits / max(params.temperature, 1e-6)
    return _mask_top_p(_mask_top_k(logits, params.top_k), params.top_p)
