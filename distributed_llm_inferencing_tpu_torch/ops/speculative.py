"""Speculative decoding: prompt-lookup drafts and one-pass verification.

The port's own copy of the JAX package's ``ops/speculative.py``. Decode
streams every weight once per token; a verify pass scores ``gamma``
drafted tokens in one forward (``gamma + 1`` query rows) and keeps the
prefix the model agrees with, so one weight pass can emit up to
``gamma + 1`` tokens. Drafts are *prompt lookup*: the continuation of the
most recent earlier occurrence of the trailing bigram in the token
history (``propose_ngram`` on the host, ``propose_ngram_device`` as a
compare/gather over a device history for the batcher's chunk).

Acceptance keeps the target distribution: greedy rows accept a draft
while it equals the argmax (tokens identical to plain greedy decode);
sampled rows run the delta-draft leave-one-out rejection rule (accept
draft i with probability p_i(d_i); on the first rejection draw from p_i
with d_i removed).

Random streams are the port's counter-based ones (ops/sampling.py), keyed
per absolute position as in the JAX package: the acceptance test of
draft i on ``(seed, steps + i)`` (``tagged_uniform``, a stream of its
own) and the stop token's draw on ``(seed, steps + n_acc)``. The stop
draw is ``sample_batch``'s own draw at that position, so a width-0 row
emits exactly the plain chunk's token, and a migrated sampled stream
continues on the same draws.

``AdaptiveSpecController`` decides per chunk whether to draft and at
what width; its exported state is the JAX controller's JSON, so resume
records cross packages.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence

import torch

from distributed_llm_inferencing_tpu_torch.ops.sampling import (
    SamplingParams, _draw, _gumbel_argmax, batch_support, tagged_uniform,
    warp_logits)

# stream tags of the acceptance tests (the JAX package folds 0x5acc too)
ACCEPT_TAG = 0x5ACC


class AdaptiveSpecController:
    """Chunk-by-chunk decision: draft (and at what gamma) or run plain
    decode, so ``speculative="ngram"`` never loses to plain for long.

    Empirical, as the JAX controller: EMAs of decode tokens/s for the
    spec and plain arms (chunks that included a capture are excluded), a
    rolling acceptance rate over the last ``window`` speculative chunks;
    in spec mode low acceptance halves gamma, and at the floor (or with
    measured spec tok/s under plain by the hysteresis) falls back to
    plain; high acceptance doubles gamma back. Probes keep both arms
    measured: a spec probe every ``probe_every`` plain chunks and a plain
    probe every ``probe_every`` spec chunks.

    The caller owns the measurements; this object owns the policy.
    Greedy output is mode-invariant, and sampled rows draw per position,
    so only the clock-driven clause (tok/s, armed once both arms are
    measured) depends on wall time.
    """

    def __init__(self, gamma_max: int, *, window: int = 16,
                 probe_every: int = 32, warmup: int = 3,
                 min_evidence: int = 3, min_accept: float = 0.12,
                 grow_accept: float = 0.5, hysteresis: float = 0.9,
                 ema_alpha: float = 0.3):
        self.gamma_max = max(1, int(gamma_max))
        self.gamma = self.gamma_max
        self.mode = "spec"           # "spec" | "plain"
        self.window = window
        self.probe_every = probe_every
        self.warmup = warmup
        self.min_evidence = max(1, min_evidence)
        self.min_accept = min_accept
        self.grow_accept = grow_accept
        self.hysteresis = hysteresis
        self.ema_alpha = ema_alpha
        self.spec_tps: Optional[float] = None
        self.plain_tps: Optional[float] = None
        self.fallbacks = 0           # spec -> plain transitions
        self.reactivations = 0       # plain -> spec transitions
        self._accept = collections.deque(maxlen=window)  # (accepted, drafted)
        self._spec_chunks = 0
        self._plain_chunks = 0
        self._since_probe = 0        # plain mode: chunks since spec probe
        self._since_plain_probe = 0  # spec mode: chunks since plain probe

    def choose(self) -> int:
        """Gamma for the next chunk; 0 means run plain decode."""
        if self.mode == "spec":
            self._since_plain_probe += 1
            if (self._spec_chunks >= self.warmup
                    and self._since_plain_probe >= self.probe_every):
                self._since_plain_probe = 0
                return 0             # plain probe: measure the other arm
            return self.gamma
        self._since_probe += 1
        if self._since_probe >= self.probe_every:
            self._since_probe = 0
            return self.gamma        # spec probe
        return 0

    def acceptance(self) -> Optional[float]:
        drafted = sum(d for _, d in self._accept)
        if not drafted:
            return None
        return sum(a for a, _ in self._accept) / drafted

    def _ema(self, prev: Optional[float], x: float) -> float:
        if prev is None:
            return x
        return prev + self.ema_alpha * (x - prev)

    def record(self, mode: str, *, emitted: int, elapsed_s: float,
               drafted: int = 0, accepted: int = 0,
               compiled: bool = False) -> None:
        """Feed one chunk's measurements back. ``compiled`` marks a chunk
        whose dispatch included a capture (its time is not decode
        time)."""
        tps = emitted / elapsed_s if elapsed_s > 0 else None
        if mode == "spec":
            self._spec_chunks += 1
            if drafted:
                self._accept.append((accepted, drafted))
            if not compiled and tps is not None:
                self.spec_tps = self._ema(self.spec_tps, tps)
            self._after_spec()
        else:
            self._plain_chunks += 1
            if not compiled and tps is not None:
                self.plain_tps = self._ema(self.plain_tps, tps)

    def _after_spec(self) -> None:
        if self._spec_chunks < self.warmup:
            return
        acc = (self.acceptance()
               if len(self._accept) >= self.min_evidence else None)
        losing_tps = (self.spec_tps is not None
                      and self.plain_tps is not None
                      and self.spec_tps < self.plain_tps * self.hysteresis)
        if self.mode == "plain":
            # a probe's verdict: this probe alone
            acc = None
            if self._accept:
                a, d = self._accept[-1]
                acc = a / d if d else None
            if ((acc is not None and acc >= self.grow_accept)
                    or (self.spec_tps is not None
                        and self.plain_tps is not None
                        and self.spec_tps * self.hysteresis
                        > self.plain_tps)):
                self.mode = "spec"
                self.reactivations += 1
                self._since_plain_probe = 0
            return
        if losing_tps or (acc is not None and acc < self.min_accept):
            if self.gamma > 2 and not losing_tps:
                self.gamma = max(2, self.gamma // 2)  # shorter draft first
                self._accept.clear()   # re-measure at the new gamma
            else:
                self.mode = "plain"
                self.fallbacks += 1
                self._since_probe = 0
                self._accept.clear()
        elif (acc is not None and acc >= self.grow_accept
                and self.gamma < self.gamma_max):
            self.gamma = min(self.gamma_max, self.gamma * 2)

    def export_state(self) -> dict:
        """The request-owned half of the state (gamma, mode, acceptance
        window, chunk counts) as JSON for a migration's resume record;
        the throughput EMAs and probe clocks measure the host and stay
        behind."""
        return {
            "gamma": int(self.gamma), "mode": str(self.mode),
            "accept": [[int(a), int(d)] for a, d in self._accept],
            "spec_chunks": int(self._spec_chunks),
            "plain_chunks": int(self._plain_chunks),
        }

    def load_state(self, state: dict) -> None:
        """Adopt a migrated request's exported state; a malformed field
        is ignored on its own, never raised."""
        if not isinstance(state, dict):
            return
        try:
            g = int(state.get("gamma", self.gamma))
            self.gamma = min(self.gamma_max, max(1, g))
        except (TypeError, ValueError):
            pass
        if state.get("mode") in ("spec", "plain"):
            self.mode = state["mode"]
        acc = state.get("accept")
        if isinstance(acc, list):
            self._accept.clear()
            for pair in acc[-self.window:]:
                try:
                    a, d = pair
                    self._accept.append((int(a), int(d)))
                except (TypeError, ValueError):
                    continue
        for key, attr in (("spec_chunks", "_spec_chunks"),
                          ("plain_chunks", "_plain_chunks")):
            try:
                setattr(self, attr, max(0, int(state.get(key, 0))))
            except (TypeError, ValueError):
                pass

    def stats(self) -> dict:
        acc = self.acceptance()
        return {
            "mode": self.mode, "gamma": self.gamma,
            "acceptance": None if acc is None else round(acc, 3),
            "spec_tokens_per_s":
                None if self.spec_tps is None else round(self.spec_tps, 1),
            "plain_tokens_per_s":
                None if self.plain_tps is None else round(self.plain_tps, 1),
            "fallbacks": self.fallbacks,
            "reactivations": self.reactivations,
            "spec_chunks": self._spec_chunks,
            "plain_chunks": self._plain_chunks,
        }


def propose_ngram(history: Sequence[int], gamma: int,
                  n: int = 2) -> Optional[List[int]]:
    """Prompt-lookup draft: the continuation of the most recent earlier
    occurrence of the trailing ``n``-gram of ``history``, right-padded to
    gamma tokens by repeating its last token; None when the n-gram never
    occurred before."""
    h = list(history)
    if len(h) < n + 1:
        return None
    key = h[-n:]
    for i in range(len(h) - n - 1, -1, -1):
        if h[i:i + n] == key:
            cont = h[i + n:i + n + gamma]
            if not cont:
                continue
            return cont + [cont[-1]] * (gamma - len(cont))
    return None


def propose_ngram_device(history, lengths, gamma: int, n: int = 2):
    """``propose_ngram`` (n = 2) for R rows on the device, with no host
    sync: history [R, H] int (row r valid to lengths[r], the known tokens
    including the current one). Returns (drafts [R, gamma] int64,
    has_draft [R] bool); a row without a match drafts its current token
    repeated (a bad draft is only rejected)."""
    assert n == 2, "device drafting implements the serving default n=2"
    r, h = history.shape
    hist = history.long()
    lengths = lengths.long()
    idx = torch.arange(h, device=hist.device)[None, :]
    last = torch.gather(hist, 1, (lengths - 1).clamp(min=0)[:, None])
    prev = torch.gather(hist, 1, (lengths - 2).clamp(min=0)[:, None])
    nxt = torch.cat([hist[:, 1:], torch.zeros_like(hist[:, :1])], dim=1)
    # start i: h[i] == prev, h[i+1] == last, i + 2 < length (a non-empty
    # continuation that is not the trailing bigram itself)
    m = ((hist == prev) & (nxt == last) & (idx + 2 < lengths[:, None])
         & (lengths[:, None] >= 3))
    has = m.any(dim=1)
    pos = torch.where(m, idx, -1).amax(dim=1)
    g_idx = pos[:, None] + 2 + torch.arange(gamma, device=hist.device)
    g_idx = torch.minimum(g_idx, lengths[:, None] - 1).clamp(min=0)
    drafts = torch.gather(hist, 1, g_idx)
    return torch.where(has[:, None], drafts, last), has


def accept_rejection_batch(logits, drafts, seeds, steps, temps, top_ks,
                           top_ps, ds, widths=None):
    """Per-row draft acceptance for the batcher's speculative chunk, with
    sampling parameters as data.

    logits [R, G+1, V] f32 (position i scores the token after i accepted
    drafts); drafts [R, G]; seeds/steps [R] (``steps``: the row's emitted
    count); temps/top_ps [R] f32; top_ks [R] int (0 disables); ds [R]
    bool; ``widths`` [R] in [0, G] (default G): row r judges only its
    first ``widths[r]`` drafts. Running out of width is not a rejection:
    the stop token then draws from the whole distribution.

    Greedy rows accept a draft while it equals the argmax and stop on the
    argmax. Sampled rows accept draft i with probability p_i(d_i) under
    ``batch_support``'s distribution (``sample_batch``'s), drawn on
    (seed, steps + i) of the tagged stream; on the first rejection the
    stop token draws from p_i without d_i. The stop draw is
    ``sample_batch``'s draw at (seed, steps + n_acc): a width-0 row emits
    exactly the plain chunk's token.

    Returns (toks_out [R, G+1], n_emit [R]): row r emits
    ``toks_out[r, :n_emit[r]]``, before the caller's budget/eos clamp.
    """
    r, g = drafts.shape
    g1 = g + 1
    dev = logits.device
    drafts = drafts.long()
    steps = steps.long()
    masked = batch_support(
        logits, temps[:, None].expand(r, g1), top_ks[:, None].expand(r, g1),
        top_ps[:, None].expand(r, g1))                        # [R, G1, V]
    probs = torch.softmax(masked[:, :-1], dim=-1)              # [R, G, V]
    p_draft = torch.gather(probs, -1, drafts[..., None])[..., 0]
    if widths is None:
        widths = torch.full((r,), g, dtype=torch.long, device=dev)
    widths = widths.long().clamp(0, g)
    ar = torch.arange(g, device=dev)
    u = tagged_uniform(seeds[:, None], steps[:, None] + ar, ACCEPT_TAG)
    targets = torch.argmax(logits.float(), dim=-1)             # [R, G1]
    acc = torch.where(ds[:, None], u < p_draft,
                      drafts == targets[:, :-1])
    acc = acc & (ar[None, :] < widths[:, None])
    n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)         # [R]

    stop_greedy = torch.gather(targets, 1, n_acc[:, None])[:, 0]
    m_stop = torch.gather(
        masked, 1, n_acc[:, None, None].expand(r, 1, masked.shape[-1]))[:, 0]
    rejected = torch.gather(drafts, 1, n_acc.clamp(max=g - 1)[:, None])
    was_rejection = n_acc < widths
    vocab = torch.arange(masked.shape[-1], device=dev)[None, :]
    m_res = m_stop.masked_fill((vocab == rejected) & was_rejection[:, None],
                               float("-inf"))
    stop_sampled = _gumbel_argmax(m_res, seeds, steps + n_acc)
    stop = torch.where(ds, stop_sampled, stop_greedy)

    pos = torch.arange(g1, device=dev)[None, :]
    draft_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    toks_out = torch.where(pos == n_acc[:, None], stop[:, None], draft_pad)
    return toks_out, n_acc + 1


def verify_step(model, cache, cur, drafts, key, sp: SamplingParams):
    """Score ``[cur, drafts...]`` in one forward over the dense cache and
    accept the longest draft prefix the target distribution keeps (the
    JAX package's ``verify_step``).

    model: a ``Transformer``; cur [B] (not yet cached); drafts [B, G];
    key (seeds [B], step [1] or [B]): the draws' streams, keyed per
    absolute position (acceptance of draft i on step + i, the stop token
    on step + n_acc). Writes K/V of all G+1 tokens at positions
    [L0, L0+G] and advances ``cache.lengths`` in place by the emitted
    count (rejected positions hold garbage that later steps overwrite in
    order). Returns (tokens [B, G+1], n_emit [B]); no host sync."""
    b, g = drafts.shape
    drafts = drafts.long()
    toks_in = torch.cat([cur.long()[:, None], drafts], dim=1)
    l0 = cache.lengths
    q_pos = l0.long()[:, None] + torch.arange(g + 1, device=cur.device)
    logits, _ = model.forward(toks_in, cache, l0, q_pos, l0 + g + 1)
    seeds, step = key
    step = step.long().expand(b)
    warped = warp_logits(logits, sp)                          # [B, G1, V]
    if sp.do_sample:
        probs = torch.softmax(warped[:, :-1], dim=-1)
        p_draft = torch.gather(probs, -1, drafts[..., None])[..., 0]
        ar = torch.arange(g, device=cur.device)
        acc = tagged_uniform(seeds[:, None], step[:, None] + ar,
                             ACCEPT_TAG) < p_draft
    else:
        acc = drafts == torch.argmax(logits, dim=-1)[:, :-1]
    n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)        # [B] 0..G
    stop_logits = torch.gather(
        warped, 1, n_acc[:, None, None].expand(b, 1, warped.shape[-1]))[:, 0]
    rejected = torch.gather(drafts, 1, n_acc.clamp(max=g - 1)[:, None])
    vocab = torch.arange(stop_logits.shape[-1], device=cur.device)[None, :]
    stop_logits = stop_logits.masked_fill(
        (vocab == rejected) & (n_acc < g)[:, None], float("-inf"))
    if sp.do_sample:
        stop = _draw(torch.softmax(stop_logits, dim=-1),
                     (seeds, step + n_acc))[:, 0]
    else:
        stop = torch.argmax(stop_logits, dim=-1)
    idx = torch.arange(g + 1, device=cur.device)[None, :]
    draft_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    tokens = torch.where(idx == n_acc[:, None], stop[:, None], draft_pad)
    n_emit = n_acc + 1
    cache.lengths.copy_(l0 + n_emit.to(l0.dtype))
    return tokens, n_emit
