"""Pipeline parallelism in the batcher: the paged programs over pp stages.

Port of the JAX package's ``parallel/paged_pipeline.py``. Each stage is a
``BatcherRank`` (runtime/batcher.py) holding its layers and their slice
of the paged pool; the leader's scheduler is unchanged, and every stage
replays each of its device programs with the same host inputs. The R
slots (a multiple of pp) form pp microbatches of R/pp; at tick t stage p
works on microbatch (t − p) mod pp at iteration (t − p) div pp, so a
K-step chunk takes K·pp + pp − 1 ticks and an admission wave (its rows a
multiple of pp, one pass) 2·pp − 1.

- ``prefill_tail_pp``: ``Transformer.paged_prefill_tail`` per microbatch
  and stage; the last stage's last-token logits, sampled there.
- ``decode_chunk_pp``: ``Transformer.paged_chunk_step`` per microbatch
  and stage: the float pool written in place and attended by the paged
  (or fused) kernel, as at pp=1 (the JAX pipelined chunk uses the side
  buffers for every pool; the port keeps them for the int8 pool alone,
  flushed after the chunk). The last stage samples from each slot's
  hash-keyed stream at the slot's step, as at pp=1.
- ``spec_chunk_pp``: ``Transformer.paged_spec_step`` per microbatch and
  stage: stage 0 drafts from the history, every stage attends the pool,
  the kept side entries and the current block, the last stage runs the
  exact rejection with the per-slot widths (wave mode); the kept entries
  are flushed into each stage's pool after the chunk.

Every stage holds the chunk's whole state, loaded from the same inputs.
Where the JAX package rides a microbatch's state around the ring, here a
hop carries the activations and the last stage's outcome for that
microbatch (its tokens; with speculation its kept counts and eos flags),
and each stage applies the outcome to its own copy before the
microbatch's next iteration (``_apply_plain`` / ``_apply_spec``): every
stage runs the same state on the same bits. The outputs go from the last
stage's leader to every rank in one broadcast at the chunk's end (so the
leader's scheduler sees every token, and every rank's digest is equal),
and there the other stages apply the last iteration's kept entries
before the flush.

Both ends of every hop derive from (t, p, K, pp) alone whether it
happens, and a ring posts its edges in one order (parallel/mesh.py
``Ring``), so no tick can leave a stage waiting on a hop its peer never
posts.
"""

from __future__ import annotations

import torch

from distributed_llm_inferencing_tpu_torch.ops import fused_decode
from distributed_llm_inferencing_tpu_torch.ops.sampling import sample_batch
from distributed_llm_inferencing_tpu_torch.ops.speculative import (
    accept_rejection_batch, propose_ngram_device)
from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    grid_rank, pack, packed_size, unpack)


def _last_leader(group) -> int:
    """The rank whose outputs every rank takes: the last stage's (0, 0)."""
    return grid_rank(group.spec, group.spec.pp - 1, 0, 0)


def prefill_tail_pp(model, group, tokens, tail_len, tail_blocks,
                    prefix_blocks, prefix_len, paged):
    """An admission wave of b rows (b a multiple of pp), pipelined: the
    pool written in place on every stage. Returns the last stage's
    last-token logits [b, V] f32 there, None on the other stages."""
    pp, p = group.spec.pp, group.coords[0]
    last = p == pp - 1
    b, t = tokens.shape
    mb = b // pp
    ar = torch.arange(t, device=tokens.device)
    q_pos = prefix_len.long()[:, None] + ar
    tail_valid = ar[None, :] < tail_len.long()[:, None]
    x_like = [((mb, t, model.cfg.hidden_size), model.dtype)]
    out = (torch.empty((b, model.cfg.vocab_size), dtype=torch.float32,
                       device=tokens.device) if last else None)
    got = None
    for tick in range(2 * pp - 1):
        m = tick - p
        x = None
        if 0 <= m < pp:
            r = slice(m * mb, (m + 1) * mb)
            x = (model.embed(tokens[r], q_pos[r]) if p == 0
                 else unpack(got, x_like)[0])
            cos_sin = model._cos_sin(q_pos[r])
            for i, layer in enumerate(model.layers):
                x = layer.paged_prefill(
                    x, paged.layer(i), cos_sin, tail_blocks[r],
                    prefix_blocks[r], prefix_len[r], q_pos[r],
                    tail_valid[r])
            if last:
                end = (tail_len[r].long() - 1).clamp(min=0)
                out[r] = model.unembed(
                    x[torch.arange(mb, device=x.device), end][:, None])[:, 0]
        send = pack([x]) if x is not None and not last else None
        recv = (packed_size(x_like)
                if p > 0 and 0 <= tick - (p - 1) < pp else 0)
        got = group.pp.exchange(send, recv)
    return out


def broadcast_from_last(group, t: torch.Tensor) -> torch.Tensor:
    """The last stage leader's ``t`` on every rank (in place)."""
    return group.broadcast(t, src=_last_leader(group))


def _ticks(k: int, pp: int, p: int):
    """(tick, microbatch, iteration or None, hop out, hop in) of stage p's
    K-iteration schedule: a tick's work is None where p idles; p hops
    out to p + 1 after each valid tick (the last stage wraps to stage 0
    while the microbatch has an iteration left), and hops in whatever
    its predecessor sends."""
    def valid(q, tick):
        return 0 <= tick - q < k * pp

    def wraps(tick):
        return pp <= tick + 1 < k * pp

    for tick in range(k * pp + pp - 1):
        j = tick - p
        work = (j % pp, j // pp) if valid(p, tick) else None
        out = wraps(tick) if p == pp - 1 else valid(p, tick)
        inn = wraps(tick) if p == 0 else valid(p - 1, tick)
        yield tick, work, out, inn


def _apply_plain(s, r, d: int, nxt, emit):
    """Iteration d's outcome for slots ``r`` of a decode chunk's state
    (``Transformer.paged_chunk_step``'s update)."""
    alive = s.alive[r].bool()
    s.cl[r] += alive.to(s.cl.dtype)
    s.alive[r] = (emit.bool() & (d + 1 < s.budget[r])).to(s.alive.dtype)
    s.cur[r] = nxt.to(s.cur.dtype)


def decode_chunk_pp(model, group, s, paged, dummy_block: int, k: int):
    """K decode iterations of every slot of ``s`` (a loaded
    ``PagedChunkState``), pipelined; an int8 pool's chunk flushed at the
    end. Returns [2, K, R] (tokens, emit flags) on every rank."""
    pp, p = group.spec.pp, group.coords[0]
    last = p == pp - 1
    r_all = s.bt.shape[0]
    mb = r_all // pp
    dev = s.bt.device
    cfg = model.cfg
    quantized = paged.quantized
    fused = fused_decode.eligible(cfg, quantized,
                                  model.tp.world if model.tp else 1)
    fwd_like = [((mb, 1, cfg.hidden_size), model.dtype),
                ((2, mb), torch.int64)]
    wrap_like = [((2, mb), torch.int64)]
    in_like = wrap_like if p == 0 else fwd_like
    applied = torch.zeros((2, mb), dtype=torch.int64, device=dev)
    got = None
    for tick, work, hop_out, hop_in in _ticks(k, pp, p):
        send = None
        if work is not None:
            m, d = work
            r = slice(m * mb, (m + 1) * mb)
            x = None
            if got is not None:
                parts = unpack(got, in_like)
                if p > 0:
                    x = parts[0]
                outc = parts[-1]
                if d > 0 and not last:
                    _apply_plain(s, r, d - 1, outc[0], outc[1])
                applied = outc.clone()
            elif d == 0:
                applied = applied.zero_()
            alive = s.alive[r].bool()
            cl = s.cl[r]
            if quantized:
                pos = torch.where(alive, cl, 0).long()[:, None]
            else:
                bt = torch.where(alive[:, None], s.bt[r], dummy_block)
                cl_eff = torch.where(alive, cl, 0)
                pos = cl_eff.long()[:, None]
            if p == 0:
                x = model.embed(s.cur[r].long()[:, None], pos)
            cos_sin = model._cos_sin(pos)
            if quantized:
                x = _side_layers(model, s, paged, r, d, x, pos, cos_sin, mb)
                s.wrote[d, r] = alive
            else:
                rope = (fused_decode.rope_rows(cos_sin)
                        if fused and cos_sin is not None else None)
                for i, layer in enumerate(model.layers):
                    x = layer.paged_decode(x, paged.layer(i), cos_sin, bt,
                                           cl_eff, fused, rope)
            if last:
                logits = model.unembed(x)[:, 0]
                nxt = sample_batch(logits, s.seeds[r], s.steps0[r] + d,
                                   s.temps[r], s.tks[r], s.tps[r],
                                   s.ds[r].bool()).long()
                eos = s.eos[r]
                emit = alive & ~((eos >= 0) & (nxt == eos))
                s.toks[d, r] = nxt
                s.emits[d, r] = emit
                _apply_plain(s, r, d, nxt, emit)
                if hop_out:
                    send = pack([torch.stack([nxt, emit.long()])])
            elif hop_out:
                send = pack([x, applied])
        got = group.pp.exchange(
            send, packed_size(in_like) if hop_in else 0)
        if not hop_in:
            got = None
    if quantized:
        model.paged_chunk_flush(s, paged, dummy_block, k)
    both = (torch.stack([s.toks[:k], s.emits[:k].long()]) if last else
            torch.empty((2, k, r_all), dtype=torch.int64, device=dev))
    return broadcast_from_last(group, both.contiguous())


def _side_layers(model, s, paged, r, d: int, x, q_pos, cos_sin, mb: int):
    """An int8 pool's step for slots ``r`` at iteration d: the side-buffer
    formulation of ``Transformer._paged_chunk_logits_q8``."""
    dev = x.device
    nb = s.bt.shape[1]
    cl0 = s.cl0[r].long()[:, None]
    pool_pos = torch.arange(nb * paged.block_size, device=dev).expand(mb, -1)
    side = torch.arange(s.side_k.shape[2], device=dev)
    kv_pos = torch.cat([pool_pos, cl0 + side], dim=1)
    kv_valid = torch.cat([pool_pos < cl0, (side <= d).expand(mb, -1)],
                         dim=1)
    off = torch.tensor([d], device=dev)
    for i, layer in enumerate(model.layers):
        x = layer.paged_side(x, paged.layer(i), cos_sin, s.bt[r], q_pos,
                             s.side_k[i][r], s.side_v[i][r], off, kv_pos,
                             kv_valid)
    return x


def _apply_spec(s, r, d: int, g1: int, toks_out, n_keep, hit_eos,
                acc_only: bool = False):
    """Iteration d's outcome for slots ``r`` of a speculative chunk's
    state (``Transformer.paged_spec_step``'s update): the kept entries'
    mask, and unless ``acc_only`` the history, token, context length,
    emitted count, eos flag and liveness."""
    dev = s.bt.device
    idx = torch.arange(g1, device=dev)
    alive = s.alive[r].bool()
    n_keep = n_keep.long()
    kept = idx[None, :] < n_keep[:, None]
    s.acc_mask[r, d * g1:(d + 1) * g1] = kept | ((idx == 0)[None, :]
                                                 & alive[:, None])
    if acc_only:
        return
    cl = s.cl[r].long()
    hist = s.hist[r]
    dump = hist.shape[1] - 1
    cols = cl[:, None] + 1 + idx
    cols = torch.where(kept & (cols < dump), cols, dump)
    rows = torch.arange(cols.shape[0], device=dev)[:, None].expand_as(cols)
    hist[rows, cols] = toks_out.to(hist.dtype)   # a view: writes s.hist
    last_tok = torch.gather(toks_out, 1, (n_keep - 1).clamp(min=0)[:, None])
    s.cur[r] = torch.where(n_keep > 0, last_tok[:, 0],
                           s.cur[r].long()).to(s.cur.dtype)
    s.cl[r] = (cl + n_keep).to(s.cl.dtype)
    emitted = s.emitted[r].long() + n_keep
    s.emitted[r] = emitted.to(s.emitted.dtype)
    s.eos_seen[r] = (s.eos_seen[r].bool()
                     | (hit_eos.bool() & alive)).to(s.eos_seen.dtype)
    s.alive[r] = (alive & ~hit_eos.bool()
                  & (emitted < s.budget[r].long())).to(s.alive.dtype)


def spec_chunk_pp(model, group, s, paged, dummy_block: int, k: int,
                  gamma: int):
    """K speculative iterations at static width ``gamma`` of every slot
    of ``s`` (a loaded ``SpecChunkState``; per-slot widths in
    ``s.gammas``), pipelined, then the kept side entries flushed into
    each stage's pool. Returns [K, R, gamma + 3] (tokens, kept count,
    eos flag) on every rank."""
    pp, p = group.spec.pp, group.coords[0]
    last = p == pp - 1
    r_all, nb = s.bt.shape
    mb = r_all // pp
    dev = s.bt.device
    cfg = model.cfg
    g1 = gamma + 1
    e = s.side_pos.shape[1]
    idx = torch.arange(g1, device=dev)
    outc_like = ((mb, g1 + 2), torch.int64)
    fwd_like = [((mb, g1, cfg.hidden_size), model.dtype),
                ((mb, gamma), torch.int64), outc_like]
    in_like = [outc_like] if p == 0 else fwd_like
    applied = torch.zeros(outc_like[0], dtype=torch.int64, device=dev)
    entry_step = torch.arange(e, device=dev) // g1
    pool_pos = torch.arange(nb * paged.block_size, device=dev).expand(mb, -1)
    got = None
    for tick, work, hop_out, hop_in in _ticks(k, pp, p):
        send = None
        if work is not None:
            m, d = work
            r = slice(m * mb, (m + 1) * mb)
            x = drafts = None
            if got is not None:
                parts = unpack(got, in_like)
                if p > 0:
                    x, drafts = parts[0], parts[1]
                outc = parts[-1]
                if d > 0 and not last:
                    _apply_spec(s, r, d - 1, g1, outc[:, :g1],
                                outc[:, g1], outc[:, g1 + 1])
                applied = outc.clone()
            elif d == 0:
                applied = applied.zero_()
            alive = s.alive[r].bool()
            cl = s.cl[r].long()
            qp = torch.where(alive, cl, 0)[:, None] + idx
            if p == 0:
                drafts, _ = propose_ngram_device(s.hist[r, :-1], cl + 1,
                                                 gamma)
                drafts = drafts.long()
                x = model.embed(torch.cat([s.cur[r].long()[:, None], drafts],
                                          dim=1), qp)
            cos_sin = model._cos_sin(qp)
            off = d * g1 + idx
            s.side_pos[r, d * g1:(d + 1) * g1] = qp.to(s.side_pos.dtype)
            kv_pos = torch.cat([pool_pos, s.side_pos[r].long()], dim=1)
            kv_valid = torch.cat([pool_pos < s.cl0[r].long()[:, None],
                                  s.acc_mask[r] | (entry_step == d)[None]],
                                 dim=1)
            for i, layer in enumerate(model.layers):
                pool = (None if s.pool_k is None
                        else (s.pool_k[i][r], s.pool_v[i][r]))
                x = layer.paged_side(x, paged.layer(i), cos_sin, s.bt[r], qp,
                                     s.side_k[i][r], s.side_v[i][r], off,
                                     kv_pos, kv_valid, pool)
            if last:
                toks_out, n_keep, hit_eos = _accept(model, s, r, d, x,
                                                    drafts, alive, idx, g1)
                s.toks[d, r] = toks_out
                s.keeps[d, r] = n_keep
                _apply_spec(s, r, d, g1, toks_out, n_keep, hit_eos)
                s.eos_out[d, r] = s.eos_seen[r].bool()
                if hop_out:
                    send = pack([torch.cat([toks_out, n_keep[:, None],
                                            hit_eos.long()[:, None]], 1)])
            elif hop_out:
                send = pack([x, drafts, applied])
        got = group.pp.exchange(
            send, packed_size(in_like) if hop_in else 0)
        if not hop_in:
            got = None
    out = (torch.cat([s.toks[:k], s.keeps[:k, :, None],
                      s.eos_out[:k, :, None].long()], dim=2)
           if last else torch.empty((k, r_all, g1 + 2), dtype=torch.int64,
                                    device=dev))
    out = broadcast_from_last(group, out.contiguous())
    if not last:   # the last iteration's kept entries, for the flush
        for m in range(pp):
            r = slice(m * mb, (m + 1) * mb)
            _apply_spec(s, r, k - 1, g1, out[k - 1, r, :g1],
                        out[k - 1, r, g1], None, acc_only=True)
    model.paged_spec_flush(s, paged, dummy_block)
    return out


def _accept(model, s, r, d: int, x, drafts, alive, idx, g1: int):
    """The last stage's exact rejection for slots ``r`` at iteration d
    (``Transformer.paged_spec_step``'s): (tokens [mb, g1], kept counts,
    eos flags)."""
    logits = model.unembed(x)
    emitted = s.emitted[r].long()
    toks_out, n_emit = accept_rejection_batch(
        logits, drafts, s.seeds[r], s.steps0[r].long() + emitted,
        s.temps[r], s.tks[r], s.tps[r], s.ds[r].bool(), widths=s.gammas[r])
    eos = s.eos[r].long()
    emit_sl = idx[None, :] < n_emit[:, None]
    is_eos = (toks_out == eos[:, None]) & (eos >= 0)[:, None] & emit_sl
    eos_pos = torch.where(is_eos, idx, g1).amin(dim=1)
    rem = s.budget[r].long() - emitted
    n_keep = torch.minimum(torch.minimum(n_emit, eos_pos), rem)
    n_keep = torch.where(alive, n_keep, 0)
    hit_eos = (eos_pos < n_emit) & (eos_pos < rem)
    return toks_out.long(), n_keep.long(), hit_eos
