"""Sequence parallelism over the ``sp`` ranks of a grid: ring attention.

Port of the JAX package's ``parallel/ring.py``. Under sp the engine's
dense cache is cut along the sequence: sequence rank s holds positions
[s·S/sp, (s+1)·S/sp) (``SeqShard``), for its tp cut of the kv heads, and
the weights replicate over sp.

- **Prefill** (``ring_attend_prefill``): each rank runs its contiguous
  chunk of the prompt block through every layer. In attention its K/V
  chunk, with its absolute positions and validity, rotates sp − 1 hops
  around the ring (parallel/mesh.py ``Ring``: a broadcast over the pair
  group of each edge), and every chunk a rank sees — its own first —
  folds into a running (m, l, o) accumulator in f32. Causality, ragged
  lengths, sliding windows across chunk edges, ALiBi (the rank's tp slice
  of the slopes) and the score softcap all follow from the positions, as
  in the JAX package. Each visiting chunk is also written into the
  cache slots of this rank that its positions fall in (``on_chunk``), so
  every position of the block lands on the rank that owns it.
- **Decode** (``ring_attend_decode``): every sp rank computes the same
  token's q/k/v; the caller writes its K/V on the rank that owns its
  position. Each rank reduces its cache shard to (m, l, o) partials, and
  one all-reduce of the zero-padded partials over the sp group (a
  ``combine``) lets every rank merge them: the same output on every rank.

Both bodies are plain torch: the JAX ring bodies reach no
``pallas_call``. Merging the attention kernels' own partials instead
(their log-sum-exp) is ROADMAP Queue B work. The JAX package rotates sp
times (its last rotation returns each chunk home); the port stops at
sp − 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from distributed_llm_inferencing_tpu_torch.parallel.mesh import (
    Ring, SubGroup, pack, packed_size, unpack)

# the JAX package's finite mask value: a row that no key admits keeps
# m = NEG and l = 0, and its partials merge without NaNs
NEG = -1e30


@dataclasses.dataclass
class SeqShard:
    """This rank's place on its sp ring: ``rank`` of ``world``, the
    ``ring`` its K/V chunks rotate on, the ``group`` its partials combine
    over, and ``cache_len``, the positions of its cache shard (it holds
    [rank·cache_len, (rank+1)·cache_len))."""
    ring: Ring
    group: SubGroup
    rank: int
    world: int
    cache_len: int

    @property
    def lo(self) -> int:
        return self.rank * self.cache_len

    def chunk(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of a block [B, S0, ...] (S0 a multiple of
        sp): positions [rank·S0/sp, (rank+1)·S0/sp)."""
        c = t.shape[1] // self.world
        return t[:, self.rank * c:(self.rank + 1) * c]

    def owned(self, origin: int, c: int):
        """(chunk slice, cache slice) of the positions of prompt chunk
        ``origin`` (c positions from origin·c) that this rank's shard
        holds, or None."""
        a = max(origin * c, self.lo)
        b = min((origin + 1) * c, self.lo + self.cache_len)
        if a >= b:
            return None
        return (slice(a - origin * c, b - origin * c),
                slice(a - self.lo, b - self.lo))


def partials(q, k, v, q_pos, kv_pos, kv_valid, sliding_window=None,
             alibi=None, softcap=None):
    """Unnormalized attention of q [B,Sq,H,hd] over one K/V chunk
    [B,Skv,Hkv,hd]: (m [B,Hkv,G,Sq], l [B,Hkv,G,Sq], o [B,Sq,Hkv,G,hd])
    in f32, with ``masked_attention``'s scores and mask."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qf = q.float().reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / math.sqrt(hd)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    rel = kv_pos[:, None, :] - q_pos[:, :, None]                # [B,Sq,Skv]
    if alibi is not None:
        s = s + alibi.float().reshape(1, Hkv, G, 1, 1) * rel.float()[:, None,
                                                                     None]
    mask = (rel <= 0) & kv_valid[:, None, :]
    if sliding_window is not None:
        mask = mask & (-rel < sliding_window)
    mask = mask[:, None, None]
    s = s.masked_fill(~mask, NEG)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return m, p.sum(dim=-1), o


def _fold(acc, part):
    """The online-softmax merge of two (m, l, o) partials."""
    if acc is None:
        return part
    (m0, l0, o0), (m1, l1, o1) = acc, part
    m = torch.maximum(m0, m1)
    a0, a1 = torch.exp(m0 - m), torch.exp(m1 - m)
    scale = lambda a: a.permute(0, 3, 1, 2)[..., None]   # to o's layout
    return m, l0 * a0 + l1 * a1, o0 * scale(a0) + o1 * scale(a1)


def _finish(acc, dtype):
    m, l, o = acc
    l = l.clamp(min=1e-30).permute(0, 3, 1, 2)[..., None]
    B, Sq, Hkv, G, hd = o.shape
    return (o / l).reshape(B, Sq, Hkv * G, hd).to(dtype)


def ring_attend_prefill(q, k, v, positions, valid, shard: SeqShard, *,
                        sliding_window: Optional[int] = None, alibi=None,
                        softcap: Optional[float] = None,
                        on_chunk: Optional[Callable] = None):
    """Causal attention of this rank's chunk q [B,c,H,hd] over every
    rank's chunk: its own k/v [B,c,Hkv,hd] with ``positions`` [B,c] and
    ``valid`` [B,c], then sp − 1 rotations of them around the ring.
    ``on_chunk(k, v, origin)`` sees every chunk, the one of sequence
    rank ``origin`` (the owned cache write). Returns [B,c,H,hd] in q's
    dtype."""
    n, me = shard.world, shard.rank
    cur = (k, v, positions, valid)
    likes = [(tuple(t.shape), t.dtype) for t in cur]
    acc = None
    for hop in range(n):
        ck, cv, cpos, cval = cur
        if on_chunk is not None:
            on_chunk(ck, cv, (me - hop) % n)
        acc = _fold(acc, partials(q, ck, cv, positions, cpos, cval,
                                  sliding_window, alibi, softcap))
        if hop < n - 1:
            got = shard.ring.exchange(pack(cur), packed_size(likes),
                                      counts=("ring", "ring"))
            cur = tuple(unpack(got, likes))
    return _finish(acc, q.dtype)


def ring_attend_decode(q, cache_k, cache_v, new_lengths, shard: SeqShard, *,
                       sliding_window: Optional[int] = None, alibi=None,
                       softcap: Optional[float] = None):
    """One query per row, q [B,1,H,hd] (the same on every sp rank), over
    the sp-sharded cache: this rank's shard cache_k/cache_v
    [B,S/sp,Hkv,hd] (dequantized by the caller) holds positions
    [lo, lo + S/sp); ``new_lengths`` [B] counts the new token. Partials
    here, one combine over the sp group, the same [B,1,H,hd] out on every
    rank."""
    B, S = cache_k.shape[:2]
    dev = q.device
    kv_pos = (shard.lo + torch.arange(S, device=dev)).expand(B, S)
    kv_valid = kv_pos < new_lengths.long()[:, None]
    q_pos = (new_lengths.long() - 1)[:, None]
    m, l, o = partials(q, cache_k, cache_v, q_pos, kv_pos, kv_valid,
                       sliding_window, alibi, softcap)
    flat = torch.cat([m.reshape(-1), l.reshape(-1), o.reshape(-1)])
    full = flat.new_zeros(shard.world, flat.numel())
    full[shard.rank] = flat
    full = shard.group.all_reduce(full, key="combine")
    nm, nl = m.numel(), l.numel()
    acc = None
    for r in range(shard.world):
        row = full[r]
        acc = _fold(acc, (row[:nm].view(m.shape),
                          row[nm:nm + nl].view(l.shape),
                          row[nm + nl:].view(o.shape)))
    return _finish(acc, q.dtype)
