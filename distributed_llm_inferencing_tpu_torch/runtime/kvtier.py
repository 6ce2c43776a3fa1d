"""Cluster prefix-cache tier: host-RAM KV offload + prefix-digest routing.

The port's own copy of the JAX package's ``runtime/kvtier.py``; the
digests are equal to the JAX package's for the same tokens and text,
because the master and both packages' workers meet on them. Three
pieces:

1. **Host-RAM offload arena** (:class:`HostKVArena`): when the radix
   cache evicts a block, the batcher copies its still-resident device KV
   pages into a bounded LRU arena keyed by the block's *token-chain
   digest* (content addressing: the same prompt prefix hashes to the
   same key on any worker). On a later radix miss, admission restores
   matching blocks to the device instead of re-running prefill. The
   restored bytes are the exact evicted bytes, so outputs are bitwise
   identical to a cold prefill. Bounded by ``DLI_KV_HOST_MB`` (0
   disables the tier); ``DLI_KV_HOST_DTYPE=int8`` stores blocks
   quantized (ops/kvblock_quant.py).

2. **Prefix-digest advertisement** (:class:`PrefixDigestIndex`): workers
   summarize which prompt prefixes they have served (leading-chunk hash
   chains over the prompt *text*, bounded top-K) in ``batcher.stats()``,
   which rides the master's health scrape. Text-level chaining because
   the master never tokenizes: both sides hash the same UTF-8 chunks.

3. **Affinity-aware routing** is the master's (``estimate_cached_tokens``
   is its input, kept here with the digests it reads).

The cache hierarchy: device radix blocks -> host arena -> recompute.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from distributed_llm_inferencing_tpu_torch.ops import kvblock_quant as kvq

# Host arena budget (MB). 0 disables the offload tier entirely.
DEFAULT_HOST_MB = 256.0
# Arena storage dtype: "native" keeps the exact device bytes (bitwise
# restore guarantee); "int8" stores blocks per-(layer, head) quantized
# (ops/kvblock_quant.py) — ~3.9x more prefix tokens per MB, restores
# are dequantized (lossy) approximations of the evicted KV.
HOST_DTYPES = ("native", "int8")
# Prompt-text chunk size (bytes of the UTF-8 encoding) for prefix-digest
# chains. Master and workers must agree — both read this env.
DIGEST_CHUNK = max(1, int(os.environ.get("DLI_PREFIX_DIGEST_CHUNK", 256)))
# How many distinct prefix chains a worker advertises (bounded top-K by
# recency) and how deep one chain may go (64 chunks x 256 B covers a
# ~16 kB system prompt).
DIGEST_TOP_K = max(1, int(os.environ.get("DLI_PREFIX_DIGEST_TOP_K", 32)))
DIGEST_MAX_CHUNKS = 64

_DIGEST_SIZE = 8   # bytes; 16 hex chars per advertised digest


def _chain(parts) -> List[str]:
    """Hash-chain ``parts`` (byte strings): digest_i covers parts[0..i].
    A chain digest identifies an exact *prefix*, so two prompts sharing
    their first N parts share their first N digests — the property both
    the arena keys and the routing advertisement rely on."""
    out = []
    prev = b""
    for part in parts:
        prev = hashlib.blake2b(prev + part,
                               digest_size=_DIGEST_SIZE).digest()
        out.append(prev.hex())
    return out


def token_chain_digests(tokens: Sequence[int], block_size: int) -> List[str]:
    """One chain digest per FULL block of ``tokens`` — digest i keys the
    KV content of block i given everything before it. Must match for the
    offload (evicted chain) and restore (admission prompt) sides, which
    both call this."""
    arr = np.asarray(list(tokens), dtype=np.int32)
    n_full = len(arr) // block_size
    return _chain(arr[i * block_size:(i + 1) * block_size].tobytes()
                  for i in range(n_full))


def text_chain_digests(text: str, chunk: int = DIGEST_CHUNK,
                       max_chunks: int = DIGEST_MAX_CHUNKS) -> List[str]:
    """Chain digests over the prompt *text* (UTF-8 bytes, ``chunk``-byte
    pieces, full chunks only). The routing-side twin of
    ``token_chain_digests``: the master has no tokenizer, so workers
    advertise — and the master matches — at the text level."""
    data = text.encode("utf-8", errors="replace")
    n_full = min(len(data) // chunk, max_chunks)
    return _chain(data[i * chunk:(i + 1) * chunk] for i in range(n_full))


class HostKVArena:
    """Bounded, LRU-managed host-RAM store of evicted KV blocks.

    Entries are keyed by token-chain digest and hold the block's pages —
    one numpy array per paged-cache leaf (k, v, and the int8 scales when
    quantized), exactly the bytes that were on device. ``get`` touches
    LRU order; inserting past the byte budget drops the LRU entry.
    Thread-safe: the batcher thread offloads/restores while HTTP handler
    threads read ``stats()``.

    ``dtype="int8"`` stores each inserted block as a quantized record
    (ops/kvblock_quant.py) instead of the raw pages: ~3.9x more blocks
    in the same budget, at the cost of the bitwise-restore guarantee
    for arena-served blocks. Whatever the mode, entries are
    self-describing — an already-quantized record (fetched from an int8
    peer) is stored as-is, never requantized — and ``_bytes`` /
    ``occupancy`` count STORED bytes, so the arena-full routing guard
    (DLI_SCHED_ARENA_FULL) sees the honest budget either way.
    """

    def __init__(self, capacity_bytes: int, dtype: str = "native"):
        if dtype not in HOST_DTYPES:
            raise ValueError(
                f"unknown arena dtype {dtype!r}; known: {HOST_DTYPES}")
        self.capacity_bytes = int(capacity_bytes)
        self.dtype = dtype
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Tuple[tuple, int]]" = OrderedDict()
        self._bytes = 0
        self._logical_bytes = 0
        self.hits = 0
        self.misses = 0
        self.offloaded = 0
        self.restored = 0
        self.dropped = 0      # LRU evictions out of the arena

    def __contains__(self, digest: str) -> bool:
        with self._lock:
            return digest in self._entries

    def put(self, digest: str, pages: Sequence[np.ndarray],
            count_offload: bool = True) -> bool:
        """Insert one block's pages; returns False when the block alone
        exceeds the whole budget (never stored). ``count_offload=False``
        keeps inserts from the transfer paths (peer fetch, finish-time
        export) out of the ``offloaded`` counter — that stat means
        device-eviction offloads, and the TSDB series charting it must
        not spike when a decode node merely pulls blocks over the
        wire. ``pages`` may be raw device pages OR an already-quantized
        block record (a peer fetch from an int8 node) — records store
        as-is; raw pages quantize first when this arena is int8."""
        if kvq.is_quantized_block(pages):
            obj = pages
            stored = kvq.stored_nbytes(obj)
            logical = kvq.logical_nbytes(obj)
        elif self.dtype == "int8":
            obj = kvq.quantize_block(pages)
            stored = kvq.stored_nbytes(obj)
            logical = kvq.logical_nbytes(obj)
        else:
            obj = tuple(np.ascontiguousarray(p) for p in pages)
            stored = logical = sum(p.nbytes for p in obj)
        if stored > self.capacity_bytes:
            return False
        with self._lock:
            old = self._entries.pop(digest, None)
            if old is not None:
                self._bytes -= old[1]
                self._logical_bytes -= old[2]
            self._entries[digest] = (obj, stored, logical)
            self._bytes += stored
            self._logical_bytes += logical
            if count_offload:
                self.offloaded += 1
            while self._bytes > self.capacity_bytes and self._entries:
                _, (_, freed, lfreed) = self._entries.popitem(last=False)
                self._bytes -= freed
                self._logical_bytes -= lfreed
                self.dropped += 1
        return True

    def get(self, digest: str) -> Optional[tuple]:
        """Pages for ``digest`` (LRU-touched), or None. The entry STAYS
        in the arena: a restored block may be radix-evicted again later,
        and re-offloading identical content would be wasted copies.
        Quantized entries dequantize here — the caller always sees
        scatter-ready logical pages."""
        with self._lock:
            hit = self._entries.get(digest)
            if hit is None:
                self.misses += 1
                return None
            self._entries.move_to_end(digest)
            self.hits += 1
            self.restored += 1
            obj = hit[0]
        if kvq.is_quantized_block(obj):
            return kvq.dequantize_block(obj)
        return obj

    def peek(self, digest: str) -> bool:
        """Membership without touching hit/miss accounting (used to size
        a consecutive restore run before committing to block allocs)."""
        with self._lock:
            return digest in self._entries

    def peek_pages(self, digest: str) -> Optional[tuple]:
        """Pages for ``digest`` WITHOUT the hit/miss/restored accounting
        ``get`` does — the ``/kv_fetch`` export path reads blocks on a
        peer's behalf, and counting that as a local restore would make
        the arena's own tiering stats lie. LRU order is still touched:
        a block peers keep pulling is a block worth keeping resident."""
        obj = self.peek_stored(digest)
        if obj is None:
            return None
        if kvq.is_quantized_block(obj):
            return kvq.dequantize_block(obj)
        return obj

    def peek_stored(self, digest: str):
        """The STORED object for ``digest`` — raw page tuple or
        quantized record — without hit/miss accounting. The /kv_fetch
        export path ships this representation as-is: a quantized block
        crosses the wire quantized (no requantize, no dequantize on
        send), so the sender's CPU cost is a memcpy either way."""
        with self._lock:
            hit = self._entries.get(digest)
            if hit is None:
                return None
            self._entries.move_to_end(digest)
            return hit[0]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"blocks": len(self._entries), "bytes": self._bytes,
                    "capacity_bytes": self.capacity_bytes,
                    # occupancy fraction rides /health into the master's
                    # runtime snapshot: the scheduler keeps prefill off
                    # nodes whose arena would evict what a decode peer
                    # is about to fetch (DLI_SCHED_ARENA_FULL). Counts
                    # STORED (possibly quantized) bytes — the honest
                    # budget fraction; logical_bytes carries the
                    # full-precision equivalent so the compression
                    # ratio is derivable fleet-wide.
                    "occupancy": self._bytes / max(1, self.capacity_bytes),
                    "dtype": self.dtype,
                    "logical_bytes": self._logical_bytes,
                    "hits": self.hits, "misses": self.misses,
                    "offloaded": self.offloaded, "restored": self.restored,
                    "dropped": self.dropped}


class PrefixDigestIndex:
    """Worker-side advertisement of served prompt prefixes.

    ``note(text, n_tokens)`` records the prompt's leading-chunk chain
    digests, each mapped to the estimated number of prompt tokens the
    prefix up to that chunk covers (tokens scaled by byte fraction — an
    estimate is enough: routing needs relative magnitudes, and the
    worker-side radix cache is the ground truth once the request lands).
    Chains are tracked whole, keyed by their deepest digest, bounded to
    the ``top_k`` most recent — one shared-prefix *family* costs one
    chain, not one entry per request, and a shorter chain that is a
    prefix of a newly noted one merges into it. ``advertise()`` emits
    each chain at geometric depths (1, 2, 4, ... and the deepest), so a
    64-chunk system prompt costs ~7 advertised digests instead of 64: a
    prompt sharing D chunks still matches the largest advertised depth
    <= D, with a conservative (shallower) token estimate.
    """

    def __init__(self, chunk: int = DIGEST_CHUNK,
                 top_k: int = DIGEST_TOP_K):
        self.chunk = int(chunk)
        self.top_k = int(top_k)
        self._lock = threading.Lock()
        # chain key (deepest digest) -> [(digest, est_tokens), ...]
        self._chains: "OrderedDict[str, list]" = OrderedDict()

    def note(self, text: str, n_tokens: int) -> None:
        if not text or n_tokens <= 0:
            return
        digs = text_chain_digests(text, self.chunk)
        if not digs:
            return
        n_bytes = len(text.encode("utf-8", errors="replace"))
        ests = [max(1, round(n_tokens * min(
            1.0, (i + 1) * self.chunk / max(1, n_bytes))))
            for i in range(len(digs))]
        key = digs[-1]
        with self._lock:
            # an existing chain that is a PREFIX of this one (same
            # family, shorter prompt) merges: its key is among our
            # shallower digests
            mine = set(digs[:-1])
            for k in [k for k in self._chains if k in mine]:
                del self._chains[k]
            old = self._chains.pop(key, None)
            if old is not None:      # same key == identical chain
                ests = [max(e, oe) for e, (_, oe) in zip(ests, old)]
            self._chains[key] = list(zip(digs, ests))
            while len(self._chains) > self.top_k:
                self._chains.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._chains)

    def advertise(self) -> dict:
        """Bounded summary for ``stats()``: the ``top_k`` most recent
        chains, each downsampled to geometric depths plus the deepest,
        with their token estimates and the chunk size the master must
        chain with."""
        with self._lock:
            chains = list(self._chains.values())
        out: Dict[str, int] = {}
        for chain in chains:
            n = len(chain)
            depths = {n - 1}
            d = 1
            while d < n:
                depths.add(d - 1)
                d *= 2
            for i in depths:
                dig, est = chain[i]
                out[dig] = max(out.get(dig, 0), est)
        return {"chunk": self.chunk,
                "top": [[d, int(v)] for d, v in out.items()]}


def estimate_cached_tokens(prompt: str, advert: Optional[dict],
                           memo: Optional[Dict[int, List[str]]] = None
                           ) -> int:
    """Master-side affinity input: estimated tokens of ``prompt`` whose
    KV a node advertising ``advert`` already holds — the deepest prompt
    chain digest present in the advertisement. ``memo`` caches the
    prompt's digest chains per chunk size across candidate nodes in one
    scheduling pick."""
    if not prompt or not isinstance(advert, dict):
        return 0
    top = advert.get("top")
    chunk = advert.get("chunk")
    if not top or not isinstance(chunk, int) or chunk < 1:
        return 0
    # the advertisement crossed the wire from a worker: malformed shapes
    # must score 0, never raise — this runs inside _pick_node on the
    # master's dispatcher threads, which have no exception net
    try:
        have = {str(d): int(v) for d, v in top}
        chunk = int(chunk)
    except (TypeError, ValueError):
        return 0
    if memo is not None and chunk in memo:
        digs = memo[chunk]
    else:
        digs = text_chain_digests(prompt, chunk)
        if memo is not None:
            memo[chunk] = digs
    for d in reversed(digs):          # deepest match wins
        est = have.get(d)
        if est is not None:
            return est
    return 0


class KVTier:
    """Per-batcher facade tying the arena and the digest index together
    (runtime/batcher.py owns the device side: page gather on offload,
    scatter on restore)."""

    def __init__(self, block_size: int, capacity_mb: float,
                 digest_chunk: int = DIGEST_CHUNK,
                 digest_top_k: int = DIGEST_TOP_K,
                 dtype: str = "native"):
        self.block_size = int(block_size)
        self.arena = HostKVArena(int(capacity_mb * 1024 * 1024),
                                 dtype=dtype)
        self.index = PrefixDigestIndex(digest_chunk, digest_top_k)

    def block_digests(self, tokens: Sequence[int]) -> List[str]:
        return token_chain_digests(tokens, self.block_size)

    def note_text(self, text: str, n_tokens: int) -> None:
        self.index.note(text, n_tokens)

    def stats(self) -> dict:
        s = self.arena.stats()
        # chain count, NOT len(advertise()["top"]): stats() rides every
        # /health scrape and inference response — don't rebuild the
        # advertisement just to count it
        s["chains_advertised"] = len(self.index)
        return s
