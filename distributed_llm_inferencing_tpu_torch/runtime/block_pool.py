"""Paged-KV block allocator with a radix prefix cache (pure Python).

The port's own copy of the JAX package's ``BlockPool`` over its
pure-Python ``_PyPool`` (``native/__init__.py``), with the same semantics:
FIFO free list, reference counts, a radix tree of whole-block token
chunks, and LRU eviction of unreferenced leaves when an ``alloc`` runs
short, with its eviction log: ``set_evict_hook(fn)`` has every alloc that
evicted radix blocks hand ``fn`` their ``(block id, token chain)`` pairs,
which the host KV tier (runtime/kvtier.py) copies off the device before
anything overwrites them. The C++ pool is not ported (the pure-Python
one has the same semantics).

API (block ids are ints in [0, num_blocks)):
  - alloc(n) -> n fresh block ids (refcount 1), or None if the pool is
    exhausted even after evicting unreferenced cached blocks.
  - release(blocks): drop one reference per block (freeing it, or
    returning it to the prefix cache's evictable set).
  - match_prefix(tokens, namespace=None) -> (blocks, n_tokens): longest
    cached prefix in whole blocks; the caller receives one reference per
    returned block.
  - insert_prefix(tokens, blocks, skip, namespace=None): register freshly
    filled blocks for tokens' prefix; ``skip`` = leading blocks already
    cached.

``namespace`` (the port's addition): blocks whose KV is not the base
model's (a LoRA adapter's, whose k and v deltas change it) live in a
radix tree of their own per namespace, so a request matches only KV its
own weights wrote; ``None`` is the base tree, whose keys are exactly the
JAX pool's. A namespaced block's eviction logs no token chain (None):
the host tier, keyed by base token chains, never stores it.
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import List, Optional, Sequence, Tuple

log = logging.getLogger(__name__)


class BlockPool:
    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError("num_blocks and block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._lock = threading.Lock()
        self._py = _PyPool(num_blocks, block_size)
        self._evict_hook = None

    def _check_blocks(self, blocks: Sequence[int]) -> List[int]:
        blocks = [int(b) for b in blocks]
        for b in blocks:
            if not 0 <= b < self.num_blocks:
                raise ValueError(f"block id {b} out of range "
                                 f"[0, {self.num_blocks})")
        return blocks

    def free_count(self) -> int:
        with self._lock:
            return len(self._py.free_list)

    def set_evict_hook(self, fn) -> None:
        """Register ``fn(evictions)``: ``evictions`` lists ``(block_id,
        token_chain)`` for the radix blocks an alloc evicted. Called
        outside the pool lock, after the alloc that evicted them returns
        but before its caller can run anything that overwrites the
        blocks: the window in which their device KV is still intact.
        ``None`` unregisters."""
        with self._lock:
            self._evict_hook = fn
            self._py.set_evict_log(self.num_blocks if fn is not None else 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n == 0:
            return []
        with self._lock:
            got = self._py.alloc(n)
            hook = self._evict_hook
            evicted = self._py.drain_evictions() if hook is not None else []
        if evicted:
            try:
                hook(evicted)
            except Exception:
                # the hook is an opportunistic offload: a failure loses
                # that copy, nothing more; raising here would lose the
                # ids this alloc handed out
                log.exception("evict hook failed; evictions not offloaded")
        return got

    def release(self, blocks: Sequence[int]) -> None:
        if not blocks:
            return
        blocks = self._check_blocks(blocks)
        with self._lock:
            self._py.release(blocks)

    def refcount(self, block: int) -> int:
        [block] = self._check_blocks([block])
        with self._lock:
            return self._py.refcount[block]

    def match_prefix(self, tokens: Sequence[int], namespace=None
                     ) -> Tuple[List[int], int]:
        with self._lock:
            blocks = self._py.match(tokens, namespace)
        return blocks, len(blocks) * self.block_size

    def insert_prefix(self, tokens: Sequence[int], blocks: Sequence[int],
                      skip: int, namespace=None) -> None:
        blocks = self._check_blocks(blocks)
        need = len(tokens) // self.block_size - skip
        if need <= 0:
            return
        if len(blocks) < need:
            raise ValueError(
                f"insert_prefix needs {need} blocks for "
                f"{len(tokens)} tokens with skip={skip}, got {len(blocks)}")
        with self._lock:
            self._py.insert(tokens, blocks, skip, namespace)

    def stats(self) -> dict:
        with self._lock:
            p = self._py
            return {"prefix_hits": p.hits, "prefix_misses": p.misses,
                    "evictions": p.evictions, "native": False}


class _Node:
    __slots__ = ("tokens", "block", "parent", "children", "last_use",
                 "in_evictable")

    def __init__(self, tokens=(), block=-1, parent=None):
        self.tokens = tokens
        self.block = block
        self.parent = parent
        self.children = {}
        self.last_use = 0
        self.in_evictable = False


class _PyPool:
    """The allocator proper; every method runs under BlockPool's lock."""

    def __init__(self, num_blocks: int, block_size: int):
        self.block_size = block_size
        self.free_list = collections.deque(range(num_blocks))
        self.refcount = [0] * num_blocks
        self.root = _Node()
        self.ns_roots = {}            # namespace -> the root of its tree
        self.block_node = {}          # block -> _Node
        self.evictable = set()        # (last_use, block)
        self.clock = 0
        self.hits = self.misses = self.evictions = 0
        self.evict_log_cap = 0
        self.evict_log = []           # (block, full token chain)

    def set_evict_log(self, cap: int):
        self.evict_log_cap = cap
        if cap <= 0:
            self.evict_log.clear()

    def drain_evictions(self):
        out, self.evict_log = self.evict_log, []
        return out

    def _evictable_add(self, n):
        if (not n.in_evictable and n is not self.root and not n.children
                and n.block >= 0 and self.refcount[n.block] == 0):
            self.evictable.add((n.last_use, n.block))
            n.in_evictable = True

    def _evictable_remove(self, n):
        if n.in_evictable:
            self.evictable.discard((n.last_use, n.block))
            n.in_evictable = False

    def _touch(self, n):
        was = n.in_evictable
        if was:
            self._evictable_remove(n)
        n.last_use = self.clock
        if was:
            self._evictable_add(n)

    def _evict_one(self) -> bool:
        """Free the least recently used unreferenced leaf."""
        if not self.evictable:
            return False
        key = min(self.evictable)
        victim = self.block_node.pop(key[1])
        if self.evict_log_cap > 0:
            chain, node = [], victim
            while node is not None and node.parent is not None:
                chain.append(node.tokens)
                node = node.parent
            self.evict_log.append(
                (victim.block, None if node is not self.root else
                 [t for toks in reversed(chain) for t in toks]))
            if len(self.evict_log) > self.evict_log_cap:
                self.evict_log.pop(0)
        self.evictable.discard(key)
        victim.in_evictable = False
        self.free_list.append(victim.block)
        self.evictions += 1
        del victim.parent.children[victim.tokens]
        self._evictable_add(victim.parent)
        return True

    def alloc(self, n):
        while len(self.free_list) < n:
            if not self._evict_one():
                return None
        out = [self.free_list.popleft() for _ in range(n)]
        for b in out:
            self.refcount[b] = 1
        return out

    def _ref(self, block):
        self.refcount[block] += 1
        if block in self.block_node:
            self._evictable_remove(self.block_node[block])

    def release(self, blocks):
        for b in blocks:
            if self.refcount[b] > 0:
                self.refcount[b] -= 1
                if self.refcount[b] == 0:
                    if b not in self.block_node:
                        self.free_list.append(b)
                    else:
                        self._evictable_add(self.block_node[b])

    def _tree(self, namespace, create: bool):
        if namespace is None:
            return self.root
        if create and namespace not in self.ns_roots:
            self.ns_roots[namespace] = _Node()
        return self.ns_roots.get(namespace)

    def match(self, tokens, namespace=None):
        bs = self.block_size
        cur = self._tree(namespace, False)
        self.clock += 1
        if cur is None:
            self.misses += 1
            return []
        out = []
        for i in range(len(tokens) // bs):
            child = cur.children.get(tuple(tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            cur = child
            self._touch(cur)
            out.append(cur.block)
            self._ref(cur.block)
        if out:
            self.hits += 1
        else:
            self.misses += 1
        return out

    def insert(self, tokens, blocks, skip, namespace=None):
        bs = self.block_size
        cur = self._tree(namespace, True)
        self.clock += 1
        for i in range(len(tokens) // bs):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = cur.children.get(key)
            if child is not None:
                cur = child
                self._touch(cur)
                continue
            if i < skip:
                break
            node = _Node(key, blocks[i - skip], cur)
            node.last_use = self.clock
            self.block_node[node.block] = node
            self._evictable_remove(cur)
            cur.children[key] = node
            cur = node
