"""Multi-LoRA adapters: the format, the host store, and the device pack.

The port's own copy of the JAX package's ``models/lora.py`` (host numpy,
no framework code), so the same ``(cfg, name, seed)`` synthesizes the
same adapter bit for bit in either package and a ``lora.npz`` +
``lora_config.json`` directory reads in both directions.

An adapter is a set of per-layer low-rank (A, B) pairs for the attention
and MLP projections of a base model:

- **Format**: ``LoRAAdapter`` (host numpy), loaded from a checkpoint
  directory (``load_adapter``) or synthesized for tests and the smoke
  (``synthesize``: deterministic in (cfg, name, seed)); ``resolve`` turns
  a registry source, a directory or a ``synth:rank=R,seed=S,scale=X``
  URI, into a validated adapter.
- **Host store**: ``LoRAHostStore``, a bounded LRU-by-bytes tier
  (``DLI_LORA_HOST_MB``) that never evicts adapters pinned by live
  requests.
- **Device pack**: ``build_pack`` stacks the slot adapters into ``[L, S,
  din, rmax]`` / ``[L, S, rmax, dout]`` arrays per projection; slot 0 is
  the base model (zeros), ranks are zero-padded to ``rmax`` and the
  ``alpha / rank`` scale is folded into B, so the serving delta
  (ops/lora.py ``gathered_delta``) has a static shape: loading, evicting
  or re-mixing adapters changes pack data, never a captured program
  (runtime/batcher.py writes a slot of its one device pack in place).

Model classes the delta hook does not cover (MLA, MoE, dense-prefix
stacks) are refused at load time: a request fails loudly rather than
serve base weights.

Knobs, read here (the port's own): ``DLI_LORA_HOST_MB`` (64), the host
store's budget; ``DLI_LORA_SLOTS`` (4), device-resident adapters per
batcher; ``DLI_LORA_MAX_RANK`` (16), the pack's static rank.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig

DEFAULT_HOST_MB = 64.0     # DLI_LORA_HOST_MB
DEFAULT_SLOTS = 4          # DLI_LORA_SLOTS (device-resident adapters)
DEFAULT_MAX_RANK = 16      # DLI_LORA_MAX_RANK (the pack's static rmax)


def host_mb_from_env() -> float:
    try:
        return float(os.environ.get("DLI_LORA_HOST_MB", DEFAULT_HOST_MB))
    except ValueError:
        return DEFAULT_HOST_MB


def slots_from_env() -> int:
    try:
        return max(1, int(os.environ.get("DLI_LORA_SLOTS", DEFAULT_SLOTS)))
    except ValueError:
        return DEFAULT_SLOTS


def max_rank_from_env() -> int:
    try:
        return max(1, int(os.environ.get("DLI_LORA_MAX_RANK",
                                         DEFAULT_MAX_RANK)))
    except ValueError:
        return DEFAULT_MAX_RANK


def validate_base_model(cfg: ModelConfig):
    """Refuse model classes the delta hook does not cover."""
    if cfg.mla:
        raise ValueError(
            "LoRA serving does not support MLA attention (the latent "
            "bottleneck replaces the q/k/v projections the delta targets)")
    if cfg.num_experts > 0:
        raise ValueError(
            "LoRA serving does not support MoE MLPs (expert-stacked "
            "weights need a routed delta formulation)")
    if getattr(cfg, "dense_prefix_layers", 0):
        raise ValueError(
            "LoRA serving does not support dense-prefix hybrid stacks "
            "(two layer segments would need two packs)")


def lora_targets(cfg: ModelConfig) -> Tuple[str, ...]:
    """The projections an adapter may target for this architecture."""
    base = ("q", "k", "v", "o", "up", "down")
    return base + ("gate",) if cfg.gated_mlp else base


def target_dims(cfg: ModelConfig, target: str) -> Tuple[int, int]:
    """(din, dout) of the dense projection ``target`` adapts."""
    h, hd = cfg.hidden_size, cfg.head_dim
    dims = {
        "q": (h, cfg.num_heads * hd),
        "k": (h, cfg.num_kv_heads * hd),
        "v": (h, cfg.num_kv_heads * hd),
        "o": (cfg.num_heads * hd, h),
        "gate": (h, cfg.intermediate_size),
        "up": (h, cfg.intermediate_size),
        "down": (cfg.intermediate_size, h),
    }
    if target not in dims or target not in lora_targets(cfg):
        raise ValueError(f"unknown LoRA target {target!r}")
    return dims[target]


@dataclasses.dataclass
class LoRAAdapter:
    """One adapter: per-layer {target: (A [din, r], B [r, dout])} in
    float32 host numpy, plus the metadata routing and packing need."""
    name: str
    rank: int
    alpha: float
    targets: Tuple[str, ...]
    layers: List[Dict[str, Tuple[np.ndarray, np.ndarray]]]
    nbytes: int = 0

    def __post_init__(self):
        if not self.nbytes:
            self.nbytes = sum(a.nbytes + b.nbytes
                              for lp in self.layers
                              for (a, b) in lp.values())

    @property
    def scale(self) -> float:
        return self.alpha / float(self.rank)


def check_adapter(cfg: ModelConfig, ad: LoRAAdapter,
                  max_rank: Optional[int] = None) -> LoRAAdapter:
    """Validate ``ad`` against the base model's shapes and the rank cap
    (``max_rank``, else ``DLI_LORA_MAX_RANK``); ValueError on any
    mismatch."""
    validate_base_model(cfg)
    cap = max_rank or max_rank_from_env()
    if ad.rank < 1 or ad.rank > cap:
        raise ValueError(f"adapter {ad.name!r} rank {ad.rank} outside "
                         f"[1, {cap}] (DLI_LORA_MAX_RANK)")
    if len(ad.layers) != cfg.num_layers:
        raise ValueError(f"adapter {ad.name!r} has {len(ad.layers)} "
                         f"layers, model has {cfg.num_layers}")
    ok = set(lora_targets(cfg))
    for li, lp in enumerate(ad.layers):
        for t, (a, b) in lp.items():
            if t not in ok:
                raise ValueError(f"adapter {ad.name!r} targets {t!r}, "
                                 f"not a projection of {cfg.name}")
            din, dout = target_dims(cfg, t)
            if a.shape != (din, ad.rank) or b.shape != (ad.rank, dout):
                raise ValueError(
                    f"adapter {ad.name!r} layer {li} target {t!r}: "
                    f"A{a.shape}/B{b.shape} do not match "
                    f"({din}, {ad.rank})/({ad.rank}, {dout})")
    return ad


def synthesize(cfg: ModelConfig, name: str, rank: int = 8,
               alpha: Optional[float] = None, seed: int = 0,
               scale: float = 0.05,
               targets: Optional[Tuple[str, ...]] = None) -> LoRAAdapter:
    """A deterministic adapter (the JAX package's draws, bit for bit):
    both A and B non-zero, so a differential test is not vacuous, small
    enough that greedy decoding stays stable."""
    validate_base_model(cfg)
    targets = tuple(targets or lora_targets(cfg))
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, len(name)]
                               + [ord(c) for c in name[:16]]))
    layers = []
    for _ in range(cfg.num_layers):
        lp = {}
        for t in targets:
            din, dout = target_dims(cfg, t)
            a = rng.standard_normal((din, rank)).astype(np.float32)
            a *= scale / np.sqrt(din)
            b = rng.standard_normal((rank, dout)).astype(np.float32)
            b *= scale / np.sqrt(rank)
            lp[t] = (a, b)
        layers.append(lp)
    ad = LoRAAdapter(name=name, rank=rank,
                     alpha=float(alpha if alpha is not None else rank),
                     targets=targets, layers=layers)
    return check_adapter(cfg, ad)


def save_adapter(ad: LoRAAdapter, path: str):
    """The checkpoint-directory format: ``lora_config.json`` +
    ``lora.npz`` with ``{layer}.{target}.a`` / ``.b`` keys."""
    os.makedirs(path, exist_ok=True)
    arrays = {}
    for li, lp in enumerate(ad.layers):
        for t, (a, b) in lp.items():
            arrays[f"{li}.{t}.a"] = a
            arrays[f"{li}.{t}.b"] = b
    np.savez(os.path.join(path, "lora.npz"), **arrays)
    with open(os.path.join(path, "lora_config.json"), "w") as f:
        json.dump({"name": ad.name, "rank": ad.rank, "alpha": ad.alpha,
                   "targets": list(ad.targets),
                   "num_layers": len(ad.layers)}, f)


def load_adapter(cfg: ModelConfig, name: str, source: str,
                 max_rank: Optional[int] = None) -> LoRAAdapter:
    """One adapter from a checkpoint directory, validated against the
    base model; ValueError on any problem."""
    cfg_path = os.path.join(source, "lora_config.json")
    npz_path = os.path.join(source, "lora.npz")
    if not (os.path.isfile(cfg_path) and os.path.isfile(npz_path)):
        raise ValueError(f"adapter {name!r}: {source!r} is not a LoRA "
                         "checkpoint dir (lora_config.json + lora.npz)")
    with open(cfg_path) as f:
        meta = json.load(f)
    data = np.load(npz_path)
    layers: List[Dict[str, Tuple[np.ndarray, np.ndarray]]] = []
    for li in range(int(meta["num_layers"])):
        lp = {}
        for t in meta["targets"]:
            lp[t] = (np.asarray(data[f"{li}.{t}.a"], np.float32),
                     np.asarray(data[f"{li}.{t}.b"], np.float32))
        layers.append(lp)
    ad = LoRAAdapter(name=name, rank=int(meta["rank"]),
                     alpha=float(meta.get("alpha", meta["rank"])),
                     targets=tuple(meta["targets"]), layers=layers)
    return check_adapter(cfg, ad, max_rank=max_rank)


def resolve(cfg: ModelConfig, name: str, source: str,
            max_rank: Optional[int] = None) -> LoRAAdapter:
    """A registry ``source`` as a validated adapter: a ``synth:`` URI
    (``synth:rank=8,seed=3,scale=0.05``) or a checkpoint directory.
    ValueError on any problem."""
    if source == "synth" or source.startswith("synth:"):
        kw = {}
        spec = source.partition(":")[2]
        for part in filter(None, spec.split(",")):
            k, _, v = part.partition("=")
            if k not in ("rank", "seed", "alpha", "scale"):
                raise ValueError(
                    f"adapter {name!r}: unknown synth param {k!r}")
            kw[k] = float(v) if k in ("alpha", "scale") else int(v)
        return check_adapter(cfg, synthesize(cfg, name, **kw),
                             max_rank=max_rank)
    return load_adapter(cfg, name, source, max_rank=max_rank)


def slot_arrays(cfg: ModelConfig, ad: Optional[LoRAAdapter], target: str,
                layer: int, max_rank: int) -> Tuple[np.ndarray, np.ndarray]:
    """One slot's (A [din, rmax], B [rmax, dout]) f32 rows of the pack
    for ``target`` at ``layer``: zeros for an empty slot or a target the
    adapter leaves alone, B scaled by ``alpha / rank``."""
    din, dout = target_dims(cfg, target)
    a = np.zeros((din, max_rank), np.float32)
    b = np.zeros((max_rank, dout), np.float32)
    if ad is not None and target in ad.layers[layer]:
        aa, bb = ad.layers[layer][target]
        a[:, :ad.rank] = aa
        b[:ad.rank, :] = bb * ad.scale
    return a, b


def build_pack(cfg: ModelConfig, slot_adapters: List[Optional[LoRAAdapter]],
               max_rank: int) -> Dict[str, Dict[str, np.ndarray]]:
    """The slot adapters stacked into the device pack: for every target
    ``{"a": [L, S, din, rmax], "b": [L, S, rmax, dout]}`` float32.
    ``slot_adapters[0]`` must be None (the base model's zero slot)."""
    if slot_adapters[0] is not None:
        raise ValueError("slot 0 is reserved for the base model")
    pack: Dict[str, Dict[str, np.ndarray]] = {}
    for t in lora_targets(cfg):
        rows = [[slot_arrays(cfg, ad, t, li, max_rank)
                 for ad in slot_adapters] for li in range(cfg.num_layers)]
        pack[t] = {k: np.stack([np.stack([r[j] for r in layer])
                                for layer in rows])
                   for j, k in enumerate(("a", "b"))}
    return pack


class LoRAHostStore:
    """Bounded host-RAM adapter tier: LRU by bytes, with hit, miss and
    eviction counts; eviction skips the caller's pinned set (adapters
    with live requests). A put that cannot fit even after evicting every
    unpinned adapter raises ValueError."""

    def __init__(self, capacity_mb: Optional[float] = None):
        if capacity_mb is None:
            capacity_mb = host_mb_from_env()
        self.capacity_bytes = int(max(0.0, float(capacity_mb)) * 2**20)
        self._adapters: "collections.OrderedDict[str, LoRAAdapter]" = \
            collections.OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._lock = threading.Lock()

    def get(self, name: str) -> Optional[LoRAAdapter]:
        with self._lock:
            ad = self._adapters.get(name)
            if ad is None:
                self.misses += 1
                return None
            self._adapters.move_to_end(name)
            self.hits += 1
            return ad

    def peek(self, name: str) -> Optional[LoRAAdapter]:
        """Lookup without touching recency or the hit/miss counts."""
        with self._lock:
            return self._adapters.get(name)

    def put(self, ad: LoRAAdapter, pinned=()) -> List[str]:
        """Insert (or refresh) an adapter; returns the evicted names."""
        if ad.nbytes > self.capacity_bytes:
            raise ValueError(
                f"adapter {ad.name!r} ({ad.nbytes} B) exceeds the host "
                f"store budget ({self.capacity_bytes} B, DLI_LORA_HOST_MB)")
        evicted: List[str] = []
        with self._lock:
            old = self._adapters.pop(ad.name, None)
            if old is not None:
                self._bytes -= old.nbytes
            while self._bytes + ad.nbytes > self.capacity_bytes:
                victim = next((n for n in self._adapters
                               if n not in pinned), None)
                if victim is None:
                    if old is not None:   # roll back
                        self._adapters[ad.name] = old
                        self._bytes += old.nbytes
                    raise ValueError(
                        f"adapter {ad.name!r} does not fit: every "
                        "resident adapter is pinned by live requests")
                v = self._adapters.pop(victim)
                self._bytes -= v.nbytes
                self.evictions += 1
                evicted.append(victim)
            self._adapters[ad.name] = ad
            self._bytes += ad.nbytes
        return evicted

    def drop(self, name: str) -> bool:
        with self._lock:
            ad = self._adapters.pop(name, None)
            if ad is None:
                return False
            self._bytes -= ad.nbytes
            return True

    def names(self) -> List[str]:
        with self._lock:
            return list(self._adapters)

    def stats(self) -> dict:
        with self._lock:
            return {"adapters": len(self._adapters), "bytes": self._bytes,
                    "capacity_bytes": self.capacity_bytes,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}
