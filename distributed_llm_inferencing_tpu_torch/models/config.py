"""Model configuration: the port's own copy of the reference ModelConfig.

The field names and defaults are those of the JAX package's
``models/config.py`` so a configuration reads the same on both sides
(``dataclasses.asdict`` of one builds the other). The port runs the dense
families (models/registry.py); the validation asserts, the dense
segment's config and the dense cache's plane shapes are the reference's
(its ``__post_init__``, ``dense_segment_cfg`` and ``cache_*``
properties); models/transformer.py refuses, at construction, a config
that switches on a feature it does not serve (``check_supported``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # Identity
    name: str = "gpt2"
    family: str = "gpt2"

    # Core dimensions
    vocab_size: int = 50257
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = 12          # < num_heads => GQA
    head_dim: int = 64
    max_position_embeddings: int = 1024

    # Architecture switches (see the reference config for each one)
    norm_type: str = "layernorm"    # layernorm | rmsnorm
    norm_eps: float = 1e-5
    activation: str = "gelu"
    gated_mlp: bool = False
    position_embedding: str = "learned"   # learned | rope | alibi
    alibi_scale: float = 1.0
    rope_theta: float = 10000.0
    rope_pct: float = 1.0
    rope_interleaved: bool = False
    rope_inv_freq: Optional[Tuple[float, ...]] = None
    rope_attn_factor: float = 1.0
    embed_norm: bool = False
    attn_bias: bool = True
    o_bias: Optional[bool] = None
    mlp_bias: bool = True
    lm_head_bias: bool = False
    tie_word_embeddings: bool = True
    parallel_residual: bool = False
    shared_attn_mlp_norm: bool = False
    sliding_window: Optional[int] = None
    attn_windows: Optional[Tuple[Optional[int], ...]] = None
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    logit_scale: Optional[float] = None
    post_block_norms: bool = False
    query_pre_attn_scalar: Optional[float] = None
    embed_scale: Optional[float] = None
    norm_offset: bool = False
    qk_norm: Optional[str] = None
    sublayer_postnorm_only: bool = False
    qk_norm_after_rope: bool = False
    qkv_clip: Optional[float] = None
    rope_layers: Optional[Tuple[int, ...]] = None
    residual_scale: Optional[float] = None
    embed_proj_dim: Optional[int] = None
    post_norm: bool = False

    # Multi-head latent attention (DeepSeek)
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: Optional[int] = None
    mla_latent_cache: bool = False

    # Mixture of experts
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_router: str = "softmax"
    moe_n_group: int = 1
    moe_topk_group: int = 1
    moe_routed_scale: float = 1.0
    moe_norm_topk: bool = True
    moe_shared_experts: int = 0
    moe_swiglu_limit: Optional[float] = None
    moe_swiglu_alpha: float = 1.702
    attn_sinks: bool = False
    dense_prefix_layers: int = 0
    dense_intermediate_size: Optional[int] = None
    moe_dispatch: str = "auto"
    moe_capacity_factor: float = 1.25

    # Numerics
    dtype: str = "bfloat16"
    quant: Optional[str] = None
    embed_quant: Optional[str] = None
    kv_quant: Optional[str] = None

    # Kept for field parity with the reference; the port picks its
    # attention path by tensor device (ops/attention.py).
    attn_backend: str = "auto"
    tp_row_sharded: bool = False

    def __post_init__(self):
        """The reference's validation of latent attention, the latent
        cache, the routers and a dense prefix (its ``__post_init__``
        asserts), assert for assert; the other switches are checked where
        the model is built (models/transformer.py ``check_supported``)."""
        assert self.num_heads % self.num_kv_heads == 0, (
            f"num_heads={self.num_heads} must be divisible by "
            f"num_kv_heads={self.num_kv_heads}")
        for f in ("rope_inv_freq", "attn_windows", "rope_layers"):
            val = getattr(self, f)
            if val is not None:   # checkpoint json turns tuples into lists
                object.__setattr__(self, f, tuple(val))
        if self.kv_lora_rank is not None:
            assert self.head_dim == (self.qk_nope_head_dim
                                     + self.qk_rope_head_dim), (
                "MLA: head_dim must equal qk_nope_head_dim + "
                "qk_rope_head_dim")
            assert self.num_kv_heads == self.num_heads, (
                "MLA materializes k/v per head: num_kv_heads == num_heads")
            assert self.position_embedding == "rope" and self.qk_norm is None
        if self.mla_latent_cache:
            assert self.mla, "mla_latent_cache requires an MLA config"
            assert self.kv_quant is None, (
                "mla_latent_cache and kv_quant are mutually exclusive "
                "(the latent row is already the compressed representation)")
            assert (self.sliding_window is None
                    and self.attn_windows is None
                    and self.attn_softcap is None), (
                "mla_latent_cache's absorbed attention does not thread "
                "sliding windows or score softcapping; serve such a "
                "config with the materialized layout (DLI_MLA_LATENT=0)")
        assert self.moe_router in ("softmax", "deepseek_v3", "ernie",
                                   "topk_softmax"), (
            f"unknown moe_router {self.moe_router!r}")
        if self.dense_prefix_layers:
            assert 0 < self.dense_prefix_layers < self.num_layers, (
                f"dense_prefix_layers={self.dense_prefix_layers} must be "
                f"in (0, num_layers={self.num_layers}); an all-dense "
                "model is just num_experts=0")
            assert self.num_experts > 0, (
                "dense_prefix_layers describes a dense prefix AHEAD of "
                "MoE layers; set num_experts")
            assert self.dense_intermediate_size, (
                "dense_prefix_layers needs dense_intermediate_size (the "
                "prefix MLP width differs from the per-expert width)")
        if self.moe_router in ("deepseek_v3", "ernie") and self.num_experts:
            E, G = self.num_experts, self.moe_n_group
            assert G >= 1 and E % G == 0, (
                f"deepseek routing: num_experts={E} must divide into "
                f"moe_n_group={G} groups")
            assert E // G >= 2, (
                f"deepseek routing scores each group by its top-2 sum: "
                f"need >= 2 experts per group, got {E // G}")
            assert 1 <= self.moe_topk_group <= G, (
                f"moe_topk_group={self.moe_topk_group} must be in "
                f"[1, moe_n_group={G}]")
            assert self.moe_topk_group * (E // G) >= \
                self.num_experts_per_tok, (
                f"top-{self.num_experts_per_tok} routing needs at least "
                f"that many eligible experts, but moe_topk_group="
                f"{self.moe_topk_group} groups expose only "
                f"{self.moe_topk_group * (E // G)}")

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank is not None

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def v_head_dim_effective(self) -> int:
        return self.head_dim if self.v_head_dim is None else self.v_head_dim

    def dense_segment_cfg(self, num_layers: Optional[int] = None
                          ) -> "ModelConfig":
        """The config of the dense-MLP prefix of a mixed stack (the
        reference's ``dense_segment_cfg``): the MoE fields cleared, the
        MLP ``dense_intermediate_size`` wide. The port's first
        ``dense_prefix_layers`` ``Block``s are built from it."""
        return self.replace(
            num_experts=0, moe_shared_experts=0, moe_router="softmax",
            dense_prefix_layers=0, dense_intermediate_size=None,
            intermediate_size=self.dense_intermediate_size,
            num_layers=(self.dense_prefix_layers if num_layers is None
                        else num_layers))

    def layer_cfg(self, i: int) -> "ModelConfig":
        """Layer i's config: the dense segment's for a dense-prefix layer
        (``num_layers`` kept, so per-layer tuples still index by i), else
        this one."""
        if i < self.dense_prefix_layers:
            return self.dense_segment_cfg(num_layers=self.num_layers)
        return self

    # Dense-cache plane shapes (ops/kvcache.py ``init_cache``): the latent
    # layout stores one shared [k_rot | c] row per token in the k plane
    # and nothing in the v plane (attention reads v as the c slice of k).
    @property
    def cache_kv_heads(self) -> int:
        return 1 if self.mla_latent_cache else self.num_kv_heads

    @property
    def cache_head_dim(self) -> int:
        if self.mla_latent_cache:
            return self.qk_rope_head_dim + self.kv_lora_rank
        return self.head_dim

    @property
    def cache_v_head_dim(self) -> int:
        return 0 if self.mla_latent_cache else self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def o_bias_effective(self) -> bool:
        return self.attn_bias if self.o_bias is None else self.o_bias

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
