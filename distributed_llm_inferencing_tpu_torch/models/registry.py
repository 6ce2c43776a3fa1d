"""Model registry: name -> ModelConfig.

An own copy of the reference registry's rows for the families the port
serves: llama (``_llama``), gpt2 (``_gpt2``) and opt (``_opt``), qwen2,
gemma, gpt-neox/pythia, phi, falcon, bloom, mpt and gpt-j, plus the tiny
test configs, the rows with experts behind the softmax router
(mixtral-8x7b, moe-proxy-8e, tiny-mixtral), and the deepseek proxies
(latent attention, the deepseek_v3 router, shared experts and a dense
prefix: deepseek-proxy, tiny-deepseek): every row of the reference's.
"""

from __future__ import annotations

from typing import Dict

from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def _gpt2(name, hidden, layers, heads, ctx=1024):
    return ModelConfig(
        name=name, family="gpt2", vocab_size=50257, hidden_size=hidden,
        intermediate_size=4 * hidden, num_layers=layers, num_heads=heads,
        num_kv_heads=heads, head_dim=hidden // heads,
        max_position_embeddings=ctx, norm_type="layernorm", activation="gelu",
        gated_mlp=False, position_embedding="learned", attn_bias=True,
        mlp_bias=True, tie_word_embeddings=True,
    )


def _opt(name, hidden, inter, layers, heads, ctx=2048):
    return ModelConfig(
        name=name, family="opt", vocab_size=50272, hidden_size=hidden,
        intermediate_size=inter, num_layers=layers, num_heads=heads,
        num_kv_heads=heads, head_dim=hidden // heads,
        max_position_embeddings=ctx, norm_type="layernorm", activation="relu",
        gated_mlp=False, position_embedding="learned", attn_bias=True,
        mlp_bias=True, tie_word_embeddings=True,
    )


def _llama(name, hidden, inter, layers, heads, kv_heads, vocab=128256,
           ctx=8192, theta=500000.0, window=None):
    return ModelConfig(
        name=name, family="llama", vocab_size=vocab, hidden_size=hidden,
        intermediate_size=inter, num_layers=layers, num_heads=heads,
        num_kv_heads=kv_heads, head_dim=hidden // heads,
        max_position_embeddings=ctx, norm_type="rmsnorm", norm_eps=1e-5,
        activation="silu", gated_mlp=True, position_embedding="rope",
        rope_theta=theta, attn_bias=False, mlp_bias=False,
        tie_word_embeddings=False, sliding_window=window,
    )


# --- GPT-2 (the reference's default model) ---
register(_gpt2("gpt2", 768, 12, 12))
register(_gpt2("gpt2-medium", 1024, 24, 16))
register(_gpt2("gpt2-large", 1280, 36, 20))
register(_gpt2("gpt2-xl", 1600, 48, 25))

# --- OPT (the reference's other hint): learned positions, ReLU ---
register(_opt("opt-125m", 768, 3072, 12, 12))
register(_opt("opt-350m", 1024, 4096, 24, 16).replace(
    embed_proj_dim=512, post_norm=True))
register(_opt("opt-1.3b", 2048, 8192, 24, 32))

register(_llama("llama-3-8b", 4096, 14336, 32, 32, 8))
register(_llama("llama-3-70b", 8192, 28672, 80, 64, 8))
# llama arch + sliding window
register(_llama("mistral-7b", 4096, 14336, 32, 32, 8, vocab=32000,
                ctx=32768, theta=10000.0, window=4096))

# --- Mixtral: Mistral + 8-expert MoE ---
register(_llama("mixtral-8x7b", 4096, 14336, 32, 32, 8, vocab=32000,
                ctx=32768, theta=1000000.0).replace(
                    name="mixtral-8x7b", num_experts=8, num_experts_per_tok=2))

# --- MoE proxy: an 8-expert ~2.6B-total (~0.8B active) llama-layout MoE
# that one card serves in bf16 ---
register(_llama("moe-proxy-8e", 1536, 4096, 16, 12, 4, vocab=32000,
                ctx=4096, theta=10000.0).replace(
                    name="moe-proxy-8e", num_experts=8,
                    num_experts_per_tok=2))

# --- DeepSeek proxy: V3's mechanisms (latent attention, sigmoid
# group-limited routing, shared experts, a dense prefix) at a size one
# card serves; dims follow V3's ratios (kv_lora_rank ~ D/14, rope head =
# nope/2, v = nope) ---
register(ModelConfig(
    name="deepseek-proxy", family="deepseek", vocab_size=32000,
    hidden_size=1024, intermediate_size=512, num_layers=12, num_heads=16,
    num_kv_heads=16, head_dim=96, qk_nope_head_dim=64,
    qk_rope_head_dim=32, v_head_dim=64, q_lora_rank=384, kv_lora_rank=128,
    max_position_embeddings=4096, norm_type="rmsnorm", activation="silu",
    gated_mlp=True, position_embedding="rope", rope_theta=10000.0,
    rope_interleaved=True, attn_bias=False, mlp_bias=False,
    tie_word_embeddings=False, num_experts=8, num_experts_per_tok=2,
    moe_router="deepseek_v3", moe_n_group=4, moe_topk_group=2,
    moe_routed_scale=2.5, moe_shared_experts=1,
    dense_prefix_layers=1, dense_intermediate_size=2048))

# --- Qwen2: llama layout + bias on q/k/v only ---
register(_llama("qwen2-7b", 3584, 18944, 28, 28, 4, vocab=152064,
                ctx=32768, theta=1000000.0).replace(
                    name="qwen2-7b", attn_bias=True, o_bias=False))
register(_llama("qwen2-0.5b", 896, 4864, 24, 14, 2, vocab=151936,
                ctx=32768, theta=1000000.0).replace(
                    name="qwen2-0.5b", attn_bias=True, o_bias=False,
                    tie_word_embeddings=True))

# --- Gemma: llama layout + tanh-gelu, sqrt(D) embed normalizer, wide
# head_dim (256 > hidden/heads), tied 256k-vocab head ---
register(_llama("gemma-7b", 3072, 24576, 28, 16, 16, vocab=256000,
                ctx=8192, theta=10000.0).replace(
                    name="gemma-7b", head_dim=256, activation="gelu",
                    tie_word_embeddings=True, embed_scale=3072 ** 0.5,
                    norm_eps=1e-6, norm_offset=True))
register(_llama("gemma-2b", 2048, 16384, 18, 8, 1, vocab=256000,
                ctx=8192, theta=10000.0).replace(
                    name="gemma-2b", head_dim=256, activation="gelu",
                    tie_word_embeddings=True, embed_scale=2048 ** 0.5,
                    norm_eps=1e-6, norm_offset=True))

# --- GPT-NeoX / Pythia: parallel residual, partial rotary, exact gelu ---
register(ModelConfig(
    name="pythia-6.9b", family="gpt-neox", vocab_size=50432,
    hidden_size=4096, intermediate_size=16384, num_layers=32, num_heads=32,
    num_kv_heads=32, head_dim=128, max_position_embeddings=2048,
    norm_type="layernorm", activation="gelu_exact", gated_mlp=False,
    position_embedding="rope", rope_theta=10000.0, rope_pct=0.25,
    attn_bias=True, mlp_bias=True, tie_word_embeddings=False,
    parallel_residual=True))
register(ModelConfig(
    name="pythia-1.4b", family="gpt-neox", vocab_size=50304,
    hidden_size=2048, intermediate_size=8192, num_layers=24, num_heads=16,
    num_kv_heads=16, head_dim=128, max_position_embeddings=2048,
    norm_type="layernorm", activation="gelu_exact", gated_mlp=False,
    position_embedding="rope", rope_theta=10000.0, rope_pct=0.25,
    attn_bias=True, mlp_bias=True, tie_word_embeddings=False,
    parallel_residual=True))

# --- Phi-2: parallel residual + single shared norm, biased lm_head ---
register(ModelConfig(
    name="phi-2", family="phi", vocab_size=51200, hidden_size=2560,
    intermediate_size=10240, num_layers=32, num_heads=32, num_kv_heads=32,
    head_dim=80, max_position_embeddings=2048, norm_type="layernorm",
    activation="gelu", gated_mlp=False, position_embedding="rope",
    rope_theta=10000.0, rope_pct=0.4, attn_bias=True, mlp_bias=True,
    lm_head_bias=True, tie_word_embeddings=False, parallel_residual=True,
    shared_attn_mlp_norm=True))

# --- Falcon-7B: MQA, parallel residual + shared norm ---
register(ModelConfig(
    name="falcon-7b", family="falcon", vocab_size=65024, hidden_size=4544,
    intermediate_size=18176, num_layers=32, num_heads=71, num_kv_heads=1,
    head_dim=64, max_position_embeddings=2048, norm_type="layernorm",
    activation="gelu_exact", gated_mlp=False, position_embedding="rope",
    rope_theta=10000.0, attn_bias=False, mlp_bias=False,
    tie_word_embeddings=True, parallel_residual=True,
    shared_attn_mlp_norm=True))

# --- BLOOM: ALiBi positions, layernormed embedding, tied 250k head ---
register(ModelConfig(
    name="bloom-7b1", family="bloom", vocab_size=250880, hidden_size=4096,
    intermediate_size=16384, num_layers=30, num_heads=32, num_kv_heads=32,
    head_dim=128, max_position_embeddings=2048, norm_type="layernorm",
    activation="gelu", gated_mlp=False, position_embedding="alibi",
    embed_norm=True, attn_bias=True, mlp_bias=True,
    tie_word_embeddings=True))

# --- Falcon-RW-1B: ALiBi + sequential residual ---
register(ModelConfig(
    name="falcon-rw-1b", family="falcon", vocab_size=50304,
    hidden_size=2048, intermediate_size=8192, num_layers=24, num_heads=32,
    num_kv_heads=32, head_dim=64, max_position_embeddings=2048,
    norm_type="layernorm", activation="gelu_exact", gated_mlp=False,
    position_embedding="alibi", alibi_scale=64 ** -0.5,
    attn_bias=True, mlp_bias=True, tie_word_embeddings=True))

# --- MPT-7B: ALiBi, bias-free, tied head ---
register(ModelConfig(
    name="mpt-7b", family="mpt", vocab_size=50432, hidden_size=4096,
    intermediate_size=16384, num_layers=32, num_heads=32, num_kv_heads=32,
    head_dim=128, max_position_embeddings=2048, norm_type="layernorm",
    activation="gelu_exact", gated_mlp=False, position_embedding="alibi",
    attn_bias=False, mlp_bias=False, tie_word_embeddings=True))

# --- GPT-J-6B: interleaved partial rotary, shared-norm parallel block ---
register(ModelConfig(
    name="gpt-j-6b", family="gptj", vocab_size=50400, hidden_size=4096,
    intermediate_size=16384, num_layers=28, num_heads=16, num_kv_heads=16,
    head_dim=256, max_position_embeddings=2048, norm_type="layernorm",
    activation="gelu", gated_mlp=False, position_embedding="rope",
    rope_theta=10000.0, rope_pct=0.25, rope_interleaved=True,
    attn_bias=False, o_bias=False, mlp_bias=True, lm_head_bias=True,
    tie_word_embeddings=False, parallel_residual=True,
    shared_attn_mlp_norm=True))

# --- Tiny configs for tests (not real checkpoints) ---
register(ModelConfig(
    name="tiny-gpt2", family="gpt2", vocab_size=256, hidden_size=64,
    intermediate_size=256, num_layers=4, num_heads=4, num_kv_heads=4,
    head_dim=16, max_position_embeddings=128, norm_type="layernorm",
    activation="gelu", gated_mlp=False, position_embedding="learned",
    attn_bias=True, mlp_bias=True, tie_word_embeddings=True))
register(ModelConfig(
    name="tiny-llama", family="llama", vocab_size=256, hidden_size=64,
    intermediate_size=128, num_layers=4, num_heads=8, num_kv_heads=4,
    head_dim=8, max_position_embeddings=128, norm_type="rmsnorm",
    activation="silu", gated_mlp=True, position_embedding="rope",
    attn_bias=False, mlp_bias=False, tie_word_embeddings=False))
register(ModelConfig(
    name="tiny-llama-long", family="llama", vocab_size=256, hidden_size=64,
    intermediate_size=128, num_layers=4, num_heads=8, num_kv_heads=4,
    head_dim=8, max_position_embeddings=1024, norm_type="rmsnorm",
    activation="silu", gated_mlp=True, position_embedding="rope",
    attn_bias=False, mlp_bias=False, tie_word_embeddings=False))
register(ModelConfig(
    name="tiny-mixtral", family="llama", vocab_size=256, hidden_size=64,
    intermediate_size=128, num_layers=2, num_heads=8, num_kv_heads=4,
    head_dim=8, max_position_embeddings=128, norm_type="rmsnorm",
    activation="silu", gated_mlp=True, position_embedding="rope",
    attn_bias=False, mlp_bias=False, tie_word_embeddings=False,
    num_experts=4, num_experts_per_tok=2))
register(ModelConfig(
    name="tiny-deepseek", family="deepseek", vocab_size=256,
    hidden_size=64, intermediate_size=32, num_layers=3, num_heads=8,
    num_kv_heads=8, head_dim=24, qk_nope_head_dim=16, qk_rope_head_dim=8,
    v_head_dim=16, q_lora_rank=32, kv_lora_rank=16,
    max_position_embeddings=128, norm_type="rmsnorm", activation="silu",
    gated_mlp=True, position_embedding="rope", rope_interleaved=True,
    attn_bias=False, mlp_bias=False, tie_word_embeddings=False,
    num_experts=4, num_experts_per_tok=2, moe_router="deepseek_v3",
    moe_n_group=2, moe_topk_group=1, moe_routed_scale=2.5,
    moe_shared_experts=1,
    # one dense-MLP layer ahead of the MoE layers (first_k_dense_replace)
    dense_prefix_layers=1, dense_intermediate_size=48))
