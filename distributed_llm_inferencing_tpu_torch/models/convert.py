"""HF checkpoint directory -> the port's flat dict (own copy of the JAX
package's ``models/convert.py``, for the converter types the port serves).

JAX function -> port function:

- ``_qwen2_window`` (:35), ``_yarn_params`` (:54), ``_rope_scaling_params``
  (:100), ``_HF_ACT`` / ``_act_from_hf`` (:203-212) -> the same names here,
  the arithmetic copied (numpy float64, as there), so ``rope_inv_freq``
  comes out as the same tuple of floats; ``_layer_windows_from_hf``
  (:182) -> the same name, the per-layer windows of qwen3, smollm3 and
  exaone4.
- ``SUPPORTED_MODEL_TYPES`` (:214) -> ``SUPPORTED_MODEL_TYPES``: all 39
  of its types, mixtral (:257-261, ``num_local_experts``), qwen3_moe
  (:788-805) and the other experts and latent attention among them
  (gpt_oss :942, hunyuan_v1_moe :985, ernie4_5_moe :1018, glm4_moe
  :1064, dbrx :1119, deepseek_v3 :1156, with yarn's mscale fold at
  :61-99); what the JAX converter refuses (per-layer expert lists,
  interleaved or early-ending MoE layers, a dbrx p-norm other than 1) is
  refused here with the same cause.
- ``config_from_hf`` (:225) -> ``config_from_hf``, taking the
  ``config.json`` dict. The JAX function reads attributes of a
  ``transformers`` config object, whose class has already filled every
  absent key with its default, aliased names through ``attribute_map``
  (``n_embd`` <-> ``hidden_size``, ...) and derived a few fields in its
  ``__init__``. ``hf_view`` does the same from data: ``HF_DEFAULTS`` holds,
  per type, the class default of every key ``config_from_hf`` reads
  (transformers 4.57.6's config classes), ``HF_ALIASES`` the attribute
  maps, and ``_derive`` the ``__init__`` rules that touch those keys
  (layer types, NoPE layers, GPT-Neo's attention layers, ...). The
  branches then read the view as the JAX branches read the object: the
  JAX lines of the later types are gpt_neo :665, gemma2 :704, cohere
  :756, qwen3 :788, smollm3 :858, hunyuan_v1_dense :887, exaone4 :911,
  granite :1226, olmo2 :1262, glm4 :1287, nemotron :1319.
- ``convert_state_dict`` (:1363) -> ``convert_state_dict``, the branches the
  types reach: gpt2 :1372, opt :1399, llama :1435 (llama, mistral,
  qwen2, gemma, ernie4_5), gpt-neox :1710, phi :1749, falcon :1777, bloom
  :1836, gptj :1881, mpt :1910, gpt_bigcode :1956, stablelm :2003,
  codegen :2034, starcoder2 :2074, olmo :2104, phi3 :2136, gpt_neo :2164,
  gemma2 :2200, cohere :2240, olmo2 :2278 (olmo2, exaone4), glm :2312
  (glm, glm4), nemotron :2351; qwen3, smollm3, hunyuan_v1_dense and
  granite take the llama branch, and so do mixtral, qwen3_moe,
  glm4_moe, ernie4_5_moe and hunyuan_v1_moe, whose MoE blocks give the
  router (with its selection bias), the stacked experts (with their
  biases) and the shared experts, after a dense prefix's MLP layers
  (:1446-1534, ``_experts``); dbrx :1535 (its fused expert stacks),
  gpt_oss :1579 and deepseek_v3 :1622 (MLA's column permutation, the
  segments) have branches of their own. The output is the port's flat dict
  (models/params.py): ``[din, dout]`` weights, the layer axis unrolled;
  the JAX tree's int32 ``attn_window`` / ``rope_on`` leaves are the
  config's ``attn_windows`` / ``rope_layers`` here (no tensors).
- ``load_hf_model`` (:2429) -> ``load_hf_model(path, dtype, device,
  shard)``: a local directory only (the JAX package's opt-in hub download
  is not ported); the files are read by models/hf_files.py, never through
  ``transformers``.

Bitwise parity with ``params_from_jax(load_hf_model(...))``: the JAX path
upcasts every tensor to f32 (``from_pretrained`` builds the model in f32),
slices, transposes and absorbs in f32, and casts once to the target dtype.
Here each tensor is copied to the device in its file dtype and cast once at
the end; the only arithmetic (gemma's ``(1 + w)`` norms, the llama
branch's ``+ 0.0`` on the others' norms, which turns -0.0 into +0.0 as it
does there, nemotron's LayerNorm1P ``(1 + w)``, and the
``query_pre_attn_scalar`` / GPT-Neo score folds into q) runs in f32
first. A
slice or transpose commutes with the one rounding, so the bits are those
of the JAX path.

One tensor at a time: each converted tensor is finished (cast, made
contiguous), passed through ``cfg.quant`` / ``cfg.embed_quant`` (the
weight-only forms of ops/quant.py, as ``init_params`` draws them) and the
``shard(name, tensor)`` callback (a tp rank's cut, as ``init_params``
takes it) before the next is read, so the device never holds more than
the result plus one leaf and its f32 twin, and the host never holds a
copy of the model: the files are memory-mapped.
"""

from __future__ import annotations

import math
import os
import types
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.models.hf_files import (
    CheckpointFiles, read_config)
from distributed_llm_inferencing_tpu_torch.ops.quant import (
    EMBED, _LINEAR_W, check_modes, quantize_embed, quantize_weight,
    quantize_weight_int4)
from distributed_llm_inferencing_tpu_torch.utils.device import (
    resolve_device, torch_dtype)

SUPPORTED_MODEL_TYPES = (
    "gpt2", "opt", "llama", "mistral", "qwen2", "gemma", "gpt_neox", "phi",
    "falcon", "bloom", "gptj", "mpt", "gpt_bigcode", "stablelm", "codegen",
    "starcoder2", "olmo", "phi3", "glm", "ernie4_5", "gpt_neo", "gemma2",
    "cohere", "qwen3", "granite", "olmo2", "glm4", "nemotron", "smollm3",
    "hunyuan_v1_dense", "exaone4", "mixtral", "qwen3_moe", "gpt_oss",
    "hunyuan_v1_moe", "ernie4_5_moe", "glm4_moe", "dbrx", "deepseek_v3")

# model_type -> the class default (transformers 4.57.6) of every key that
# config_from_hf reads for it; a key absent here and from config.json
# reads as config_from_hf's own getattr default
HF_DEFAULTS = {
    "gpt2": {"n_embd": 768, "n_inner": None, "n_layer": 12, "n_head": 12,
             "n_positions": 1024, "layer_norm_epsilon": 1e-05,
             "vocab_size": 50257, "tie_word_embeddings": True},
    "opt": {"hidden_size": 768, "word_embed_proj_dim": None,
            "do_layer_norm_before": True, "ffn_dim": 3072,
            "num_hidden_layers": 12, "num_attention_heads": 12,
            "max_position_embeddings": 2048, "vocab_size": 50272,
            "tie_word_embeddings": True},
    "llama": {"hidden_size": 4096, "intermediate_size": 11008,
              "num_hidden_layers": 32, "num_attention_heads": 32,
              "num_key_value_heads": None, "head_dim": None,
              "max_position_embeddings": 2048, "rms_norm_eps": 1e-06,
              "rope_theta": 10000.0, "rope_scaling": None,
              "attention_bias": False, "mlp_bias": False,
              "vocab_size": 32000, "tie_word_embeddings": False},
    "mistral": {"hidden_size": 4096, "intermediate_size": 14336,
                "num_hidden_layers": 32, "num_attention_heads": 32,
                "num_key_value_heads": 8, "head_dim": None,
                "max_position_embeddings": 131072, "rms_norm_eps": 1e-06,
                "rope_theta": 10000.0, "sliding_window": 4096,
                "vocab_size": 32000, "tie_word_embeddings": False},
    "mixtral": {"vocab_size": 32000, "hidden_size": 4096,
                "intermediate_size": 14336, "num_hidden_layers": 32,
                "num_attention_heads": 32, "num_key_value_heads": 8,
                "head_dim": None, "max_position_embeddings": 131072,
                "rms_norm_eps": 1e-05, "rope_theta": 1000000.0,
                "sliding_window": None, "tie_word_embeddings": False,
                "num_local_experts": 8, "num_experts_per_tok": 2},
    "qwen3_moe": {"vocab_size": 151936, "hidden_size": 2048,
                  "intermediate_size": 6144, "moe_intermediate_size": 768,
                  "num_hidden_layers": 24, "num_attention_heads": 32,
                  "num_key_value_heads": 4, "hidden_act": "silu",
                  "max_position_embeddings": 32768, "rms_norm_eps": 1e-06,
                  "tie_word_embeddings": False, "rope_theta": 10000.0,
                  "rope_scaling": None, "attention_bias": False,
                  "use_sliding_window": False, "sliding_window": 4096,
                  "num_experts": 128, "num_experts_per_tok": 8,
                  "norm_topk_prob": False, "mlp_only_layers": None,
                  "decoder_sparse_step": 1},
    "qwen2": {"hidden_size": 4096, "intermediate_size": 22016,
              "num_hidden_layers": 32, "num_attention_heads": 32,
              "num_key_value_heads": 32, "max_position_embeddings": 32768,
              "rms_norm_eps": 1e-06, "rope_theta": 10000.0,
              "rope_scaling": None, "use_sliding_window": False,
              "sliding_window": 4096, "max_window_layers": 28,
              "vocab_size": 151936, "tie_word_embeddings": False},
    "gemma": {"hidden_size": 3072, "intermediate_size": 24576,
              "num_hidden_layers": 28, "num_attention_heads": 16,
              "num_key_value_heads": 16, "head_dim": 256,
              "max_position_embeddings": 8192, "rms_norm_eps": 1e-06,
              "rope_theta": 10000.0, "attention_bias": False,
              "vocab_size": 256000, "tie_word_embeddings": True},
    "gpt_neox": {"hidden_size": 6144, "intermediate_size": 24576,
                 "num_hidden_layers": 44, "num_attention_heads": 64,
                 "max_position_embeddings": 2048, "layer_norm_eps": 1e-05,
                 "hidden_act": "gelu", "rotary_emb_base": 10000,
                 "rotary_pct": 0.25, "attention_bias": True,
                 "use_parallel_residual": True, "vocab_size": 50432,
                 "tie_word_embeddings": False},
    "phi": {"hidden_size": 2048, "intermediate_size": 8192,
            "num_hidden_layers": 24, "num_attention_heads": 32,
            "num_key_value_heads": None, "max_position_embeddings": 2048,
            "layer_norm_eps": 1e-05, "hidden_act": "gelu_new",
            "rope_theta": 10000.0, "partial_rotary_factor": 0.5,
            "qk_layernorm": False, "vocab_size": 51200,
            "tie_word_embeddings": False},
    "falcon": {"hidden_size": 4544, "num_hidden_layers": 32,
               "num_attention_heads": 71, "num_kv_heads": None,
               "layer_norm_epsilon": 1e-05, "alibi": False,
               "new_decoder_architecture": False, "multi_query": True,
               "parallel_attn": True, "bias": False,
               "num_ln_in_parallel_attn": None,
               "max_position_embeddings": 2048, "rope_theta": 10000.0,
               "activation": "gelu", "ffn_hidden_size": None,
               "vocab_size": 65024, "tie_word_embeddings": True},
    "bloom": {"hidden_size": 64, "n_layer": 2, "n_head": 8,
              "layer_norm_epsilon": 1e-05, "vocab_size": 250880,
              "tie_word_embeddings": True},
    "gptj": {"n_embd": 4096, "n_inner": None, "n_layer": 28, "n_head": 16,
             "n_positions": 2048, "layer_norm_epsilon": 1e-05,
             "rotary_dim": 64, "activation_function": "gelu_new",
             "vocab_size": 50400, "tie_word_embeddings": False},
    "mpt": {"d_model": 2048, "n_heads": 16, "n_layers": 24,
            "expansion_ratio": 4, "max_seq_len": 2048, "no_bias": True,
            "vocab_size": 50368, "tie_word_embeddings": True,
            "attn_config": None},
    "gpt_bigcode": {"n_embd": 768, "n_inner": None, "n_layer": 12,
                    "n_head": 12, "n_positions": 1024,
                    "layer_norm_epsilon": 1e-05,
                    "activation_function": "gelu_pytorch_tanh",
                    "multi_query": True, "vocab_size": 50257,
                    "tie_word_embeddings": True},
    "stablelm": {"hidden_size": 2560, "intermediate_size": 6912,
                 "num_hidden_layers": 32, "num_attention_heads": 32,
                 "num_key_value_heads": 32, "max_position_embeddings": 4096,
                 "layer_norm_eps": 1e-05, "hidden_act": "silu",
                 "rope_theta": 10000, "partial_rotary_factor": 0.25,
                 "use_qkv_bias": False, "qk_layernorm": False,
                 "use_parallel_residual": False, "vocab_size": 50304,
                 "tie_word_embeddings": False},
    "codegen": {"n_embd": 4096, "n_inner": None, "n_layer": 28,
                "n_head": 16, "n_positions": 2048,
                "layer_norm_epsilon": 1e-05, "rotary_dim": 64,
                "activation_function": "gelu_new", "vocab_size": 50400,
                "tie_word_embeddings": False},
    "starcoder2": {"hidden_size": 3072, "intermediate_size": 12288,
                   "num_hidden_layers": 30, "num_attention_heads": 24,
                   "num_key_value_heads": 2,
                   "max_position_embeddings": 4096, "norm_epsilon": 1e-05,
                   "hidden_act": "gelu_pytorch_tanh", "rope_theta": 10000.0,
                   "use_bias": True, "sliding_window": None,
                   "vocab_size": 49152, "tie_word_embeddings": True},
    "olmo": {"hidden_size": 4096, "intermediate_size": 11008,
             "num_hidden_layers": 32, "num_attention_heads": 32,
             "num_key_value_heads": None, "max_position_embeddings": 2048,
             "hidden_act": "silu", "rope_theta": 10000.0,
             "attention_bias": False, "clip_qkv": None, "vocab_size": 50304,
             "tie_word_embeddings": False},
    "phi3": {"hidden_size": 3072, "intermediate_size": 8192,
             "num_hidden_layers": 32, "num_attention_heads": 32,
             "num_key_value_heads": None, "max_position_embeddings": 4096,
             "original_max_position_embeddings": 4096,
             "rms_norm_eps": 1e-05, "hidden_act": "silu",
             "rope_theta": 10000.0, "rope_scaling": None,
             "partial_rotary_factor": 1.0, "sliding_window": None,
             "vocab_size": 32064, "tie_word_embeddings": False},
    "glm": {"hidden_size": 4096, "intermediate_size": 13696,
            "num_hidden_layers": 40, "num_attention_heads": 32,
            "num_key_value_heads": 2, "head_dim": 128,
            "max_position_embeddings": 131072, "rms_norm_eps": 1.5625e-07,
            "hidden_act": "silu", "rope_theta": 10000.0,
            "partial_rotary_factor": 0.5, "attention_bias": True,
            "vocab_size": 151552, "tie_word_embeddings": False},
    "ernie4_5": {"hidden_size": 1024, "intermediate_size": 3072,
                 "num_hidden_layers": 18, "num_attention_heads": 16,
                 "num_key_value_heads": 2, "head_dim": 128,
                 "max_position_embeddings": 131072, "rms_norm_eps": 1e-05,
                 "hidden_act": "silu", "rope_theta": 500000.0,
                 "rope_scaling": None, "use_bias": False,
                 "vocab_size": 103424, "tie_word_embeddings": True},
    "gpt_neo": {"vocab_size": 50257, "max_position_embeddings": 2048,
                "hidden_size": 2048, "num_layers": 24,
                "attention_types": [[["global", "local"], 12]],
                "num_heads": 16, "intermediate_size": None,
                "window_size": 256, "activation_function": "gelu_new",
                "layer_norm_epsilon": 1e-05, "tie_word_embeddings": True},
    "gemma2": {"vocab_size": 256000, "hidden_size": 2304,
               "intermediate_size": 9216, "num_hidden_layers": 26,
               "num_attention_heads": 8, "num_key_value_heads": 4,
               "head_dim": 256, "hidden_activation": "gelu_pytorch_tanh",
               "max_position_embeddings": 8192, "rms_norm_eps": 1e-06,
               "tie_word_embeddings": True, "rope_theta": 10000.0,
               "attention_bias": False, "query_pre_attn_scalar": 256,
               "sliding_window": 4096, "layer_types": None,
               "final_logit_softcapping": 30.0,
               "attn_logit_softcapping": 50.0},
    "cohere": {"vocab_size": 256000, "hidden_size": 8192,
               "intermediate_size": 22528, "logit_scale": 0.0625,
               "num_hidden_layers": 40, "num_attention_heads": 64,
               "num_key_value_heads": None, "hidden_act": "silu",
               "max_position_embeddings": 8192, "layer_norm_eps": 1e-05,
               "tie_word_embeddings": True, "rope_theta": 10000.0,
               "attention_bias": False, "use_qk_norm": False},
    "qwen3": {"vocab_size": 151936, "hidden_size": 4096,
              "intermediate_size": 22016, "num_hidden_layers": 32,
              "num_attention_heads": 32, "num_key_value_heads": 32,
              "head_dim": 128, "hidden_act": "silu",
              "max_position_embeddings": 32768, "rms_norm_eps": 1e-06,
              "tie_word_embeddings": False, "rope_theta": 10000.0,
              "rope_scaling": None, "attention_bias": False,
              "use_sliding_window": False, "sliding_window": 4096,
              "max_window_layers": 28, "layer_types": None},
    "smollm3": {"vocab_size": 128256, "hidden_size": 2048,
                "intermediate_size": 11008, "num_hidden_layers": 36,
                "num_attention_heads": 16, "num_key_value_heads": 4,
                "hidden_act": "silu", "max_position_embeddings": 32768,
                "rms_norm_eps": 1e-06, "rope_theta": 2000000.0,
                "use_sliding_window": False, "sliding_window": None,
                "no_rope_layers": None, "no_rope_layer_interval": 4,
                "layer_types": None, "attention_bias": False,
                "mlp_bias": False, "tie_word_embeddings": True},
    "hunyuan_v1_dense": {"vocab_size": 290943, "hidden_size": 4096,
                         "intermediate_size": 11008,
                         "num_hidden_layers": 32,
                         "num_attention_heads": 32,
                         "num_key_value_heads": None, "hidden_act": "silu",
                         "max_position_embeddings": 2048,
                         "rms_norm_eps": 1e-05,
                         "tie_word_embeddings": False,
                         "rope_theta": 10000.0, "attention_bias": False,
                         "head_dim": None},
    "exaone4": {"vocab_size": 102400, "hidden_size": 4096,
                "intermediate_size": 16384, "num_hidden_layers": 32,
                "num_attention_heads": 32, "num_key_value_heads": 32,
                "hidden_act": "silu", "max_position_embeddings": 2048,
                "rms_norm_eps": 1e-05, "tie_word_embeddings": False,
                "rope_theta": 10000.0, "sliding_window": 4096,
                "sliding_window_pattern": 4, "layer_types": None},
    "granite": {"vocab_size": 32000, "hidden_size": 4096,
                "intermediate_size": 11008, "num_hidden_layers": 32,
                "num_attention_heads": 32, "num_key_value_heads": None,
                "hidden_act": "silu", "max_position_embeddings": 2048,
                "rms_norm_eps": 1e-06, "tie_word_embeddings": False,
                "rope_theta": 10000.0, "attention_bias": False,
                "mlp_bias": False, "embedding_multiplier": 1.0,
                "logits_scaling": 1.0, "residual_multiplier": 1.0,
                "attention_multiplier": 1.0},
    "olmo2": {"vocab_size": 50304, "hidden_size": 4096,
              "intermediate_size": 11008, "num_hidden_layers": 32,
              "num_attention_heads": 32, "num_key_value_heads": None,
              "hidden_act": "silu", "max_position_embeddings": 2048,
              "tie_word_embeddings": False, "rope_theta": 10000.0,
              "attention_bias": False, "rms_norm_eps": 1e-05},
    "glm4": {"vocab_size": 151552, "hidden_size": 4096,
             "intermediate_size": 13696, "num_hidden_layers": 40,
             "num_attention_heads": 32, "num_key_value_heads": 2,
             "partial_rotary_factor": 0.5, "head_dim": 128,
             "hidden_act": "silu", "max_position_embeddings": 131072,
             "rms_norm_eps": 1.5625e-07, "tie_word_embeddings": False,
             "rope_theta": 10000.0, "attention_bias": True},
    "nemotron": {"vocab_size": 256000, "hidden_size": 6144,
                 "intermediate_size": 24576, "num_hidden_layers": 32,
                 "num_attention_heads": 48, "head_dim": None,
                 "num_key_value_heads": None, "hidden_act": "relu2",
                 "max_position_embeddings": 4096, "norm_eps": 1e-05,
                 "tie_word_embeddings": False, "rope_theta": 10000.0,
                 "partial_rotary_factor": 0.5, "attention_bias": False,
                 "mlp_bias": False},
    # the experts and latent attention (their __init__ rules: _derive)
    "gpt_oss": {"vocab_size": 201088, "hidden_size": 2880,
                "intermediate_size": 2880, "num_hidden_layers": 36,
                "num_attention_heads": 64, "num_key_value_heads": 8,
                "head_dim": 64, "max_position_embeddings": 131072,
                "rms_norm_eps": 1e-05, "rope_theta": 150000.0,
                "rope_scaling": {"rope_type": "yarn", "factor": 32.0,
                                 "beta_fast": 32.0, "beta_slow": 1.0,
                                 "truncate": False,
                                 "original_max_position_embeddings": 4096},
                "sliding_window": 128, "layer_types": None,
                "num_local_experts": 128, "num_experts_per_tok": 4,
                "tie_word_embeddings": False},
    "hunyuan_v1_moe": {"vocab_size": 290943, "hidden_size": 4096,
                       "intermediate_size": 11008, "num_hidden_layers": 32,
                       "num_attention_heads": 32,
                       "num_key_value_heads": None, "head_dim": None,
                       "hidden_act": "silu", "max_position_embeddings": 2048,
                       "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
                       "attention_bias": False, "num_experts": 1,
                       "moe_topk": 1, "tie_word_embeddings": False},
    "ernie4_5_moe": {"vocab_size": 103424, "hidden_size": 2560,
                     "intermediate_size": 12288, "num_hidden_layers": 28,
                     "num_attention_heads": 20, "num_key_value_heads": 4,
                     "hidden_act": "silu", "max_position_embeddings": 131072,
                     "rms_norm_eps": 1e-05, "rope_theta": 500000.0,
                     "rope_scaling": None, "use_bias": False,
                     "moe_intermediate_size": 1536, "moe_k": 6,
                     "moe_num_experts": 64, "moe_num_shared_experts": 2,
                     "moe_layer_start_index": 1, "moe_layer_end_index": -1,
                     "moe_layer_interval": 1, "tie_word_embeddings": True},
    "glm4_moe": {"vocab_size": 151552, "hidden_size": 4096,
                 "intermediate_size": 10944, "num_hidden_layers": 46,
                 "num_attention_heads": 96, "partial_rotary_factor": 0.5,
                 "num_key_value_heads": 8, "hidden_act": "silu",
                 "max_position_embeddings": 131072, "rms_norm_eps": 1e-05,
                 "rope_theta": 10000.0, "rope_scaling": None,
                 "attention_bias": False, "moe_intermediate_size": 1408,
                 "num_experts_per_tok": 8, "n_shared_experts": 1,
                 "n_routed_experts": 128, "routed_scaling_factor": 1.0,
                 "n_group": 1, "topk_group": 1, "first_k_dense_replace": 1,
                 "norm_topk_prob": True, "use_qk_norm": False,
                 "tie_word_embeddings": False},
    "dbrx": {"d_model": 2048, "n_heads": 16, "n_layers": 24,
             "max_seq_len": 2048, "vocab_size": 32000, "attn_config": None,
             "ffn_config": None, "tie_word_embeddings": False},
    "deepseek_v3": {"vocab_size": 129280, "hidden_size": 7168,
                    "intermediate_size": 18432,
                    "moe_intermediate_size": 2048, "num_hidden_layers": 61,
                    "num_attention_heads": 128, "num_key_value_heads": 128,
                    "n_shared_experts": 1, "n_routed_experts": 256,
                    "routed_scaling_factor": 2.5, "kv_lora_rank": 512,
                    "q_lora_rank": 1536, "qk_rope_head_dim": 64,
                    "v_head_dim": 128, "qk_nope_head_dim": 128, "n_group": 8,
                    "topk_group": 4, "num_experts_per_tok": 8,
                    "first_k_dense_replace": 3, "norm_topk_prob": True,
                    "hidden_act": "silu", "max_position_embeddings": 4096,
                    "rms_norm_eps": 1e-06, "tie_word_embeddings": False,
                    "rope_theta": 10000.0, "rope_scaling": None,
                    "rope_interleave": True, "attention_bias": False},
}

# model_type -> transformers' ``attribute_map`` (alias -> stored name)
HF_ALIASES = {
    "gpt2": {"hidden_size": "n_embd", "max_position_embeddings":
             "n_positions", "num_attention_heads": "n_head",
             "num_hidden_layers": "n_layer"},
    "bloom": {"num_hidden_layers": "n_layer",
              "num_attention_heads": "n_head"},
    "gptj": {"max_position_embeddings": "n_positions",
             "hidden_size": "n_embd", "num_attention_heads": "n_head",
             "num_hidden_layers": "n_layer"},
    "mpt": {"num_attention_heads": "n_heads", "hidden_size": "d_model",
            "num_hidden_layers": "n_layers"},
    "gpt_bigcode": {"hidden_size": "n_embd", "max_position_embeddings":
                    "n_positions", "num_attention_heads": "n_head",
                    "num_hidden_layers": "n_layer"},
    "codegen": {"max_position_embeddings": "n_positions",
                "hidden_size": "n_embd", "num_attention_heads": "n_head",
                "num_hidden_layers": "n_layer"},
    "gpt_neo": {"num_attention_heads": "num_heads",
                "num_hidden_layers": "num_layers"},
    "dbrx": {"num_attention_heads": "n_heads", "hidden_size": "d_model",
             "num_hidden_layers": "n_layers",
             "max_position_embeddings": "max_seq_len"},
}

# MptAttentionConfig's fields and defaults (it keeps no other key)
_MPT_ATTN = {"attn_type": "multihead_attention", "attn_pdrop": 0,
             "attn_impl": "torch", "clip_qkv": None, "softmax_scale": None,
             "prefix_lm": False, "qk_ln": False,
             "attn_uses_sequence_id": False, "alibi": True,
             "alibi_bias_max": 8}
# DbrxAttentionConfig's and DbrxFFNConfig's fields and defaults (an
# unknown key is a ValueError there); the keys PretrainedConfig's
# serialization adds, which both drop
_DBRX_ATTN = {"attn_pdrop": 0.0, "clip_qkv": None, "kv_n_heads": 1,
              "rope_theta": 10000.0}
_DBRX_FFN = {"ffn_act_fn": None, "ffn_hidden_size": 3584,
             "moe_num_experts": 4, "moe_top_k": 1, "moe_jitter_eps": None,
             "moe_loss_weight": 0.01, "moe_normalize_expert_weights": 1.0}
_DBRX_DROPPED = ("model_type", "attn_implementation", "transformers_version",
                 "_commit_hash", "torch_dtype", "dtype")
# types whose config __init__ defaults num_key_value_heads to the heads
_KV_FROM_HEADS = ("llama", "mistral", "qwen2", "phi", "olmo", "phi3",
                  "ernie4_5", "cohere", "qwen3", "smollm3",
                  "hunyuan_v1_dense", "granite", "olmo2", "mixtral",
                  "qwen3_moe", "gpt_oss", "hunyuan_v1_moe", "deepseek_v3")
# types whose config __init__ copies rope_scaling's "type" to "rope_type"
_ROPE_TYPE_COPY = ("llama", "qwen2", "gpt_neox", "phi", "stablelm",
                   "starcoder2", "ernie4_5", "qwen3", "smollm3", "qwen3_moe",
                   "gpt_oss", "ernie4_5_moe", "glm4_moe", "deepseek_v3")
# transformers' ALLOWED_LAYER_TYPES
_LAYER_TYPES = ("full_attention", "sliding_attention", "chunked_attention",
                "linear_attention")


def _check_layer_types(kinds, n_layers):
    """transformers' ``layer_type_validation``."""
    if not all(k in _LAYER_TYPES for k in kinds):
        raise ValueError(f"The `layer_types` entries must be in "
                         f"{_LAYER_TYPES}")
    if len(kinds) != n_layers:
        raise ValueError(f"`num_hidden_layers` ({n_layers}) must be equal "
                         f"to the number of layer types ({len(kinds)})")


def _derive(mt: str, v: dict, given: dict):
    """The ``__init__`` rules of ``mt``'s config class that touch the keys
    config_from_hf reads (``given``: the keys config.json set)."""
    if mt in _KV_FROM_HEADS and v.get("num_key_value_heads") is None:
        v["num_key_value_heads"] = v["num_attention_heads"]
    if mt in ("llama", "ernie4_5") and v.get("head_dim") is None:
        v["head_dim"] = v["hidden_size"] // v["num_attention_heads"]
    if isinstance(v.get("rope_scaling"), dict):
        rs = v["rope_scaling"] = dict(v["rope_scaling"])
        if mt in _ROPE_TYPE_COPY and "type" in rs:
            rs["rope_type"] = rs["type"]
        if mt == "phi3" and rs.get("type") in ("su", "yarn"):
            rs["type"] = "longrope"
        if mt == "deepseek_v3":
            for key in ("beta_fast", "beta_slow", "factor"):
                if key in rs:
                    rs[key] = float(rs[key])
    if mt == "qwen2":
        if not v["use_sliding_window"]:
            v["sliding_window"] = None
        kinds = v.get("layer_types")   # layer_type_validation
        if kinds is not None and len(kinds) != v["num_hidden_layers"]:
            raise ValueError(f"num_hidden_layers "
                             f"({v['num_hidden_layers']}) must be equal to "
                             f"the number of layer types ({len(kinds)})")
    if mt in ("gemma2", "qwen3", "smollm3", "exaone4"):
        _derive_layer_types(mt, v)
    if mt == "qwen3_moe":
        if not v["use_sliding_window"]:
            v["sliding_window"] = None
        if v["mlp_only_layers"] is None:
            v["mlp_only_layers"] = []
    if mt == "gpt_neo":
        kinds = [k for kinds, n in v["attention_types"] for _ in range(n)
                 for k in kinds]
        if len(kinds) != v["num_layers"]:
            raise ValueError("Configuration for convolutional module is "
                             "incorrect: len(config.attention_layers) "
                             f"= {len(kinds)} != config.num_layers = "
                             f"{v['num_layers']}")
        # a saved attention_layers is set after __init__ expands the types
        v.setdefault("attention_layers", kinds)
    if mt == "gpt_oss":
        if v["head_dim"] is None:
            v["head_dim"] = v["hidden_size"] // v["num_attention_heads"]
        if v["layer_types"] is None:
            v["layer_types"] = ["sliding_attention" if (i + 1) % 2
                                else "full_attention"
                                for i in range(v["num_hidden_layers"])]
        _check_layer_types(v["layer_types"], v["num_hidden_layers"])
        v["attention_bias"] = True   # set whatever the file says
    if mt == "ernie4_5_moe" and v["moe_layer_end_index"] == -1:
        v["moe_layer_end_index"] = v["num_hidden_layers"] - 1
    if mt == "deepseek_v3":
        v["qk_head_dim"] = v["qk_nope_head_dim"] + v["qk_rope_head_dim"]
        v["head_dim"] = v["qk_rope_head_dim"]
    if mt == "dbrx":
        if v["tie_word_embeddings"]:
            raise ValueError("tie_word_embeddings is not supported for "
                             "DBRX models.")
        for key, fields in (("attn_config", _DBRX_ATTN),
                            ("ffn_config", _DBRX_FFN)):
            given_sub = {k: val for k, val in (v[key] or {}).items()
                         if k not in _DBRX_DROPPED}
            unknown = set(given_sub) - set(fields)
            if unknown:
                raise ValueError(f"Found unknown kwargs={sorted(unknown)}")
            v[key] = dict(fields, **given_sub)
        if v["ffn_config"]["ffn_act_fn"] is None:
            v["ffn_config"]["ffn_act_fn"] = {"name": "silu"}
        v["num_key_value_heads"] = v["attn_config"]["kv_n_heads"]
    if mt == "nemotron" and v["head_dim"] is None:
        v["head_dim"] = v["hidden_size"] // v["num_attention_heads"]
    if mt in ("falcon", "bloom") and "n_embed" in given:
        v["hidden_size"] = given["n_embed"]
    if mt == "falcon":
        if v["num_kv_heads"] is None:
            v["num_kv_heads"] = v["num_attention_heads"]
        if v["ffn_hidden_size"] is None:   # from hidden_size, not n_embed
            v["ffn_hidden_size"] = given.get(
                "hidden_size", HF_DEFAULTS["falcon"]["hidden_size"]) * 4
    if mt == "gpt_neox":
        if v["hidden_size"] % v["num_attention_heads"]:
            raise ValueError("The hidden size is not divisible by the "
                             "number of attention heads")
        v["rope_theta"] = v["rotary_emb_base"]
        v["partial_rotary_factor"] = v["rotary_pct"]
    if mt == "mpt":
        ac = v["attn_config"]
        v["attn_config"] = dict(_MPT_ATTN, **{
            k: val for k, val in (ac or {}).items() if k in _MPT_ATTN})


def _derive_layer_types(mt: str, v: dict):
    """The ``__init__`` rules of the layer-typed configs: qwen3's window
    switch, smollm3's NoPE layers, each one's default ``layer_types``,
    then their validation."""
    n = v["num_hidden_layers"]
    if mt == "qwen3" and not v["use_sliding_window"]:
        v["sliding_window"] = None
    if mt == "smollm3" and v["no_rope_layers"] is None:
        every = v["no_rope_layer_interval"]
        v["no_rope_layers"] = [int((i + 1) % every != 0) for i in range(n)]
    if v["layer_types"] is None:
        if mt == "gemma2":
            kinds = ["sliding_attention" if (i + 1) % 2 else "full_attention"
                     for i in range(n)]
        elif mt == "qwen3":
            kinds = ["sliding_attention" if v["sliding_window"] is not None
                     and i >= v["max_window_layers"] else "full_attention"
                     for i in range(n)]
        elif mt == "smollm3":
            kinds = ["sliding_attention" if v["use_sliding_window"]
                     and v["sliding_window"] is not None
                     and not v["no_rope_layers"][i] else "full_attention"
                     for i in range(n)]
        else:   # exaone4: every pattern-th layer global
            every = (v["sliding_window_pattern"]
                     if v["sliding_window"] is not None else 0)
            kinds = ["sliding_attention" if (i + 1) % every != 0
                     else "full_attention" for i in range(n)]
        v["layer_types"] = kinds
    _check_layer_types(v["layer_types"], n)


def hf_view(d: dict) -> types.SimpleNamespace:
    """``config.json``'s dict as the attributes a ``transformers`` config
    object of its ``model_type`` would have for config_from_hf."""
    mt = d.get("model_type")
    if mt not in HF_DEFAULTS:
        raise NotImplementedError(
            f"unsupported model_type {mt!r}; the port converts "
            f"{list(SUPPORTED_MODEL_TYPES)}")
    given = dict(d)
    for alias, name in HF_ALIASES.get(mt, {}).items():
        if alias in given:   # the alias is set last: it wins
            given[name] = given.pop(alias)
    v = dict(HF_DEFAULTS[mt], **given)
    _derive(mt, v, d)
    return types.SimpleNamespace(**v)


def _qwen2_window(hf_config):
    """Qwen2 windows only layers >= max_window_layers (HF
    configuration_qwen2.py): accept the two shapes that map onto one
    global window and refuse the mixed one."""
    if not getattr(hf_config, "use_sliding_window", False):
        return None
    mwl = getattr(hf_config, "max_window_layers", 0) or 0
    if mwl > 0 and mwl < hf_config.num_hidden_layers:
        raise NotImplementedError(
            f"qwen2 with use_sliding_window and 0 < max_window_layers="
            f"{mwl} < num_layers={hf_config.num_hidden_layers}: mixed "
            "full/windowed layers are not supported")
    if mwl >= hf_config.num_hidden_layers:
        return None                       # every layer is full-attention
    return hf_config.sliding_window       # every layer is windowed


def _yarn_params(rs: dict, dim: int, base: float, max_pos: int):
    """Yarn NTK-by-part rope scaling (HF _compute_yarn_parameters):
    (inv_freq tuple [dim/2], attention_factor, mscale_all_dim scale)."""
    factor = float(rs["factor"])
    beta_fast = float(rs.get("beta_fast") or 32)
    beta_slow = float(rs.get("beta_slow") or 1)
    orig = int(rs.get("original_max_position_embeddings") or max_pos)
    mscale = rs.get("mscale")
    mscale_all = rs.get("mscale_all_dim")

    def get_mscale(scale, m=1.0):
        return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

    attn_factor = rs.get("attention_factor")
    if attn_factor is None:
        if mscale and mscale_all:
            attn_factor = get_mscale(factor, mscale) / get_mscale(
                factor, mscale_all)
        else:
            attn_factor = get_mscale(factor)

    def corr_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))
                ) / (2 * math.log(base))
    low, high = corr_dim(beta_fast), corr_dim(beta_slow)
    if rs.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    ramp = np.clip((np.arange(dim // 2, dtype=np.float64) - low)
                   / max(high - low, 1e-3), 0.0, 1.0)
    pos_freqs = base ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    inv_freq = (1.0 / (factor * pos_freqs)) * ramp \
        + (1.0 / pos_freqs) * (1.0 - ramp)
    score_scale = get_mscale(factor, float(mscale_all or 0.0)) \
        if mscale_all else 1.0
    return tuple(float(f) for f in inv_freq), float(attn_factor), \
        float(score_scale)


def _rope_scaling_params(hf_config, dim: int, what: str):
    """An HF ``rope_scaling`` dict as (inv_freq tuple | None,
    attention_factor, score_scale) for cfg.rope_inv_freq /
    cfg.rope_attn_factor: yarn, llama3, linear, longrope and default;
    any other kind is refused."""
    rs = getattr(hf_config, "rope_scaling", None)
    if not rs:
        return None, 1.0, 1.0
    kind = rs.get("rope_type", rs.get("type"))
    base = float(getattr(hf_config, "rope_theta", 10000.0))
    if kind == "yarn":
        return _yarn_params(rs, dim, base,
                            hf_config.max_position_embeddings)
    pos_freqs = base ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    inv_freq = 1.0 / pos_freqs
    if kind in (None, "default"):
        return None, 1.0, 1.0
    if kind == "linear":
        return tuple(float(f) for f in inv_freq / float(rs["factor"])), \
            1.0, 1.0
    if kind == "longrope":
        # one static regime: the long factors when max_position_embeddings
        # was extended past the original, the short ones otherwise
        orig = getattr(hf_config, "original_max_position_embeddings",
                       None)
        if orig:
            factor = hf_config.max_position_embeddings / orig
            extended = hf_config.max_position_embeddings > orig
        else:
            orig = hf_config.max_position_embeddings
            factor = float(rs.get("factor") or 1.0)
            extended = False
        ext = np.asarray(rs["long_factor" if extended else "short_factor"],
                         np.float64)
        if ext.shape != (dim // 2,):
            raise NotImplementedError(
                f"longrope factor set has {ext.shape[0]} entries for "
                f"rotary dim {dim}")
        attn_factor = rs.get("attention_factor")
        if attn_factor is None:
            attn_factor = (1.0 if factor <= 1.0
                           else math.sqrt(1 + math.log(factor)
                                          / math.log(orig)))
        return tuple(float(v) for v in 1.0 / (ext * pos_freqs)), \
            float(attn_factor), 1.0
    if kind == "llama3":
        factor = float(rs["factor"])
        lo_f = float(rs["low_freq_factor"])
        hi_f = float(rs["high_freq_factor"])
        old = float(rs.get("original_max_position_embeddings")
                    or hf_config.max_position_embeddings)
        wavelen = 2 * math.pi / inv_freq
        scaled = np.where(wavelen > old / lo_f, inv_freq / factor, inv_freq)
        smooth = (old / wavelen - lo_f) / (hi_f - lo_f)
        smoothed = (1 - smooth) * scaled / factor + smooth * scaled
        medium = ~(wavelen < old / hi_f) & ~(wavelen > old / lo_f)
        out = np.where(medium, smoothed, scaled)
        return tuple(float(f) for f in out), 1.0, 1.0
    raise NotImplementedError(
        f"{what} rope_scaling type {kind!r} — yarn, llama3, linear and "
        "longrope convert")


def _layer_windows_from_hf(hf_config, require_use_flag: bool = False):
    """Per-layer windows from an HF ``layer_types`` list: (sliding_window,
    attn_windows, kinds) for the ModelConfig kwargs: a uniform window
    stays the static ``sliding_window``, a mixed one becomes the
    per-layer tuple. ``require_use_flag``: gate on use_sliding_window
    (smollm3) instead of sliding_window's presence alone."""
    kinds = list(getattr(hf_config, "layer_types", None) or [])
    win = getattr(hf_config, "sliding_window", None)
    enabled = (bool(getattr(hf_config, "use_sliding_window", win))
               if require_use_flag else win is not None)
    wins = tuple(win if (enabled and t == "sliding_attention") else None
                 for t in kinds)
    windowed = any(w is not None for w in wins)
    uniform = not windowed or len(set(wins)) == 1
    return ((wins[0] if windowed and uniform else None),
            (None if uniform else wins), kinds)


# HF hidden_act -> the model's activation kinds ("gelu" is the erf form)
_HF_ACT = {"gelu": "gelu_exact", "gelu_new": "gelu",
           "gelu_pytorch_tanh": "gelu", "silu": "silu", "relu": "relu",
           "relu2": "relu2"}


def _act_from_hf(name: str) -> str:
    if name not in _HF_ACT:
        raise NotImplementedError(f"unsupported hidden_act {name!r}")
    return _HF_ACT[name]


def config_from_hf(d: dict, name: Optional[str] = None) -> ModelConfig:
    """The ModelConfig of an HF ``config.json`` dict, as the JAX
    ``config_from_hf`` gives it for the ``transformers`` config object
    built from the same file. ``name`` stands in for the object's
    ``name_or_path`` (``from_pretrained`` sets the directory)."""
    hf = hf_view(d)
    mt = hf.model_type
    name = name or mt
    if mt == "gpt2":
        return ModelConfig(
            name=name, family="gpt2", vocab_size=hf.vocab_size,
            hidden_size=hf.n_embd,
            intermediate_size=hf.n_inner or 4 * hf.n_embd,
            num_layers=hf.n_layer, num_heads=hf.n_head,
            num_kv_heads=hf.n_head, head_dim=hf.n_embd // hf.n_head,
            max_position_embeddings=hf.n_positions,
            norm_type="layernorm", norm_eps=hf.layer_norm_epsilon,
            activation="gelu", gated_mlp=False, position_embedding="learned",
            attn_bias=True, mlp_bias=True, tie_word_embeddings=True)
    if mt == "opt":
        proj = hf.word_embed_proj_dim
        if proj is None:   # OPTConfig: word_embed_proj_dim or hidden_size
            proj = hf.hidden_size
        return ModelConfig(
            embed_proj_dim=proj if proj != hf.hidden_size else None,
            post_norm=not hf.do_layer_norm_before,
            name=name, family="opt", vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size, intermediate_size=hf.ffn_dim,
            num_layers=hf.num_hidden_layers,
            num_heads=hf.num_attention_heads,
            num_kv_heads=hf.num_attention_heads,
            head_dim=hf.hidden_size // hf.num_attention_heads,
            max_position_embeddings=hf.max_position_embeddings,
            norm_type="layernorm", activation="relu", gated_mlp=False,
            position_embedding="learned", attn_bias=True, mlp_bias=True,
            tie_word_embeddings=True)
    if mt in ("llama", "mistral", "mixtral", "qwen2", "gemma"):
        head_dim = (getattr(hf, "head_dim", None)
                    or hf.hidden_size // hf.num_attention_heads)
        inv_freq, attn_factor, _ = _rope_scaling_params(hf, head_dim, mt)
        return ModelConfig(
            rope_inv_freq=inv_freq, rope_attn_factor=attn_factor,
            name=name, family="llama", vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            intermediate_size=hf.intermediate_size,
            num_layers=hf.num_hidden_layers,
            num_heads=hf.num_attention_heads,
            num_kv_heads=getattr(hf, "num_key_value_heads",
                                 hf.num_attention_heads),
            head_dim=head_dim,
            max_position_embeddings=hf.max_position_embeddings,
            norm_type="rmsnorm", norm_eps=hf.rms_norm_eps,
            activation="gelu" if mt == "gemma" else "silu",
            gated_mlp=True, position_embedding="rope",
            rope_theta=getattr(hf, "rope_theta", 10000.0),
            attn_bias=(True if mt == "qwen2"
                       else getattr(hf, "attention_bias", False)),
            o_bias=False if mt == "qwen2" else None,
            mlp_bias=getattr(hf, "mlp_bias", False),
            tie_word_embeddings=getattr(hf, "tie_word_embeddings",
                                        mt == "gemma"),
            sliding_window=_qwen2_window(hf) if mt == "qwen2"
            else getattr(hf, "sliding_window", None),
            num_experts=(getattr(hf, "num_local_experts", 0)
                         if mt == "mixtral" else 0),
            num_experts_per_tok=getattr(hf, "num_experts_per_tok", 2),
            embed_scale=(hf.hidden_size ** 0.5 if mt == "gemma" else None),
            norm_offset=mt == "gemma")
    if mt == "gpt_neox":
        return ModelConfig(
            name=name, family="gpt-neox", vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            intermediate_size=hf.intermediate_size,
            num_layers=hf.num_hidden_layers,
            num_heads=hf.num_attention_heads,
            num_kv_heads=hf.num_attention_heads,
            head_dim=hf.hidden_size // hf.num_attention_heads,
            max_position_embeddings=hf.max_position_embeddings,
            norm_type="layernorm", norm_eps=hf.layer_norm_eps,
            activation=_act_from_hf(hf.hidden_act),
            gated_mlp=False, position_embedding="rope",
            rope_theta=getattr(hf, "rotary_emb_base", None)
            or getattr(hf, "rope_theta", 10000.0),
            rope_pct=getattr(hf, "rotary_pct", 1.0),
            attn_bias=getattr(hf, "attention_bias", True),
            mlp_bias=True,
            tie_word_embeddings=getattr(hf, "tie_word_embeddings", False),
            parallel_residual=getattr(hf, "use_parallel_residual", True))
    if mt == "phi":
        if getattr(hf, "qk_layernorm", False):
            raise NotImplementedError("phi with qk_layernorm")
        heads = hf.num_attention_heads
        return ModelConfig(
            name=name, family="phi", vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            intermediate_size=hf.intermediate_size,
            num_layers=hf.num_hidden_layers, num_heads=heads,
            num_kv_heads=getattr(hf, "num_key_value_heads", None) or heads,
            head_dim=hf.hidden_size // heads,
            max_position_embeddings=hf.max_position_embeddings,
            norm_type="layernorm", norm_eps=hf.layer_norm_eps,
            activation=_act_from_hf(hf.hidden_act),
            gated_mlp=False, position_embedding="rope",
            rope_theta=getattr(hf, "rope_theta", 10000.0),
            rope_pct=getattr(hf, "partial_rotary_factor", 0.5),
            attn_bias=True, mlp_bias=True, lm_head_bias=True,
            tie_word_embeddings=getattr(hf, "tie_word_embeddings", False),
            parallel_residual=True, shared_attn_mlp_norm=True)
    if mt == "falcon":
        new_arch = getattr(hf, "new_decoder_architecture", False)
        parallel = getattr(hf, "parallel_attn", True)
        alibi = getattr(hf, "alibi", False)
        if new_arch and getattr(hf, "num_ln_in_parallel_attn", None) == 1:
            raise NotImplementedError("falcon new-arch with a single "
                                      "parallel layernorm")
        heads = hf.num_attention_heads
        if new_arch:
            kv = getattr(hf, "num_kv_heads", None) or heads
        else:
            kv = 1 if getattr(hf, "multi_query", True) else heads
        bias = getattr(hf, "bias", False)
        return ModelConfig(
            name=name, family="falcon", vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            intermediate_size=getattr(hf, "ffn_hidden_size", None)
            or 4 * hf.hidden_size,
            num_layers=hf.num_hidden_layers, num_heads=heads,
            num_kv_heads=kv, head_dim=hf.hidden_size // heads,
            max_position_embeddings=getattr(hf, "max_position_embeddings",
                                            2048),
            norm_type="layernorm",
            norm_eps=getattr(hf, "layer_norm_epsilon", 1e-5),
            activation=_act_from_hf(getattr(hf, "activation", "gelu")),
            gated_mlp=False,
            position_embedding="alibi" if alibi else "rope",
            alibi_scale=(hf.hidden_size // heads) ** -0.5 if alibi else 1.0,
            rope_theta=getattr(hf, "rope_theta", 10000.0),
            attn_bias=bias, mlp_bias=bias,
            tie_word_embeddings=getattr(hf, "tie_word_embeddings", True),
            parallel_residual=parallel,
            shared_attn_mlp_norm=parallel and not new_arch)
    if mt == "bloom":
        heads = hf.n_head
        return ModelConfig(
            name=name, family="bloom", vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            intermediate_size=4 * hf.hidden_size,
            num_layers=hf.n_layer, num_heads=heads, num_kv_heads=heads,
            head_dim=hf.hidden_size // heads,
            max_position_embeddings=getattr(hf, "seq_length", None) or 2048,
            norm_type="layernorm", norm_eps=hf.layer_norm_epsilon,
            activation="gelu", gated_mlp=False,
            position_embedding="alibi", embed_norm=True,
            attn_bias=True, mlp_bias=True,
            tie_word_embeddings=getattr(hf, "tie_word_embeddings", True))
    if mt in ("gptj", "codegen"):
        heads = hf.n_head
        hd = hf.n_embd // heads
        if mt == "codegen" and heads % 4:
            raise NotImplementedError(
                "codegen with n_head not divisible by mp_num=4 (HF "
                "CodeGenAttention hard-codes 4 TP blocks in the fused "
                "QKV layout)")
        return ModelConfig(
            name=name, family=mt, vocab_size=hf.vocab_size,
            hidden_size=hf.n_embd,
            intermediate_size=getattr(hf, "n_inner", None) or 4 * hf.n_embd,
            num_layers=hf.n_layer, num_heads=heads,
            num_kv_heads=heads, head_dim=hd,
            max_position_embeddings=hf.n_positions,
            norm_type="layernorm", norm_eps=hf.layer_norm_epsilon,
            activation=_act_from_hf(hf.activation_function),
            gated_mlp=False, position_embedding="rope", rope_theta=10000.0,
            rope_pct=(getattr(hf, "rotary_dim", None) or hd) / hd,
            rope_interleaved=True,
            attn_bias=False, o_bias=False, mlp_bias=True, lm_head_bias=True,
            tie_word_embeddings=getattr(hf, "tie_word_embeddings", False),
            parallel_residual=True, shared_attn_mlp_norm=True)
    if mt == "mpt":
        ac = hf.attn_config
        if not ac.get("alibi", True):
            raise NotImplementedError("mpt without alibi positions")
        if ac.get("clip_qkv") or ac.get("qk_ln", False):
            raise NotImplementedError("mpt with clip_qkv/qk_ln")
        if ac.get("softmax_scale") is not None:
            raise NotImplementedError(
                "mpt with a custom attn softmax_scale (the runtime always "
                "uses 1/sqrt(head_dim))")
        if ac.get("alibi_bias_max", 8) != 8:
            raise NotImplementedError("mpt with alibi_bias_max != 8")
        heads = hf.n_heads
        if heads & (heads - 1):
            raise NotImplementedError(
                "mpt with non-power-of-two heads: its alibi slope "
                "interpolation differs from the BLOOM convention")
        D = hf.d_model
        bias = not getattr(hf, "no_bias", True)
        return ModelConfig(
            name=name, family="mpt", vocab_size=hf.vocab_size,
            hidden_size=D, intermediate_size=int(hf.expansion_ratio * D),
            num_layers=hf.n_layers, num_heads=heads,
            # MptAttentionConfig keeps no kv_n_heads: always the heads
            num_kv_heads=heads, head_dim=D // heads,
            max_position_embeddings=hf.max_seq_len,
            norm_type="layernorm", norm_eps=1e-5,
            activation="gelu_exact", gated_mlp=False,
            position_embedding="alibi", attn_bias=bias, mlp_bias=bias,
            tie_word_embeddings=True)
    if mt == "gpt_bigcode":
        heads = hf.n_head
        return ModelConfig(
            name=name, family="gpt_bigcode", vocab_size=hf.vocab_size,
            hidden_size=hf.n_embd,
            intermediate_size=getattr(hf, "n_inner", None) or 4 * hf.n_embd,
            num_layers=hf.n_layer, num_heads=heads,
            num_kv_heads=1 if getattr(hf, "multi_query", True) else heads,
            head_dim=hf.n_embd // heads,
            max_position_embeddings=hf.n_positions,
            norm_type="layernorm", norm_eps=hf.layer_norm_epsilon,
            activation=_act_from_hf(getattr(hf, "activation_function",
                                            "gelu_pytorch_tanh")),
            gated_mlp=False, position_embedding="learned",
            attn_bias=True, mlp_bias=True,
            tie_word_embeddings=getattr(hf, "tie_word_embeddings", True))
    if mt == "stablelm":
        if getattr(hf, "use_parallel_residual", False):
            raise NotImplementedError("stablelm with use_parallel_residual")
        if getattr(hf, "qk_layernorm", False):
            raise NotImplementedError("stablelm with qk_layernorm")
        heads = hf.num_attention_heads
        return ModelConfig(
            name=name, family="stablelm", vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            intermediate_size=hf.intermediate_size,
            num_layers=hf.num_hidden_layers, num_heads=heads,
            num_kv_heads=getattr(hf, "num_key_value_heads", None) or heads,
            head_dim=hf.hidden_size // heads,
            max_position_embeddings=hf.max_position_embeddings,
            norm_type="layernorm",
            norm_eps=getattr(hf, "layer_norm_eps", 1e-5),
            activation=_act_from_hf(getattr(hf, "hidden_act", "silu")),
            gated_mlp=True, position_embedding="rope",
            rope_theta=getattr(hf, "rope_theta", 10000.0),
            rope_pct=getattr(hf, "partial_rotary_factor", 0.25),
            attn_bias=getattr(hf, "use_qkv_bias", False),
            o_bias=False, mlp_bias=False,
            tie_word_embeddings=getattr(hf, "tie_word_embeddings", False))
    if mt == "starcoder2":
        heads = hf.num_attention_heads
        bias = getattr(hf, "use_bias", True)
        return ModelConfig(
            name=name, family="starcoder2", vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            intermediate_size=hf.intermediate_size,
            num_layers=hf.num_hidden_layers, num_heads=heads,
            num_kv_heads=getattr(hf, "num_key_value_heads", None) or heads,
            head_dim=hf.hidden_size // heads,
            max_position_embeddings=hf.max_position_embeddings,
            norm_type="layernorm",
            norm_eps=getattr(hf, "norm_epsilon", 1e-5),
            activation=_act_from_hf(getattr(hf, "hidden_act",
                                            "gelu_pytorch_tanh")),
            gated_mlp=False, position_embedding="rope",
            rope_theta=getattr(hf, "rope_theta", 10000.0),
            attn_bias=bias, mlp_bias=bias,
            sliding_window=getattr(hf, "sliding_window", None),
            tie_word_embeddings=getattr(hf, "tie_word_embeddings", True))
    if mt == "olmo":
        if getattr(hf, "clip_qkv", None):
            raise NotImplementedError(
                "olmo with clip_qkv (the runtime applies no QKV "
                "activation clamp)")
        heads = hf.num_attention_heads
        return ModelConfig(
            name=name, family="olmo", vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            intermediate_size=hf.intermediate_size,
            num_layers=hf.num_hidden_layers, num_heads=heads,
            num_kv_heads=getattr(hf, "num_key_value_heads", None) or heads,
            head_dim=hf.hidden_size // heads,
            max_position_embeddings=hf.max_position_embeddings,
            # HF OlmoLayerNorm: F.layer_norm with no affine, eps 1e-5
            norm_type="layernorm", norm_eps=1e-5,
            activation=_act_from_hf(getattr(hf, "hidden_act", "silu")),
            gated_mlp=True, position_embedding="rope",
            rope_theta=getattr(hf, "rope_theta", 10000.0),
            attn_bias=getattr(hf, "attention_bias", False),
            mlp_bias=False,
            tie_word_embeddings=getattr(hf, "tie_word_embeddings", False))
    if mt == "phi3":
        heads = hf.num_attention_heads
        inv_freq, attn_factor, _ = _rope_scaling_params(
            hf, int((hf.hidden_size // heads)
                    * getattr(hf, "partial_rotary_factor", 1.0)), mt)
        return ModelConfig(
            name=name, family="phi3", vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            intermediate_size=hf.intermediate_size,
            num_layers=hf.num_hidden_layers, num_heads=heads,
            num_kv_heads=getattr(hf, "num_key_value_heads", None) or heads,
            head_dim=hf.hidden_size // heads,
            max_position_embeddings=hf.max_position_embeddings,
            norm_type="rmsnorm", norm_eps=hf.rms_norm_eps,
            activation=_act_from_hf(getattr(hf, "hidden_act", "silu")),
            gated_mlp=True, position_embedding="rope",
            rope_theta=getattr(hf, "rope_theta", 10000.0),
            rope_inv_freq=inv_freq, rope_attn_factor=attn_factor,
            rope_pct=float(getattr(hf, "partial_rotary_factor", 1.0)),
            attn_bias=False, mlp_bias=False,
            sliding_window=getattr(hf, "sliding_window", None),
            tie_word_embeddings=getattr(hf, "tie_word_embeddings", False))
    if mt == "ernie4_5":
        b = bool(getattr(hf, "use_bias", False))
        return ModelConfig(
            name=name, family="llama", vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            intermediate_size=hf.intermediate_size,
            num_layers=hf.num_hidden_layers,
            num_heads=hf.num_attention_heads,
            num_kv_heads=getattr(hf, "num_key_value_heads", None)
            or hf.num_attention_heads,
            head_dim=getattr(hf, "head_dim", None)
            or hf.hidden_size // hf.num_attention_heads,
            max_position_embeddings=hf.max_position_embeddings,
            norm_type="rmsnorm", norm_eps=hf.rms_norm_eps,
            activation=_act_from_hf(hf.hidden_act),
            gated_mlp=True, position_embedding="rope",
            rope_theta=getattr(hf, "rope_theta", 10000.0),
            attn_bias=b, o_bias=b, mlp_bias=b,
            tie_word_embeddings=getattr(hf, "tie_word_embeddings", True))
    if mt in _LATER:
        return _LATER[mt](hf, mt, name)
    # glm, glm4
    return ModelConfig(
        name=name, family="glm", vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size, intermediate_size=hf.intermediate_size,
        num_layers=hf.num_hidden_layers, num_heads=hf.num_attention_heads,
        num_kv_heads=getattr(hf, "num_key_value_heads", None)
        or hf.num_attention_heads,
        head_dim=getattr(hf, "head_dim", None)
        or hf.hidden_size // hf.num_attention_heads,
        max_position_embeddings=hf.max_position_embeddings,
        norm_type="rmsnorm", norm_eps=hf.rms_norm_eps,
        activation=_act_from_hf(hf.hidden_act),
        gated_mlp=True, position_embedding="rope",
        rope_theta=getattr(hf, "rope_theta", 10000.0),
        rope_pct=float(getattr(hf, "partial_rotary_factor", 0.5)),
        rope_interleaved=True,
        attn_bias=bool(getattr(hf, "attention_bias", True)),
        o_bias=False, mlp_bias=False, post_block_norms=mt == "glm4",
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", False))


def _heads_kv_hd(hf):
    """(heads, kv heads, head_dim) as the llama-shaped branches read
    them: kv heads and head_dim from their keys, else the heads and
    hidden/heads."""
    heads = hf.num_attention_heads
    return (heads, getattr(hf, "num_key_value_heads", None) or heads,
            getattr(hf, "head_dim", None) or hf.hidden_size // heads)


def _llama_shaped(hf, name, **kw):
    """The common fields of the rmsnorm, gated-silu-shaped later branches
    (qwen3, smollm3, hunyuan_v1_dense, exaone4, granite, olmo2); ``kw``
    adds or overrides."""
    heads, kv, hd = _heads_kv_hd(hf)
    fields = dict(
        name=name, family="llama", vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size, intermediate_size=hf.intermediate_size,
        num_layers=hf.num_hidden_layers, num_heads=heads, num_kv_heads=kv,
        head_dim=hd, max_position_embeddings=hf.max_position_embeddings,
        norm_type="rmsnorm", norm_eps=hf.rms_norm_eps,
        activation=_act_from_hf(hf.hidden_act), gated_mlp=True,
        position_embedding="rope",
        rope_theta=getattr(hf, "rope_theta", 10000.0),
        attn_bias=getattr(hf, "attention_bias", False), mlp_bias=False,
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", False))
    fields.update(kw)
    return ModelConfig(**fields)


def _gpt_neo_config(hf, mt, name):
    kinds = list(hf.attention_layers)
    if not all(t in ("global", "local") for t in kinds):
        raise NotImplementedError(
            f"gpt_neo attention_types {sorted(set(kinds))!r} — only "
            "global/local convert")
    win = int(getattr(hf, "window_size", 256))
    wins = tuple(None if t == "global" else win for t in kinds)
    uniform = len(set(wins)) == 1
    heads = hf.num_heads
    return ModelConfig(
        name=name, family="gpt_neo", vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size,
        intermediate_size=getattr(hf, "intermediate_size", None)
        or 4 * hf.hidden_size,
        num_layers=hf.num_layers, num_heads=heads, num_kv_heads=heads,
        head_dim=hf.hidden_size // heads,
        max_position_embeddings=hf.max_position_embeddings,
        norm_type="layernorm", norm_eps=hf.layer_norm_epsilon,
        activation=_act_from_hf(getattr(hf, "activation_function",
                                        "gelu_new")),
        gated_mlp=False, position_embedding="learned",
        attn_bias=False, o_bias=True, mlp_bias=True,
        sliding_window=wins[0] if uniform else None,
        attn_windows=None if uniform else wins,
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", True))


def _gemma2_config(hf, mt, name):
    heads = hf.num_attention_heads
    kinds = list(getattr(hf, "layer_types", None)
                 or ["sliding_attention" if i % 2 == 0 else "full_attention"
                     for i in range(hf.num_hidden_layers)])
    if not all(t in ("sliding_attention", "full_attention") for t in kinds):
        raise NotImplementedError(f"gemma2 layer_types "
                                  f"{sorted(set(kinds))!r}")
    win = getattr(hf, "sliding_window", None)
    wins = tuple(win if t == "sliding_attention" else None for t in kinds)
    uniform = win is None or len(set(wins)) == 1
    hd = getattr(hf, "head_dim", None) or hf.hidden_size // heads
    return ModelConfig(
        name=name, family="gemma2", vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size, intermediate_size=hf.intermediate_size,
        num_layers=hf.num_hidden_layers, num_heads=heads,
        num_kv_heads=getattr(hf, "num_key_value_heads", None) or heads,
        head_dim=hd, max_position_embeddings=hf.max_position_embeddings,
        norm_type="rmsnorm", norm_eps=hf.rms_norm_eps,
        activation=_act_from_hf(getattr(hf, "hidden_activation",
                                        "gelu_pytorch_tanh")),
        gated_mlp=True, position_embedding="rope",
        rope_theta=getattr(hf, "rope_theta", 10000.0),
        attn_bias=getattr(hf, "attention_bias", False), mlp_bias=False,
        sliding_window=wins[0] if uniform else None,
        attn_windows=None if uniform else wins,
        attn_softcap=getattr(hf, "attn_logit_softcapping", None),
        logit_softcap=getattr(hf, "final_logit_softcapping", None),
        post_block_norms=True,
        query_pre_attn_scalar=float(
            getattr(hf, "query_pre_attn_scalar", None) or hd),
        embed_scale=hf.hidden_size ** 0.5, norm_offset=True,
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", True))


def _cohere_config(hf, mt, name):
    heads = hf.num_attention_heads
    return ModelConfig(
        name=name, family="cohere", vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size, intermediate_size=hf.intermediate_size,
        num_layers=hf.num_hidden_layers, num_heads=heads,
        num_kv_heads=getattr(hf, "num_key_value_heads", None) or heads,
        head_dim=hf.hidden_size // heads,
        max_position_embeddings=hf.max_position_embeddings,
        norm_type="layernorm", norm_eps=getattr(hf, "layer_norm_eps", 1e-5),
        activation=_act_from_hf(getattr(hf, "hidden_act", "silu")),
        gated_mlp=True, position_embedding="rope",
        rope_theta=getattr(hf, "rope_theta", 10000.0),
        rope_interleaved=True,
        attn_bias=getattr(hf, "attention_bias", False), mlp_bias=False,
        logit_scale=getattr(hf, "logit_scale", None),
        qk_norm="ln_head" if getattr(hf, "use_qk_norm", False) else None,
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", True),
        parallel_residual=True, shared_attn_mlp_norm=True)


def _qwen3_config(hf, mt, name):
    """qwen3 and qwen3_moe (the JAX branch :788): the MoE type is
    mixtral-shaped, its experts ``moe_intermediate_size`` wide, refused
    with dense ``mlp_only_layers`` or a ``decoder_sparse_step`` past 1."""
    sw, aw, _ = _layer_windows_from_hf(hf)
    heads, _, hd = _heads_kv_hd(hf)
    inv_freq, attn_factor, _ = _rope_scaling_params(hf, hd, mt)
    num_experts, extra = 0, {}
    if mt == "qwen3_moe":
        num_experts = hf.num_experts
        if list(getattr(hf, "mlp_only_layers", []) or []):
            raise NotImplementedError("qwen3_moe with mlp_only_layers")
        if getattr(hf, "decoder_sparse_step", 1) != 1:
            raise NotImplementedError(
                "qwen3_moe with decoder_sparse_step != 1")
        extra["intermediate_size"] = hf.moe_intermediate_size
    return _llama_shaped(
        hf, name, rope_inv_freq=inv_freq, rope_attn_factor=attn_factor,
        qk_norm="rms_head", sliding_window=sw, attn_windows=aw,
        num_experts=num_experts,
        num_experts_per_tok=getattr(hf, "num_experts_per_tok", 2),
        moe_norm_topk=bool(getattr(hf, "norm_topk_prob", True)), **extra)


def _smollm3_config(hf, mt, name):
    sw, aw, _ = _layer_windows_from_hf(hf, require_use_flag=True)
    nope = tuple(int(v) for v in getattr(hf, "no_rope_layers", None) or [])
    return _llama_shaped(
        hf, name, attn_bias=bool(getattr(hf, "attention_bias", False)),
        mlp_bias=bool(getattr(hf, "mlp_bias", False)),
        sliding_window=sw, attn_windows=aw,
        rope_layers=nope if nope and not all(nope) else None,
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", True))


def _hunyuan_config(hf, mt, name):
    return _llama_shaped(
        hf, name, attn_bias=bool(getattr(hf, "attention_bias", False)),
        qk_norm="rms_head", qk_norm_after_rope=True)


def _exaone4_config(hf, mt, name):
    sw, aw, kinds = _layer_windows_from_hf(hf)
    windowed = sw is not None or aw is not None
    return _llama_shaped(
        hf, name, family="olmo2", attn_bias=False, qk_norm="rms_head",
        sublayer_postnorm_only=True, sliding_window=sw, attn_windows=aw,
        rope_layers=(tuple(1 if t == "sliding_attention" else 0
                           for t in kinds) if windowed else None))


def _granite_config(hf, mt, name):
    am = float(getattr(hf, "attention_multiplier", 1.0))
    ls = float(getattr(hf, "logits_scaling", 1.0))
    return _llama_shaped(
        hf, name, head_dim=hf.hidden_size // hf.num_attention_heads,
        mlp_bias=getattr(hf, "mlp_bias", False),
        embed_scale=float(getattr(hf, "embedding_multiplier", 1.0)),
        query_pre_attn_scalar=am ** -2,
        residual_scale=float(getattr(hf, "residual_multiplier", 1.0)),
        logit_scale=1.0 / ls)


def _olmo2_config(hf, mt, name):
    return _llama_shaped(
        hf, name, family="olmo2",
        head_dim=hf.hidden_size // hf.num_attention_heads,
        qk_norm="rms_full", sublayer_postnorm_only=True)


def _nemotron_config(hf, mt, name):
    heads, kv, hd = _heads_kv_hd(hf)
    return ModelConfig(
        name=name, family="nemotron", vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size, intermediate_size=hf.intermediate_size,
        num_layers=hf.num_hidden_layers, num_heads=heads, num_kv_heads=kv,
        head_dim=hd, max_position_embeddings=hf.max_position_embeddings,
        norm_type="layernorm", norm_eps=getattr(hf, "norm_eps", 1e-5),
        activation=_act_from_hf(hf.hidden_act), gated_mlp=False,
        position_embedding="rope",
        rope_theta=getattr(hf, "rope_theta", 10000.0),
        rope_pct=float(getattr(hf, "partial_rotary_factor", 0.5)),
        attn_bias=bool(getattr(hf, "attention_bias", False)),
        mlp_bias=bool(getattr(hf, "mlp_bias", False)), norm_offset=True,
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", False))


def _gpt_oss_config(hf, mt, name):
    """gpt-oss (the JAX branch :942): llama-shaped attention with biases,
    yarn RoPE and alternating windows, per-head sinks, and experts with
    biases behind the topk_softmax router, through the clamped swish
    GLU."""
    heads = hf.num_attention_heads
    hd = getattr(hf, "head_dim", None) or hf.hidden_size // heads
    inv_freq, attn_factor, _ = _rope_scaling_params(hf, hd, mt)
    sw, aw, _ = _layer_windows_from_hf(hf)
    return ModelConfig(
        name=name, family="gpt_oss", vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size, intermediate_size=hf.intermediate_size,
        num_layers=hf.num_hidden_layers, num_heads=heads,
        num_kv_heads=getattr(hf, "num_key_value_heads", None) or heads,
        head_dim=hd, max_position_embeddings=hf.max_position_embeddings,
        norm_type="rmsnorm", norm_eps=hf.rms_norm_eps, activation="silu",
        gated_mlp=True, position_embedding="rope",
        rope_theta=getattr(hf, "rope_theta", 150000.0),
        rope_inv_freq=inv_freq, rope_attn_factor=attn_factor,
        attn_bias=bool(getattr(hf, "attention_bias", True)), mlp_bias=True,
        sliding_window=sw, attn_windows=aw, attn_sinks=True,
        num_experts=hf.num_local_experts,
        num_experts_per_tok=getattr(hf, "num_experts_per_tok", 4),
        moe_router="topk_softmax",
        moe_swiglu_limit=float(getattr(hf, "swiglu_limit", 7.0)),
        moe_swiglu_alpha=1.702,
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", False))


def _hunyuan_moe_config(hf, mt, name):
    """hunyuan_v1_moe (the JAX branch :985): the dense hunyuan layout with
    the softmax router and one shared expert of the same width; per-layer
    expert lists are refused."""
    ne, tk = hf.num_experts, getattr(hf, "moe_topk", 1)
    if not isinstance(ne, int) or not isinstance(tk, int):
        raise NotImplementedError(
            "hunyuan_v1_moe with per-layer num_experts/moe_topk lists")
    return _llama_shaped(
        hf, name, attn_bias=bool(getattr(hf, "attention_bias", False)),
        qk_norm="rms_head", qk_norm_after_rope=True, num_experts=ne,
        num_experts_per_tok=tk, moe_shared_experts=1)


def _ernie_moe_config(hf, mt, name):
    """ernie4_5_moe (the JAX branch :1018): softmax scores under the
    bias-corrected selection (the "ernie" router), shared experts and a
    dense prefix (``moe_layer_start_index``); interleaved MoE layers and
    an early MoE end are refused."""
    L = hf.num_hidden_layers
    if getattr(hf, "moe_layer_interval", 1) != 1:
        raise NotImplementedError("ernie4_5_moe with moe_layer_interval != 1")
    if getattr(hf, "moe_layer_end_index", L - 1) not in (-1, L - 1):
        raise NotImplementedError(
            "ernie4_5_moe with moe_layer_end_index before the last layer")
    fk = getattr(hf, "moe_layer_start_index", 0) or 0
    mixed = 0 < fk < L
    b = bool(getattr(hf, "use_bias", False))
    return _llama_shaped(
        hf, name, intermediate_size=hf.moe_intermediate_size,
        attn_bias=b, o_bias=b, mlp_bias=b,
        num_experts=hf.moe_num_experts,
        num_experts_per_tok=getattr(hf, "moe_k", 2), moe_router="ernie",
        moe_shared_experts=getattr(hf, "moe_num_shared_experts", 0) or 0,
        dense_prefix_layers=fk if mixed else 0,
        dense_intermediate_size=hf.intermediate_size if mixed else None,
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", True))


def _deepseek_routing(hf, all_dense: bool, mixed: bool, fk: int) -> dict:
    """The deepseek_v3 router's fields, shared experts and dense prefix of
    glm4_moe and deepseek_v3 (``first_k_dense_replace``: every layer
    dense at or past L, a dense prefix below)."""
    E = 0 if all_dense else hf.n_routed_experts
    return dict(
        num_experts=E,
        num_experts_per_tok=getattr(hf, "num_experts_per_tok", 8),
        moe_router="deepseek_v3" if E else "softmax",
        moe_n_group=getattr(hf, "n_group", 1) or 1,
        moe_topk_group=getattr(hf, "topk_group", 1) or 1,
        moe_routed_scale=float(getattr(hf, "routed_scaling_factor", 1.0)),
        moe_norm_topk=bool(getattr(hf, "norm_topk_prob", True)),
        moe_shared_experts=(getattr(hf, "n_shared_experts", 0) or 0)
        if E else 0,
        dense_prefix_layers=fk if mixed else 0,
        dense_intermediate_size=hf.intermediate_size if mixed else None,
        intermediate_size=(hf.intermediate_size if all_dense
                           else hf.moe_intermediate_size))


def _glm4_moe_config(hf, mt, name):
    """glm4_moe (the JAX branch :1064): the llama block with optional
    per-head q/k norms and partial rotary, deepseek_v3 routing, shared
    experts and a dense prefix."""
    L = hf.num_hidden_layers
    fk = getattr(hf, "first_k_dense_replace", 0) or 0
    heads, _, hd = _heads_kv_hd(hf)
    pct = float(getattr(hf, "partial_rotary_factor", 1.0))
    inv_freq, attn_factor, _ = _rope_scaling_params(hf, int(hd * pct), mt)
    return _llama_shaped(
        hf, name, rope_pct=pct, rope_inv_freq=inv_freq,
        rope_attn_factor=attn_factor,
        attn_bias=bool(getattr(hf, "attention_bias", False)), o_bias=False,
        qk_norm=("rms_head" if getattr(hf, "use_qk_norm", False) else None),
        **_deepseek_routing(hf, fk >= L, 0 < fk < L, fk))


def _dbrx_config(hf, mt, name):
    """dbrx (the JAX branch :1119): bias-free LayerNorms, a fused Wqkv with
    the ``clip_qkv`` clamp, 16 GLU experts behind the softmax router whose
    p-norm renormalization converts only for p = 1 (renormalize) or None
    (none)."""
    ac, fc = hf.attn_config, hf.ffn_config
    p = fc.get("moe_normalize_expert_weights", 1.0)
    if p is not None and float(p) != 1.0:
        raise NotImplementedError(
            f"dbrx moe_normalize_expert_weights={p} — only 1.0 (L1 over "
            "positive softmax weights == renormalize) or None convert")
    act = fc.get("ffn_act_fn") or {}
    return ModelConfig(
        name=name, family="dbrx", vocab_size=hf.vocab_size,
        hidden_size=hf.d_model, intermediate_size=fc["ffn_hidden_size"],
        num_layers=hf.n_layers, num_heads=hf.n_heads,
        num_kv_heads=ac["kv_n_heads"], head_dim=hf.d_model // hf.n_heads,
        max_position_embeddings=hf.max_seq_len, norm_type="layernorm",
        activation=_act_from_hf(act.get("name", "silu")), gated_mlp=True,
        position_embedding="rope",
        rope_theta=ac.get("rope_theta", 10000.0), attn_bias=False,
        mlp_bias=False,
        qkv_clip=float(ac["clip_qkv"]) if ac.get("clip_qkv") else None,
        num_experts=fc["moe_num_experts"],
        num_experts_per_tok=fc["moe_top_k"], moe_norm_topk=p is not None,
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", False))


def _deepseek_v3_config(hf, mt, name):
    """deepseek_v3 (the JAX branch :1156): latent attention with yarn over
    the decoupled rope head, whose ``mscale_all_dim`` score multiplier
    (its square) is folded into q through ``query_pre_attn_scalar``, and
    the deepseek_v3 router, shared experts and a dense prefix."""
    nd, rd = hf.qk_nope_head_dim, hf.qk_rope_head_dim
    inv_freq, attn_factor, score_scale = _rope_scaling_params(hf, rd, mt)
    qpas = (nd + rd) / score_scale ** 4 if score_scale != 1.0 else None
    L = hf.num_hidden_layers
    fk = getattr(hf, "first_k_dense_replace", 0) or 0
    return ModelConfig(
        name=name, family="deepseek", vocab_size=hf.vocab_size,
        hidden_size=hf.hidden_size, num_layers=L,
        num_heads=hf.num_attention_heads,
        num_kv_heads=hf.num_attention_heads, head_dim=nd + rd,
        max_position_embeddings=hf.max_position_embeddings,
        norm_type="rmsnorm", norm_eps=hf.rms_norm_eps,
        activation=_act_from_hf(hf.hidden_act), gated_mlp=True,
        position_embedding="rope",
        rope_theta=getattr(hf, "rope_theta", 10000.0),
        rope_interleaved=bool(getattr(hf, "rope_interleave", True)),
        rope_inv_freq=inv_freq, rope_attn_factor=attn_factor,
        query_pre_attn_scalar=qpas,
        attn_bias=bool(getattr(hf, "attention_bias", False)),
        mlp_bias=False, q_lora_rank=getattr(hf, "q_lora_rank", None),
        kv_lora_rank=hf.kv_lora_rank, qk_nope_head_dim=nd,
        qk_rope_head_dim=rd, v_head_dim=hf.v_head_dim,
        tie_word_embeddings=getattr(hf, "tie_word_embeddings", False),
        **_deepseek_routing(hf, fk >= L, 0 < fk < L, fk))


# the later types' config_from_hf branches (glm4 shares glm's)
_LATER = {
    "gpt_oss": _gpt_oss_config, "hunyuan_v1_moe": _hunyuan_moe_config,
    "ernie4_5_moe": _ernie_moe_config, "glm4_moe": _glm4_moe_config,
    "dbrx": _dbrx_config, "deepseek_v3": _deepseek_v3_config,
    "gpt_neo": _gpt_neo_config, "gemma2": _gemma2_config,
    "cohere": _cohere_config, "qwen3": _qwen3_config,
    "qwen3_moe": _qwen3_config,
    "smollm3": _smollm3_config, "hunyuan_v1_dense": _hunyuan_config,
    "exaone4": _exaone4_config, "granite": _granite_config,
    "olmo2": _olmo2_config, "nemotron": _nemotron_config,
}


# ---------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------

class _Reader:
    """The checkpoint's tensors, each copied to ``device`` on request."""

    def __init__(self, files: CheckpointFiles, device):
        self.files, self.device = files, device

    def __contains__(self, key):
        return key in self.files

    def t(self, key) -> torch.Tensor:
        """Tensor ``key`` on the device, in its file dtype (a copy)."""
        return self.files.get(key).to(self.device, copy=True)

    def f32(self, key) -> torch.Tensor:
        """Tensor ``key`` on the device in f32, for arithmetic."""
        return self.files.get(key).to(self.device, torch.float32, copy=True)

    def lin(self, key, bias=None):
        """(name suffix, tensor) of a torch ``nn.Linear``: ``w`` is its
        [out, in] weight transposed; ``b`` its bias, when ``bias`` (None:
        when the files hold one)."""
        out = [("w", self.t(key + ".weight").T)]
        if bias or (bias is None and key + ".bias" in self):
            out.append(("b", self.t(key + ".bias")))
        return out

    def norm(self, key, bias=True):
        out = [("scale", self.t(key + ".weight"))]
        if bias:
            out.append(("bias", self.t(key + ".bias")))
        return out


def _linear_items(prefix, items):
    for k, t in items:
        yield f"{prefix}.{k}", t


def _gpt2(cfg, r):
    D = cfg.hidden_size
    yield EMBED, r.t("transformer.wte.weight")
    yield "embed.positions", r.t("transformer.wpe.weight")
    for i in range(cfg.num_layers):
        p, o = f"transformer.h.{i}.", f"layers.{i}."
        yield from _linear_items(o + "attn_norm", r.norm(p + "ln_1"))
        cw = r.t(p + "attn.c_attn.weight")    # Conv1D: [D, 3D] (in, out)
        cb = r.t(p + "attn.c_attn.bias")
        for j, n in enumerate("qkv"):
            yield o + n + ".w", cw[:, j * D:(j + 1) * D]
            yield o + n + ".b", cb[j * D:(j + 1) * D]
        del cw, cb
        yield o + "o.w", r.t(p + "attn.c_proj.weight")
        yield o + "o.b", r.t(p + "attn.c_proj.bias")
        yield from _linear_items(o + "mlp_norm", r.norm(p + "ln_2"))
        yield o + "up.w", r.t(p + "mlp.c_fc.weight")
        yield o + "up.b", r.t(p + "mlp.c_fc.bias")
        yield o + "down.w", r.t(p + "mlp.c_proj.weight")
        yield o + "down.b", r.t(p + "mlp.c_proj.bias")
    yield from _linear_items("final_norm", r.norm("transformer.ln_f"))


def _opt(cfg, r):
    yield EMBED, r.t("model.decoder.embed_tokens.weight")
    # OPT's learned positions are offset by 2 (OPTLearnedPositionalEmbedding)
    yield "embed.positions", r.t("model.decoder.embed_positions.weight")[2:]
    if cfg.embed_proj_dim:
        yield "embed.project_in.w", r.t("model.decoder.project_in.weight").T
        yield "embed.project_out.w", \
            r.t("model.decoder.project_out.weight").T
    for i in range(cfg.num_layers):
        p, o = f"model.decoder.layers.{i}.", f"layers.{i}."
        yield from _linear_items(o + "attn_norm",
                                 r.norm(p + "self_attn_layer_norm"))
        for n, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                      ("o", "out_proj")):
            yield from _linear_items(o + n, r.lin(p + "self_attn." + hf, True))
        yield from _linear_items(o + "mlp_norm", r.norm(p + "final_layer_norm"))
        yield from _linear_items(o + "up", r.lin(p + "fc1", True))
        yield from _linear_items(o + "down", r.lin(p + "fc2", True))
    if not cfg.post_norm:   # opt-350m (post-LN) has no final norm
        yield from _linear_items("final_norm",
                                 r.norm("model.decoder.final_layer_norm"))


def _scaled_lin(r, key, scale=1.0):
    """``r.lin(key)`` with weight and bias times ``scale`` in f32."""
    for k, t in r.lin(key):
        yield k, t if scale == 1.0 else t.float() * scale


def _q_scale(cfg) -> float:
    """The score scale folded into q: query_pre_attn_scalar**-0.5 (gemma2,
    granite's attention_multiplier) over the runtime's hd**-0.5."""
    return (cfg.head_dim / (cfg.query_pre_attn_scalar or cfg.head_dim)) ** 0.5


def _llama(cfg, r):
    # gemma's (1 + w) norms absorbed; the others' + 0.0 as in the JAX
    # branch (f32 arithmetic either way)
    off = 1.0 if cfg.norm_offset else 0.0
    qs = _q_scale(cfg)

    def lin(key, scale=1.0):
        return _scaled_lin(r, key, scale)

    yield EMBED, r.t("model.embed_tokens.weight")
    for i in range(cfg.num_layers):
        p, o = f"model.layers.{i}.", f"layers.{i}."
        yield o + "attn_norm.scale", r.f32(p + "input_layernorm.weight") + off
        # under qk_norm the q norm erases a weight scale: the fold moves
        # to the q norm's scale (qwen3 names them q_norm/k_norm, hunyuan
        # query_layernorm/key_layernorm)
        yield from _linear_items(o + "q", lin(p + "self_attn.q_proj",
                                              1.0 if cfg.qk_norm else qs))
        if cfg.qk_norm:
            for n, alt, sc in (("q", "query", qs), ("k", "key", 1.0)):
                key = f"{p}self_attn.{n}_norm.weight"
                if key not in r:
                    key = f"{p}self_attn.{alt}_layernorm.weight"
                yield f"{o}{n}_norm.scale", r.f32(key) * sc
        for n in "kvo":
            yield from _linear_items(o + n, lin(f"{p}self_attn.{n}_proj"))
        yield o + "mlp_norm.scale", \
            r.f32(p + "post_attention_layernorm.weight") + off
        if cfg.layer_cfg(i).is_moe:   # not a dense-prefix layer
            yield from _experts(cfg, r, p, o)
            continue
        for n in ("gate", "up", "down"):
            yield from _linear_items(o + n, lin(f"{p}mlp.{n}_proj"))
    yield "final_norm.scale", r.f32("model.norm.weight") + off
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("lm_head.weight").T


def _experts(cfg, r, p, o):
    """An MoE block's router and stacked experts (the JAX llama branch
    :1475-1534): the router ``mlp.gate`` (qwen3_moe, glm4_moe,
    ernie4_5_moe), ``mlp.gate.wg`` (hunyuan_v1_moe) or mixtral's
    ``block_sparse_moe.gate``; the deepseek_v3 / ernie router's selection
    bias (``mlp.gate.e_score_correction_bias``, or ernie's [1, E]
    ``mlp.moe_statics.e_score_correction_bias``); the experts
    ``mlp.experts.N.{gate,up,down}_proj`` (with their biases where the
    files hold them: ernie4_5_moe ``use_bias``) or mixtral's
    ``block_sparse_moe.experts.N.{w1, w3, w2}``, each weight transposed to
    [din, dout] and stacked over the experts; and the shared experts'
    linears (``mlp.shared_experts.*``, hunyuan's ``mlp.shared_mlp.*``)."""
    router = next((p + c for c in ("mlp.gate.weight", "mlp.gate.wg.weight")
                   if p + c in r), None)
    if router is not None:
        ex = p + "mlp.experts.{}."
        names = {"gate": "gate_proj", "up": "up_proj", "down": "down_proj"}
    else:
        router, ex = (p + "block_sparse_moe.gate.weight",
                      p + "block_sparse_moe.experts.{}.")
        names = {"gate": "w1", "up": "w3", "down": "w2"}
    yield o + "router.w", r.t(router).T
    if cfg.moe_router in ("deepseek_v3", "ernie"):
        bias = p + "mlp.gate.e_score_correction_bias"
        if bias not in r:
            bias = p + "mlp.moe_statics.e_score_correction_bias"
        yield o + "router.bias", r.t(bias).reshape(-1)
    for n, hf in names.items():
        yield f"{o}experts.{n}.w", torch.stack(
            [r.t(ex.format(e) + hf + ".weight").T
             for e in range(cfg.num_experts)])
        if ex.format(0) + hf + ".bias" in r:
            yield f"{o}experts.{n}.b", torch.stack(
                [r.t(ex.format(e) + hf + ".bias")
                 for e in range(cfg.num_experts)])
    if cfg.moe_shared_experts:
        sh = (p + "mlp.shared_experts."
              if p + "mlp.shared_experts.gate_proj.weight" in r
              else p + "mlp.shared_mlp.")
        for n in ("gate", "up", "down"):
            yield from _linear_items(f"{o}shared_{n}", r.lin(sh + n + "_proj"))


def _dbrx(cfg, r):
    """dbrx (the JAX branch :1535): ``norm_attn_norm.{norm_1, attn.Wqkv,
    attn.out_proj, norm_2}`` with bias-free LayerNorms (zero biases, the
    exact equivalent), and the fused expert stacks ``ffn.experts.mlp.
    {w1, v1, w2}`` [E*I, D]: w1 / v1 (gate / up) transposed per expert,
    w2 (down) as stored."""
    D, E, I = cfg.hidden_size, cfg.num_experts, cfg.intermediate_size
    kvd = cfg.num_kv_heads * cfg.head_dim
    zb = torch.zeros(D, dtype=torch.float32, device=r.device)
    yield EMBED, r.t("transformer.wte.weight")
    for i in range(cfg.num_layers):
        p, o = f"transformer.blocks.{i}.", f"layers.{i}."
        a = p + "norm_attn_norm."
        yield o + "attn_norm.scale", r.t(a + "norm_1.weight")
        yield o + "attn_norm.bias", zb
        qkv = r.t(a + "attn.Wqkv.weight").T                  # [D, D+2kvd]
        yield o + "q.w", qkv[:, :D]
        yield o + "k.w", qkv[:, D:D + kvd]
        yield o + "v.w", qkv[:, D + kvd:]
        del qkv
        yield o + "o.w", r.t(a + "attn.out_proj.weight").T
        yield o + "mlp_norm.scale", r.t(a + "norm_2.weight")
        yield o + "mlp_norm.bias", zb
        yield o + "router.w", r.t(p + "ffn.router.layer.weight").T
        for n, hf in (("gate", "w1"), ("up", "v1"), ("down", "w2")):
            w = r.t(p + "ffn.experts.mlp." + hf).reshape(E, I, D)
            yield f"{o}experts.{n}.w", w if n == "down" else w.transpose(1, 2)
    yield "final_norm.scale", r.t("transformer.norm_f.weight")
    yield "final_norm.bias", zb
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("lm_head.weight").T


def _gpt_oss(cfg, r):
    """gpt_oss (the JAX branch :1579): llama names with biases, the
    per-layer ``self_attn.sinks``, the router ``mlp.router`` (a linear
    with its bias), and the experts' fused ``gate_up_proj`` [E, D, 2I]
    (gate the even columns, up the odd) and ``down_proj`` [E, I, D], each
    with its bias, contracted as stored."""
    yield EMBED, r.t("model.embed_tokens.weight")
    for i in range(cfg.num_layers):
        p, o = f"model.layers.{i}.", f"layers.{i}."
        yield o + "attn_norm.scale", r.t(p + "input_layernorm.weight")
        for n in "qkvo":
            yield from _linear_items(o + n, r.lin(f"{p}self_attn.{n}_proj"))
        yield o + "sinks", r.t(p + "self_attn.sinks")
        yield o + "mlp_norm.scale", r.t(p + "post_attention_layernorm.weight")
        yield o + "router.w", r.t(p + "mlp.router.weight").T
        yield o + "router.bias", r.t(p + "mlp.router.bias")
        e = p + "mlp.experts."
        gu, gub = r.t(e + "gate_up_proj"), r.t(e + "gate_up_proj_bias")
        yield o + "experts.gate.w", gu[..., 0::2]
        yield o + "experts.gate.b", gub[..., 0::2]
        yield o + "experts.up.w", gu[..., 1::2]
        yield o + "experts.up.b", gub[..., 1::2]
        del gu, gub
        yield o + "experts.down.w", r.t(e + "down_proj")
        yield o + "experts.down.b", r.t(e + "down_proj_bias")
    yield "final_norm.scale", r.t("model.norm.weight")
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("lm_head.weight").T


def _deepseek(cfg, r):
    """deepseek_v3 (the JAX branch :1622): latent attention's projections,
    q's per-head columns permuted from HF's [nope | rope] to [rope |
    nope] and scaled in f32 by the folded ``mscale_all_dim`` (``_q_scale``
    over ``query_pre_attn_scalar``); ``kv_b_proj`` split per head into
    ``kv_b_k`` (nope) and ``kv_b_v``; a dense prefix's MLP, then the
    router with its selection bias, the experts and the shared experts."""
    H, hd = cfg.num_heads, cfg.head_dim
    nd, vd = cfg.qk_nope_head_dim, cfg.v_head_dim_effective
    qs = _q_scale(cfg)

    def q_permute(w):
        w = w.float().reshape(-1, H, hd)
        return torch.cat([w[..., nd:], w[..., :nd]], dim=-1).reshape(
            -1, H * hd) * qs

    yield EMBED, r.t("model.embed_tokens.weight")
    for i in range(cfg.num_layers):
        p, o = f"model.layers.{i}.", f"layers.{i}."
        a = p + "self_attn."
        yield o + "attn_norm.scale", r.t(p + "input_layernorm.weight")
        yield from _linear_items(o + "kv_a", r.lin(a + "kv_a_proj_with_mqa"))
        yield o + "kv_a_norm.scale", r.t(a + "kv_a_layernorm.weight")
        kv_b = r.t(a + "kv_b_proj.weight").T.reshape(-1, H, nd + vd)
        yield o + "kv_b_k.w", kv_b[..., :nd].reshape(-1, H * nd)
        yield o + "kv_b_v.w", kv_b[..., nd:].reshape(-1, H * vd)
        del kv_b
        yield from _linear_items(o + "o", r.lin(a + "o_proj"))
        yield o + "mlp_norm.scale", r.t(p + "post_attention_layernorm.weight")
        if cfg.q_lora_rank:
            yield from _linear_items(o + "q_a", r.lin(a + "q_a_proj"))
            yield o + "q_a_norm.scale", r.t(a + "q_a_layernorm.weight")
            yield o + "q_b.w", q_permute(r.t(a + "q_b_proj.weight").T)
        else:
            yield o + "q.w", q_permute(r.t(a + "q_proj.weight").T)
        if cfg.layer_cfg(i).is_moe:
            yield from _experts(cfg, r, p, o)
        else:
            for n in ("gate", "up", "down"):
                yield from _linear_items(o + n, r.lin(f"{p}mlp.{n}_proj"))
    yield "final_norm.scale", r.t("model.norm.weight")
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("lm_head.weight").T


def _per_head_qkv(w, b, H, hd, D):
    """A fused QKV of per-head interleaved rows [H, 3, hd] (gpt-neox,
    bloom, gpt_bigcode MHA) as q, k, v items."""
    w3 = w.reshape(H, 3, hd, D)
    b3 = None if b is None else b.reshape(H, 3, hd)
    for j, n in enumerate("qkv"):
        yield n + ".w", w3[:, j].reshape(H * hd, D).T
        if b3 is not None:
            yield n + ".b", b3[:, j].reshape(H * hd)


def _gpt_neox(cfg, r):
    H, hd, D = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    yield EMBED, r.t("gpt_neox.embed_in.weight")
    for i in range(cfg.num_layers):
        p, o = f"gpt_neox.layers.{i}.", f"layers.{i}."
        yield from _linear_items(o + "attn_norm",
                                 r.norm(p + "input_layernorm"))
        yield from _linear_items(o[:-1], _per_head_qkv(
            r.t(p + "attention.query_key_value.weight"),
            r.t(p + "attention.query_key_value.bias"), H, hd, D))
        yield from _linear_items(o + "o", r.lin(p + "attention.dense", True))
        yield from _linear_items(o + "mlp_norm",
                                 r.norm(p + "post_attention_layernorm"))
        yield from _linear_items(o + "up", r.lin(p + "mlp.dense_h_to_4h",
                                                 True))
        yield from _linear_items(o + "down", r.lin(p + "mlp.dense_4h_to_h",
                                                   True))
    yield from _linear_items("final_norm",
                             r.norm("gpt_neox.final_layer_norm"))
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("embed_out.weight").T


def _phi(cfg, r):
    yield EMBED, r.t("model.embed_tokens.weight")
    for i in range(cfg.num_layers):
        p, o = f"model.layers.{i}.", f"layers.{i}."
        # one shared layernorm (shared_attn_mlp_norm): no mlp_norm leaf
        yield from _linear_items(o + "attn_norm",
                                 r.norm(p + "input_layernorm"))
        for n, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                      ("o", "dense")):
            yield from _linear_items(o + n, r.lin(p + "self_attn." + hf, True))
        yield from _linear_items(o + "up", r.lin(p + "mlp.fc1", True))
        yield from _linear_items(o + "down", r.lin(p + "mlp.fc2", True))
    yield from _linear_items("final_norm", r.norm("model.final_layernorm"))
    if not cfg.tie_word_embeddings:
        yield from _linear_items("lm_head", r.lin("lm_head", True))


def _falcon(cfg, r):
    H, hd, KV, D = (cfg.num_heads, cfg.head_dim, cfg.num_kv_heads,
                    cfg.hidden_size)
    g = H // KV
    yield EMBED, r.t("transformer.word_embeddings.weight")
    for i in range(cfg.num_layers):
        p, o = f"transformer.h.{i}.", f"layers.{i}."
        if cfg.shared_attn_mlp_norm:
            yield from _linear_items(o + "attn_norm",
                                     r.norm(p + "input_layernorm"))
        else:   # the new decoder arch's pair, or the RW layout's
            attn_n, mlp_n = (("ln_attn", "ln_mlp")
                             if p + "ln_attn.weight" in r
                             else ("input_layernorm",
                                   "post_attention_layernorm"))
            yield from _linear_items(o + "attn_norm", r.norm(p + attn_n))
            yield from _linear_items(o + "mlp_norm", r.norm(p + mlp_n))
        # fused QKV grouped per kv head: [KV, g + 2, hd] rows, g query
        # heads then k then v per group (HF Falcon _split_heads)
        wg = r.t(p + "self_attention.query_key_value.weight"
                 ).reshape(KV, g + 2, hd, D)
        bg = (r.t(p + "self_attention.query_key_value.bias"
                  ).reshape(KV, g + 2, hd) if cfg.attn_bias else None)
        for n, sel, rows in (("q", slice(0, g), H),
                             ("k", slice(g, g + 1), KV),
                             ("v", slice(g + 1, g + 2), KV)):
            yield o + n + ".w", wg[:, sel].reshape(rows * hd, D).T
            if bg is not None:
                yield o + n + ".b", bg[:, sel].reshape(rows * hd)
        del wg, bg
        yield from _linear_items(o + "o", r.lin(
            p + "self_attention.dense", cfg.o_bias_effective))
        yield from _linear_items(o + "up", r.lin(p + "mlp.dense_h_to_4h",
                                                 cfg.mlp_bias))
        yield from _linear_items(o + "down", r.lin(p + "mlp.dense_4h_to_h",
                                                   cfg.mlp_bias))
    yield from _linear_items("final_norm", r.norm("transformer.ln_f"))
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("lm_head.weight").T


def _bloom(cfg, r):
    H, hd, D = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    yield EMBED, r.t("transformer.word_embeddings.weight")
    yield from _linear_items("embed.norm", r.norm(
        "transformer.word_embeddings_layernorm"))
    for i in range(cfg.num_layers):
        p, o = f"transformer.h.{i}.", f"layers.{i}."
        yield from _linear_items(o + "attn_norm",
                                 r.norm(p + "input_layernorm"))
        yield from _linear_items(o[:-1], _per_head_qkv(
            r.t(p + "self_attention.query_key_value.weight"),
            r.t(p + "self_attention.query_key_value.bias"), H, hd, D))
        yield from _linear_items(o + "o", r.lin(p + "self_attention.dense",
                                                True))
        yield from _linear_items(o + "mlp_norm",
                                 r.norm(p + "post_attention_layernorm"))
        yield from _linear_items(o + "up", r.lin(p + "mlp.dense_h_to_4h",
                                                 True))
        yield from _linear_items(o + "down", r.lin(p + "mlp.dense_4h_to_h",
                                                   True))
    yield from _linear_items("final_norm", r.norm("transformer.ln_f"))
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("lm_head.weight").T


def _gptj(cfg, r):
    yield EMBED, r.t("transformer.wte.weight")
    for i in range(cfg.num_layers):
        p, o = f"transformer.h.{i}.", f"layers.{i}."
        # one shared ln_1 (shared_attn_mlp_norm): no mlp_norm
        yield from _linear_items(o + "attn_norm", r.norm(p + "ln_1"))
        for n, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                      ("o", "out_proj")):
            yield from _linear_items(o + n, r.lin(p + "attn." + hf, False))
        yield from _linear_items(o + "up", r.lin(p + "mlp.fc_in", True))
        yield from _linear_items(o + "down", r.lin(p + "mlp.fc_out", True))
    yield from _linear_items("final_norm", r.norm("transformer.ln_f"))
    if not cfg.tie_word_embeddings:
        yield from _linear_items("lm_head", r.lin("lm_head", True))


def _mpt(cfg, r):
    qd, kvd, D = cfg.q_dim, cfg.kv_dim, cfg.hidden_size
    dtype_of = r.files.get("transformer.wte.weight").dtype

    def norm(key):
        # no_bias MPT norms carry weight only; a zero bias is HF's
        # bias=None layer_norm exactly
        yield "scale", r.t(key + ".weight")
        yield "bias", (r.t(key + ".bias") if key + ".bias" in r else
                       torch.zeros((D,), dtype=dtype_of, device=r.device))

    yield EMBED, r.t("transformer.wte.weight")
    for i in range(cfg.num_layers):
        p, o = f"transformer.blocks.{i}.", f"layers.{i}."
        yield from _linear_items(o + "attn_norm", norm(p + "norm_1"))
        wqkv = r.t(p + "attn.Wqkv.weight")      # [q | k | v] rows
        bqkv = (r.t(p + "attn.Wqkv.bias") if p + "attn.Wqkv.bias" in r
                else None)
        for n, lo, hi in (("q", 0, qd), ("k", qd, qd + kvd),
                          ("v", qd + kvd, qd + 2 * kvd)):
            yield o + n + ".w", wqkv[lo:hi].T
            if bqkv is not None:
                yield o + n + ".b", bqkv[lo:hi]
        del wqkv, bqkv
        yield from _linear_items(o + "o", r.lin(p + "attn.out_proj"))
        yield from _linear_items(o + "mlp_norm", norm(p + "norm_2"))
        yield from _linear_items(o + "up", r.lin(p + "ffn.up_proj"))
        yield from _linear_items(o + "down", r.lin(p + "ffn.down_proj"))
    yield from _linear_items("final_norm", norm("transformer.norm_f"))


def _gpt_bigcode(cfg, r):
    H, hd, D = cfg.num_heads, cfg.head_dim, cfg.hidden_size
    yield EMBED, r.t("transformer.wte.weight")
    yield "embed.positions", r.t("transformer.wpe.weight")
    for i in range(cfg.num_layers):
        p, o = f"transformer.h.{i}.", f"layers.{i}."
        yield from _linear_items(o + "attn_norm", r.norm(p + "ln_1"))
        cw, cb = r.t(p + "attn.c_attn.weight"), r.t(p + "attn.c_attn.bias")
        if cfg.num_kv_heads == 1:   # MQA: [q (D) | k (hd) | v (hd)] rows
            for n, lo, hi in (("q", 0, D), ("k", D, D + hd),
                              ("v", D + hd, D + 2 * hd)):
                yield o + n + ".w", cw[lo:hi].T
                yield o + n + ".b", cb[lo:hi]
        else:                       # MHA: per-head interleaved
            yield from _linear_items(o[:-1], _per_head_qkv(cw, cb, H, hd, D))
        del cw, cb
        yield from _linear_items(o + "o", r.lin(p + "attn.c_proj", True))
        yield from _linear_items(o + "mlp_norm", r.norm(p + "ln_2"))
        yield from _linear_items(o + "up", r.lin(p + "mlp.c_fc", True))
        yield from _linear_items(o + "down", r.lin(p + "mlp.c_proj", True))
    yield from _linear_items("final_norm", r.norm("transformer.ln_f"))
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("lm_head.weight").T


def _stablelm(cfg, r):
    yield EMBED, r.t("model.embed_tokens.weight")
    for i in range(cfg.num_layers):
        p, o = f"model.layers.{i}.", f"layers.{i}."
        yield from _linear_items(o + "attn_norm",
                                 r.norm(p + "input_layernorm"))
        for n in "qkvo":   # use_qkv_bias variants carry q/k/v biases
            yield from _linear_items(o + n, r.lin(f"{p}self_attn.{n}_proj"))
        yield from _linear_items(o + "mlp_norm",
                                 r.norm(p + "post_attention_layernorm"))
        for n in ("gate", "up", "down"):
            yield from _linear_items(o + n, r.lin(f"{p}mlp.{n}_proj"))
    yield from _linear_items("final_norm", r.norm("model.norm"))
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("lm_head.weight").T


def _codegen(cfg, r):
    # fused QKV in mp_num=4 blocks, each q | v | k for its H/4 heads:
    # kind j's rows, concatenated across blocks, are in global head order
    D, mp = cfg.hidden_size, 4
    local = 3 * D // mp
    third = local // 3
    yield EMBED, r.t("transformer.wte.weight")
    for i in range(cfg.num_layers):
        p, o = f"transformer.h.{i}.", f"layers.{i}."
        yield from _linear_items(o + "attn_norm", r.norm(p + "ln_1"))
        wb = r.t(p + "attn.qkv_proj.weight").reshape(mp, local, D)
        for j, n in enumerate("qvk"):
            yield o + n + ".w", \
                wb[:, j * third:(j + 1) * third].reshape(D, D).T
        del wb
        yield from _linear_items(o + "o", r.lin(p + "attn.out_proj", False))
        yield from _linear_items(o + "up", r.lin(p + "mlp.fc_in", True))
        yield from _linear_items(o + "down", r.lin(p + "mlp.fc_out", True))
    yield from _linear_items("final_norm", r.norm("transformer.ln_f"))
    if not cfg.tie_word_embeddings:
        yield from _linear_items("lm_head", r.lin("lm_head", True))


def _starcoder2(cfg, r):
    yield EMBED, r.t("model.embed_tokens.weight")
    for i in range(cfg.num_layers):
        p, o = f"model.layers.{i}.", f"layers.{i}."
        yield from _linear_items(o + "attn_norm",
                                 r.norm(p + "input_layernorm"))
        for n in "qkv":
            yield from _linear_items(o + n, r.lin(f"{p}self_attn.{n}_proj",
                                                  cfg.attn_bias))
        yield from _linear_items(o + "o", r.lin(p + "self_attn.o_proj",
                                                cfg.o_bias_effective))
        yield from _linear_items(o + "mlp_norm",
                                 r.norm(p + "post_attention_layernorm"))
        yield from _linear_items(o + "up", r.lin(p + "mlp.c_fc",
                                                 cfg.mlp_bias))
        yield from _linear_items(o + "down", r.lin(p + "mlp.c_proj",
                                                   cfg.mlp_bias))
    yield from _linear_items("final_norm", r.norm("model.norm"))
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("lm_head.weight").T


def _olmo(cfg, r):
    # non-parametric layernorms: unit scale and zero bias are HF
    # OlmoLayerNorm exactly
    D = cfg.hidden_size

    def unit_norm():
        yield "scale", torch.ones((D,), device=r.device)
        yield "bias", torch.zeros((D,), device=r.device)

    yield EMBED, r.t("model.embed_tokens.weight")
    for i in range(cfg.num_layers):
        p, o = f"model.layers.{i}.", f"layers.{i}."
        yield from _linear_items(o + "attn_norm", unit_norm())
        for n in "qkvo":
            yield from _linear_items(o + n, r.lin(f"{p}self_attn.{n}_proj"))
        yield from _linear_items(o + "mlp_norm", unit_norm())
        for n in ("gate", "up", "down"):
            yield from _linear_items(o + n, r.lin(f"{p}mlp.{n}_proj"))
    yield from _linear_items("final_norm", unit_norm())
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("lm_head.weight").T


def _fused_gate_up(cfg, r, p, o):
    wgu = r.t(p + "mlp.gate_up_proj.weight")        # [gate | up, D]
    I = cfg.intermediate_size
    yield o + "gate.w", wgu[:I].T
    yield o + "up.w", wgu[I:].T


def _phi3(cfg, r):
    qd, kvd = cfg.q_dim, cfg.kv_dim
    yield EMBED, r.t("model.embed_tokens.weight")
    for i in range(cfg.num_layers):
        p, o = f"model.layers.{i}.", f"layers.{i}."
        yield o + "attn_norm.scale", r.t(p + "input_layernorm.weight")
        wqkv = r.t(p + "self_attn.qkv_proj.weight")     # [q | k | v, D]
        for n, lo, hi in (("q", 0, qd), ("k", qd, qd + kvd),
                          ("v", qd + kvd, qd + 2 * kvd)):
            yield o + n + ".w", wqkv[lo:hi].T
        del wqkv
        yield o + "o.w", r.t(p + "self_attn.o_proj.weight").T
        yield o + "mlp_norm.scale", r.t(p + "post_attention_layernorm.weight")
        yield from _fused_gate_up(cfg, r, p, o)
        yield o + "down.w", r.t(p + "mlp.down_proj.weight").T
    yield "final_norm.scale", r.t("model.norm.weight")
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("lm_head.weight").T


def _glm(cfg, r):
    yield EMBED, r.t("model.embed_tokens.weight")
    for i in range(cfg.num_layers):
        p, o = f"model.layers.{i}.", f"layers.{i}."
        yield o + "attn_norm.scale", r.t(p + "input_layernorm.weight")
        for n in "qkvo":   # q/k/v biased, o bias-free
            yield from _linear_items(o + n, r.lin(f"{p}self_attn.{n}_proj"))
        yield o + "mlp_norm.scale", r.t(p + "post_attention_layernorm.weight")
        if cfg.post_block_norms:   # glm4's sandwich
            yield (o + "attn_post_norm.scale",
                   r.t(p + "post_self_attn_layernorm.weight"))
            yield (o + "mlp_post_norm.scale",
                   r.t(p + "post_mlp_layernorm.weight"))
        yield from _fused_gate_up(cfg, r, p, o)
        yield o + "down.w", r.t(p + "mlp.down_proj.weight").T
    yield "final_norm.scale", r.t("model.norm.weight")
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("lm_head.weight").T


def _gpt_neo(cfg, r):
    # GPT-Neo's scores are unscaled: sqrt(hd) folded into q cancels the
    # runtime's hd**-0.5 (f32, as the JAX branch)
    qs = float(cfg.head_dim) ** 0.5
    yield EMBED, r.t("transformer.wte.weight")
    yield "embed.positions", r.t("transformer.wpe.weight")
    for i in range(cfg.num_layers):
        p, o = f"transformer.h.{i}.", f"layers.{i}."
        a = p + "attn.attention."
        yield from _linear_items(o + "attn_norm", r.norm(p + "ln_1"))
        yield o + "q.w", r.f32(a + "q_proj.weight").T * qs
        yield from _linear_items(o + "k", r.lin(a + "k_proj", False))
        yield from _linear_items(o + "v", r.lin(a + "v_proj", False))
        yield from _linear_items(o + "o", r.lin(a + "out_proj", True))
        yield from _linear_items(o + "mlp_norm", r.norm(p + "ln_2"))
        yield from _linear_items(o + "up", r.lin(p + "mlp.c_fc", True))
        yield from _linear_items(o + "down", r.lin(p + "mlp.c_proj", True))
    yield from _linear_items("final_norm", r.norm("transformer.ln_f"))
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("lm_head.weight").T


def _gemma2(cfg, r):
    # the (1 + w) rmsnorm convention absorbed on all five norm kinds; the
    # query_pre_attn_scalar ratio folded into q (weight and bias)
    qs = _q_scale(cfg)
    yield EMBED, r.t("model.embed_tokens.weight")
    for i in range(cfg.num_layers):
        p, o = f"model.layers.{i}.", f"layers.{i}."
        for n, hf in (("attn_norm", "input_layernorm"),
                      ("attn_post_norm", "post_attention_layernorm"),
                      ("mlp_norm", "pre_feedforward_layernorm"),
                      ("mlp_post_norm", "post_feedforward_layernorm")):
            yield f"{o}{n}.scale", r.f32(f"{p}{hf}.weight") + 1.0
        yield from _linear_items(o + "q", _scaled_lin(
            r, p + "self_attn.q_proj", qs))
        for n in "kvo":
            yield from _linear_items(o + n, r.lin(f"{p}self_attn.{n}_proj"))
        for n in ("gate", "up", "down"):
            yield from _linear_items(o + n, r.lin(f"{p}mlp.{n}_proj"))
    yield "final_norm.scale", r.f32("model.norm.weight") + 1.0
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("lm_head.weight").T


def _cohere(cfg, r):
    # bias-free layernorms: a zero bias is their exact parametric form;
    # use_qk_norm's [H, hd] per-head scales stored flat
    zero = torch.zeros((cfg.hidden_size,), device=r.device)
    yield EMBED, r.t("model.embed_tokens.weight")
    for i in range(cfg.num_layers):
        p, o = f"model.layers.{i}.", f"layers.{i}."
        yield o + "attn_norm.scale", r.t(p + "input_layernorm.weight")
        yield o + "attn_norm.bias", zero
        for n in "qkvo":
            yield from _linear_items(o + n, r.lin(f"{p}self_attn.{n}_proj"))
        for n in ("gate", "up", "down"):
            yield from _linear_items(o + n, r.lin(f"{p}mlp.{n}_proj"))
        if cfg.qk_norm:
            for n in "qk":
                yield (f"{o}{n}_norm.scale",
                       r.t(f"{p}self_attn.{n}_norm.weight").reshape(-1))
    yield "final_norm.scale", r.t("model.norm.weight")
    yield "final_norm.bias", zero
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("lm_head.weight").T


def _olmo2(cfg, r):
    # olmo2 and exaone4: the block's two norms are its sublayer-output
    # norms (sublayer_postnorm_only); q/k norms on the projections
    yield EMBED, r.t("model.embed_tokens.weight")
    for i in range(cfg.num_layers):
        p, o = f"model.layers.{i}.", f"layers.{i}."
        yield o + "attn_norm.scale", r.t(p + "post_attention_layernorm.weight")
        yield o + "mlp_norm.scale", r.t(p + "post_feedforward_layernorm.weight")
        for n in "qkvo":
            yield from _linear_items(o + n, r.lin(f"{p}self_attn.{n}_proj"))
        for n in "qk":
            yield f"{o}{n}_norm.scale", r.t(f"{p}self_attn.{n}_norm.weight")
        for n in ("gate", "up", "down"):
            yield from _linear_items(o + n, r.lin(f"{p}mlp.{n}_proj"))
    yield "final_norm.scale", r.t("model.norm.weight")
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("lm_head.weight").T


def _nemotron(cfg, r):
    # LayerNorm1P: (1 + w) * x_hat + b, the + 1 absorbed (f32)
    def norm1p(key):
        yield "scale", r.f32(key + ".weight") + 1.0
        yield "bias", r.t(key + ".bias")

    yield EMBED, r.t("model.embed_tokens.weight")
    for i in range(cfg.num_layers):
        p, o = f"model.layers.{i}.", f"layers.{i}."
        yield from _linear_items(o + "attn_norm", norm1p(p + "input_layernorm"))
        for n in "qkvo":
            yield from _linear_items(o + n, r.lin(f"{p}self_attn.{n}_proj"))
        yield from _linear_items(o + "mlp_norm",
                                 norm1p(p + "post_attention_layernorm"))
        for n in ("up", "down"):
            yield from _linear_items(o + n, r.lin(f"{p}mlp.{n}_proj"))
    yield from _linear_items("final_norm", norm1p("model.norm"))
    if not cfg.tie_word_embeddings:
        yield "lm_head.w", r.t("lm_head.weight").T


_FAMILIES = {
    "gpt2": _gpt2, "opt": _opt, "llama": _llama, "gpt-neox": _gpt_neox,
    "phi": _phi, "falcon": _falcon, "bloom": _bloom, "gptj": _gptj,
    "mpt": _mpt, "gpt_bigcode": _gpt_bigcode, "stablelm": _stablelm,
    "codegen": _codegen, "starcoder2": _starcoder2, "olmo": _olmo,
    "phi3": _phi3, "glm": _glm, "gpt_neo": _gpt_neo, "gemma2": _gemma2,
    "cohere": _cohere, "olmo2": _olmo2, "nemotron": _nemotron,
    "dbrx": _dbrx, "gpt_oss": _gpt_oss, "deepseek": _deepseek,
}


def _finish(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` cast once to ``dtype`` (through f32 from another float
    type) as a fresh contiguous tensor of its own: a slice never keeps
    its fused parent alive."""
    if t.dtype != dtype:
        if t.dtype != torch.float32:
            t = t.float()
        t = t.to(dtype)
    if t._base is not None or not t.is_contiguous():
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def stored_leaves(cfg: ModelConfig, name: str, t: torch.Tensor
                  ) -> Iterator[Tuple[str, torch.Tensor]]:
    """The stored tensors of converted leaf ``name`` under ``cfg.quant``
    / ``cfg.embed_quant``: a float linear weight becomes its quantized
    leaf (``maybe_quantize``'s forms, from the same tensor), the float
    embedding table its int8 one; anything else passes."""
    if cfg.quant and _LINEAR_W.match(name):
        quantize = (quantize_weight if cfg.quant == "int8"
                    else quantize_weight_int4)
        for k, q in quantize(t).items():
            yield f"{name[:-len('.w')]}.{k}", q
    elif cfg.embed_quant and name == EMBED:
        for k, q in quantize_embed(t).items():
            yield f"{EMBED}.{k}", q
    else:
        yield name, t


def convert_state_dict(cfg: ModelConfig, files: CheckpointFiles, dtype=None,
                       device=None, shard: Optional[Callable] = None
                       ) -> Dict[str, torch.Tensor]:
    """The flat dict of ``cfg`` from an open checkpoint, every float leaf
    in ``dtype`` (default ``cfg.dtype``) on ``device``, each leaf then
    quantized by ``cfg.quant`` / ``cfg.embed_quant`` and cut by
    ``shard(name, tensor)`` before the next is read."""
    from distributed_llm_inferencing_tpu_torch.models.params import (
        param_shapes)
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        check_supported)
    check_supported(cfg)
    check_modes(cfg)
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"no weight conversion for family "
                                  f"{cfg.family!r}")
    dtype = torch_dtype(dtype or cfg.dtype)
    device = torch.device(device) if device is not None else \
        torch.device("cpu")
    expect = param_shapes(cfg)
    out = {}
    float_cfg = cfg.replace(quant=None, embed_quant=None)
    want = param_shapes(float_cfg)
    for name, t in _FAMILIES[cfg.family](cfg, _Reader(files, device)):
        t = _finish(t, dtype)
        if name not in want or tuple(t.shape) != want[name]:
            raise ValueError(
                f"{files.path}: converted {name} has shape "
                f"{tuple(t.shape)}; {cfg.name}'s config wants "
                f"{want.get(name)}")
        for k, s in stored_leaves(cfg, name, t):
            s = shard(k, s) if shard is not None else s
            if s is not None:   # else another pp stage's
                out[k] = s
        del t
    keep = getattr(shard, "keep", None) or (lambda name: True)
    missing = {n for n in expect if keep(n)} - set(out)
    if missing:
        raise ValueError(f"{files.path}: no tensor converts to "
                         f"{sorted(missing)[:6]}")
    return out


def load_hf_model(path: str, dtype=None, device=None,
                  shard: Optional[Callable] = None, quantize=None,
                  embed_quantize=None
                  ) -> Tuple[ModelConfig, Dict[str, torch.Tensor]]:
    """(ModelConfig, params on ``device``) of the HF checkpoint directory
    ``path``. Local directories only: anything else is a ``ValueError``
    (the JAX package's opt-in hub download is not ported). ``quantize`` /
    ``embed_quantize`` set ``cfg.quant`` / ``cfg.embed_quant``, applied
    leaf by leaf; ``shard`` as in ``convert_state_dict``. Raises
    ``NotImplementedError`` for a type or config switch the port does not
    serve, before any weight is read."""
    if not isinstance(path, str) or not os.path.isdir(path):
        raise ValueError(f"checkpoint_path {path!r} is not a local "
                         "directory (the port loads no hub names)")
    d = read_config(path)
    cfg = config_from_hf(d, name=path).replace(
        quant=quantize or None, embed_quant=embed_quantize or None)
    device = resolve_device(device)
    with CheckpointFiles(path, d["model_type"]) as files:
        params = convert_state_dict(cfg, files, dtype, device, shard)
    return cfg, params
