"""The port's model ingestion against the JAX package's, on the CPU.

For each of the 39 converter types the port serves (models/convert.py
``SUPPORTED_MODEL_TYPES``), a tiny HF model is built in memory from a
config (``HF_TINY``, after tests/test_numerics_hf.py), every parameter
moved by a seeded numpy draw (so biases and norms are under test), and
``save_pretrained`` to a temporary directory. Held here:

- ``config_from_hf`` on the saved ``config.json`` equals
  ``dataclasses.asdict`` of the JAX ``config_from_hf(AutoConfig)``; so
  does it on the same file with every key but ``model_type`` deleted (the
  class defaults), and with each key deleted in turn (the same result, or
  the same exception);
- ``load_hf_model``'s params equal ``params_from_jax`` of the JAX
  ``load_hf_model(dir)`` bitwise, in bf16 and f32;
- the save forms ``from_pretrained`` reads: sharded safetensors
  (``max_shard_size``), ``pytorch_model.bin`` (``safe_serialization=
  False``), and a base model's save (no ``transformer.`` prefix, no head);
- the file reader and writer (models/hf_files.py) on their own, and what
  is refused: a type or switch the port does not serve, a missing tensor,
  a path that is not a local directory.

The JAX reference of each type is converted once per module
(``reference``). Greedy tokens through the engines and batchers are in
``test_torch_convert_tokens_*.py``; the worker's ``/load_model`` in
``test_torch_worker.py`` and ``test_torch_e2e_master.py``.
"""

import atexit
import dataclasses
import functools
import json
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from distributed_llm_inferencing_tpu.models import convert as jconvert
from distributed_llm_inferencing_tpu_torch.models import convert, hf_files
from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.models.params import (
    params_from_jax)
from test_torch_families import one_torch_thread  # noqa: F401

_T = dict(vocab_size=128)
_L = dict(_T, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
          num_attention_heads=4, max_position_embeddings=128)
# type -> (config class, causal-LM class, kwargs): tiny, every switch the
# type's converter branch reads at a value that puts it under test
HF_TINY = {
    "gpt2": ("GPT2Config", "GPT2LMHeadModel",
             dict(_T, n_positions=128, n_embd=32, n_layer=2, n_head=4)),
    "opt": ("OPTConfig", "OPTForCausalLM",
            dict(_T, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=128,
                 word_embed_proj_dim=32, pad_token_id=1)),
    # Llama-3.1's rope_scaling, the smoothing inside 128 positions
    "llama": ("LlamaConfig", "LlamaForCausalLM",
              dict(_L, num_key_value_heads=2, rope_theta=10000.0,
                   rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                 "low_freq_factor": 1.0,
                                 "high_freq_factor": 4.0,
                                 "original_max_position_embeddings": 16},
                   tie_word_embeddings=False)),
    "mistral": ("MistralConfig", "MistralForCausalLM",
                dict(_L, num_key_value_heads=2, sliding_window=24)),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM",
              dict(_L, num_key_value_heads=2, tie_word_embeddings=True)),
    "gemma": ("GemmaConfig", "GemmaForCausalLM",
              dict(_L, num_key_value_heads=1, head_dim=16)),
    "gpt_neox": ("GPTNeoXConfig", "GPTNeoXForCausalLM",
                 dict(_L, rotary_pct=0.5)),
    "phi": ("PhiConfig", "PhiForCausalLM",
            dict(_L, partial_rotary_factor=0.5)),
    "falcon": ("FalconConfig", "FalconForCausalLM",
               dict(_T, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=128)),
    "bloom": ("BloomConfig", "BloomForCausalLM",
              dict(_T, hidden_size=32, n_layer=2, n_head=4)),
    "gptj": ("GPTJConfig", "GPTJForCausalLM",
             dict(_T, n_positions=128, n_embd=32, n_layer=2, n_head=4,
                  rotary_dim=4)),
    "mpt": ("MptConfig", "MptForCausalLM",
            dict(_T, d_model=32, n_heads=4, n_layers=2, max_seq_len=128)),
    "gpt_bigcode": ("GPTBigCodeConfig", "GPTBigCodeForCausalLM",
                    dict(_T, n_positions=128, n_embd=32, n_layer=2,
                         n_head=4)),
    "stablelm": ("StableLmConfig", "StableLmForCausalLM",
                 dict(_L, num_key_value_heads=2, partial_rotary_factor=0.5,
                      use_qkv_bias=True)),
    "codegen": ("CodeGenConfig", "CodeGenForCausalLM",
                dict(_T, n_positions=128, n_ctx=128, n_embd=32, n_layer=2,
                     n_head=4, rotary_dim=4)),
    "starcoder2": ("Starcoder2Config", "Starcoder2ForCausalLM",
                   dict(_L, num_key_value_heads=2, use_bias=True)),
    "olmo": ("OlmoConfig", "OlmoForCausalLM",
             dict(_L, num_key_value_heads=2, pad_token_id=0)),
    "phi3": ("Phi3Config", "Phi3ForCausalLM",
             dict(_L, num_key_value_heads=2, pad_token_id=0,
                  original_max_position_embeddings=128)),
    "glm": ("GlmConfig", "GlmForCausalLM",
            dict(_L, num_key_value_heads=2, head_dim=16,
                 partial_rotary_factor=0.5, attention_bias=True,
                 pad_token_id=0)),
    "ernie4_5": ("Ernie4_5Config", "Ernie4_5ForCausalLM",
                 dict(_L, num_key_value_heads=2, head_dim=16,
                      pad_token_id=0)),
    # the later types: windows of 8 (shorter than the token tests'
    # prompts) on some layers, caps small enough to bite at these sizes
    "gpt_neo": ("GPTNeoConfig", "GPTNeoForCausalLM",
                dict(_T, hidden_size=32, num_layers=2, num_heads=4,
                     max_position_embeddings=128, window_size=8,
                     attention_types=[[["global", "local"], 1]])),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM",
               dict(_L, num_key_value_heads=2, head_dim=16, sliding_window=8,
                    query_pre_attn_scalar=24, attn_logit_softcapping=0.1,
                    final_logit_softcapping=0.5, pad_token_id=0)),
    "cohere": ("CohereConfig", "CohereForCausalLM",
               dict(_L, num_key_value_heads=2, use_qk_norm=True,
                    logit_scale=0.5, pad_token_id=0)),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM",
              dict(_L, num_key_value_heads=2, head_dim=16,
                   use_sliding_window=True, sliding_window=8,
                   max_window_layers=1)),
    "granite": ("GraniteConfig", "GraniteForCausalLM",
                dict(_L, num_key_value_heads=2, embedding_multiplier=2.0,
                     attention_multiplier=0.3, residual_multiplier=0.5,
                     logits_scaling=2.0, pad_token_id=0)),
    "olmo2": ("Olmo2Config", "Olmo2ForCausalLM",
              dict(_L, num_key_value_heads=2, pad_token_id=0)),
    "glm4": ("Glm4Config", "Glm4ForCausalLM",
             dict(_L, num_key_value_heads=2, head_dim=16,
                  partial_rotary_factor=0.5, attention_bias=True,
                  pad_token_id=0)),
    "nemotron": ("NemotronConfig", "NemotronForCausalLM",
                 dict(_L, num_key_value_heads=2, partial_rotary_factor=0.5,
                      pad_token_id=0)),
    "smollm3": ("SmolLM3Config", "SmolLM3ForCausalLM",
                dict(_L, num_key_value_heads=2, no_rope_layers=[1, 0],
                     use_sliding_window=True, sliding_window=8,
                     pad_token_id=0)),
    "hunyuan_v1_dense": ("HunYuanDenseV1Config", "HunYuanDenseV1ForCausalLM",
                         dict(_L, num_key_value_heads=2, head_dim=8,
                              pad_token_id=0)),
    "exaone4": ("Exaone4Config", "Exaone4ForCausalLM",
                dict(_L, num_key_value_heads=2, sliding_window=8,
                     sliding_window_pattern=2, pad_token_id=0)),
}
# the experts behind the softmax router: configs and params here, tokens
# in test_torch_moe.py (held to the JAX batcher, whose capacity dispatch
# sees other shapes than the engine's)
MOE_TYPES = {
    "mixtral": ("MixtralConfig", "MixtralForCausalLM",
                dict(_L, num_key_value_heads=2, num_local_experts=4,
                     num_experts_per_tok=2, sliding_window=None)),
    "qwen3_moe": ("Qwen3MoeConfig", "Qwen3MoeForCausalLM",
                  dict(_L, num_key_value_heads=2, head_dim=16,
                       moe_intermediate_size=48, num_experts=4,
                       num_experts_per_tok=2, norm_topk_prob=True)),
}
# the other experts and latent attention: the deepseek_v3, ernie and
# topk_softmax routers (group-limited selection at 2 groups, one
# eligible), shared experts, dense prefixes (glm4_moe, ernie4_5_moe,
# deepseek_v3: layer 0 dense), dbrx's clip_qkv at a value that bites, and
# gpt-oss's sinks, alternating windows of 8, yarn RoPE and a GLU clamp
# that bites; deepseek_v3's yarn with mscale_all_dim (a q fold)
EXPERT_TYPES = {
    "glm4_moe": ("Glm4MoeConfig", "Glm4MoeForCausalLM",
                 dict(_L, num_key_value_heads=2, head_dim=16,
                      partial_rotary_factor=0.5, attention_bias=True,
                      use_qk_norm=True, moe_intermediate_size=48,
                      n_routed_experts=4, num_experts_per_tok=2,
                      n_shared_experts=1, n_group=2, topk_group=1,
                      routed_scaling_factor=2.5, first_k_dense_replace=1,
                      pad_token_id=0)),
    "ernie4_5_moe": ("Ernie4_5_MoeConfig", "Ernie4_5_MoeForCausalLM",
                     dict(_L, num_key_value_heads=2,
                          moe_intermediate_size=48, moe_num_experts=4,
                          moe_k=2, moe_num_shared_experts=1,
                          moe_layer_start_index=1, pad_token_id=0)),
    "hunyuan_v1_moe": ("HunYuanMoEV1Config", "HunYuanMoEV1ForCausalLM",
                       dict(_L, num_key_value_heads=2, head_dim=8,
                            num_experts=4, moe_topk=2, pad_token_id=0)),
    "dbrx": ("DbrxConfig", "DbrxForCausalLM",
             dict(_T, d_model=32, n_heads=4, n_layers=2, max_seq_len=128,
                  attn_config={"kv_n_heads": 2, "clip_qkv": 0.3},
                  ffn_config={"ffn_hidden_size": 64, "moe_num_experts": 4,
                              "moe_top_k": 2})),
    "gpt_oss": ("GptOssConfig", "GptOssForCausalLM",
                dict(_L, num_key_value_heads=2, head_dim=8,
                     num_local_experts=4, num_experts_per_tok=2,
                     sliding_window=8,
                     rope_scaling={"rope_type": "yarn", "factor": 4.0,
                                   "beta_fast": 32.0, "beta_slow": 1.0,
                                   "truncate": False,
                                   "original_max_position_embeddings": 32},
                     swiglu_limit=0.5, pad_token_id=0)),
    "deepseek_v3": ("DeepseekV3Config", "DeepseekV3ForCausalLM",
                    dict(_L, num_key_value_heads=4, moe_intermediate_size=48,
                         n_routed_experts=4, n_group=2, topk_group=1,
                         num_experts_per_tok=2, n_shared_experts=1,
                         first_k_dense_replace=1, kv_lora_rank=16,
                         q_lora_rank=24, qk_rope_head_dim=8,
                         qk_nope_head_dim=16, v_head_dim=16,
                         rope_scaling={"type": "yarn", "factor": 4,
                                       "original_max_position_embeddings": 32,
                                       "mscale": 1.0, "mscale_all_dim": 1.0,
                                       "beta_fast": 32, "beta_slow": 1},
                         pad_token_id=0)),
}
TYPES = list(HF_TINY)
HF_TINY.update(MOE_TYPES)
HF_TINY.update(EXPERT_TYPES)
# a weights-only case: biases on every linear, the gated MLP's gate too
# (the JAX engine cannot shard a gate bias: ROADMAP Queue C)
HF_TINY["ernie4_5+bias"] = ("Ernie4_5Config", "Ernie4_5ForCausalLM",
                            dict(HF_TINY["ernie4_5"][2], use_bias=True))
# and the experts' biases (ernie4_5_moe use_bias: expert, shared and
# dense-prefix biases)
HF_TINY["ernie4_5_moe+bias"] = ("Ernie4_5_MoeConfig",
                                "Ernie4_5_MoeForCausalLM",
                                dict(HF_TINY["ernie4_5_moe"][2],
                                     use_bias=True))
_ROOT = tempfile.mkdtemp(prefix="dli-convert-")
atexit.register(shutil.rmtree, _ROOT, True)


def hf_model(mt, seed=0, base=False):
    """The tiny HF model of ``mt`` (its base model when ``base``), every
    parameter moved by a seeded numpy draw (std 0.05)."""
    conf_cls, lm_cls, kw = HF_TINY[mt]
    conf = getattr(transformers, conf_cls)(**kw)
    torch.manual_seed(seed)
    cls = getattr(transformers, lm_cls)
    model = cls(conf)
    if base:
        model = getattr(model, model.base_model_prefix)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(rng.normal(0, 0.05, tuple(p.shape))
                                    .astype(np.float32)))
    return model.eval()


@functools.lru_cache(maxsize=None)
def saved(mt, form="safetensors", seed=0):
    """A directory holding ``mt``'s tiny model in save form ``form``:
    "safetensors", "sharded", "bin", or "base" (the base model, no head,
    no prefix)."""
    d = os.path.join(_ROOT, f"{mt}-{form}-{seed}")
    model = hf_model(mt, seed, base=form == "base")
    kw = {"safetensors": {}, "sharded": {"max_shard_size": "20KB"},
          "bin": {"safe_serialization": False}, "base": {}}[form]
    model.save_pretrained(d, **kw)
    return d


@functools.lru_cache(maxsize=None)
def reference(d, dtype="float32"):
    """(port config from the JAX one, the JAX tree as numpy) of the JAX
    ``load_hf_model(d)`` in ``dtype``."""
    jcfg, jparams = jconvert.load_hf_model(d, dtype=jnp.dtype(dtype))
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    return tcfg, jax.tree.map(np.asarray, jparams)


def jax_params(d, dtype="float32"):
    tcfg, tree = reference(d, dtype)
    return tcfg, params_from_jax(tree, tcfg, "cpu")


def assert_bitwise(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    for k, t in want.items():
        g = got[k]
        assert g.dtype == t.dtype and g.shape == t.shape, (k, g.dtype,
                                                           t.dtype)
        ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
        bits = ints[t.element_size()]
        assert torch.equal(g.contiguous().view(bits),
                           t.contiguous().view(bits)), k


def jax_config(d):
    return dataclasses.asdict(jconvert.config_from_hf(
        transformers.AutoConfig.from_pretrained(d)))


def port_config(d):
    return dataclasses.asdict(convert.config_from_hf(
        hf_files.read_config(d), name=d))


def _outcome(fn, d):
    try:
        return fn(d)
    except Exception as e:   # both sides must refuse alike
        return type(e).__name__


# ---- configuration -------------------------------------------------------

def test_supported_types_are_the_jax_converters_minus_the_refused():
    """The port converts every type of the JAX converter (none is refused
    since the experts and latent attention were ported)."""
    assert set(convert.SUPPORTED_MODEL_TYPES) == \
        set(TYPES) | set(MOE_TYPES) | set(EXPERT_TYPES)
    assert set(convert.SUPPORTED_MODEL_TYPES) == set(
        jconvert.SUPPORTED_MODEL_TYPES)
    assert not hasattr(convert, "REFUSED_MODEL_TYPES")


ALL_TYPES = TYPES + list(MOE_TYPES) + list(EXPERT_TYPES)


@pytest.mark.parametrize("mt", ALL_TYPES)
def test_config_from_hf_matches_jax(mt):
    d = saved(mt)
    assert port_config(d) == jax_config(d)


@pytest.mark.parametrize("mt", ALL_TYPES)
def test_config_from_hf_class_defaults_match_jax(mt):
    """Every key but model_type deleted, then each key deleted in turn:
    the port's defaults table and derivations give the JAX result (or the
    same exception)."""
    src = hf_files.read_config(saved(mt))
    variants = [{"model_type": mt}] + [
        {k: v for k, v in src.items() if k != drop}
        for drop in src if drop != "model_type"]
    for i, conf in enumerate(variants):
        d = os.path.join(_ROOT, f"{mt}-stripped-{i}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(conf, f)
        assert _outcome(port_config, d) == _outcome(jax_config, d), \
            sorted(set(src) - set(conf))


@pytest.mark.parametrize("conf,switch", [
    ({"model_type": "hunyuan_v1_moe", "num_experts": [4, 4],
      "num_hidden_layers": 2}, "per-layer"),
    ({"model_type": "ernie4_5_moe", "moe_layer_interval": 2},
     "moe_layer_interval"),
    ({"model_type": "ernie4_5_moe", "moe_layer_end_index": 3},
     "moe_layer_end_index"),
    ({"model_type": "dbrx", "ffn_config": {
        "moe_normalize_expert_weights": 2.0}}, "moe_normalize_expert"),
    ({"model_type": "phi", "qk_layernorm": True}, "qk_layernorm"),
    ({"model_type": "qwen2", "use_sliding_window": True,
      "max_window_layers": 2, "num_hidden_layers": 4}, "max_window_layers"),
    ({"model_type": "t5"}, "t5"),
])
def test_refused_types_and_switches_name_the_cause(conf, switch):
    """What the JAX converter refuses, the port refuses with the same
    cause (the experts' refusals: per-layer expert lists, interleaved or
    early-ending MoE layers, a p-norm other than 1)."""
    with pytest.raises(NotImplementedError, match=switch):
        convert.config_from_hf(conf)
    if conf["model_type"] != "t5":
        d = os.path.join(_ROOT, f"refused-{conf['model_type']}-{switch}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(conf, f)
        with pytest.raises(NotImplementedError, match=switch):
            jconvert.config_from_hf(transformers.AutoConfig.from_pretrained(d))


def test_rope_scaling_type_aliases_match_jax():
    """The legacy ``type`` key of rope_scaling (llama's copy to
    rope_type, phi3's su -> longrope) reads as the config classes read
    it."""
    for mt, rs in (("llama", {"type": "linear", "factor": 2.0}),
                   ("phi3", {"type": "su", "short_factor": [1.0] * 4,
                             "long_factor": [2.0] * 4})):
        src = dict(hf_files.read_config(saved(mt)), rope_scaling=rs)
        if mt == "phi3":
            src["max_position_embeddings"] = 256
        d = os.path.join(_ROOT, f"{mt}-rope-alias")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(src, f)
        got = port_config(d)
        assert got == jax_config(d) and got["rope_inv_freq"] is not None


# ---- weights -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mt", TYPES + ["ernie4_5+bias"] + list(MOE_TYPES)
                         + list(EXPERT_TYPES) + ["ernie4_5_moe+bias"])
def test_load_hf_model_params_bitwise(mt, dtype):
    d = saved(mt)
    tcfg, want = jax_params(d, dtype)
    cfg, got = convert.load_hf_model(d, dtype=dtype, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    assert_bitwise(got, want)


@pytest.mark.parametrize("mt,form", [
    ("llama", "sharded"), ("gpt_neox", "sharded"), ("gpt2", "bin"),
    ("phi3", "bin"), ("gpt2", "base"), ("bloom", "base"),
])
def test_save_forms_load_bitwise(mt, form):
    d = saved(mt, form)
    names = os.listdir(d)
    if form == "sharded":
        assert hf_files.SAFETENSORS_INDEX in names
        assert sum(n.endswith(".safetensors") for n in names) > 1
    if form == "bin":
        assert hf_files.TORCH_BIN in names
    if form == "base":   # the hub gpt2 / bloom layout: no prefix, no head
        with hf_files.CheckpointFiles(d, mt) as f:
            assert not any(k.startswith("lm_head") for k in f.keys())
        raw = hf_files.SafetensorsFile(os.path.join(d, hf_files.SAFETENSORS))
        assert not any(k.startswith("transformer.") for k in raw.keys())
        raw.close()
    assert_bitwise(convert.load_hf_model(d, device="cpu")[1],
                   jax_params(d, "bfloat16")[1])


def test_quantized_load_equals_maybe_quantize():
    """``quantize`` / ``embed_quantize`` applied leaf by leaf give the
    bytes of ops/quant.py's maybe_quantize on the whole float dict."""
    from distributed_llm_inferencing_tpu_torch.ops.quant import (
        maybe_quantize, maybe_quantize_embed)
    d = saved("llama")
    cfg, flat = convert.load_hf_model(d, device="cpu")
    for q in ("int8", "int4"):
        qcfg, got = convert.load_hf_model(d, device="cpu", quantize=q,
                                          embed_quantize="int8")
        assert qcfg.quant == q and qcfg.embed_quant == "int8"
        want = maybe_quantize_embed(maybe_quantize(dict(flat), qcfg), qcfg)
        assert_bitwise(got, want)


def test_shard_callback_sees_every_stored_tensor():
    d = saved("llama")
    seen = []

    def shard(name, t):
        seen.append(name)
        return t[..., :1].clone()
    _, params = convert.load_hf_model(d, device="cpu", shard=shard,
                                      quantize="int4")
    assert sorted(seen) == sorted(params)
    assert all(t.shape[-1] == 1 for t in params.values())


def test_missing_tensor_is_named():
    src = saved("llama")
    d = os.path.join(_ROOT, "llama-missing")
    shutil.copytree(src, d, dirs_exist_ok=True)
    f = hf_files.SafetensorsFile(os.path.join(src, hf_files.SAFETENSORS))
    keep = {k: f.get(k).clone() for k in f.keys()
            if k != "model.layers.1.mlp.up_proj.weight"}
    f.close()
    hf_files.write_safetensors(os.path.join(d, hf_files.SAFETENSORS), keep)
    with pytest.raises(ValueError, match="model.layers.1.mlp.up_proj.weight"):
        convert.load_hf_model(d, device="cpu")


def test_mpt_config_that_disagrees_with_its_weights_is_refused():
    """HF's MptMLP is 4 x d_model whatever expansion_ratio says; the JAX
    config_from_hf sizes the MLP by the ratio (ROADMAP Queue C). The port
    refuses the checkpoint, naming the leaf."""
    conf_cls, lm_cls, kw = HF_TINY["mpt"]
    d = os.path.join(_ROOT, "mpt-ratio")
    torch.manual_seed(0)
    getattr(transformers, lm_cls)(getattr(transformers, conf_cls)(
        **kw, expansion_ratio=2)).save_pretrained(d)
    assert jconvert.config_from_hf(
        transformers.AutoConfig.from_pretrained(d)).intermediate_size == 64
    with pytest.raises(ValueError, match="layers.0.up.w"):
        convert.load_hf_model(d, device="cpu")


@pytest.mark.parametrize("path", ["meta-llama/Llama-3.1-8B", "/no/such/dir"])
def test_non_local_path_is_refused(path):
    with pytest.raises(ValueError, match="not a local directory"):
        convert.load_hf_model(path, device="cpu")


# ---- the file reader and writer -----------------------------------------

def test_safetensors_round_trip_and_dtypes():
    rng = np.random.default_rng(3)
    tensors = {
        "a": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)),
        "b": torch.from_numpy(rng.normal(size=(7,)).astype(np.float32)
                              ).to(torch.bfloat16),
        "c": torch.from_numpy(rng.normal(size=(2, 2)).astype(np.float16)),
        "d": torch.from_numpy(rng.integers(-127, 128, (4, 3)
                                           ).astype(np.int8)),
        "e": torch.from_numpy(rng.integers(0, 256, (5,)).astype(np.uint8)),
        "z": torch.zeros((2, 0), dtype=torch.int8),
    }
    p = os.path.join(_ROOT, "rt.safetensors")
    n = hf_files.write_safetensors(p, tensors, {"format": "pt"})
    assert n == os.path.getsize(p)
    from safetensors.torch import load_file   # the reference reader
    ref = load_file(p)
    assert set(ref) == set(tensors)
    for k, t in tensors.items():
        assert torch.equal(ref[k], t), k
    f = hf_files.SafetensorsFile(p, hf_files.NATIVE_DTYPES)
    assert f.metadata == {"format": "pt"}
    for k, t in tensors.items():
        assert torch.equal(f.get(k).clone(), t), k
    f.close()
    f = hf_files.SafetensorsFile(p)   # the HF reader takes floats only
    assert torch.equal(f.get("a").clone(), tensors["a"])
    with pytest.raises(ValueError, match="I8"):
        f.get("d")
    f.close()


def test_reader_reads_the_reference_writers_files():
    from safetensors.torch import save_file
    rng = np.random.default_rng(4)
    t = {"w": torch.from_numpy(rng.normal(size=(6, 4)).astype(np.float32)
                               ).to(torch.bfloat16),
         "i": torch.arange(5, dtype=torch.int32)}
    p = os.path.join(_ROOT, "ref.safetensors")
    save_file(t, p)
    f = hf_files.SafetensorsFile(p)
    assert torch.equal(f.get("w").clone(), t["w"])
    with pytest.raises(ValueError, match="I32"):
        f.get("i")
    f.close()


def test_truncated_file_is_refused():
    p = os.path.join(_ROOT, "cut.safetensors")
    hf_files.write_safetensors(p, {"a": torch.ones(64)})
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 8)
    with pytest.raises(ValueError, match="past the end"):
        hf_files.SafetensorsFile(p)


def with_tokenizer(mt, vocab=100):
    """A copy of ``mt``'s saved checkpoint with a tiny tokenizer beside
    it: a BPE over a few sentences, built in memory with ``tokenizers``
    (its ids stay under the models' 128-token vocabulary)."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers import trainers
    d = os.path.join(_ROOT, f"{mt}-tokenizer")
    if os.path.isdir(d):
        return d
    shutil.copytree(saved(mt), d)
    tok = Tokenizer(models.BPE(unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.decoder = decoders.BPEDecoder()
    corpus = ["hello world", "the quick brown fox jumps over the lazy dog",
              "distributed llm inference", "abc def ghi"] * 10
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=vocab, special_tokens=["[UNK]", "<s>", "</s>"]))
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="[UNK]", bos_token="<s>",
        eos_token="</s>").save_pretrained(d)
    return d


def test_scaled_rope_ladder_is_built_once_on_the_models_device(monkeypatch):
    """Llama-3.1's rope_scaling gives a ladder of floats in the config;
    the model makes it a tensor on its device once, so a captured decode
    step copies nothing from the host (a copy inside a CUDA graph capture
    is an error)."""
    from distributed_llm_inferencing_tpu_torch.models import transformer
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        Transformer)
    cfg, params = convert.load_hf_model(saved("llama"), dtype="float32",
                                        device="cpu")
    model = Transformer(cfg.replace(dtype="float32"), params)
    assert torch.equal(model.rope_inv_freq,
                       torch.tensor(cfg.rope_inv_freq, dtype=torch.float32))
    seen = []
    real = transformer.rope_cos_sin

    def spy(positions, head_dim, theta, inv_freq=None, attn_factor=1.0):
        seen.append(inv_freq)
        return real(positions, head_dim, theta, inv_freq, attn_factor)
    monkeypatch.setattr(transformer, "rope_cos_sin", spy)
    model._cos_sin(torch.arange(4)[None])
    assert seen and seen[0] is model.rope_inv_freq
