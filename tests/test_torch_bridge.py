"""The port's weight bridge and config copies against the JAX package.

``params_from_jax`` must carry every float leaf of the reference pytree
into the port bit for bit, and the port's own ModelConfig/registry copies
must describe the same models as the reference's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributed_llm_inferencing_tpu.models import registry as jreg
from distributed_llm_inferencing_tpu.models.params import (
    init_params as jax_init_params)
from distributed_llm_inferencing_tpu_torch.models import registry as treg
from distributed_llm_inferencing_tpu_torch.models.params import (
    init_params, param_shapes, params_from_jax)
from test_torch_families import one_torch_thread  # noqa: F401


def _np_tree(name, dtype):
    cfg = jreg.get_config(name).replace(dtype=dtype)
    params = jax_init_params(cfg, jax.random.PRNGKey(7))
    return jax.tree.map(np.asarray, params)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _tbits(t):
    t = t.contiguous()
    return _bits((t.view(torch.int16) if t.element_size() == 2
                  else t.view(torch.int32)).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["tiny-llama", "tiny-llama-long"])
def test_params_from_jax_is_bitwise(name, dtype):
    tree = _np_tree(name, dtype)
    cfg = treg.get_config(name).replace(dtype=dtype)
    port = params_from_jax(tree, cfg, device="cpu")
    assert set(port) == set(param_shapes(cfg))
    pairs = [("embed.tokens", tree["embed"]["tokens"]),
             ("final_norm.scale", tree["final_norm"]["scale"]),
             ("lm_head.w", tree["lm_head"]["w"])]
    for i in range(cfg.num_layers):
        for n in ("attn_norm", "mlp_norm"):
            pairs.append((f"layers.{i}.{n}.scale",
                          tree["layers"][n]["scale"][i]))
        for n in ("q", "k", "v", "o", "gate", "up", "down"):
            pairs.append((f"layers.{i}.{n}.w", tree["layers"][n]["w"][i]))
    for name_, ref in pairs:
        t = port[name_]
        assert t.dtype == getattr(torch, dtype), name_
        np.testing.assert_array_equal(_tbits(t), _bits(ref), err_msg=name_)


def test_params_from_jax_refuses_quantized_leaves():
    """Quantized leaves under a config that says the weights are float are
    refused; a chunk-local int4 pack (the JAX package's tp layout of o)
    bridges bit for bit with its ``chunked`` marker."""
    from distributed_llm_inferencing_tpu.ops.quant import repack_int4_rows
    cfg = jreg.get_config("tiny-llama").replace(dtype="float32", quant="int4")
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    params["layers"]["o"] = repack_int4_rows(params["layers"]["o"], 2)
    tree = jax.tree.map(np.asarray, params)
    tcfg = treg.get_config("tiny-llama").replace(dtype="float32")
    port = params_from_jax(tree, tcfg.replace(quant="int4"), device="cpu")
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(port[f"layers.{i}.o.p4"].numpy(),
                                      tree["layers"]["o"]["p4"][i])
        assert tuple(port[f"layers.{i}.o.chunked"].shape) == (2, 0)
    assert "layers.0.down.chunked" not in port
    del tree["layers"]["o"]["chunked"]
    with pytest.raises(ValueError):
        params_from_jax(tree, tcfg, device="cpu")


@pytest.mark.parametrize("name", ["llama-3-8b", "llama-3-70b", "mistral-7b",
                                  "tiny-llama", "tiny-llama-long"])
def test_registry_copy_matches_reference(name):
    assert dataclasses.asdict(treg.get_config(name)) == \
        dataclasses.asdict(jreg.get_config(name))


def test_init_params_shapes_and_seed():
    cfg = treg.get_config("tiny-llama").replace(dtype="float32")
    a = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    for k, shape in param_shapes(cfg).items():
        assert tuple(a[k].shape) == shape
        assert torch.equal(a[k], b[k])
    assert float(a["layers.0.q.w"].std()) == pytest.approx(0.02, rel=0.2)
    assert torch.equal(a["final_norm.scale"], torch.ones(cfg.hidden_size))
