"""The port imports neither jax nor the JAX package, nor ``ml_dtypes``.

An AST scan of every module of ``distributed_llm_inferencing_tpu_torch``
(and of chip_smoke.py, which drives it on the card) for ``import jax``,
``from jax...``, imports of ``distributed_llm_inferencing_tpu`` or its
submodules, and of ``ml_dtypes`` (a JAX dependency the machine with the
card lacks; the port keeps bf16 pages as raw words,
ops/kvblock_quant.py). The port's own name shares that prefix, so the
scan matches whole dotted components, not strings.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "distributed_llm_inferencing_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "distributed_llm_inferencing_tpu", "ml_dtypes")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def forbidden_imports(source: str):
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            if n.split(".")[0] in FORBIDDEN:
                bad.append((node.lineno, n))
    return bad


@pytest.mark.parametrize("src,bad", [
    ("import jax", True),
    ("import jax.numpy as jnp", True),
    ("from jax import lax", True),
    ("from distributed_llm_inferencing_tpu.models import config", True),
    ("import distributed_llm_inferencing_tpu", True),
    ("from distributed_llm_inferencing_tpu_torch.ops import build", False),
    ("import distributed_llm_inferencing_tpu_torch.ops", False),
    ("import jaxtyping", False),
    ("def f():\n    import jax\n", True),
    ("import ml_dtypes", True),
    ("from ml_dtypes import bfloat16", True),
])
def test_scanner(src, bad):
    assert bool(forbidden_imports(src)) == bad


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    found = {}
    for path in files:
        with open(path, encoding="utf-8") as f:
            bad = forbidden_imports(f.read())
        if bad:
            found[os.path.relpath(path, ROOT)] = bad
    assert not found, found


@pytest.mark.parametrize("module", [
    "ops/paged_attention.py", "ops/fused_decode.py", "ops/paged_kvcache.py",
    "ops/sampling.py", "models/transformer.py", "runtime/block_pool.py",
    "runtime/batcher.py", "runtime/worker.py", "ops/quant.py",
    "ops/quant_matmul.py", "models/params.py", "models/hf_files.py",
    "models/convert.py", "models/checkpoint.py", "utils/tokenizer.py",
    "__main__.py", "ops/kvcache.py", "ops/kvblock_quant.py",
    "runtime/kvtier.py", "runtime/kvwire.py", "parallel/mesh.py",
    "parallel/sharding.py", "runtime/lockstep.py", "runtime/engine.py",
    "ops/norms.py", "parallel/pipeline.py", "parallel/paged_pipeline.py",
    "parallel/ring.py",
])
def test_batched_serving_modules_are_scanned_and_clean(module):
    path = os.path.join(PORT, *module.split("/"))
    assert path in _port_files()
    with open(path, encoding="utf-8") as f:
        assert forbidden_imports(f.read()) == []


@pytest.mark.parametrize("module", [
    "models/hf_files.py", "models/convert.py", "models/checkpoint.py"])
def test_the_loader_imports_neither_transformers_nor_safetensors(module):
    """A serving node need not have either: the port reads checkpoint
    files itself (models/hf_files.py)."""
    path = os.path.join(PORT, *module.split("/"))
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [n for n in names
                if n.split(".")[0] in ("transformers", "safetensors")]
