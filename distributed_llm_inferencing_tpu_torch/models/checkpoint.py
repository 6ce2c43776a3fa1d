"""The port's native checkpoints, and the checkpoint sources the worker
loads from.

A native checkpoint is a directory holding ``config.json``
(``dataclasses.asdict`` of the port's ModelConfig: the keys of the JAX
package's file) and ``params.safetensors``, the flat dict
(models/params.py) in safetensors form, written by the port's own writer
(models/hf_files.py). Quantized leaves (``q`` / ``p4`` + ``scale``,
``embed.tokens.q8`` + ``rscale``) are stored as they are, as the JAX
``convert --quantize`` stores them. The JAX package writes Orbax
directories (a ``params/`` subdirectory), which the port cannot read: such
a directory is refused by name.

JAX function -> port function (JAX ``models/checkpoint.py``):

- ``save_checkpoint`` (:36) -> ``save_checkpoint``
- ``load_config`` (:48) -> ``load_config``
- ``load_checkpoint`` (:53) -> ``load_checkpoint(path, dtype, device,
  shard)``: each tensor mapped from the file, copied to the device, cast
  to the served dtype, quantized if asked and cut by ``shard`` (a tp
  rank's share: every rank reads the file itself, the counterpart of the
  JAX sharded restore).
- ``convert_hf_to_native`` (:97) -> ``convert_hf_to_native``; the
  tokenizer files are copied along (the JAX function re-saves them
  through ``transformers``).

``CheckpointSource`` is what ``/load_model``'s ``checkpoint_path`` or
``native_checkpoint`` names, with the body's ``dtype``, ``quantize`` and
``embed_quantize``: ``config()`` reads the configuration alone (so a
refused type or switch is refused before any weight is read), ``load``
the weights. It follows the JAX worker's order of operations: an HF
directory converts to the config's default bf16 whatever the body's
dtype, is quantized from that, and only then are its float leaves cast to
the body's dtype (so a ``"dtype": "float32"`` load computes on
bf16-rounded weights, as the JAX worker does); a native checkpoint is
cast to the body's dtype on restore, then quantized.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from distributed_llm_inferencing_tpu_torch.models.config import ModelConfig
from distributed_llm_inferencing_tpu_torch.models.hf_files import (
    CONFIG_FILE, NATIVE_DTYPES, SafetensorsFile, read_config,
    write_safetensors)
from distributed_llm_inferencing_tpu_torch.utils.device import (
    resolve_device, torch_dtype)
from distributed_llm_inferencing_tpu_torch.utils.tokenizer import (
    copy_tokenizer)

PARAMS_FILE = "params.safetensors"
ORBAX_DIR = "params"   # what the JAX package's save_checkpoint writes


def save_checkpoint(path: str, cfg: ModelConfig,
                    params: Dict[str, torch.Tensor]) -> int:
    """Write ``path/config.json`` and ``path/params.safetensors``;
    returns the bytes of the weights file."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, CONFIG_FILE), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    return write_safetensors(os.path.join(path, PARAMS_FILE), params,
                             {"format": "pt"})


def _local_dir(path, what: str) -> str:
    if not isinstance(path, str) or not os.path.isdir(path):
        raise ValueError(f"{what} {path!r} is not a local directory")
    return path


def load_config(path: str) -> ModelConfig:
    _local_dir(path, "native_checkpoint")
    if (os.path.isdir(os.path.join(path, ORBAX_DIR))
            and not os.path.isfile(os.path.join(path, PARAMS_FILE))):
        raise ValueError(
            f"{path} is an Orbax checkpoint of the JAX package (a "
            f"{ORBAX_DIR}/ directory); the port reads its own format: "
            "convert the HF checkpoint with `python -m "
            "distributed_llm_inferencing_tpu_torch convert`")
    with open(os.path.join(path, CONFIG_FILE)) as f:
        return ModelConfig(**json.load(f))


def _quant_scale(name: str, names) -> bool:
    """True for a quantized leaf's f32 scale (kept f32 whatever the
    served dtype), False for a norm's scale."""
    if name.endswith(".rscale"):
        return True
    stem = name[:-len(".scale")] if name.endswith(".scale") else None
    return stem is not None and (stem + ".q" in names or stem + ".p4" in names)


def cast_float_leaves(params: Dict[str, torch.Tensor], dtype
                      ) -> Dict[str, torch.Tensor]:
    """Every float leaf of the model's dtype (weights, biases, norms,
    positions; not a quantized leaf's scales) cast to ``dtype``, in place,
    one leaf at a time."""
    dtype = torch_dtype(dtype)
    for name in list(params):
        t = params[name]
        if t.is_floating_point() and t.dtype != dtype \
                and not _quant_scale(name, params):
            params[name] = t.to(dtype)
            del t
    return params


def load_checkpoint(path: str, dtype=None, device=None,
                    shard: Optional[Callable] = None, quantize=None,
                    embed_quantize=None
                    ) -> Tuple[ModelConfig, Dict[str, torch.Tensor]]:
    """(cfg, params on ``device``) of a native checkpoint: float leaves
    cast to ``dtype`` (default the stored config's), then quantized by
    ``quantize`` / ``embed_quantize`` where still float, then cut by
    ``shard(name, tensor)``, one tensor at a time (None: not this rank's;
    a ``shard.keep(name)`` predicate skips reading the others)."""
    from distributed_llm_inferencing_tpu_torch.models.convert import (
        stored_leaves)
    from distributed_llm_inferencing_tpu_torch.models.params import (
        param_shapes)
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        check_supported)
    cfg = _native_config(path, dtype, quantize, embed_quantize)
    check_supported(cfg)
    device = resolve_device(device)
    target = torch_dtype(cfg.dtype)
    f = SafetensorsFile(os.path.join(path, PARAMS_FILE), NATIVE_DTYPES)
    out = {}
    # a pp stage's cut names the tensors it holds: the others stay unread
    keep = getattr(shard, "keep", None) or (lambda name: True)
    try:
        names = set(f.keys())
        for name in list(f.keys()):
            if not keep(name):
                continue
            t = f.get(name).to(device, copy=True)
            if t.is_floating_point() and t.dtype != target \
                    and not _quant_scale(name, names):
                t = t.to(target)
            for k, s in stored_leaves(cfg, name, t):
                s = shard(k, s) if shard is not None else s
                if s is not None:
                    out[k] = s
            del t
    finally:
        f.close()
    expect = [n for n in param_shapes(cfg) if keep(n)]
    got = {n for n in out if not n.endswith(".chunked")}
    if got != set(expect):
        raise ValueError(f"{path}: tensors differ from the config's: "
                         f"{sorted(got ^ set(expect))[:6]}")
    return cfg, out


def _native_config(path, dtype=None, quantize=None, embed_quantize=None):
    cfg = load_config(path)
    for field, want in (("quant", quantize), ("embed_quant", embed_quantize)):
        have = getattr(cfg, field)
        if want and have and want != have:
            raise ValueError(f"{path} stores {field}={have!r}; it cannot "
                             f"be served as {want!r}")
        if want:
            cfg = cfg.replace(**{field: want})
    return cfg.replace(dtype=dtype) if dtype else cfg


@dataclasses.dataclass(frozen=True)
class CheckpointSource:
    """Weights named by a load request: ``kind`` "hf" (an HF directory)
    or "native"; ``dtype``, ``quantize``, ``embed_quantize`` as the
    request sets them. Picklable: a tp follower loads its own share."""

    kind: str
    path: str
    dtype: Optional[str] = None
    quantize: Optional[str] = None
    embed_quantize: Optional[str] = None

    def config(self) -> ModelConfig:
        """The served config, from the configuration file alone."""
        if self.kind == "native":
            return _native_config(self.path, self.dtype, self.quantize,
                                  self.embed_quantize)
        from distributed_llm_inferencing_tpu_torch.models.convert import (
            config_from_hf)
        _local_dir(self.path, "checkpoint_path")
        cfg = config_from_hf(read_config(self.path), name=self.path)
        cfg = cfg.replace(quant=self.quantize or None,
                          embed_quant=self.embed_quantize or None)
        return cfg.replace(dtype=self.dtype) if self.dtype else cfg

    def load(self, device=None, shard: Optional[Callable] = None
             ) -> Dict[str, torch.Tensor]:
        if self.kind == "native":
            return load_checkpoint(self.path, self.dtype, device, shard,
                                   self.quantize, self.embed_quantize)[1]
        from distributed_llm_inferencing_tpu_torch.models.convert import (
            load_hf_model)
        cfg, params = load_hf_model(self.path, device=device, shard=shard,
                                    quantize=self.quantize,
                                    embed_quantize=self.embed_quantize)
        return cast_float_leaves(params, self.dtype or cfg.dtype)


def convert_hf_to_native(hf_path: str, out_path: str, dtype=None,
                         quantize=None, embed_quantize=None,
                         device=None) -> ModelConfig:
    """One-shot HF -> native conversion (the ``convert`` CLI): the weights
    the worker would serve for ``checkpoint_path`` with the same
    ``dtype`` / ``quantize`` / ``embed_quantize``, then the tokenizer."""
    src = CheckpointSource("hf", hf_path, dtype, quantize, embed_quantize)
    cfg = src.config()
    params = src.load(device)
    save_checkpoint(out_path, cfg, params)
    del params
    copy_tokenizer(hf_path, out_path)
    return cfg
