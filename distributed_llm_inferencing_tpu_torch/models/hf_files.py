"""Reading (and writing) checkpoint files without ``transformers`` or
``safetensors``.

The JAX package reaches an HF directory through
``transformers.AutoModelForCausalLM.from_pretrained`` (its
``models/convert.py`` ``load_hf_model``), which builds the whole model in
f32 on the host first. The port reads the files itself, one tensor at a
time, so that neither package is needed on a serving node and no copy of
the whole model is ever made on the host:

- ``read_config``: ``config.json`` as a dict.
- ``safetensors``: an 8-byte little-endian header length, a JSON header
  (``name -> {"dtype", "shape", "data_offsets"}``, offsets relative to the
  end of the header), then the raw little-endian bytes. ``SafetensorsFile``
  maps the file and hands out each tensor as a ``torch.frombuffer`` view
  of the map; ``write_safetensors`` is the port's own writer (the native
  checkpoints of models/checkpoint.py).
- ``pytorch_model.bin``: ``torch.load(weights_only=True, mmap=True)``.
- sharded saves: ``*.index.json``'s ``weight_map`` names each tensor's file.

``CheckpointFiles`` opens a directory the way ``from_pretrained`` picks its
files (``model.safetensors``, its index, ``pytorch_model.bin``, its index)
and maps key names as ``from_pretrained`` does: a save of the base model
(no ``transformer.`` / ``model.`` prefix, as hub gpt2 and bloom files are)
gets the type's ``base_model_prefix``. Buffers the converter never reads
(gpt2's ``attn.bias``) are simply never asked for, and a tied head absent
from the files is expected; a key the converter asks for and the files
lack is a ``ValueError`` that names it.

A view from ``get`` lives on the file's map: the caller copies it before
the directory is closed (``CheckpointFiles.close``).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import sys
import warnings
from typing import Dict, Iterable, Optional

import torch

CONFIG_FILE = "config.json"
SAFETENSORS = "model.safetensors"
SAFETENSORS_INDEX = "model.safetensors.index.json"
TORCH_BIN = "pytorch_model.bin"
TORCH_BIN_INDEX = "pytorch_model.bin.index.json"

# the dtypes an HF checkpoint's float weights come in
FLOAT_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                "BF16": torch.bfloat16}
# the native checkpoints also store int8 levels and packed int4 bytes
NATIVE_DTYPES = dict(FLOAT_DTYPES, I8=torch.int8, U8=torch.uint8)
_NAMES = {t: n for n, t in NATIVE_DTYPES.items()}

# model_type -> transformers' ``base_model_prefix`` of its causal-LM class
BASE_MODEL_PREFIX = {
    "gpt2": "transformer", "opt": "model", "llama": "model",
    "mistral": "model", "qwen2": "model", "gemma": "model",
    "gpt_neox": "gpt_neox", "phi": "model", "falcon": "transformer",
    "bloom": "transformer", "gptj": "transformer", "mpt": "transformer",
    "gpt_bigcode": "transformer", "stablelm": "model",
    "codegen": "transformer", "starcoder2": "model", "olmo": "model",
    "phi3": "model", "glm": "model", "ernie4_5": "model",
    "gpt_neo": "transformer", "gemma2": "model", "cohere": "model",
    "qwen3": "model", "smollm3": "model", "hunyuan_v1_dense": "model",
    "exaone4": "model", "granite": "model", "olmo2": "model",
    "glm4": "model", "nemotron": "model", "mixtral": "model",
    "qwen3_moe": "model", "gpt_oss": "model", "hunyuan_v1_moe": "model",
    "ernie4_5_moe": "model", "glm4_moe": "model", "dbrx": "transformer",
    "deepseek_v3": "model",
}


def read_config(path: str) -> dict:
    with open(os.path.join(path, CONFIG_FILE)) as f:
        return json.load(f)


class SafetensorsFile:
    """One ``.safetensors`` file, mapped read-only; ``get`` is a view of
    the map (copy it before ``close``)."""

    def __init__(self, path: str, dtypes=FLOAT_DTYPES):
        if sys.byteorder != "little":
            raise ValueError("safetensors stores little-endian bytes; "
                             "this host is big-endian")
        self.path = path
        self._f = open(path, "rb")
        try:
            (n,) = struct.unpack("<Q", self._f.read(8))
            header = json.loads(self._f.read(n))
            size = os.fstat(self._f.fileno()).st_size
            self._map = (mmap.mmap(self._f.fileno(), 0,
                                   access=mmap.ACCESS_READ)
                         if size else None)
        except (struct.error, ValueError, OSError) as e:
            self._f.close()
            raise ValueError(f"{path}: not a safetensors file ({e})") \
                from None
        self.metadata = header.pop("__metadata__", None) or {}
        self._base = 8 + n
        self._entries = header
        for name, e in header.items():
            begin, end = e["data_offsets"]
            if self._base + end > size or begin > end:
                self.close()
                raise ValueError(f"{path}: tensor {name} runs past the "
                                 "end of the file")
        self._dtypes = dtypes

    def keys(self) -> Iterable[str]:
        return self._entries.keys()

    def get(self, name: str) -> torch.Tensor:
        e = self._entries[name]
        if e["dtype"] not in self._dtypes:
            raise ValueError(
                f"{self.path}: tensor {name} has dtype {e['dtype']}; the "
                f"port reads {sorted(self._dtypes)}")
        dtype = self._dtypes[e["dtype"]]
        begin, end = e["data_offsets"]
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        if count == 0:
            return torch.empty(e["shape"], dtype=dtype)
        with warnings.catch_warnings():   # read-only map: never written
            warnings.simplefilter("ignore", UserWarning)
            flat = torch.frombuffer(self._map, dtype=dtype, count=count,
                                    offset=self._base + begin)
        return flat.view(e["shape"])

    def close(self):
        if self._map is not None:
            self._map.close()
            self._map = None
        self._f.close()


class _TorchBin:
    """One ``pytorch_model.bin`` (or a shard of one), memory-mapped."""

    def __init__(self, path: str):
        self.path = path
        self._sd = torch.load(path, map_location="cpu", weights_only=True,
                              mmap=True)

    def keys(self):
        return self._sd.keys()

    def get(self, name: str) -> torch.Tensor:
        t = self._sd[name]
        if t.dtype not in FLOAT_DTYPES.values():
            raise ValueError(f"{self.path}: tensor {name} has dtype "
                             f"{t.dtype}; the port reads "
                             f"{sorted(FLOAT_DTYPES)}")
        return t

    def close(self):
        self._sd = {}


def _open(path: str):
    return _TorchBin(path) if path.endswith(".bin") else \
        SafetensorsFile(path)


class CheckpointFiles:
    """The weight files of an HF checkpoint directory, as one lookup by
    key name (the names ``from_pretrained`` would give the causal-LM
    model of ``model_type``)."""

    def __init__(self, path: str, model_type: str):
        self.path = path
        files = self._weight_files(path)
        self._files = {}
        self._where: Dict[str, str] = {}
        try:
            for fname in files:
                f = _open(os.path.join(path, fname))
                self._files[fname] = f
                for k in f.keys():
                    self._where[k] = fname
        except BaseException:
            self.close()
            raise
        # a save of the base model lacks its prefix: from_pretrained adds
        # it to every key (transformers' _get_key_renaming_mapping)
        prefix = BASE_MODEL_PREFIX.get(model_type, "")
        if prefix and not any(k.startswith(prefix) for k in self._where):
            self._where = {f"{prefix}.{k}": v for k, v in self._where.items()}
            self._strip = len(prefix) + 1
        else:
            self._strip = 0

    @staticmethod
    def _weight_files(path: str):
        for single, index in ((SAFETENSORS, SAFETENSORS_INDEX),
                              (TORCH_BIN, TORCH_BIN_INDEX)):
            if os.path.isfile(os.path.join(path, single)):
                return [single]
            if os.path.isfile(os.path.join(path, index)):
                with open(os.path.join(path, index)) as f:
                    return sorted(set(json.load(f)["weight_map"].values()))
        raise ValueError(
            f"{path}: no weights ({SAFETENSORS}, {SAFETENSORS_INDEX}, "
            f"{TORCH_BIN} or {TORCH_BIN_INDEX})")

    def __contains__(self, key: str) -> bool:
        return key in self._where

    def keys(self):
        return self._where.keys()

    def get(self, key: str) -> torch.Tensor:
        """A view of tensor ``key`` on its file (copy before ``close``)."""
        if key not in self._where:
            raise ValueError(f"{self.path}: the checkpoint has no tensor "
                             f"{key!r}")
        return self._files[self._where[key]].get(key[self._strip:])

    def close(self):
        for f in self._files.values():
            f.close()
        self._files = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (any device; dtypes of ``NATIVE_DTYPES``) as one
    safetensors file, in the given order, one tensor on the host at a
    time. Returns the bytes written."""
    header, offset = {}, 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             "name here")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = dict(metadata)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)   # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                host = t.detach().contiguous().cpu().reshape(-1)
                f.write(host.view(torch.uint8).numpy().data)
                del host
    return 8 + len(raw) + offset
