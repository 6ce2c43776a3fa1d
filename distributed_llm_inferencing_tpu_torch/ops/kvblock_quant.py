"""Per-(block, head) symmetric int8 quantization for paged-KV pages.

The port's own copy of the JAX package's ``ops/kvblock_quant.py``, the
same records bit for bit. The KV plane moves blocks two ways — host-RAM
offload into the ``HostKVArena`` (runtime/kvtier.py) and cross-node
transfer over ``runtime/kvwire.py`` — and both pay full-precision freight
unless the arena stores blocks as int8 with per-(layer, head) scales:
~3.9x more prefix tokens per MB of arena and per byte of wire.

Scheme: an arena page is one paged-cache leaf sliced at a block,
``[num_layers, block_size, num_kv_heads, head_dim]``. Per (layer, head)
— the axes attention contracts within — ``scale[l, h] =
max|page[l, :, h, :]| / 127``, ``q = round(page / scale)`` clipped.
Blocks quantize independently, so a partial prefix restore needs no
cross-block state. Everything here is numpy on host threads, at offload
and fetch time, never inside a decode step.

A quantized *block record* is ``{"kvq8": 1, "pages": [entry, ...]}``
with one entry per paged-cache leaf: ``{"kind": "q8", "q": int8,
"scale": f32 [L, H], "dtype": <logical dtype name>}`` for float pages,
or ``{"kind": "raw", "data": arr}`` passthrough for pages that are
already integer (an int8 device pool's k/v) and the small float scale
leaves that ride with them. Records are self-describing, so one arena
can hold native tuples and quantized records side by side.

bfloat16 without ``ml_dtypes``: the machines the port runs on need not
have it, so a bf16 page lives on the host as raw 2-byte words, numpy
dtype ``BF16`` (``V2``), whose logical name is "bfloat16" here and whose
wire dtype string is ``"<V2"``, the string the JAX package's
``ml_dtypes.bfloat16`` pages carry (runtime/kvwire.py). ``to_numpy`` /
``to_torch`` move pages between the device pool and this host form; the
widening to f32 and the rounding back (half to even, as ``ml_dtypes``)
are done on the words.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

LEVELS = 127.0
# logical dtypes a q8 entry may restore to (wire meta is untrusted; an
# unknown name must fail validation, not reach np.dtype())
_FLOAT_NAMES = ("float32", "float16", "float64", "bfloat16")


# the host form of a bfloat16 page: its raw 2-byte words
BF16 = np.dtype("V2")


def _np_dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        return BF16
    return np.dtype(name)


def dtype_name(dtype) -> str:
    """The logical name of a host page dtype ("bfloat16" for ``BF16``)."""
    dt = np.dtype(dtype)
    return "bfloat16" if dt == BF16 else dt.name


def _is_float(dtype) -> bool:
    return dtype_name(dtype) in _FLOAT_NAMES


def _to_f32(a: np.ndarray) -> np.ndarray:
    """A float page widened to f32, exactly (bf16 words shifted up)."""
    if a.dtype == BF16:
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return np.asarray(a, dtype=np.float32)


def _from_f32(f: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """f32 values rounded to ``dtype`` (bf16: half to even, as
    ``ml_dtypes``' cast)."""
    if dtype == BF16:
        return to_numpy(torch.from_numpy(np.ascontiguousarray(f)).to(
            torch.bfloat16))
    return f.astype(dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as its host page (bf16 as ``BF16`` words)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The host page dtype of a device tensor dtype."""
    if dtype == torch.bfloat16:
        return BF16
    return np.dtype(str(dtype).replace("torch.", ""))


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A host page as a CPU tensor (``BF16`` words as bfloat16), sharing
    its memory where numpy allows (a read-only page is copied)."""
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _scale_shape(qshape: Tuple[int, ...]) -> Tuple[int, int]:
    """Scale dims for a q8 page: (layers, heads) == (axis 0, axis -2)."""
    return (qshape[0], qshape[-2])


def _broadcast(scale: np.ndarray, qshape: Tuple[int, ...]) -> np.ndarray:
    keep = (0, len(qshape) - 2)
    return scale.reshape([qshape[i] if i in keep else 1
                          for i in range(len(qshape))])


def quantize_page(page: np.ndarray) -> Dict:
    """One paged-cache page -> a record entry (q8 or raw passthrough).

    Only float pages with the full [layers, pos, heads, dim] rank
    quantize; integer pages (kv-quantized device caches) and the small
    low-rank float scale leaves that ride with them pass through."""
    a = np.ascontiguousarray(page)
    if a.ndim < 4 or not _is_float(a.dtype):
        return {"kind": "raw", "data": a}
    f = _to_f32(a)
    keep = (0, a.ndim - 2)
    red = tuple(i for i in range(a.ndim) if i not in keep)
    amax = np.max(np.abs(f), axis=red)                 # [L, H]
    scale = (np.maximum(amax, 1e-8) / LEVELS).astype(np.float32)
    q = np.clip(np.rint(f / _broadcast(scale, a.shape)), -127, 127)
    return {"kind": "q8", "q": q.astype(np.int8), "scale": scale,
            "dtype": dtype_name(a.dtype)}


def dequantize_page(entry: Dict) -> np.ndarray:
    if entry["kind"] == "raw":
        return entry["data"]
    q = entry["q"]
    deq = q.astype(np.float32) * _broadcast(entry["scale"], q.shape)
    return np.ascontiguousarray(_from_f32(deq, _np_dtype(entry["dtype"])))


def quantize_block(pages: Sequence[np.ndarray]) -> Dict:
    """All of one block's pages -> a self-describing block record."""
    return {"kvq8": 1, "pages": [quantize_page(p) for p in pages]}


def dequantize_block(record: Dict) -> tuple:
    """Block record -> logical pages (the scatter-ready layout)."""
    return tuple(dequantize_page(e) for e in record["pages"])


def is_quantized_block(obj) -> bool:
    return (isinstance(obj, dict) and "kvq8" in obj
            and isinstance(obj.get("pages"), list))


def stored_nbytes(record: Dict) -> int:
    """Bytes the record actually occupies (q + scales + raw pages) —
    what arena occupancy and wire accounting must count."""
    n = 0
    for e in record["pages"]:
        if e["kind"] == "raw":
            n += e["data"].nbytes
        else:
            n += e["q"].nbytes + e["scale"].nbytes
    return n


def logical_nbytes(record: Dict) -> int:
    """Bytes of the full-precision pages the record restores to."""
    n = 0
    for e in record["pages"]:
        if e["kind"] == "raw":
            n += e["data"].nbytes
        else:
            n += e["q"].size * _np_dtype(e["dtype"]).itemsize
    return n


def logical_specs(record: Dict) -> List[Tuple[Tuple[int, ...], np.dtype]]:
    """(shape, dtype) per restored page — what the fetch path checks
    against the live paged-cache leaves before admitting a record."""
    out = []
    for e in record["pages"]:
        if e["kind"] == "raw":
            out.append((tuple(e["data"].shape), e["data"].dtype))
        else:
            out.append((tuple(e["q"].shape), _np_dtype(e["dtype"])))
    return out


# ----------------------------------------------------------------------
# Wire flattening: a record crosses kvwire as a flat array list plus a
# per-page meta list in the frame header. Reassembly validates every
# declared shape/dtype relationship BEFORE the record is trusted — the
# meta came off a socket.
# ----------------------------------------------------------------------


def wire_arrays(record: Dict) -> List[np.ndarray]:
    """Flat stored-array list in page order (raw -> [data]; q8 ->
    [q, scale]). Ships the arena representation as-is: no requantize,
    no dequantize on send."""
    out: List[np.ndarray] = []
    for e in record["pages"]:
        if e["kind"] == "raw":
            out.append(e["data"])
        else:
            out.extend((e["q"], e["scale"]))
    return out


def wire_meta(record: Dict) -> List[Dict]:
    """JSON-safe per-page meta for the frame header."""
    out = []
    for e in record["pages"]:
        if e["kind"] == "raw":
            out.append({"kind": "raw"})
        else:
            out.append({"kind": "q8", "dtype": e["dtype"]})
    return out


def block_from_wire(meta: List[Dict], arrays: List[np.ndarray]) -> Dict:
    """Reassemble a block record from decoded wire arrays + header meta.

    Raises ValueError on any inconsistency — unknown page kind, array
    count mismatch, non-int8 q / non-f32 scale, a scale whose shape
    disagrees with its q page, an unknown logical dtype, or non-finite
    scale values (a NaN scale would silently poison every element it
    dequantizes). Callers map ValueError to the codec's WireError so a
    corrupt frame degrades to recompute, never a crash."""
    pages: List[Dict] = []
    i = 0
    for m in meta:
        kind = m.get("kind") if isinstance(m, dict) else None
        if kind == "raw":
            if i + 1 > len(arrays):
                raise ValueError("kvq8 meta/payload count mismatch")
            pages.append({"kind": "raw", "data": arrays[i]})
            i += 1
        elif kind == "q8":
            if i + 2 > len(arrays):
                raise ValueError("kvq8 meta/payload count mismatch")
            q, scale = arrays[i], arrays[i + 1]
            i += 2
            dtype = m.get("dtype")
            if dtype not in _FLOAT_NAMES:
                raise ValueError(f"kvq8 bad logical dtype {dtype!r}")
            if q.dtype != np.int8:
                raise ValueError(f"kvq8 q page dtype {q.dtype}, want int8")
            if scale.dtype != np.float32:
                raise ValueError(
                    f"kvq8 scale dtype {scale.dtype}, want float32")
            if q.ndim < 4 or tuple(scale.shape) != _scale_shape(q.shape):
                raise ValueError(
                    f"kvq8 scale shape {tuple(scale.shape)} does not "
                    f"match q page {tuple(q.shape)}")
            if not np.isfinite(scale).all():
                raise ValueError("kvq8 non-finite scale payload")
            pages.append({"kind": "q8", "q": q, "scale": scale,
                          "dtype": dtype})
        else:
            raise ValueError(f"kvq8 unknown page kind {kind!r}")
    if i != len(arrays):
        raise ValueError("kvq8 meta/payload count mismatch")
    return {"kvq8": 1, "pages": pages}
