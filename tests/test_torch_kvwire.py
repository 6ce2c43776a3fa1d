"""The port's KV transfer wire (runtime/kvwire.py) against the JAX
package's, on the CPU.

- Frames are byte for byte the JAX package's for the same blocks: f32,
  f16 and int8 pages, bf16 pages (``ml_dtypes.bfloat16`` in JAX, the
  port's ``BF16`` words), kvq8 records and the terminal frame.
- Each package decodes the other's frames to the same pages.
- Every corruption that tests/test_disagg.py mangles raises ``WireError``
  in the port's decoder too.
- bf16 across packages: the JAX decoder reads a bf16 frame (its own or
  the port's: they are the same bytes) as void ``V2`` pages, which the
  JAX batcher's ``_admit_fetched`` refuses against its bfloat16 pool
  (the transfer then costs a recompute, ROADMAP Queue C); the port reads
  the same frame as bf16 words equal to the sender's.
"""

import json
import struct

import ml_dtypes
import numpy as np
import pytest

from distributed_llm_inferencing_tpu.ops import kvblock_quant as jkvq
from distributed_llm_inferencing_tpu.runtime import kvwire as jwire
from distributed_llm_inferencing_tpu_torch.ops import kvblock_quant as kvq
from distributed_llm_inferencing_tpu_torch.runtime import kvwire

RNG = np.random.default_rng(7)
# one paged-cache block of a tiny model: [L, bs, Hkv, hd]
PAGE = RNG.standard_normal((2, 8, 2, 4)).astype(np.float32)


def _bf16_pair(a):
    """(JAX page, port page) of f32 ``a`` rounded to bfloat16."""
    j = a.astype(ml_dtypes.bfloat16)
    return j, j.view(np.uint16).view(kvq.BF16)


def _blocks():
    """name -> (JAX pages, port pages): the same bytes in each package's
    host form."""
    jb, pb = _bf16_pair(PAGE)
    q = RNG.integers(-127, 128, PAGE.shape).astype(np.int8)
    s = RNG.random((2, 8, 2)).astype(np.float32)
    return {"f32": ([PAGE, PAGE * 2], [PAGE, PAGE * 2]),
            "f16": ([PAGE.astype(np.float16)], [PAGE.astype(np.float16)]),
            "int8": ([q, q, s, s], [q, q, s, s]),
            "bf16": ([jb, jb], [pb, pb])}


@pytest.mark.parametrize("kind", ["f32", "f16", "int8", "bf16"])
def test_frames_equal_jax_byte_for_byte(kind):
    jp, pp = _blocks()[kind]
    assert kvwire.encode_frame("d0", pp) == jwire.encode_frame("d0", jp)
    # the stored form of each arena mode: raw pages and kvq8 records
    jrec, prec = jkvq.quantize_block(jp), kvq.quantize_block(pp)
    assert kvwire.encode_stored("d1", prec) == jwire.encode_stored(
        "d1", jrec)
    assert kvwire.encode_stored("d2", pp) == jwire.encode_stored("d2", jp)
    assert kvwire.stored_nbytes(prec) == jwire.stored_nbytes(jrec)
    assert kvwire.logical_nbytes(prec) == jwire.logical_nbytes(jrec)
    assert kvwire.encode_end(3, ["x"] * 300, 2, 99) == jwire.encode_end(
        3, ["x"] * 300, 2, 99)


@pytest.mark.parametrize("kind", ["f32", "f16", "int8", "bf16"])
def test_each_package_decodes_the_others_frames(kind):
    jp, pp = _blocks()[kind]
    stream = (jwire.encode_frame("a", jp)
              + jwire.encode_stored("b", jkvq.quantize_block(jp))
              + jwire.encode_end(2, []))
    chunks = [stream[i:i + 13] for i in range(0, len(stream), 13)]
    got, end = kvwire.decode_frames(chunks)
    assert end["served"] == 2
    for g, want in zip(got["a"], pp):
        assert g.dtype == want.dtype and g.tobytes() == want.tobytes()
    for g, want in zip(kvq.dequantize_block(got["b"]),
                       kvq.dequantize_block(kvq.quantize_block(pp))):
        assert g.dtype == want.dtype and g.tobytes() == want.tobytes()
    stream = (kvwire.encode_frame("a", pp)
              + kvwire.encode_stored("b", kvq.quantize_block(pp))
              + kvwire.encode_end(2, []))
    got, _ = jwire.decode_frames([stream])
    for g, want in zip(got["a"], jp):
        assert g.tobytes() == want.tobytes()
    for g, want in zip(jkvq.dequantize_block(got["b"]),
                       jkvq.dequantize_block(jkvq.quantize_block(jp))):
        assert g.dtype == want.dtype and g.tobytes() == want.tobytes()
    if kind == "bf16":
        # the JAX receiver's view of a raw bf16 frame: void words, which
        # its batcher's shape/dtype check refuses against a bf16 pool
        assert got["a"][0].dtype == np.dtype("V2")
        assert got["a"][0].dtype != np.dtype(ml_dtypes.bfloat16)


def _pages():
    return [np.arange(24, dtype=np.float32).reshape(2, 3, 4),
            np.arange(6, dtype=np.int8).reshape(6),
            np.arange(4, dtype=np.float16).reshape(2, 2)]


@pytest.mark.parametrize("mangle", ["magic", "truncate", "hdr_cap",
                                    "payload_cap", "spec_short", "garbage",
                                    "byte_cap"])
def test_frame_corruption_raises(mangle):
    good = kvwire.encode_frame("d", _pages()) + kvwire.encode_end(1, [])
    cap = None
    if mangle == "magic":
        bad = b"XXXX" + good[4:]
    elif mangle == "truncate":
        bad = good[:len(good) // 2]     # ends before the terminal frame
    elif mangle == "hdr_cap":
        bad = kvwire.MAGIC + struct.pack(">II", 1 << 20, 0)
    elif mangle == "payload_cap":
        bad = kvwire.MAGIC + struct.pack(">II", 2, 1 << 30) + b"{}"
    elif mangle == "spec_short":
        hdr = json.dumps({"digest": "d", "pages": [
            {"dtype": "<f4", "shape": [64]}]}).encode()
        bad = kvwire.MAGIC + struct.pack(">II", len(hdr), 8) + hdr + b"\0" * 8
    elif mangle == "byte_cap":
        bad, cap = good, 64
    else:
        bad = b"#!<<injected corrupt body; not JSON>>"
    with pytest.raises(kvwire.WireError):
        kvwire.decode_frames([bad], max_total_bytes=cap)
    with pytest.raises(jwire.WireError):   # the reference agrees
        jwire.decode_frames([bad], max_total_bytes=cap)


def _reframe(frame, mutate_hdr=None, mutate_payload=None):
    hl, pl = struct.unpack(">II", frame[4:12])
    hdr = json.loads(frame[12:12 + hl])
    payload = frame[12 + hl:12 + hl + pl]
    if mutate_hdr:
        hdr = mutate_hdr(hdr)
    if mutate_payload:
        payload = mutate_payload(payload)
    h = json.dumps(hdr).encode()
    return (kvwire.MAGIC + struct.pack(">II", len(h), len(payload))
            + h + payload)


@pytest.mark.parametrize("mangle", [
    "quant_scheme", "meta_missing", "meta_count", "bad_dtype",
    "scale_truncated", "nonfinite_scale"])
def test_kvq8_frame_corruption_raises(mangle):
    rec = kvq.quantize_block([PAGE, RNG.integers(0, 7, (5,)).astype(np.int8)])
    q_nbytes = rec["pages"][0]["q"].nbytes

    def hdr_mut(hdr):
        if mangle == "quant_scheme":
            hdr["quant"] = "kvq9"
        elif mangle == "meta_missing":
            del hdr["meta"]
        elif mangle == "meta_count":
            hdr["meta"] = hdr["meta"] + [{"kind": "raw"}]
        elif mangle == "bad_dtype":
            hdr["meta"][0]["dtype"] = "int64"
        elif mangle == "scale_truncated":
            hdr["pages"][1]["shape"] = [1, 2]
        return hdr

    def payload_mut(payload):
        if mangle == "scale_truncated":
            return payload[:q_nbytes + 8]
        if mangle == "nonfinite_scale":
            return (payload[:q_nbytes] + struct.pack("<f", float("nan"))
                    + payload[q_nbytes + 4:])
        return payload

    bad = (_reframe(kvwire.encode_stored("q", rec), hdr_mut, payload_mut)
           + kvwire.encode_end(1, []))
    with pytest.raises(kvwire.WireError):
        kvwire.decode_frames([bad])
    with pytest.raises(jwire.WireError):
        jwire.decode_frames([bad])
