#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python3 chip_smoke.py

Phases (any failure fails the run, exit code != 0):

1. Print the card's name and power limit (nvidia-smi), then build every
   kernel source under distributed_llm_inferencing_tpu_torch/csrc/ with
   nvcc for sm_90a (one nvcc per source, all started together).
2. Hold each kernel against its plain PyTorch version on the card: the
   serving path's shapes (llama-3-8b, bf16: prefill B=1 S=512 H=32 Hkv=8
   hd=128; decode B=4 S=4096 lengths [1, 37, 1000, 4096]; paged decode
   and fused decode R=8 bs=16 over a 2048-block pool, context lengths
   [0, 1, 15, 16, 17, 300, 1000, 4096], the fused q weight [4096, 4096],
   the last two in f32 as well) plus small f32, sliding-window, ALiBi,
   MQA/MHA, head_dim 8-256 and zero-length cases. The paged and fused
   decodes in bf16 are held to one bf16 ulp (PAGED_BF16_TOL). Times the
   kernel, its plain version and one torch call computing the same
   function (scaled_dot_product_attention; the yardstick only, the port
   never calls it; none for the fused kernel),
   and works out the bound: the larger of bytes / 3.35 TB/s and
   operations / peak rate.
3. The engine path: the port's worker on a localhost port serves
   full-width llama-3-8b (random weights from a seed, bf16, max_seq 4096)
   through POST /load_model and three POST /inference requests in
   different prefill buckets (one greedy, two sampled, 32 new tokens).
   Kernel launch counts are zeroed just before and read just after, and
   each request must add one flash_attention launch per layer and one
   flash_decode launch per layer per decode step.
4. Cross-check at full width and reduced depth (2 layers, f32): the same
   weights through the kernels on the card and through the plain
   versions on the CPU — the dense path (teacher-forced prefill plus 8
   decode steps) and the paged path (paged_prefill_tail with a cached
   prefix plus 8 paged_decode_steps), once through paged_flash_decode and
   once through fused_decode_step.
5. The batched path: the worker loads llama-3-8b bf16 with
   "serving": "batched" (8 slots, 1024 blocks of 16, max_seq 4096) and
   serves 8 concurrent requests (prompts of 60-1000 tokens, two sharing a
   512-token prefix, greedy and sampled, 32 new tokens), once with
   DLI_FUSED_DECODE off and once on. Counts are zeroed before each pass:
   the pass's decode kernel must launch num_layers times per weight pass
   of the batcher, and no other attention kernel may launch.
6. Both decode routes at full depth: phase 5's prompts through
   llama-3-8b with one set of weights in bf16 and in f32, a paged
   prefill and ROUTE_STEPS decode steps (f32 greedy; bf16 through each
   kernel fed the same tokens). Reports the f32 top-1/top-2 logit gaps
   and each route's logit error against f32; each route's error must
   stay within ROUTE_ERR_FACTOR times the bf16 prefill's.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. With no GPU, or without the port
package beside this file, it exits non-zero and prints no result.
"""

import concurrent.futures
import gc
import itertools
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12                                   # H100 SXM HBM3
# |kernel - plain| <= ATOL + RTOL*|plain|, elementwise. f32: summation
# order only. bf16: both sides round one f32 result to bf16, and one bf16
# ulp is 2^-7 = 0.0078 relative.
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 1e-2)}
# paged and fused decode in bf16: kernel and plain version both compute in
# f32 and round once to bf16, so they differ by at most one bf16 ulp
# (<= 2^-7 |x|) plus the f32 summation-order error
PAGED_BF16_TOL = (1e-4, 2 ** -7)
# fused decode in f32: its GEMV sums D = 4096 products in another order
# than the host's matmul before the attention
FUSED_F32_TOL = (1e-4, 1e-4)
# cross-check (phase 4): f32 GEMMs over K up to 14336 in another
# summation order on card and host, through 2 layers and the head
XCHECK_TOL = (1e-3, 1e-3)
# phase 5's serving configuration and traffic
BATCHED_LOAD = {"model_name": "llama-3-8b", "allow_random_init": True,
                "dtype": "bfloat16", "serving": "batched", "slots": 8,
                "kv_blocks": 1024, "kv_block_size": 16, "max_seq": 4096}
PROMPT_LENS = (60, 130, 250, 500, 700, 1000)
SHARED_PREFIX, SHARED_TAIL, NEW_TOKENS = 512, 40, 32
# phase 6: decode steps per route at full depth; a route's logit error
# against f32 may be this many times the bf16 prefill's (both decode
# routes stay under the prefill's own error; a decode fault at depth
# decorrelates the logits and lands far above)
ROUTE_STEPS, ROUTE_ERR_FACTOR = 4, 1.5


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def timed_ms(torch, fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


# ---------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------

def _bound_ms(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _library_call(torch, sdpa, q, k, v, **kw):
    """One torch call computing the same attention on [B,H,S,hd] views:
    SDPA with its GQA mode, or (torch without enable_gqa) on k/v whose
    heads were repeated beforehand, outside the timed call."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        sdpa(qt, kt, vt, enable_gqa=True, **kw)
        return lambda: sdpa(qt, kt, vt, enable_gqa=True, **kw)
    except TypeError:
        g = q.shape[2] // k.shape[2]
        kt, vt = (t.repeat_interleave(g, dim=1) for t in (kt, vt))
        return lambda: sdpa(qt, kt, vt, **kw)


def _compare(torch, out, ref, tol):
    atol, rtol = tol
    o, r = out.float(), ref.float()
    assert torch.isfinite(o).all(), "kernel output is not finite"
    err = (o - r).abs()
    ok = bool((err <= atol + rtol * r.abs()).all())
    return float(err.max()), ok


def check_prefill(torch, fa, sdpa, B, S, H, Hkv, hd, dtype, window=None,
                  alibi=False, timing=False):
    from distributed_llm_inferencing_tpu_torch.ops.attention import (
        alibi_slopes)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(S * 31 + H)
    q = torch.randn(B, S, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device=dev).to(dtype)
    sl = alibi_slopes(H, dev) if alibi else None
    out = fa.flash_attention(q, k, v, sliding_window=window, alibi=sl)
    torch.cuda.synchronize()
    ref = fa.flash_attention_ref(q, k, v, sliding_window=window, alibi=sl)
    dname = str(dtype).replace("torch.", "")
    err, ok = _compare(torch, out, ref, TOL[dname])
    row = {"case": f"prefill B={B} S={S} H={H} Hkv={Hkv} hd={hd} {dname}"
                   f" window={window} alibi={alibi}",
           "max_abs_err": err, "tol": TOL[dname], "ok": ok}
    if timing:
        keys = sum(min(i + 1, window or S) for i in range(S))
        flops = 4.0 * B * H * hd * keys
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        row["bound_ms"], row["bound_by"] = _bound_ms(flops, nbytes, dname)
        row["ms"] = timed_ms(torch, lambda: fa.flash_attention(
            q, k, v, sliding_window=window, alibi=sl))
        row["plain_ms"] = timed_ms(torch, lambda: fa.flash_attention_ref(
            q, k, v, sliding_window=window, alibi=sl), iters=5)
        row["library_ms"] = timed_ms(torch, _library_call(
            torch, sdpa, q, k, v, is_causal=True))
    return row


def check_decode(torch, fa, sdpa, lengths, S, H, Hkv, hd, dtype, window=None,
                 alibi=False, timing=False):
    from distributed_llm_inferencing_tpu_torch.ops.attention import (
        alibi_slopes)
    dev = torch.device("cuda")
    B = len(lengths)
    g = torch.Generator(device=dev).manual_seed(S * 17 + H)
    q = torch.randn(B, 1, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device=dev).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    sl = alibi_slopes(H, dev) if alibi else None
    out = fa.flash_decode(q, k, v, lens, sliding_window=window, alibi=sl)
    torch.cuda.synchronize()
    ref = fa.flash_decode_ref(q, k, v, lens, sliding_window=window, alibi=sl)
    dname = str(dtype).replace("torch.", "")
    err, ok = _compare(torch, out, ref, TOL[dname])
    row = {"case": f"decode lengths={lengths} S={S} H={H} Hkv={Hkv} hd={hd}"
                   f" {dname} window={window} alibi={alibi}",
           "max_abs_err": err, "tol": TOL[dname], "ok": ok}
    if timing:
        keys = sum(min(n, window or n) for n in lengths)   # rows read
        flops = 4.0 * H * hd * keys
        nbytes = (2 * keys * Hkv * hd + 2 * q.numel()) * q.element_size() \
            + 4 * B
        row["bound_ms"], row["bound_by"] = _bound_ms(flops, nbytes, dname)
        row["ms"] = timed_ms(torch, lambda: fa.flash_decode(
            q, k, v, lens, sliding_window=window, alibi=sl))
        row["plain_ms"] = timed_ms(torch, lambda: fa.flash_decode_ref(
            q, k, v, lens, sliding_window=window, alibi=sl), iters=5)
        mask = (torch.arange(S, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        row["library_ms"] = timed_ms(torch, _library_call(
            torch, sdpa, q, k, v, attn_mask=mask))
    return row


def _cold_ms(torch, fns, iters=30):
    """Kernel time with inputs the L2 cache does not hold: round-robin
    over input sets that together exceed its 50 MB, as the serving path
    meets a new layer's pool and weights at every launch."""
    it = itertools.cycle(fns)
    return timed_ms(torch, lambda: next(it)(), iters=iters)


def _paged_inputs(torch, g, dtype, lengths, H, Hkv, hd, bs, nb):
    """A random pool of nb blocks; each slot's table is its own random
    permutation of pool blocks (the dummy block 0 aside)."""
    dev = torch.device("cuda")
    R = len(lengths)
    mb = max(1, -(-max(lengths) // bs))
    k = torch.randn(nb, bs, Hkv, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(nb, bs, Hkv, hd, generator=g, device=dev).to(dtype)
    bt = torch.stack([torch.randperm(nb - 1, generator=g, device=dev)[:mb]
                      + 1 for _ in range(R)]).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return k, v, bt, lens


def _paged_keys(lengths, window):
    return sum(min(n, window or n) for n in lengths)


def check_paged(torch, pa, sdpa, lengths, H, Hkv, hd, dtype, bs=16, nb=None,
                window=None, timing=False):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(len(lengths) * 13 + hd)
    R = len(lengths)
    nb = nb or R * max(1, -(-max(lengths) // bs)) + 1
    k, v, bt, lens = _paged_inputs(torch, g, dtype, lengths, H, Hkv, hd, bs,
                                   nb)
    q = torch.randn(R, 1, H, hd, generator=g, device=dev).to(dtype)
    out = pa.paged_flash_decode(q, k, v, bt, lens, sliding_window=window)
    torch.cuda.synchronize()
    ref = pa.paged_flash_decode_ref(q, k, v, bt, lens, sliding_window=window)
    dname = str(dtype).replace("torch.", "")
    tol = TOL[dname] if dtype == torch.float32 else PAGED_BF16_TOL
    err, ok = _compare(torch, out, ref, tol)
    row = {"case": f"paged lengths={lengths} H={H} Hkv={Hkv} hd={hd} bs={bs}"
                   f" blocks={nb} {dname} window={window}",
           "max_abs_err": err, "tol": tol, "ok": ok}
    if timing:
        keys = _paged_keys(lengths, window)
        flops = 4.0 * H * hd * keys
        nbytes = (2 * keys * Hkv * hd + 2 * q.numel()) * q.element_size() \
            + 4 * (R + bt.numel())
        row["bound_ms"], row["bound_by"] = _bound_ms(flops, nbytes, dname)
        sets = [(q, k, v)] + [
            (torch.randn_like(q), *_paged_inputs(
                torch, g, dtype, lengths, H, Hkv, hd, bs, nb)[:2])
            for _ in range(2)]
        row["ms"] = _cold_ms(torch, [
            (lambda a=a: pa.paged_flash_decode(a[0], a[1], a[2], bt, lens,
                                               sliding_window=window))
            for a in sets])
        row["plain_ms"] = timed_ms(torch, lambda: pa.paged_flash_decode_ref(
            q, k, v, bt, lens, sliding_window=window), iters=5)
        # the yardstick attends K/V gathered outside the timed call
        mb = bt.shape[1]
        kg = k[bt.long()].reshape(R, mb * bs, Hkv, hd)
        vg = v[bt.long()].reshape(R, mb * bs, Hkv, hd)
        mask = (torch.arange(mb * bs, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        row["library_ms"] = timed_ms(torch, _library_call(
            torch, sdpa, q, kg, vg, attn_mask=mask))
    return row


def check_fused(torch, fd, lengths, H, Hkv, hd, D, dtype, bs=16, nb=None,
                rope=True, window=None, timing=False):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(len(lengths) * 7 + D)
    R = len(lengths)
    nb = nb or R * max(1, -(-max(lengths) // bs)) + 1
    k, v, bt, lens = _paged_inputs(torch, g, dtype, lengths, H, Hkv, hd, bs,
                                   nb)

    def xw():
        x = torch.randn(R, D, generator=g, device=dev).to(dtype)
        w = (torch.randn(D, H * hd, generator=g, device=dev)
             / D ** 0.5).to(dtype)
        return x, w

    x, w = xw()
    cos = sin = None
    if rope:
        ang = torch.rand(R, hd // 2, generator=g, device=dev) * 6.0
        cos = torch.cat([ang.cos(), ang.cos()], -1).contiguous()
        sin = torch.cat([ang.sin(), ang.sin()], -1).contiguous()
    kw = dict(rope_cos=cos, rope_sin=sin, sliding_window=window)
    out = fd.fused_decode_step(x, {"w": w}, k, v, bt, lens, **kw)
    torch.cuda.synchronize()
    ref = fd.fused_decode_step_ref(x, {"w": w}, k, v, bt, lens, **kw)
    dname = str(dtype).replace("torch.", "")
    tol = FUSED_F32_TOL if dtype == torch.float32 else PAGED_BF16_TOL
    err, ok = _compare(torch, out, ref, tol)
    row = {"case": f"fused lengths={lengths} H={H} Hkv={Hkv} hd={hd} D={D} "
                   f"bs={bs} blocks={nb} {dname} rope={rope} window={window}",
           "max_abs_err": err, "tol": tol, "ok": ok}
    if timing:
        keys = _paged_keys(lengths, window)
        flops = 2.0 * R * D * H * hd + 4.0 * H * hd * keys
        es = x.element_size()
        # the q weight once, the K/V rows of [0, len), x, out, rope rows
        nbytes = (w.numel() + 2 * keys * Hkv * hd + x.numel()
                  + R * H * hd) * es + 2 * 4 * R * hd + 4 * (R + bt.numel())
        row["bound_ms"], row["bound_by"] = _bound_ms(flops, nbytes, dname)
        sets = [(x, w, k, v)] + [
            (*xw(), *_paged_inputs(torch, g, dtype, lengths, H, Hkv, hd, bs,
                                   nb)[:2]) for _ in range(2)]
        row["ms"] = _cold_ms(torch, [
            (lambda a=a: fd.fused_decode_step(a[0], {"w": a[1]}, a[2], a[3],
                                              bt, lens, **kw))
            for a in sets])
        row["plain_ms"] = timed_ms(torch, lambda: fd.fused_decode_step_ref(
            x, {"w": w}, k, v, bt, lens, **kw), iters=5)
        row["library_ms"] = None   # no single torch call computes it
    return row


def int4_bounds(cfg, rows=(1, 8), tp=2):
    """Bounds of the two kernels not ported yet (q4_matmul, q4_matmul_row),
    worked out from their shapes at this config's widths: x [b, din] bf16
    @ unpack(p4 [din/2, dout] uint8) * scale [dout] f32 -> [b, dout] bf16,
    one call per linear. The row-parallel twin runs the same on a din/tp
    shard of o and down (its all-reduce is not counted)."""
    D, I, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    lin = {"q": (D, cfg.num_heads * hd), "k": (D, cfg.num_kv_heads * hd),
           "v": (D, cfg.num_kv_heads * hd), "o": (cfg.num_heads * hd, D),
           "gate": (D, I), "up": (D, I), "down": (I, D)}

    def bound(b, din, dout):
        nbytes = din // 2 * dout + 4 * dout + 2 * b * (din + dout)
        return _bound_ms(2.0 * b * din * dout, nbytes, "bfloat16")

    out = {}
    for b in rows:
        per = {n: bound(b, *s)[0] for n, s in lin.items()}
        out[f"q4_matmul b={b}"] = {
            "per_linear_ms": per,
            "per_weight_pass_ms": cfg.num_layers * sum(per.values()),
            "bound_by": bound(b, *lin["gate"])[1]}
        row = {n: bound(b, lin[n][0] // tp, lin[n][1])[0]
               for n in ("o", "down")}
        out[f"q4_matmul_row b={b} tp={tp} (per shard)"] = {
            "per_linear_ms": row,
            "per_weight_pass_ms": cfg.num_layers * sum(row.values()),
            "bound_by": bound(b, lin["down"][0] // tp, D)[1]}
    return out


def phase_paged_kernels(torch, pa, fd):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16, f32 = torch.bfloat16, torch.float32
    serve = [0, 1, 15, 16, 17, 300, 1000, 4096]
    paged = [check_paged(torch, pa, sdpa, serve, 32, 8, 128, bf16, nb=2048,
                         timing=True),
             check_paged(torch, pa, sdpa, serve, 32, 8, 128, f32, nb=2048),
             check_paged(torch, pa, sdpa, [5, 17, 32, 1], 4, 2, 16, f32,
                         bs=8),
             check_paged(torch, pa, sdpa, [0, 200, 33], 8, 2, 64, f32),
             check_paged(torch, pa, sdpa, [300, 17], 8, 2, 128, bf16,
                         window=64),
             check_paged(torch, pa, sdpa, [90, 3], 8, 1, 256, f32,
                         window=16),
             check_paged(torch, pa, sdpa, [64, 129], 4, 4, 64, bf16)]
    fused = [check_fused(torch, fd, serve, 32, 8, 128, 4096, bf16, nb=2048,
                         timing=True),
             check_fused(torch, fd, serve, 32, 8, 128, 4096, f32, nb=2048),
             check_fused(torch, fd, [7, 21, 12], 4, 2, 16, 32, f32, bs=8),
             check_fused(torch, fd, [19, 8], 4, 2, 16, 32, f32, bs=8,
                         rope=False, window=5),
             check_fused(torch, fd, [100, 3, 0], 8, 1, 128, 512, bf16),
             check_fused(torch, fd, [100, 33], 8, 8, 64, 512, f32),
             check_fused(torch, fd, [1000, 17], 32, 8, 128, 4096, f32,
                         window=256)]
    for row in paged + fused:
        log("  check", json.dumps(row))
    bad = [r["case"] for r in paged + fused if not r["ok"]]
    assert not bad, f"kernels disagree with their plain versions: {bad}"
    return paged, fused


def phase_kernels(torch, fa):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16, f32 = torch.bfloat16, torch.float32
    pre = [check_prefill(torch, fa, sdpa, 1, 512, 32, 8, 128, bf16,
                         timing=True),
           check_prefill(torch, fa, sdpa, 2, 100, 8, 2, 64, f32),
           check_prefill(torch, fa, sdpa, 2, 300, 8, 2, 128, bf16, window=64),
           check_prefill(torch, fa, sdpa, 1, 64, 8, 8, 32, f32, alibi=True),
           check_prefill(torch, fa, sdpa, 1, 80, 4, 2, 256, f32, window=20,
                         alibi=True),
           check_prefill(torch, fa, sdpa, 2, 40, 8, 4, 8, f32)]
    dec = [check_decode(torch, fa, sdpa, [1, 37, 1000, 4096], 4096, 32, 8,
                        128, bf16, timing=True),
           check_decode(torch, fa, sdpa, [0, 1, 200], 256, 8, 2, 64, f32),
           check_decode(torch, fa, sdpa, [200, 17], 256, 8, 2, 128, bf16,
                        window=64),
           check_decode(torch, fa, sdpa, [37, 101], 128, 8, 2, 32, f32,
                        alibi=True),
           check_decode(torch, fa, sdpa, [90, 3], 128, 4, 1, 256, f32,
                        window=16, alibi=True),
           check_decode(torch, fa, sdpa, [5, 60], 64, 8, 4, 8, f32)]
    for row in pre + dec:
        log("  check", json.dumps(row))
    bad = [r["case"] for r in pre + dec if not r["ok"]]
    assert not bad, f"kernels disagree with their plain versions: {bad}"
    return pre, dec


# ---------------------------------------------------------------------
# phase 3: the main path through the port's worker
# ---------------------------------------------------------------------

def _http(url, body=None, timeout=900):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method="GET" if body is None else "POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_main_path(torch, fa):
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    cfg = get_config("llama-3-8b")
    L, new = cfg.num_layers, 32
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    base = f"http://127.0.0.1:{worker.service.port}"
    try:
        st, health = _http(base + "/health")
        assert st == 200 and health["device"]["platform"] == "gpu", health
        torch.cuda.reset_peak_memory_stats()
        st, res = _http(base + "/load_model", {
            "model_name": "llama-3-8b", "allow_random_init": True,
            "dtype": "bfloat16", "max_seq": 4096})
        assert st == 200 and res["status"] == "success", res
        log(f"  load_model: {res['load_time_s']:.2f} s, "
            f"{res['stats']['param_bytes'] / 1e9:.3f} GB of weights")
        # byte tokenizer: BOS + one token per byte -> 100/200/500 tokens,
        # prefill buckets 128/256/512
        reqs = [(100, {"do_sample": False}, 0), (200, {}, 1), (500, {}, 2)]
        fa.flash_attention.launches = 0     # counts of the main path only
        fa.flash_decode.launches = 0
        rows = []
        for n_tok, sampling, seed in reqs:
            text = "".join(chr(97 + (i * 7 + seed) % 26)
                           for i in range(n_tok - 1))
            fa0, fd0 = fa.flash_attention.launches, fa.flash_decode.launches
            st, r = _http(base + "/inference", {
                "model_name": "llama-3-8b", "prompt": text,
                "max_new_tokens": new, "sampling": sampling, "seed": seed})
            assert st == 200 and r["status"] == "success", r
            toks, passes = r["tokens"], r["cost"]["weight_passes"]
            d_fa = fa.flash_attention.launches - fa0
            d_fd = fa.flash_decode.launches - fd0
            assert all(0 <= t < cfg.vocab_size for t in toks), toks
            assert d_fa == L, f"flash_attention launches {d_fa} != {L}"
            assert d_fd == L * (passes - 1), \
                f"flash_decode launches {d_fd} != {L} x {passes - 1}"
            assert passes <= new and (len(toks) == new or (
                len(toks) < new and passes >= len(toks) + 1)), (toks, passes)
            row = {"prompt_tokens": n_tok, "sampling": sampling or "default",
                   "new_tokens": len(toks), "weight_passes": passes,
                   "prefill_ms": r["prefill_ms"],
                   "decode_tokens_per_s": r["tokens_per_s"],
                   "execution_s": r["execution_time"],
                   "flash_attention_launches": d_fa,
                   "flash_decode_launches": d_fd}
            log("  request", json.dumps(row))
            rows.append(row)
        launches = {"flash_attention": fa.flash_attention.launches,
                    "flash_decode": fa.flash_decode.launches}
        peak = torch.cuda.max_memory_allocated()
        log(f"  peak device memory: {peak / 2**30:.3f} GiB "
            "(torch.cuda.max_memory_allocated)")
        st, _ = _http(base + "/unload_model", {"model_name": "llama-3-8b"})
        assert st == 200
    finally:
        worker.shutdown()
    return launches, rows, peak


# ---------------------------------------------------------------------
# phase 4: card (kernels) against host (plain versions), full width
# ---------------------------------------------------------------------

def phase_cross_check(torch, fa):
    from distributed_llm_inferencing_tpu_torch.models.params import (
        init_params)
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        Transformer)
    from distributed_llm_inferencing_tpu_torch.ops.kvcache import init_cache
    cfg = get_config("llama-3-8b").replace(num_layers=2, dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                         "cuda")
    models = {"cuda": Transformer(cfg, params),
              "cpu": Transformer(cfg, {k: t.cpu() for k, t in
                                       params.items()})}
    g = torch.Generator().manual_seed(8)
    B, S0, max_seq = 2, 64, 96
    lens = torch.tensor([37, 64], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (B, S0), generator=g)
    toks[0, 37:] = 0
    forced = torch.randint(0, cfg.vocab_size, (8, B, 1), generator=g)
    logits = {}
    n0 = (fa.flash_attention.launches, fa.flash_decode.launches)
    with torch.inference_mode():
        for dev, model in models.items():
            cache = init_cache(cfg, B, max_seq, device=dev)
            lg, cache = model.prefill(toks.to(dev), lens.to(dev), cache)
            outs = [torch.cat([lg[0, :37], lg[1]]).cpu()]
            for t in range(8):
                lg, cache = model.decode_step(forced[t].to(dev), cache)
                outs.append(lg[:, 0].cpu())
            logits[dev] = torch.cat(outs)
    n1 = (fa.flash_attention.launches, fa.flash_decode.launches)
    assert n1[0] - n0[0] == 2 and n1[1] - n0[1] == 16, (n0, n1)
    errs = {"dense": _xcheck(torch, "dense", logits["cuda"], logits["cpu"])}
    host = _paged_run(torch, models["cpu"], "cpu")
    for route in ("paged", "fused"):
        errs[route] = _xcheck(torch, route,
                              _paged_run(torch, models["cuda"], "cuda",
                                         route), host)
    del models, params
    gc.collect()
    torch.cuda.empty_cache()
    return errs


def _xcheck(torch, what, a, b):
    assert torch.isfinite(a).all()
    err = (a - b).abs()
    atol, rtol = XCHECK_TOL
    log(f"  cross-check {what}: llama-3-8b width, 2 layers, f32, "
        f"{a.shape[0]} logit rows: max_abs_err {float(err.max()):.3e} "
        f"(tol {atol} + {rtol}*|ref|), logits |max| {float(b.abs().max()):.3f}")
    assert bool((err <= atol + rtol * b.abs()).all()), \
        f"card and host logits disagree ({what})"
    return float(err.max())


def _paged_run(torch, model, dev, route=None):
    """paged_prefill_tail (a 32-token prompt, then a wave of two tails, one
    reusing that prompt's blocks as its cached prefix) + 8 teacher-forced
    paged_decode_steps; decode attention through `route` ("paged" or
    "fused") on the card. Returns the logits rows [N, V] on the host."""
    from distributed_llm_inferencing_tpu_torch.ops import (
        fused_decode as fd, paged_attention as pa)
    from distributed_llm_inferencing_tpu_torch.ops.paged_kvcache import (
        init_paged_cache)
    cfg = model.cfg
    V, bs = cfg.vocab_size, 16
    g = torch.Generator().manual_seed(9)
    i32 = dict(dtype=torch.int32, device=dev)
    paged = init_paged_cache(cfg, 16, bs, device=dev)
    prompt = torch.randint(0, V, (1, 32), generator=g)
    tails = torch.randint(0, V, (2, 48), generator=g)
    forced = torch.randint(0, V, (8, 2), generator=g)
    os.environ["DLI_FUSED_DECODE"] = "1" if route == "fused" else "0"
    n0 = (pa.paged_flash_decode.launches, fd.fused_decode_step.launches)
    outs = []
    try:
        with torch.inference_mode():
            lg, _ = model.paged_prefill_tail(
                prompt.to(dev), torch.tensor([32], **i32),
                torch.tensor([[1, 2]], **i32), torch.tensor([[0, 0]], **i32),
                torch.tensor([0], **i32), paged)
            outs.append(lg.cpu())
            lg, _ = model.paged_prefill_tail(
                tails.to(dev), torch.tensor([20, 37], **i32),
                torch.tensor([[3, 4, 5], [6, 7, 8]], **i32),
                torch.tensor([[1, 2], [0, 0]], **i32),
                torch.tensor([32, 0], **i32), paged)
            outs.append(lg.cpu())
            bt = torch.tensor([[1, 2, 3, 4], [6, 7, 8, 9]], **i32)
            cl = torch.tensor([52, 37], **i32)
            for t in range(8):
                lg, _ = model.paged_decode_step(forced[t].to(dev), paged, bt,
                                                cl)
                outs.append(lg.cpu())
                cl = cl + 1
    finally:
        os.environ.pop("DLI_FUSED_DECODE", None)
    d = (pa.paged_flash_decode.launches - n0[0],
         fd.fused_decode_step.launches - n0[1])
    want = {None: (0, 0), "paged": (16, 0), "fused": (0, 16)}[route]
    assert d == want, f"{route}: kernel launches {d} != {want}"
    return torch.cat(outs)


# ---------------------------------------------------------------------
# phase 5: batched serving through the port's worker
# ---------------------------------------------------------------------

def _batched_bodies(cfg):
    """8 requests: prompts of PROMPT_LENS tokens plus two that share a
    512-token prefix with different 40-token tails; even ones greedy, odd
    ones sampled, all seeded."""
    import numpy as np
    rng = np.random.default_rng(11)
    tok = lambda n: rng.integers(1, cfg.vocab_size, n).tolist()  # noqa
    prefix = tok(SHARED_PREFIX)
    prompts = [tok(n) for n in PROMPT_LENS] + [
        prefix + tok(SHARED_TAIL), prefix + tok(SHARED_TAIL)]
    return [{"model_name": BATCHED_LOAD["model_name"], "prompt_tokens": p,
             "max_new_tokens": NEW_TOKENS, "seed": 100 + i,
             "sampling": ({"do_sample": False} if i % 2 == 0 else
                          {"temperature": 0.8, "top_k": 50, "top_p": 0.95})}
            for i, p in enumerate(prompts)]


def _batched_pass(torch, base, worker, kernels, route, cfg):
    bodies = _batched_bodies(cfg)
    L = cfg.num_layers
    st, res = _http(base + "/load_model", BATCHED_LOAD)
    assert st == 200 and res["status"] == "success", res
    log(f"  load_model (batched, {route}): {res['load_time_s']:.2f} s")
    counters = lambda: worker.metrics.snapshot()["counters"]  # noqa: E731
    c0 = counters()
    for mod, name in kernels.values():   # counts of this pass only
        setattr(getattr(mod, name), "launches", 0)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(bodies)) as ex:
        got = list(ex.map(lambda b: _http(base + "/inference", b), bodies))
    wall = time.perf_counter() - t0
    launches = {k: getattr(mod, name).launches
                for k, (mod, name) in kernels.items()}
    c1 = counters()
    passes, emitted = (c1.get(k, 0) - c0.get(k, 0) for k in (
        "batcher_weight_passes", "batcher_tokens_emitted"))
    rows, tokens = [], []
    for body, (st, r) in zip(bodies, got):
        assert st == 200 and r["status"] == "success", r
        toks = r["tokens"]
        assert 1 <= len(toks) <= NEW_TOKENS, toks
        assert all(0 <= t < cfg.vocab_size for t in toks), toks
        tokens.append(toks)
        rows.append({"prompt_tokens": len(body["prompt_tokens"]),
                     "greedy": body["sampling"].get("do_sample") is False,
                     "new_tokens": len(toks), "ttft_ms": r["ttft_ms"],
                     "cost": r["cost"]})
    other = "fused_decode_step" if route == "paged" else "paged_flash_decode"
    mine = "paged_flash_decode" if route == "paged" else "fused_decode_step"
    assert launches[mine] == L * passes, \
        f"{mine} launches {launches[mine]} != {L} x {passes} weight passes"
    assert launches[other] == 0 and launches["flash_attention"] == 0 \
        and launches["flash_decode"] == 0, launches
    cached = [r["cost"]["prefill_cached_tokens"] for r in rows[-2:]]
    assert max(cached) >= SHARED_PREFIX, \
        f"shared-prefix requests cached {cached} prompt tokens"
    summary = {"route": route, "wall_s": wall,
               "generated_tokens": sum(len(t) for t in tokens),
               "tokens_per_s": sum(len(t) for t in tokens) / wall,
               "weight_passes": passes,
               "decode_tokens_per_weight_pass": emitted / passes,
               "launches": launches, "requests": rows}
    for row in rows:
        log("  request", json.dumps(row))
    log("  wave", json.dumps({k: v for k, v in summary.items()
                              if k != "requests"}))
    st, _ = _http(base + "/unload_model",
                  {"model_name": BATCHED_LOAD["model_name"]})
    assert st == 200
    return summary, tokens


def phase_batched(torch, kernels):
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.runtime.worker import (
        WorkerAgent)
    cfg = get_config("llama-3-8b")
    worker = WorkerAgent(device="cuda")
    worker.serve("127.0.0.1", 0, background=True)
    base = f"http://127.0.0.1:{worker.service.port}"
    try:
        torch.cuda.reset_peak_memory_stats()
        os.environ["DLI_FUSED_DECODE"] = "0"
        paged, toks_p = _batched_pass(torch, base, worker, kernels, "paged",
                                      cfg)
        os.environ["DLI_FUSED_DECODE"] = "1"
        fused, toks_f = _batched_pass(torch, base, worker, kernels, "fused",
                                      cfg)
    finally:
        os.environ.pop("DLI_FUSED_DECODE", None)
        worker.shutdown()
    greedy = [i for i in range(len(toks_p)) if i % 2 == 0]
    agree = sum(a == b for i in greedy
                for a, b in zip(toks_p[i], toks_f[i]))
    total = sum(len(toks_p[i]) for i in greedy)
    peak = torch.cuda.max_memory_allocated()
    log(f"  greedy tokens equal across the two decode routes: {agree} of "
        f"{total} (bf16 q rounds differently: reported, not asserted)")
    log(f"  peak device memory: {peak / 2**30:.3f} GiB")
    gc.collect()
    torch.cuda.empty_cache()
    return {"paged": paged, "fused": fused,
            "greedy_tokens_agree": [agree, total], "peak_memory_bytes": peak}


# ---------------------------------------------------------------------
# phase 6: the two decode routes at full depth, bf16 against f32
# ---------------------------------------------------------------------

def _route_tables(torch, lens, steps, bs):
    """Block tables for one paged prefill of every prompt plus ``steps``
    decode positions: row r owns consecutive fresh blocks, the rest of
    its row is the dummy block 0."""
    need = [-(-(n + steps) // bs) for n in lens]
    mb = max(need)
    bt = torch.zeros(len(lens), mb, dtype=torch.int32)
    nxt = 1
    for r, n in enumerate(need):
        bt[r, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        nxt += n
    return bt, nxt


def _route_run(torch, model, pool, bt, lens, first, route, kernels,
               forced=None):
    """ROUTE_STEPS paged_decode_steps through ``route``'s kernel from the
    tokens ``first`` [R]: fed ``forced`` [steps, R] when given, else each
    step's own argmax. Checks the launches; returns (logits [steps, R, V],
    the tokens fed [steps, R])."""
    L = model.cfg.num_layers
    os.environ["DLI_FUSED_DECODE"] = "1" if route == "fused" else "0"
    for mod, name in kernels.values():
        setattr(getattr(mod, name), "launches", 0)
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    cur, logits, fed = first, [], []
    try:
        with torch.inference_mode():
            for t in range(ROUTE_STEPS):
                cur = cur if forced is None else forced[t]
                lg, _ = model.paged_decode_step(cur, pool, bt, cl)
                logits.append(lg)
                fed.append(cur)
                cur, cl = lg.argmax(-1), cl + 1
    finally:
        os.environ.pop("DLI_FUSED_DECODE", None)
    launches = {k: getattr(mod, name).launches
                for k, (mod, name) in kernels.items()}
    mine = "fused_decode_step" if route == "fused" else "paged_flash_decode"
    want = {k: (L * ROUTE_STEPS if k == mine else 0) for k in launches}
    assert launches == want, f"{route}: launches {launches} != {want}"
    return torch.stack(logits), torch.stack(fed)


def phase_route_depth(torch, kernels):
    """Phase 5's eight prompts through full-depth llama-3-8b with one set
    of random weights held in bf16 and, widened, in f32: one paged
    prefill, then ROUTE_STEPS paged decode steps through the paged kernel
    in f32 (greedy), and through each decode kernel in bf16 fed the same
    tokens. Per row and step it reports the f32 top-1/top-2 logit gap,
    each bf16 route's largest logit error against f32 and whether its
    argmax agrees. The bf16 prefill's error against f32 (no decode
    kernel in it) is the yardstick of bf16 rounding at this depth."""
    from distributed_llm_inferencing_tpu_torch.models.params import (
        init_params)
    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.models.transformer import (
        Transformer)
    from distributed_llm_inferencing_tpu_torch.ops.paged_kvcache import (
        PagedKVCache, init_paged_cache)
    cfg, bs = get_config("llama-3-8b"), 16
    prompts = [b["prompt_tokens"] for b in _batched_bodies(cfg)]
    lens = [len(p) for p in prompts]
    R = len(prompts)
    bt, nb = _route_tables(torch, lens, ROUTE_STEPS, bs)
    tokens = torch.zeros(R, bt.shape[1] * bs, dtype=torch.long)
    for r, p in enumerate(prompts):
        tokens[r, :len(p)] = torch.tensor(p)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(21),
                         "cuda")
    models = {"bf16": Transformer(cfg, params),
              "f32": Transformer(cfg.replace(dtype="float32"),
                                 {k: t.float() for k, t in params.items()})}
    i32 = dict(dtype=torch.int32, device="cuda")
    bt = bt.cuda()
    pools, prefill = {}, {}
    with torch.inference_mode():
        for name, model in models.items():
            pools[name] = init_paged_cache(model.cfg, nb, bs, device="cuda")
            prefill[name], _ = model.paged_prefill_tail(
                tokens.cuda(), torch.tensor(lens, **i32), bt,
                torch.zeros(R, 1, **i32), torch.zeros(R, **i32), pools[name])
    first = prefill["f32"].argmax(-1)
    ref, fed = _route_run(torch, models["f32"], pools["f32"], bt, lens,
                          first, "paged", kernels)
    runs = {}
    for route in ("paged", "fused"):
        pool = PagedKVCache(pools["bf16"].k.clone(), pools["bf16"].v.clone())
        runs[route], _ = _route_run(torch, models["bf16"], pool, bt, lens,
                                    first, route, kernels, forced=fed)
        del pool
    for t in (ref, *runs.values(), *prefill.values()):
        assert torch.isfinite(t).all(), "full-depth logits are not finite"
    top2 = ref.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]                         # [steps, R]
    amax = ref.argmax(-1)
    out = {"prompt_tokens": lens, "steps": ROUTE_STEPS,
           "prefill_err_bf16": (prefill["bf16"] - prefill["f32"]).abs()
           .amax(-1).tolist(),
           "prefill_argmax_agree": int((prefill["bf16"].argmax(-1)
                                        == first).sum()),
           "logit_std_f32": float(ref.std(-1).mean()),
           "gap_f32": gap.tolist()}
    for route, lg in runs.items():
        out[f"err_{route}"] = (lg - ref).abs().amax(-1).tolist()
        out[f"argmax_agree_{route}"] = int((lg.argmax(-1) == amax).sum())
        # an argmax can flip only where the f32 gap is under twice the
        # route's largest error
        out[f"rows_gap_under_2x_err_{route}"] = int(
            (gap < 2 * (lg - ref).abs().amax(-1)).sum())
    out["argmax_agree_paged_fused"] = int(
        (runs["paged"].argmax(-1) == runs["fused"].argmax(-1)).sum())
    per_row = ("prefill_err_bf16", "gap_f32", "err_paged", "err_fused")
    for key in per_row:
        log(f"  {key}: {json.dumps(out[key])}")
    log("  route summary", json.dumps(
        {k: v for k, v in out.items() if k not in per_row}))
    # both routes stay within bf16 rounding at this depth, as the prefill
    # measures it: a kernel fault at depth would not
    bound = ROUTE_ERR_FACTOR * max(out["prefill_err_bf16"])
    worst = {r: max(map(max, out[f"err_{r}"])) for r in runs}
    assert all(e <= bound for e in worst.values()), \
        f"bf16 decode logits off f32 by {worst}, over {bound}"
    del models, params, pools, prefill, runs, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from distributed_llm_inferencing_tpu_torch.ops import build
        from distributed_llm_inferencing_tpu_torch.ops import (
            flash_attention as fa, fused_decode as fd, paged_attention as pa)
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")

    log("phase 1: build")
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"  built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  [{name}] {line.strip()}")

    log("phase 2: kernels against their plain versions")
    pre, dec = phase_kernels(torch, fa)
    paged, fused = phase_paged_kernels(torch, pa, fd)

    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    q4 = int4_bounds(get_config("llama-3-8b"))
    log("  bounds of the kernels not ported yet (llama-3-8b int4 shapes):",
        json.dumps(q4))

    log("phase 3: engine path (worker, llama-3-8b bf16, 3 requests)")
    launches, rows, peak = phase_main_path(torch, fa)
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the engine path"

    log("phase 4: card vs host cross-check")
    xerr = phase_cross_check(torch, fa)

    log("phase 5: batched path (worker, llama-3-8b bf16, 8 concurrent "
        "requests, paged then fused decode)")
    batched = phase_batched(torch, {
        "flash_attention": (fa, "flash_attention"),
        "flash_decode": (fa, "flash_decode"),
        "paged_flash_decode": (pa, "paged_flash_decode"),
        "fused_decode_step": (fd, "fused_decode_step")})
    launches["paged_flash_decode"] = \
        batched["paged"]["launches"]["paged_flash_decode"]
    launches["fused_decode_step"] = \
        batched["fused"]["launches"]["fused_decode_step"]

    log("phase 6: both decode routes at full depth, bf16 against f32")
    route_depth = phase_route_depth(torch, {
        "flash_attention": (fa, "flash_attention"),
        "flash_decode": (fa, "flash_decode"),
        "paged_flash_decode": (pa, "paged_flash_decode"),
        "fused_decode_step": (fd, "fused_decode_step")})

    csrc = "distributed_llm_inferencing_tpu_torch/csrc/"
    pallas = "distributed_llm_inferencing_tpu/ops/pallas/"
    kernels = []
    for name, source, replaces, checks in (
            ("flash_attention", "flash_attention.cu",
             "flash_attention.py:115", pre),
            ("flash_decode", "flash_attention.cu", "flash_attention.py:250",
             dec),
            ("paged_flash_decode", "paged_attention.cu",
             "paged_attention.py:87", paged),
            ("fused_decode_step", "fused_decode.cu", "fused_decode.py:193",
             fused)):
        row = checks[0]
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": pallas + replaces, "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["case"],
            "checks": [{"case": r["case"], "max_abs_err": r["max_abs_err"],
                        "ok": r["ok"]} for r in checks],
        })
    report = {"smi": smi, "kernels": kernels, "requests": rows,
              "peak_memory_bytes": peak, "cross_check_max_abs_err": xerr,
              "batched": batched, "route_depth": route_depth,
              "int4_bounds": q4,
              "seconds": time.perf_counter() - t_start}
    out_dir = os.path.join(HERE, "chiprun_out")
    if os.path.isdir(out_dir):
        with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
            json.dump(report, f, indent=1)
    log(f"total {report['seconds']:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
