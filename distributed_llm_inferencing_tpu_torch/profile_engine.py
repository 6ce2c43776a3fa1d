"""Where an engine-mode request spends its time on the GPU.

    python -m distributed_llm_inferencing_tpu_torch.profile_engine \
        [--model llama-3-8b] [--prompt 500] [--new 32] [--reps 3] \
        [--quantize int8|int4]

Loads the model with random weights (bf16 activations; ``--quantize``
draws the linears as int8 or int4 weights) on the card, runs one request
to warm up (first-use cuBLAS and kernel loading), then ``--reps`` timed
greedy requests (prefill ms and decode tokens/s from CUDA events), then
one request under ``torch.profiler``: device time by kernel, the two
attention kernels' time per launch, and the device's busy share of the
decode wall time (sum of kernel time over wall time; one stream, so
kernels never overlap), with ``q4_matmul``'s time per launch in int4.
Prints one JSON object. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="llama-3-8b")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--prompt", type=int, default=500)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--max-seq", type=int, default=4096)
    ap.add_argument("--quantize", choices=("int8", "int4"), default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.ops import (
        flash_attention as fa, quant_matmul as qm)
    from distributed_llm_inferencing_tpu_torch.ops.sampling import (
        SamplingParams)
    from distributed_llm_inferencing_tpu_torch.runtime.engine import (
        InferenceEngine)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = get_config(args.model).replace(dtype=args.dtype,
                                         quant=args.quantize)
    eng = InferenceEngine(cfg, max_seq=args.max_seq, device="cuda")
    prompt = [(i * 7919) % 30000 + 3 for i in range(args.prompt)]
    greedy = SamplingParams.greedy()
    eng.generate([prompt], max_new_tokens=args.new, sampling=greedy)  # warm

    reps = []
    for _ in range(args.reps):
        r = eng.generate([prompt], max_new_tokens=args.new, sampling=greedy)
        reps.append({"prefill_ms": r.prefill_ms, "decode_ms": r.decode_ms,
                     "decode_tokens_per_s": r.decode_tokens_per_s,
                     "ms_per_decode_step": r.decode_ms / max(1, r.steps - 1)})

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = eng.generate([prompt], max_new_tokens=args.new, sampling=greedy)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.key and not evt.key.startswith("aten::"):
            kernels[evt.key] = {"device_ms": us / 1e3, "calls": evt.count}
    device_ms = sum(k["device_ms"] for k in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["device_ms"])[:12]

    def per_launch(*names):
        hits = [v for k, v in kernels.items() if any(n in k for n in names)]
        n = sum(v["calls"] for v in hits)
        ms = sum(v["device_ms"] for v in hits)
        return {"calls": n, "device_ms": ms,
                "us_per_launch": 1e3 * ms / n if n else None}

    out = {
        "smi": smi, "model": args.model, "dtype": args.dtype,
        "quantize": args.quantize,
        "prompt_tokens": args.prompt, "new_tokens": args.new,
        "warm_requests": reps,
        "profiled_request": {
            "wall_ms": wall_ms, "prefill_ms": r.prefill_ms,
            "decode_ms": r.decode_ms, "device_kernel_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "prefill_kernel": per_launch("prefill_kernel<",
                                         "prefill_mma_kernel<"),
            "decode_kernel": per_launch("decode_kernel<"),
            "q4_matmul_kernel": per_launch("q4_matmul_kernel<"),
            "q4_finish_kernel": per_launch("q4_finish_kernel<"),
            "top_kernels": [{"name": k[:90], **v} for k, v in top],
        },
        "launches": {"flash_attention": fa.flash_attention.launches,
                     "flash_decode": fa.flash_decode.launches,
                     "q4_matmul": qm.q4_matmul.launches},
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
