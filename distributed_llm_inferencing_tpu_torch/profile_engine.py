"""Where an engine-mode request spends its time on the GPU.

    python -m distributed_llm_inferencing_tpu_torch.profile_engine \
        [--model llama-3-8b] [--prompt 500] [--new 32] [--reps 3] \
        [--quantize int8|int4]

Loads the model with random weights (bf16 activations; ``--quantize``
draws the linears as int8 or int4 weights) on the card, then for the
decode step captured as a CUDA graph and run eagerly
(``DLI_CUDA_GRAPHS`` 1 and 0, runtime/graphs.py), in that order on the
same engine: one request to warm up (first-use cuBLAS and kernel
loading; with graphs, the capture, whose time is reported), ``--reps``
timed greedy requests (prefill ms, ms per decode step and decode
tokens/s from CUDA events), then one request under ``torch.profiler``
in a trace shown to hold all of its kernels (ops/trace.py
``bracketed_trace``): device time by kernel, the two attention kernels' time per launch
(``flash_decode``'s split pass and merge together), and the device's
busy share: the request's kernel time over the timed requests' median
prefill + decode ms (one stream, so kernels never overlap; the profiler
itself slows the host and each graph replay, so its own request's wall
time is reported but not divided by), with the q4 kernels' time per
launch in int4. Prints one JSON object. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time


# the kernels of one wrapper call, and the one that counts the calls
Q4_KERNELS = ("q4_mma_kernel<", "q4_matmul_kernel<", "q4_finish_kernel<")
Q4_COUNTED = ("q4_mma_kernel<", "q4_matmul_kernel<")


def per_launch(kernels, names, counted=None):
    """Device time of the kernels (name -> {"device_ms", "calls"}) whose
    names contain one of ``names``, per call of those matching
    ``counted`` (default: all of them)."""
    hit = lambda k, ns: any(n in k for n in ns)  # noqa: E731
    n = sum(v["calls"] for k, v in kernels.items()
            if hit(k, counted or names))
    ms = sum(v["device_ms"] for k, v in kernels.items() if hit(k, names))
    return {"calls": n, "device_ms": ms,
            "us_per_launch": 1e3 * ms / n if n else None}


def _profile(eng, prompt, args):
    """One warm-up request, ``args.reps`` timed ones and one under
    torch.profiler, greedy, through ``eng`` as it is set up now."""
    from distributed_llm_inferencing_tpu_torch.ops.sampling import (
        SamplingParams)
    from distributed_llm_inferencing_tpu_torch.ops.trace import (
        bracketed_trace, kernel_times)
    greedy = SamplingParams.greedy()
    eng.generate([prompt], max_new_tokens=args.new, sampling=greedy)  # warm

    reps = []
    for _ in range(args.reps):
        r = eng.generate([prompt], max_new_tokens=args.new, sampling=greedy)
        reps.append({"prefill_ms": r.prefill_ms, "decode_ms": r.decode_ms,
                     "decode_tokens_per_s": r.decode_tokens_per_s,
                     "ms_per_decode_step": r.decode_ms / max(1, r.steps - 1)})

    def request():
        import torch
        t0 = time.perf_counter()
        r = eng.generate([prompt], max_new_tokens=args.new, sampling=greedy)
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3
    prof, (r, wall_ms), _ = bracketed_trace(request)
    kernels = kernel_times(prof)
    device_ms = sum(k["device_ms"] for k in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["device_ms"])[:12]
    return {
        "timed_requests": reps,
        "profiled_request": {
            "wall_ms": wall_ms, "prefill_ms": r.prefill_ms,
            "decode_ms": r.decode_ms,
            "ms_per_decode_step": r.decode_ms / max(1, r.steps - 1),
            "device_kernel_ms": device_ms,
            "device_busy_share": device_ms / statistics.median(
                t["prefill_ms"] + t["decode_ms"] for t in reps),
            "prefill_kernel": per_launch(kernels, ("prefill_kernel<",
                                                   "prefill_mma_kernel<")),
            # flash_decode = its split pass + its merge, per call
            "decode_kernel": per_launch(
                kernels, ("decode_split_kernel<", "decode_combine_kernel<"),
                counted=("decode_split_kernel<",)),
            "q4_kernel": per_launch(kernels, Q4_KERNELS, Q4_COUNTED),
            "top_kernels": [{"name": k[:90], **v} for k, v in top],
        },
    }


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

    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.ops import (
        flash_attention as fa, quant_matmul as qm)
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
    out = {"smi": smi, "model": args.model, "dtype": args.dtype,
           "quantize": args.quantize, "prompt_tokens": args.prompt,
           "new_tokens": args.new, "graphs": {}}
    for mode in ("on", "off"):
        os.environ["DLI_CUDA_GRAPHS"] = "1" if mode == "on" else "0"
        out["graphs"][mode] = _profile(eng, prompt, args)
    os.environ.pop("DLI_CUDA_GRAPHS", None)
    out["capture_s"] = [p.capture_s for p in eng.programs.programs()
                        if p.capture_s is not None]
    out["launches"] = {"flash_attention": fa.flash_attention.launches,
                       "flash_decode": fa.flash_decode.launches,
                       "q4_matmul": qm.q4_matmul.launches,
                       "q4_matmul[mma]": qm.q4_matmul.launches_mma}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
