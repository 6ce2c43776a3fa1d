"""Where a batched decode step spends its time on the GPU.

    python -m distributed_llm_inferencing_tpu_torch.profile_batched \
        [--model llama-3-8b] [--slots 8] [--new 32] [--reps 2] \
        [--quantize int8|int4]

Builds a ``ContinuousBatcher`` on the card (random weights, bf16
activations, ``--quantize`` for int8 or int4 linears; 1024
blocks of 16, max_seq 4096) and drives it synchronously: all requests
are queued, one admission wave fills every slot, and one ``step()`` then
decodes all of them together in one chunk. For each decode route
(``paged``: ``paged_flash_decode``; ``fused``: ``fused_decode_step`` with
``DLI_FUSED_DECODE=1``), and in it for the decode step captured as a
CUDA graph and run eagerly (``DLI_CUDA_GRAPHS`` 1 then 0,
runtime/graphs.py; the batcher captures at construction, as the worker's
load does, and the capture time is reported), it runs one warm-up
round, ``--reps`` timed rounds (admission wave ms, decode chunk ms per
weight pass, decode tokens per weight pass), and one round with the
decode chunk under ``torch.profiler`` (in a trace shown to hold all of
its kernels, ops/trace.py ``bracketed_trace``, the round's admission
run again before each trace taken): device time by kernel, its sum
per weight pass, and the device's busy share: that sum over the timed
rounds' median ms per weight pass (one stream, so kernels never overlap;
the profiler itself slows the host and each graph replay, so its own
round's wall time is reported but not divided by), the attention
kernel's time per launch (for
``paged_flash_decode`` its split pass and merge together) and the q4
kernels' in int4.
Prints one JSON object. Needs a GPU.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import time

from distributed_llm_inferencing_tpu_torch.profile_engine import (
    Q4_COUNTED, Q4_KERNELS, per_launch)

PROMPT_LENS = (60, 130, 250, 500, 300, 400, 700, 1000)


def _admit(b, prompts, new, sp):
    """Queue every prompt and admit them in one wave: (requests, ms)."""
    import torch
    reqs = [b.submit(p, max_new_tokens=new, sampling=sp, seed=i)
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    with torch.inference_mode():
        b._admit_wave()
    torch.cuda.synchronize()
    return reqs, (time.perf_counter() - t0) * 1e3


def _chunk(b, reqs, admit_ms):
    """Decode the admitted requests in one chunk: the round's numbers."""
    import torch
    t1 = time.perf_counter()
    b.step()                          # one decode chunk for every slot
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    assert all(r.done.is_set() for r in reqs), "one chunk must finish them"
    passes = max(r.cost["weight_passes"] for r in reqs)
    chunk_ms = (t2 - t1) * 1e3
    return {"admit_wave_ms": admit_ms, "decode_chunk_ms": chunk_ms,
            "weight_passes": passes,
            "ms_per_weight_pass": chunk_ms / passes,
            "decode_tokens_per_weight_pass":
                sum(len(r.tokens) - 1 for r in reqs) / passes}


def _round(b, prompts, new, sp):
    return _chunk(b, *_admit(b, prompts, new, sp))


def _profile(b, prompts, new, sp, reps):
    """One warm-up round, ``reps`` timed ones and one with the decode
    chunk under torch.profiler, through ``b`` as it is set up now."""
    from distributed_llm_inferencing_tpu_torch.ops.trace import (
        bracketed_trace, kernel_times)
    _round(b, prompts, new, sp)                                # warm-up
    timed = [_round(b, prompts, new, sp) for _ in range(reps)]
    admitted = []

    def setup():
        admitted[:] = [_admit(b, prompts, new, sp)]
    prof, prof_round, _ = bracketed_trace(
        lambda: _chunk(b, *admitted[0]), setup=setup)
    kernels = kernel_times(prof)
    device_ms = sum(k["device_ms"] for k in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["device_ms"])
    per_pass = device_ms / prof_round["weight_passes"]
    return {
        "timed_rounds": timed,
        "device_ms_per_weight_pass": per_pass,
        "device_busy_share": per_pass / statistics.median(
            r["ms_per_weight_pass"] for r in timed),
        "profiled_round": {
            **prof_round, "device_kernel_ms": device_ms,
            # paged_flash_decode = its split pass + its merge, per call;
            # fused_decode_step = one cluster kernel per call
            "attention_kernel": per_launch(
                kernels, ("paged_split_kernel", "paged_combine_kernel",
                          "fused_cluster_kernel"),
                counted=("paged_split_kernel", "fused_cluster_kernel")),
            "q4_kernel": per_launch(kernels, Q4_KERNELS, Q4_COUNTED),
            "top_kernels": [{"name": k[:90], **v} for k, v in top[:12]]},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="llama-3-8b")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--quantize", choices=("int8", "int4"), default=None)
    args = ap.parse_args(argv)

    import torch

    from distributed_llm_inferencing_tpu_torch.models.registry import (
        get_config)
    from distributed_llm_inferencing_tpu_torch.ops.sampling import (
        SamplingParams)
    from distributed_llm_inferencing_tpu_torch.runtime.batcher import (
        ContinuousBatcher)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = get_config(args.model).replace(quant=args.quantize)
    prompts = [[(i * 7919 + j * 104729) % 30000 + 3 for j in range(n)]
               for i, n in enumerate(PROMPT_LENS[:args.slots])]
    sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.95)
    out = {"smi": smi, "model": args.model, "quantize": args.quantize,
           "slots": args.slots,
           "prompt_tokens": list(PROMPT_LENS[:args.slots]),
           "new_tokens": args.new, "routes": {}}
    for route in ("paged", "fused"):
        os.environ["DLI_FUSED_DECODE"] = "1" if route == "fused" else "0"
        os.environ["DLI_CUDA_GRAPHS"] = "1"
        # chunked prefill off: the whole wave admits in one step
        b = ContinuousBatcher(cfg, num_blocks=1024, block_size=16,
                              slots=args.slots, max_seq=4096,
                              prefill_chunk=None, device="cuda")
        b.warm_decode_programs()
        out["routes"][route] = {"graphs": {}, "capture_s": [
            p.capture_s for p in b.programs.programs()]}
        for mode in ("on", "off"):
            os.environ["DLI_CUDA_GRAPHS"] = "1" if mode == "on" else "0"
            out["routes"][route]["graphs"][mode] = _profile(
                b, prompts, args.new, sp, args.reps)
        b.stop()
        del b
        gc.collect()
        torch.cuda.empty_cache()
    os.environ.pop("DLI_CUDA_GRAPHS", None)
    os.environ.pop("DLI_FUSED_DECODE", None)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
