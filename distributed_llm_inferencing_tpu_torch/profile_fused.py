"""Where the fused decode kernel spends its time, and how its build-time
choices compare, on the GPU.

    python -m distributed_llm_inferencing_tpu_torch.profile_fused \
        [--variants base,cs8,cs16] [--phases]

Builds variants of ``csrc/fused_decode.cu`` with nvcc into
``_build/variants/`` (bf16 and head_dim 128 only, so each builds in
seconds), each the source with one choice changed (``VARIANTS``: the
cluster-size rule forced to one size, the weight ring's depth, the work
item's size or setup cost), and times each at llama-3-8b's width (x
[8, 4096], q weight [4096, 4096], H=32, Hkv=8) in the float, int8 and
int4 forms, at the serving lengths 0/1/15/16/17/300/1000/4096 over a
2048-block pool and at full occupancy (8 x 4096, no block shared):
``torch.profiler`` device time over three input sets round-robin (L2
cold), the variants in turns (v1..vn, then vn..v1), each row checked
against ``fused_decode_step_ref`` within one bf16 ulp. ``--phases`` also
builds the unchanged source with a globaltimer stamp at each phase
boundary of every block (start, A done, B start, C start, each team's
items done, D start, D's merge, end) and reports min/mean/max over the
blocks in µs from the first block's start. Prints one JSON object.
Needs a GPU; the kernels' sources come from this checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import re
import subprocess

SRC_NAME = "fused_decode.cu"
RULE = "  for (int CS = kMaxCS; CS >= 8; --CS) {"
FIT = "if (fit >= (CS > 8 ? Hkv : 1)) {"


def _force_cluster(n):
    return [(RULE, f"  for (int CS = {n}; CS >= {n}; --CS) {{"),
            (FIT, "if (fit >= 1) {")]


def _const(name, old, new):
    return [(f"constexpr int {name} = {old};",
             f"constexpr int {name} = {new};")]


# name -> substitutions in the source
VARIANTS = {
    "base": [],
    "cs8": _force_cluster(8),
    "cs16": _force_cluster(16),
    "stages3": _const("kStages", 4, 3),
    "split512": _const("kSplit", 1024, 512),
    "itemcost64": _const("kItemCost", 128, 64),
}

# globaltimer stamps: (text in the source, stamp index, before/after)
_MARKS = [
    ("  // meta: per-slot key ranges [s_beg, s_len) of phase C\n", 0,
     "before"),
    ("  cluster.sync();   // every block's partial q is complete\n", 1,
     "before"),
    ("  cluster.sync();   // every block's partial q is complete\n", 2,
     "after"),
    ("  cluster.sync();   // q is complete in every block; partials are "
     "dead\n", 3, "after"),
    ("  cluster.sync();   // every worker's partials are complete\n", 5,
     "after"),
    ("  cluster.sync();   // every row's partials are in its owner's "
     "inbox\n", 6, "before"),
    ("  cluster.sync();   // every row's partials are in its owner's "
     "inbox\n", 7, "after"),
]
_PHASES = {0: "start", 1: "A done", 2: "B start", 3: "C start",
           8: "C done, team 0", 9: "C done, team 1", 5: "D start",
           6: "D pushed", 7: "D merge start", 4: "end"}
_STAMP = """__device__ unsigned long long g_stamps[4096 * 12];
__device__ __forceinline__ void stamp(int k) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const int b = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (b < 4096) g_stamps[b * 12 + k] = t;
}
"""


def _slim(src):
    """bf16 only, the head_dim 128 instantiation only (LPK 16)."""
    src = src.replace(
        "if (dtype == 0) return dispatch_form<float>(form, a, st, nullptr);",
        "if (dtype == 0) return cudaErrorInvalidValue;")
    src = src.replace(
        "if (dtype == 0) return dispatch_form<float>(form, a, nullptr, plan);",
        "if (dtype == 0) return cudaErrorInvalidValue;")
    return re.sub(
        r"  if \(chunks <= 2\) return launch<T, FORM, 2, 1>\(a, st, plan\);\n"
        r".*?  return launch<T, FORM, 32, 2>\(a, st, plan\);",
        "  return launch<T, FORM, 16, 1>(a, st, plan);", src, flags=re.S)


def _instrument(src):
    src = src.replace("namespace cg = cooperative_groups;\n",
                      "namespace cg = cooperative_groups;\n" + _STAMP, 1)
    for text, k, where in _MARKS:
        if text not in src:
            raise RuntimeError(f"profile_fused: mark {k} not in the source")
        st = f"  if (threadIdx.x == 0) stamp({k});\n"
        src = src.replace(text, st + text if where == "before"
                          else text + st, 1)
    end = ("      dli::store_val(orow + dd, L > 0.f ? A / L : 0.f);\n"
           "    }\n  }\n}\n")
    if end not in src:
        raise RuntimeError("profile_fused: the kernel's end is not found")
    src = src.replace(end, end[:-2] + "  if (threadIdx.x == 0) stamp(4);\n}\n",
                      1)
    team = "  cluster.sync();   // every worker's partials are complete\n"
    src = src.replace(
        team, "  if (threadIdx.x % kSplitThreads == 0)\n"
        "    stamp(8 + threadIdx.x / kSplitThreads);\n" + team, 1)
    return src.replace(
        "const char* dli_cuda_error_string(int err) {",
        "int dli_read_stamps(void* host) {\n"
        "  return cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n"
        "}\n\nconst char* dli_cuda_error_string(int err) {", 1)


def build_variants(names, phases):
    """Write and compile every variant (one nvcc each, all together);
    returns name -> library path."""
    from distributed_llm_inferencing_tpu_torch.ops import build
    base = open(os.path.join(build.CSRC_DIR, SRC_NAME)).read()
    jobs = {n: VARIANTS[n] for n in names}
    if phases:
        jobs["phases"] = []
    procs = {}
    for name, subs in jobs.items():
        src = _slim(base)
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"profile_fused: {name}: {old!r} is not "
                                   "in the source")
            src = src.replace(old, new)
        if name == "phases":
            src = _instrument(src)
        d = os.path.join(build.BUILD_DIR, "variants", name)
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(build.CSRC_DIR):
            if f.endswith(".cuh"):
                with open(os.path.join(build.CSRC_DIR, f)) as fh:
                    text = fh.read()
                with open(os.path.join(d, f), "w") as fh:
                    fh.write(text)
        with open(os.path.join(d, SRC_NAME), "w") as fh:
            fh.write(src)
        lib = os.path.join(d, "lib.so")
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", lib,
             os.path.join(d, SRC_NAME)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = lib
    return libs


def _load(path):
    lib = ctypes.CDLL(path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dli_fused_decode_fwd.argtypes = [P] * 10 + [I] * 8 + [P, F, I, P]
    lib.dli_fused_decode_fwd.restype = I
    lib.dli_fused_decode_plan.argtypes = [I] * 7 + [P]
    lib.dli_fused_decode_plan.restype = I
    lib.dli_cuda_error_string.argtypes = [I]
    lib.dli_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _cases(torch, g):
    """(shape/form) -> three input sets (x, leaf, k, v, bt, lens, cos,
    sin) at llama-3-8b's width."""
    from distributed_llm_inferencing_tpu_torch.ops import quant as tq
    dev = torch.device("cuda")
    R, D, H, Hkv, hd, bs = 8, 4096, 32, 8, 128, 16
    out = {}
    for shape, lengths, nb, disjoint in (
            ("serve", [0, 1, 15, 16, 17, 300, 1000, 4096], 2048, False),
            ("full", [4096] * 8, 8 * 256 + 1, True)):
        mb = 256
        for form in ("float", "int8", "int4"):
            sets = []
            for _ in range(3):
                k = torch.randn(nb, bs, Hkv, hd, generator=g,
                                device=dev).bfloat16()
                v = torch.randn(nb, bs, Hkv, hd, generator=g,
                                device=dev).bfloat16()
                if disjoint:
                    bt = (torch.randperm(nb - 1, generator=g, device=dev)
                          [:R * mb] + 1).reshape(R, mb)
                else:
                    bt = torch.stack([torch.randperm(
                        nb - 1, generator=g, device=dev)[:mb] + 1
                        for _ in range(R)])
                bt = bt.to(torch.int32)
                lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
                x = torch.randn(R, D, generator=g, device=dev).bfloat16()
                w = torch.randn(D, H * hd, generator=g, device=dev) / 64
                leaf = ({"w": w.bfloat16()} if form == "float" else
                        (tq.quantize_weight if form == "int8"
                         else tq.quantize_weight_int4)(w))
                ang = torch.rand(R, hd // 2, generator=g, device=dev) * 6
                cos = torch.cat([ang.cos()] * 2, -1).contiguous()
                sin = torch.cat([ang.sin()] * 2, -1).contiguous()
                sets.append((x, leaf, k, v, bt, lens, cos, sin))
            out[f"{shape}/{form}"] = sets
    return out


def _device_ms(torch, fns, iters=30):
    """Device ms per call over ``iters`` calls round-robin over ``fns``, in
    a trace shown to hold all of their kernels (ops/trace.py)."""
    from distributed_llm_inferencing_tpu_torch.ops.trace import (
        bracketed_trace, kernel_times)
    it = itertools.cycle(fns)
    for _ in range(3):
        next(it)()

    def calls():
        for _ in range(iters):
            next(it)()
    prof, _, _ = bracketed_trace(calls)
    return sum(k["device_ms"] for k in kernel_times(prof).values()) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_fused: needs a CUDA device")
    from distributed_llm_inferencing_tpu_torch.ops import fused_decode as fd
    names = [n for n in args.variants.split(",") if n]
    libs = build_variants(names, args.phases)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cases = _cases(torch, torch.Generator(device="cuda").manual_seed(1))
    tol = (1e-4, 2 ** -7)   # chip_smoke.py PAGED_BF16_TOL

    def run(lib, sets):
        fd._lib = lib
        calls = [(lambda s=s: fd.fused_decode_step(
            s[0], s[1], s[2], s[3], s[4], s[5], rope_cos=s[6],
            rope_sin=s[7])) for s in sets]
        s = sets[0]
        out = calls[0]()
        ref = fd.fused_decode_step_ref(s[0], s[1], s[2], s[3], s[4], s[5],
                                       rope_cos=s[6], rope_sin=s[7])
        err = (out.float() - ref.float()).abs()
        if not bool((err <= tol[0] + tol[1] * ref.float().abs()).all()):
            raise RuntimeError("profile_fused: a variant disagrees with "
                               "the plain version")
        return _device_ms(torch, calls)

    report = {"smi": smi, "variants": {}, "plans": {}}
    loaded = {n: _load(libs[n]) for n in names}
    for n in names + names[::-1]:          # in turns: v1..vn, vn..v1
        plan = (ctypes.c_int * 5)()
        loaded[n].dli_fused_decode_plan(1, 0, 4096, 32, 8, 128, 256, plan)
        report["plans"][n] = dict(zip(("cluster", "rows_per_group", "teams",
                                       "smem_bytes", "clusters_fit"), plan))
        for cname, sets in cases.items():
            report["variants"].setdefault(n, {}).setdefault(
                cname, []).append(run(loaded[n], sets))
    if args.phases:
        lib = _load(libs["phases"])
        lib.dli_read_stamps.argtypes = [ctypes.c_void_p]
        lib.dli_read_stamps.restype = ctypes.c_int
        buf = (ctypes.c_ulonglong * (4096 * 12))()
        report["phases_us"] = {}
        for cname in ("serve/float", "full/float", "serve/int4"):
            s = cases[cname][0]
            run(lib, cases[cname])
            fd.fused_decode_step(s[0], s[1], s[2], s[3], s[4], s[5],
                                 rope_cos=s[6], rope_sin=s[7])
            torch.cuda.synchronize()
            lib.dli_read_stamps(buf)
            plan = (ctypes.c_int * 5)()
            lib.dli_fused_decode_plan(1, 0, 4096, 32, 8, 128, 256, plan)
            blocks = plan[0] * 8
            st = [[buf[b * 12 + k] for k in range(12)]
                  for b in range(blocks)]
            t0 = min(r[0] for r in st)
            report["phases_us"][cname] = {
                _PHASES[k]: [round(f((r[k] - t0) / 1e3 for r in st), 2)
                             for f in (min, lambda v: sum(v) / blocks, max)]
                for k in (0, 1, 2, 3, 8, 9, 5, 6, 7, 4)}
    fd._lib = None
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
