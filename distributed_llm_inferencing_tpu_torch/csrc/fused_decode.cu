// Fused q projection -> RoPE -> paged flash decode for NVIDIA Hopper
// (sm_90a), float weight form.
//
// Replaces the Pallas TPU kernel of the JAX package
// ops/pallas/fused_decode.py fused_decode_step (kernel _fused_kernel):
// per (slot, kv head), the GEMV of the slot's post-norm hidden row
// x [D] against that kv head's [D, G*hd] column tile of the q weight,
// then rotate-half RoPE from per-slot cos/sin rows (yarn's attn_factor
// already folded in), then paged online-softmax decode over the slot's
// block table (csrc/paged_decode.cuh). q never leaves the SM: it is
// computed into shared memory in f32 and attended from there. The int8
// and int4 weight forms of the TPU kernel are not ported yet (the port
// has no quantized leaves).
//
// What bounds it on this card, and what the design does about it: it is
// bounded by bytes, the q weight (D*H*hd values per layer) plus the K/V
// rows of [0, len) of every slot. One thread block per (kv head, slot),
// as the TPU grid has it, streams its kv head's weight tile (4 MiB at
// llama-3-8b width, bf16) with 16-byte loads: the tile is read once per
// slot, R times per layer in all, of which L2 (50 MB, the whole 32 MiB
// q weight fits) serves the repeats when the slots' blocks run together.
// The GEMV splits D over thread groups and reduces the partial sums in
// shared memory. At R=8 and Hkv=8 that is 64 blocks on 132 SMs.
//
// Interface: plain C, pointers and the stream as void*, the launcher
// returns its cudaError_t (0 on success) and allocates nothing.

#include "paged_decode.cuh"

namespace {

using dli::Chunk;
using dli::kMaxSmem;
using dli::kPagedThreads;
using dli::load_chunk;
using dli::load_tile;
using dli::PoolStrides;

struct Gemv {
  int per_group;   // threads that share one D-slice (one per column chunk)
  int groups;      // D-slices summed in shared memory
};

template <typename T>
Gemv gemv_shape(int ghd) {
  const int nch = ghd / Chunk<T>::N;
  const int per = nch < kPagedThreads ? nch : kPagedThreads;
  return {per, kPagedThreads / per};
}

// grid (Hkv, R), kPagedThreads threads. smem: Qs [G][hd], then a region
// used first by the GEMV (x row [D] + partial sums [groups][G*hd]) and
// then by paged_attend.
template <typename T>
__global__ void __launch_bounds__(kPagedThreads)
fused_decode_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ rope_cos,
                    const float* __restrict__ rope_sin,
                    const T* __restrict__ kpool, const T* __restrict__ vpool,
                    T* __restrict__ out, const int* __restrict__ block_tables,
                    const int* __restrict__ context_lens, int D, int H,
                    int Hkv, int hd, int bs, long long x_sr, long long w_sd,
                    long long cs_sr, long long bt_sr, PoolStrides ks,
                    PoolStrides vs, long long o_sr, long long o_sh,
                    float scale, int window, Gemv gs) {
  constexpr int N = Chunk<T>::N;
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int ghd = G * hd;
  const int kvh = blockIdx.x, r = blockIdx.y;
  const int tid = threadIdx.x;
  float* Qs = smem;                  // [G][hd] projected, rotated q
  float* work = Qs + ghd;
  float* Xs = work;                  // [D] the slot's hidden row
  float* Red = Xs + D;               // [groups][ghd] partial sums

  load_tile(Xs, D, x + r * x_sr, 0, 1, 1, D);
  __syncthreads();

  // q = x @ w[:, kvh*ghd : (kvh+1)*ghd] in f32: thread (grp, c) sums
  // rows d = grp, grp + groups, ... of column chunk c
  const int nch = ghd / N;
  const int grp = tid / gs.per_group, lane_c = tid % gs.per_group;
  if (grp < gs.groups) {
    const T* wt = w + (long long)kvh * ghd;
    for (int c = lane_c; c < nch; c += gs.per_group) {
      float acc[N];
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = 0.f;
      for (int d = grp; d < D; d += gs.groups) {
        float wv[N];
        load_chunk(wt + d * w_sd + c * N, wv);
        const float xv = Xs[d];
#pragma unroll
        for (int j = 0; j < N; ++j) acc[j] = fmaf(xv, wv[j], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < N; ++j) Red[grp * ghd + c * N + j] = acc[j];
    }
  }
  __syncthreads();
  for (int i = tid; i < ghd; i += kPagedThreads) {   // column i: one owner
    float s = Red[i];
    for (int g = 1; g < gs.groups; ++g) s += Red[g * ghd + i];
    Red[i] = s;
  }
  __syncthreads();

  // rotate-half RoPE: q*cos + concat(-q[hd/2:], q[:hd/2])*sin
  const int half = hd / 2;
  for (int i = tid; i < ghd; i += kPagedThreads) {
    const int e = i % hd;
    float v = Red[i];
    if (rope_cos != nullptr) {
      const float rot = e < half ? -Red[i + half] : Red[i - half];
      v = v * rope_cos[r * cs_sr + e] + rot * rope_sin[r * cs_sr + e];
    }
    Qs[i] = v;
  }
  __syncthreads();                   // Red is dead: paged_attend reuses it

  dli::paged_attend<T>(work, Qs, kpool, vpool, ks, vs,
                       block_tables + r * bt_sr, context_lens[r], bs, kvh, G,
                       hd, scale, window,
                       out + r * o_sr + (long long)kvh * G * o_sh, o_sh);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* cos_rows,
                   const void* sin_rows, const void* k, const void* v, void* out,
                   const void* bt, const void* lens, int R, int D, int H,
                   int Hkv, int hd, int bs, const long long* st, float scale,
                   int window, cudaStream_t stream) {
  auto kern = fused_decode_kernel<T>;
  const int G = H / Hkv;
  const int ghd = G * hd;
  const Gemv gs = gemv_shape<T>(ghd);
  const size_t gemv = (size_t)D + (size_t)gs.groups * ghd;
  const size_t attend = dli::paged_attend_smem_floats(G, hd);
  const size_t smem =
      sizeof(float) * ((size_t)ghd + (gemv > attend ? gemv : attend));
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, R);
  kern<<<grid, kPagedThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(cos_rows),
      static_cast<const float*>(sin_rows),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<const int*>(bt), static_cast<const int*>(lens), D, H, Hkv,
      hd, bs, st[0], st[1], st[2], st[3], PoolStrides{st[4], st[5], st[6]},
      PoolStrides{st[7], st[8], st[9]}, st[10], st[11], scale, window, gs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w, pools, out). rope_cos/rope_sin:
// [R, hd] f32 or both NULL (no RoPE). strides (elements): x r, w d (row),
// cos/sin r, block_tables r, k pool b/s/h, v pool b/s/h, out r/h.
// block_tables [R, MB] and context_lens [R] are int32 on the device.
// window <= 0: no window.
int dli_fused_decode_fwd(const void* x, const void* w, const void* rope_cos,
                         const void* rope_sin, const void* k, const void* v,
                         void* out, const void* block_tables,
                         const void* context_lens, int dtype, int R, int D,
                         int H, int Hkv, int hd, int bs,
                         const long long* strides, float scale, int window,
                         void* stream) {
  if (hd % 8 != 0 || hd > 256 || hd < 8 || H % Hkv != 0 || bs < 1 ||
      D % 8 != 0 || D < 8 || (rope_cos == nullptr) != (rope_sin == nullptr))
    return cudaErrorInvalidValue;
  if (R <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, rope_cos, rope_sin, k, v, out, block_tables,
                         context_lens, R, D, H, Hkv, hd, bs, strides, scale,
                         window, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, rope_cos, rope_sin, k, v, out,
                                 block_tables, context_lens, R, D, H, Hkv, hd,
                                 bs, strides, scale, window, st);
  return cudaErrorInvalidValue;
}

const char* dli_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
