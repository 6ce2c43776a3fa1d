// Fused q projection -> RoPE -> paged flash decode for NVIDIA Hopper
// (sm_90a), in the float, int8 and int4 weight forms.
//
// Replaces the Pallas TPU kernel of the JAX package
// ops/pallas/fused_decode.py fused_decode_step (kernel _fused_kernel):
// per (slot, kv head), the GEMV of the slot's post-norm hidden row
// x [D] against that kv head's [D, G*hd] column tile of the q weight,
// then rotate-half RoPE from per-slot cos/sin rows (yarn's attn_factor
// already folded in), then paged online-softmax decode over the slot's
// block table (csrc/paged_decode.cuh). q never leaves the SM: it is
// computed into shared memory in f32 and attended from there.
//
// Weight forms (ops/quant.py layouts): float (x's dtype); int8 levels
// [D, H*hd] with a per-output-channel f32 scale; int4 split-half biased
// nibbles [D/2, H*hd] (byte row i: din row i low, row i + D/2 high) with
// the same scale. The quantized tile is read in its stored form, 8
// columns per 8-byte load, and its levels are made in registers, exactly
// (common.cuh int8_level / int4_level: every nibble sign-extended, as the
// TPU kernel does for every dtype); no dequantized weight is written
// anywhere. The f32 sums are multiplied by the scale once per column,
// before RoPE (the TPU kernel's order).
//
// What bounds it on this card, and what the design does about it: it is
// bounded by bytes, the q weight (D*H*hd values per layer: 2 or 4 bytes
// each in the float form, 1 in int8, 1/2 in int4) plus the K/V
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
using dli::int4_level;
using dli::int8_level;
using dli::kMaxSmem;
using dli::kPagedThreads;
using dli::load_chunk;
using dli::load_tile;
using dli::PoolStrides;

enum WForm { kFloat = 0, kInt8 = 1, kInt4 = 2 };

// weight columns per load: one 16-byte chunk of T, or 8 quantized bytes
template <typename T, int FORM>
__host__ __device__ constexpr int wcols() {
  return FORM == kFloat ? Chunk<T>::N : 8;
}

struct Gemv {
  int per_group;   // threads that share one D-slice (one per column chunk)
  int groups;      // D-slices summed in shared memory
};

template <typename T, int FORM>
Gemv gemv_shape(int ghd) {
  const int nch = ghd / wcols<T, FORM>();
  const int per = nch < kPagedThreads ? nch : kPagedThreads;
  return {per, kPagedThreads / per};
}

// grid (Hkv, R), kPagedThreads threads. smem: Qs [G][hd], then a region
// used first by the GEMV (x row [D] + partial sums [groups][G*hd]) and
// then by paged_attend.
template <typename T, int FORM>
__global__ void __launch_bounds__(kPagedThreads)
fused_decode_kernel(const T* __restrict__ x, const void* __restrict__ w,
                    const float* __restrict__ wscale,
                    const float* __restrict__ rope_cos,
                    const float* __restrict__ rope_sin,
                    const T* __restrict__ kpool, const T* __restrict__ vpool,
                    T* __restrict__ out, const int* __restrict__ block_tables,
                    const int* __restrict__ context_lens, int D, int H,
                    int Hkv, int hd, int bs, long long x_sr, long long w_sd,
                    long long cs_sr, long long bt_sr, PoolStrides ks,
                    PoolStrides vs, long long o_sr, long long o_sh,
                    float scale, int window, Gemv gs) {
  constexpr int N = wcols<T, FORM>();
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
  // weight rows d = grp, grp + groups, ... of column chunk c (int4: byte
  // rows of D/2, each feeding x[d] and x[d + D/2])
  const int nch = ghd / N;
  const int wrows = FORM == kInt4 ? D / 2 : D;
  const int grp = tid / gs.per_group, lane_c = tid % gs.per_group;
  if (grp < gs.groups) {
    for (int c = lane_c; c < nch; c += gs.per_group) {
      float acc[N];
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = 0.f;
      const long long col = (long long)kvh * ghd + c * N;
      for (int d = grp; d < wrows; d += gs.groups) {
        const float xv = Xs[d];
        if constexpr (FORM == kFloat) {
          float wv[N];
          load_chunk(static_cast<const T*>(w) + d * w_sd + col, wv);
#pragma unroll
          for (int j = 0; j < N; ++j) acc[j] = fmaf(xv, wv[j], acc[j]);
        } else {
          const uint2 raw = *reinterpret_cast<const uint2*>(
              static_cast<const uint8_t*>(w) + d * w_sd + col);
          const float xh = FORM == kInt4 ? Xs[d + wrows] : 0.f;
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const uint32_t word = j < 4 ? raw.x : raw.y;
            const int sh = 8 * (j % 4);
            if constexpr (FORM == kInt8) {
              acc[j] = fmaf(xv, int8_level(word, sh), acc[j]);
            } else {
              acc[j] = fmaf(xv, int4_level(word, sh), acc[j]);
              acc[j] = fmaf(xh, int4_level(word, sh + 4), acc[j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < N; ++j) Red[grp * ghd + c * N + j] = acc[j];
    }
  }
  __syncthreads();
  for (int i = tid; i < ghd; i += kPagedThreads) {   // column i: one owner
    float s = Red[i];
    for (int g = 1; g < gs.groups; ++g) s += Red[g * ghd + i];
    Red[i] = FORM == kFloat ? s : s * wscale[kvh * ghd + i];
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

template <typename T, int FORM>
cudaError_t launch(const void* x, const void* w, const void* wscale,
                   const void* cos_rows, const void* sin_rows, const void* k,
                   const void* v, void* out, const void* bt, const void* lens,
                   int R, int D, int H, int Hkv, int hd, int bs,
                   const long long* st, float scale, int window,
                   cudaStream_t stream) {
  auto kern = fused_decode_kernel<T, FORM>;
  const int G = H / Hkv;
  const int ghd = G * hd;
  const Gemv gs = gemv_shape<T, FORM>(ghd);
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
      static_cast<const T*>(x), w, static_cast<const float*>(wscale),
      static_cast<const float*>(cos_rows),
      static_cast<const float*>(sin_rows),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<const int*>(bt), static_cast<const int*>(lens), D, H, Hkv,
      hd, bs, st[0], st[1], st[2], st[3], PoolStrides{st[4], st[5], st[6]},
      PoolStrides{st[7], st[8], st[9]}, st[10], st[11], scale, window, gs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_form(int form, const void* x, const void* w,
                        const void* wscale, const void* cos_rows,
                        const void* sin_rows, const void* k, const void* v,
                        void* out, const void* bt, const void* lens, int R,
                        int D, int H, int Hkv, int hd, int bs,
                        const long long* st, float scale, int window,
                        cudaStream_t stream) {
  if (form == kFloat)
    return launch<T, kFloat>(x, w, wscale, cos_rows, sin_rows, k, v, out, bt,
                             lens, R, D, H, Hkv, hd, bs, st, scale, window,
                             stream);
  if (form == kInt8)
    return launch<T, kInt8>(x, w, wscale, cos_rows, sin_rows, k, v, out, bt,
                            lens, R, D, H, Hkv, hd, bs, st, scale, window,
                            stream);
  if (form == kInt4)
    return launch<T, kInt4>(x, w, wscale, cos_rows, sin_rows, k, v, out, bt,
                            lens, R, D, H, Hkv, hd, bs, st, scale, window,
                            stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, pools, out; w in the float form).
// form: 0 = float w [D, H*hd]; 1 = int8 q [D, H*hd] + wscale [H*hd] f32;
// 2 = int4 p4 [D/2, H*hd] uint8 + wscale. Quantized rows are read 8 bytes
// at a time (8-byte aligned row starts). rope_cos/rope_sin: [R, hd] f32
// or both NULL (no RoPE). strides (elements): x r, w d (row), cos/sin r,
// block_tables r, k pool b/s/h, v pool b/s/h, out r/h. block_tables
// [R, MB] and context_lens [R] are int32 on the device. window <= 0: no
// window.
int dli_fused_decode_fwd(const void* x, const void* w, const void* wscale,
                         const void* rope_cos, const void* rope_sin,
                         const void* k, const void* v, void* out,
                         const void* block_tables, const void* context_lens,
                         int dtype, int form, int R, int D, int H, int Hkv,
                         int hd, int bs, const long long* strides,
                         float scale, int window, void* stream) {
  if (hd % 8 != 0 || hd > 256 || hd < 8 || H % Hkv != 0 || bs < 1 ||
      D % 8 != 0 || D < 8 || (rope_cos == nullptr) != (rope_sin == nullptr) ||
      (form != kFloat && wscale == nullptr))
    return cudaErrorInvalidValue;
  if (R <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_form<float>(form, x, w, wscale, rope_cos, rope_sin, k, v,
                              out, block_tables, context_lens, R, D, H, Hkv,
                              hd, bs, strides, scale, window, st);
  if (dtype == 1)
    return launch_form<__nv_bfloat16>(form, x, w, wscale, rope_cos, rope_sin,
                                      k, v, out, block_tables, context_lens,
                                      R, D, H, Hkv, hd, bs, strides, scale,
                                      window, st);
  return cudaErrorInvalidValue;
}

const char* dli_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
