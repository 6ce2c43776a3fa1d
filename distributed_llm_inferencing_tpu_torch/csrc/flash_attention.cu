// Flash attention (prefill) and flash decode for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   - prefill_kernel <- ops/pallas/flash_attention.py flash_attention
//     (kernel _prefill_kernel): causal attention over the fresh block,
//     positions 0..S-1, optional static window and per-head ALiBi.
//   - decode_kernel  <- ops/pallas/flash_attention.py flash_decode
//     (kernel _decode_kernel): one query token per row against the dense
//     cache, query at lengths[b]-1, the G grouped heads resident.
//
// What bounds them on this card, and what the design does about it:
//   - Prefill is bounded by operations (4*hd*S^2/2 per head). This first
//     version runs the two products on the CUDA cores in f32 (no wgmma
//     yet): one block per (64-row q tile, head, batch) walks the kv tiles
//     from the window's start up to the causal diagonal only, so the
//     upper triangle costs nothing, and keeps m/l/acc in f32 (acc in
//     registers, 8 rows x hd/32 dims per thread).
//   - Decode is bounded by bytes (the K/V rows it must read). One block
//     per (kv head, batch) reads each K/V row once for all G query heads
//     of its group and stops at lengths[b] (the TPU kernel DMAs every tile
//     up to S). At batch 1 that is only Hkv blocks on 132 SMs; splitting
//     the kv axis across blocks (split-KV) is the next step.
//
// Masking and numerics follow the Pallas kernels: scores in f32, scaled,
// then ALiBi slope*(kv - q), then the causal/window mask; online softmax
// with a running max; rows whose denominator is 0 (no admissible key)
// write 0. Inputs are read in their own layout [B, S, H, hd] through the
// strides the caller passes (last dim contiguous, row starts 16-byte
// aligned); no transpose is materialised.
//
// Interface: plain C, pointers and the stream as void*, every launcher
// returns its cudaError_t (0 on success) and allocates nothing.

#include "common.cuh"

namespace {

using dli::kMaxSmem;
using dli::load_tile;
using dli::store_val;
using dli::warp_max;
using dli::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPrefillBQ = 64;     // query rows per prefill block
constexpr int kPrefillBKV = 32;    // keys per prefill kv tile
constexpr int kDecodeBKV = 64;     // keys per decode kv tile

// ---------------------------------------------------------------------
// Prefill: grid (ceil(S/BQ), H, B), kThreads threads.
// ---------------------------------------------------------------------

size_t prefill_smem_bytes(int hd) {
  const int qp = hd + 1;
  return sizeof(float) *
         (size_t)(kPrefillBQ * qp + kPrefillBKV * qp + kPrefillBKV * hd +
                  kPrefillBQ * (kPrefillBKV + 1) + 3 * kPrefillBQ);
}

template <typename T, int HDMAX>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               const float* __restrict__ slopes, int S, int H, int Hkv,
               int hd, long long q_sb, long long q_ss, long long q_sh,
               long long k_sb, long long k_ss, long long k_sh,
               long long v_sb, long long v_ss, long long v_sh,
               long long o_sb, long long o_ss, long long o_sh, float scale,
               int window) {
  constexpr int BQ = kPrefillBQ;
  constexpr int BKV = kPrefillBKV;
  constexpr int PP = BKV + 1;            // probability row pitch
  constexpr int RPW = BQ / kWarps;       // PV rows per warp (8)
  constexpr int DPT = HDMAX / 32;        // PV dims per lane
  extern __shared__ float smem[];
  const int qp = hd + 1;                 // padded pitch: no bank conflicts
  float* Qs = smem;                      // [BQ][qp]
  float* Ks = Qs + BQ * qp;              // [BKV][qp]
  float* Vs = Ks + BKV * qp;             // [BKV][hd]
  float* Ps = Vs + BKV * hd;             // [BQ][PP] scores, then probs
  float* m_s = Ps + BQ * PP;             // [BQ] running max
  float* l_s = m_s + BQ;                 // [BQ] running denominator
  float* a_s = l_s + BQ;                 // [BQ] this tile's rescale

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float slope = slopes != nullptr ? slopes[h] : 0.f;

  load_tile(Qs, qp, q + b * q_sb + q0 * q_ss + h * q_sh, q_ss, BQ,
            min(BQ, S - q0), hd);
  for (int i = tid; i < BQ; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  float acc[RPW][DPT];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[r][e] = 0.f;

  // Causal: keys past the tile's last row never count. Window: keys
  // before (first row - window + 1) never count.
  const int kv_end = min(S, q0 + BQ);
  int kv_begin = 0;
  if (window > 0) {
    kv_begin = max(0, q0 - window + 1);
    kv_begin -= kv_begin % BKV;
  }

  // score micro-tile of this thread: rows sr, sr+1; cols sc + 8*j
  const int sr = (tid >> 3) * 2;
  const int sc = tid & 7;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();   // the previous tile's K/V/P are consumed
    const int valid = min(BKV, S - kv0);
    load_tile(Ks, qp, k + b * k_sb + kv0 * k_ss + kvh * k_sh, k_ss, BKV,
              valid, hd);
    load_tile(Vs, hd, v + b * v_sb + kv0 * v_ss + kvh * v_sh, v_ss, BKV,
              valid, hd);
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float qa = Qs[sr * qp + d];
      const float qb = Qs[(sr + 1) * qp + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kk = Ks[(sc + 8 * j) * qp + d];
        s[0][j] = fmaf(qa, kk, s[0][j]);
        s[1][j] = fmaf(qb, kk, s[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + sr + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = kv0 + sc + 8 * j;
        float val = s[i][j] * scale;
        if (slopes != nullptr) val += slope * (float)(kj - qi);
        const bool ok = kj <= qi && (window <= 0 || qi - kj < window);
        Ps[(sr + i) * PP + sc + 8 * j] = ok ? val : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: four threads per row, eight columns each
    {
      const int r = tid >> 2, part = tid & 3;
      float* prow = Ps + r * PP + part * 8;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = expf(prow[c] - m_use);   // masked: exp(-inf) = 0
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_use);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V; warp owns rows warp*RPW.., lane owns
    // dims lane + 32*e
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float alpha = a_s[warp * RPW + r];
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[r][e] *= alpha;
    }
    for (int j = 0; j < BKV; ++j) {
      float vv[DPT];
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const int d = lane + 32 * e;
        vv[e] = d < hd ? Vs[j * hd + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float p = Ps[(warp * RPW + r) * PP + j];
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = warp * RPW + r;
    const int qi = q0 + row;
    if (qi >= S) continue;
    const float l = l_s[row];
    T* orow = out + b * o_sb + qi * o_ss + h * o_sh;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) store_val(orow + d, l > 0.f ? acc[r][e] / l : 0.f);
    }
  }
}

template <typename T, int HDMAX>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           void* out, const void* slopes, int B, int S,
                           int H, int Hkv, int hd, const long long* st,
                           float scale, int window, cudaStream_t stream) {
  auto kern = prefill_kernel<T, HDMAX>;
  const size_t smem = prefill_smem_bytes(hd);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kPrefillBQ - 1) / kPrefillBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<const float*>(slopes), S, H, Hkv, hd, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale,
      window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_prefill(const void* q, const void* k, const void* v,
                             void* out, const void* slopes, int B, int S,
                             int H, int Hkv, int hd, const long long* st,
                             float scale, int window, cudaStream_t stream) {
  if (hd <= 64)
    return launch_prefill<T, 64>(q, k, v, out, slopes, B, S, H, Hkv, hd, st,
                                 scale, window, stream);
  if (hd <= 128)
    return launch_prefill<T, 128>(q, k, v, out, slopes, B, S, H, Hkv, hd,
                                  st, scale, window, stream);
  return launch_prefill<T, 256>(q, k, v, out, slopes, B, S, H, Hkv, hd, st,
                                scale, window, stream);
}

// ---------------------------------------------------------------------
// Decode: grid (Hkv, B), kThreads threads.
// ---------------------------------------------------------------------

size_t decode_smem_bytes(int G, int hd) {
  return sizeof(float) *
         (size_t)(2 * G * hd + kDecodeBKV * (hd + 1) + kDecodeBKV * hd +
                  G * kDecodeBKV + 3 * G);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              const int* __restrict__ lengths,
              const float* __restrict__ slopes, int H, int Hkv, int hd,
              long long q_sb, long long q_sh, long long k_sb, long long k_ss,
              long long k_sh, long long v_sb, long long v_ss, long long v_sh,
              long long o_sb, long long o_sh, float scale, int window) {
  constexpr int BKV = kDecodeBKV;
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int kp = hd + 1;
  float* Qs = smem;                 // [G][hd]
  float* Acc = Qs + G * hd;         // [G][hd]
  float* Ks = Acc + G * hd;         // [BKV][kp]
  float* Vs = Ks + BKV * kp;        // [BKV][hd]
  float* Ps = Vs + BKV * hd;        // [G][BKV]
  float* m_s = Ps + G * BKV;        // [G]
  float* l_s = m_s + G;             // [G]
  float* a_s = l_s + G;             // [G]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lengths[b];       // valid kv slots: [0, len)
  const int qpos = len - 1;

  // the group's G query heads are rows kvh*G .. kvh*G+G-1, stride q_sh
  load_tile(Qs, hd, q + b * q_sb + (long long)kvh * G * q_sh, q_sh, G, G,
            hd);
  for (int i = tid; i < G * hd; i += kThreads) Acc[i] = 0.f;
  for (int i = tid; i < G; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  int kv_begin = 0;
  if (window > 0) {
    kv_begin = max(0, len - window);
    kv_begin -= kv_begin % BKV;
  }

  for (int kv0 = kv_begin; kv0 < len; kv0 += BKV) {
    __syncthreads();
    const int valid = min(BKV, len - kv0);
    load_tile(Ks, kp, k + b * k_sb + kv0 * k_ss + kvh * k_sh, k_ss, BKV,
              valid, hd);
    load_tile(Vs, hd, v + b * v_sb + kv0 * v_ss + kvh * v_sh, v_ss, BKV,
              valid, hd);
    __syncthreads();

    for (int i = tid; i < G * BKV; i += kThreads) {
      const int g = i / BKV, j = i - g * BKV;
      const int kj = kv0 + j;
      const float* qrow = Qs + g * hd;
      const float* krow = Ks + j * kp;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qrow[d], krow[d], s);
      s *= scale;
      if (slopes != nullptr) s += slopes[kvh * G + g] * (float)(kj - qpos);
      const bool ok = kj < len && (window <= 0 || qpos - kj < window);
      Ps[i] = ok ? s : -INFINITY;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {   // one warp per query head
      float* prow = Ps + g * BKV;
      float mx = -INFINITY;
      for (int j = lane; j < BKV; j += 32) mx = fmaxf(mx, prow[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int j = lane; j < BKV; j += 32) {
        const float p = expf(prow[j] - m_use);
        prow[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_use);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd, d = i - g * hd;
      const float* prow = Ps + g * BKV;
      float a = Acc[i] * a_s[g];
      for (int j = 0; j < BKV; ++j) a = fmaf(prow[j], Vs[j * hd + d], a);
      Acc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    const float l = l_s[g];
    store_val(out + b * o_sb + (long long)(kvh * G + g) * o_sh + d,
              l > 0.f ? Acc[i] / l : 0.f);
  }
}

template <typename T>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          void* out, const void* lengths, const void* slopes,
                          int B, int H, int Hkv, int hd, const long long* st,
                          float scale, int window, cudaStream_t stream) {
  auto kern = decode_kernel<T>;
  const size_t smem = decode_smem_bytes(H / Hkv, hd);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<const int*>(lengths), static_cast<const float*>(slopes), H,
      Hkv, hd, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], scale, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides (elements): q b/s/h, k b/s/h,
// v b/s/h, out b/s/h. window <= 0: no window. slopes: [H] f32 or NULL.
int dli_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* out, const void* slopes, int dtype, int B,
                            int S, int H, int Hkv, int hd,
                            const long long* strides, float scale,
                            int window, void* stream) {
  if (hd % 8 != 0 || hd > 256 || hd < 8 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  if (S <= 0 || B <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_prefill<float>(q, k, v, out, slopes, B, S, H, Hkv, hd,
                                   strides, scale, window, st);
  if (dtype == 1)
    return dispatch_prefill<__nv_bfloat16>(q, k, v, out, slopes, B, S, H,
                                           Hkv, hd, strides, scale, window,
                                           st);
  return cudaErrorInvalidValue;
}

// strides (elements): q b/h, k b/s/h, v b/s/h, out b/h. lengths: [B] int32
// on the device (read by the kernel; the host never syncs on it).
int dli_flash_decode_fwd(const void* q, const void* k, const void* v,
                         void* out, const void* lengths, const void* slopes,
                         int dtype, int B, int H, int Hkv, int hd,
                         const long long* strides, float scale, int window,
                         void* stream) {
  if (hd % 8 != 0 || hd > 256 || hd < 8 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_decode<float>(q, k, v, out, lengths, slopes, B, H, Hkv, hd,
                                strides, scale, window, st);
  if (dtype == 1)
    return launch_decode<__nv_bfloat16>(q, k, v, out, lengths, slopes, B, H,
                                        Hkv, hd, strides, scale, window, st);
  return cudaErrorInvalidValue;
}

const char* dli_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
