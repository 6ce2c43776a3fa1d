// Flash attention (prefill) and flash decode for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   - prefill_kernel <- ops/pallas/flash_attention.py flash_attention
//     (kernel _prefill_kernel): causal attention over the fresh block,
//     positions 0..S-1, optional static window, per-head ALiBi and score
//     softcap.
//   - decode_split_kernel + decode_combine_kernel <-
//     ops/pallas/flash_attention.py flash_decode (kernel _decode_kernel):
//     one query token per row against the dense cache, query at
//     lengths[b]-1, the G grouped heads read each K/V row once.
//
// What bounds them on this card, and what the design does about it:
//   - Prefill is bounded by operations (4*hd*S^2/2 per head; at S=512
//     the bytes come close). Two forms, picked by the wrapper from dtype
//     and hd, never by a failure:
//     * prefill_mma_kernel, bf16 with hd % 16 == 0 (the serving path):
//       both products on the tensor cores, in FlashAttention-2's shape.
//       A block of 4 warps takes 64 q rows, a warp 16; Q is loaded once
//       into registers as mma A fragments (ldmatrix). K/V tiles of 64
//       keys (32 above hd 128, for registers) stream through a
//       two-stage shared-memory ring with 16-byte cp.async, the next
//       tile's copy in flight while the current one is computed; rows
//       are padded by 16 bytes so ldmatrix has no bank conflicts.
//       S = Q.K^T and O += P.V run as mma.sync.m16n8k16 bf16 -> f32 (V
//       through ldmatrix.trans); the online softmax stays on the
//       accumulator fragments (quad shuffles for row max and sum, exp2
//       with scale*log2e folded in), and P goes back into the P.V
//       product as bf16 A fragments without touching shared memory. The
//       causal and window masks run only on the diagonal and window-edge
//       tiles; tiles above the diagonal are never loaded; the flat grid
//       launches the bottom (longest) q tiles first. mma.sync rather
//       than wgmma/TMA: it needs no descriptors or warpgroup
//       choreography, and reaches a large share of the bf16 peak at
//       these tile sizes; wgmma is the next step if the times ask.
//     * prefill_kernel, f32 (and hd not a multiple of 16): the products
//       on the CUDA cores in f32, one block per (64-row q tile, head,
//       batch) walking the kv tiles from the window's start up to the
//       causal diagonal only; the f32 cross-checks run it.
//   - Decode is bounded by bytes (the K/V rows of [max(0, len - window),
//     len) it must read; the TPU kernel DMAs every tile up to S). Those
//     are only fast to read with many SMs each keeping loads in flight,
//     and the engine decodes one row: a grid of (kv head, row) would put
//     8 blocks on 132 SMs. So decode is split_decode.cuh's split-KV
//     design, shared with paged_flash_decode: the grid gains a split axis
//     over the cache's capacity S (the wrapper picks the split length
//     from B, Hkv and S so that the grid has a block per SM; the host
//     never reads the lengths), each split streams 64-key K/V tiles with
//     cp.async into a two-stage ring, q in registers and each K element
//     read from shared memory serving every head of the block, and a
//     fixed-order log-sum-exp merge writes q's dtype.
//
// Masking and numerics follow the Pallas kernels: scores in f32, scaled,
// then the softcap cap * tanh(s / cap) where one is given (the JAX
// package's XLA formulation: its Pallas kernels have no cap; here each
// kernel has a cap arm, a uniform branch on softcap > 0 that leaves the
// uncapped arithmetic and bits as they were; tanhf, applied to the
// scaled score before any log2e folding), then ALiBi slope*(kv - q),
// then the causal/window mask; online softmax
// with a running max; rows whose denominator is 0 (no admissible key)
// write 0. The tensor-core form rounds P to bf16 before P.V (its
// denominator sums the f32 values), as FlashAttention-2 does. Inputs are
// read in their own layout [B, S, H, hd] through the strides the caller
// passes (last dim contiguous, row starts 16-byte aligned); no transpose
// is materialised.
//
// Interface: plain C, pointers and the stream as void*, every launcher
// returns its cudaError_t (0 on success) and allocates nothing.

#include "split_decode.cuh"

namespace {

using dli::kMaxSmem;
using dli::load_tile;
using dli::store_val;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPrefillBQ = 64;     // query rows per prefill block
constexpr int kPrefillBKV = 32;    // keys per prefill kv tile

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
               int window, float softcap) {
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
  const float cap_in = softcap > 0.f ? 1.f / softcap : 0.f;

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
        if (softcap > 0.f) val = tanhf(val * cap_in) * softcap;
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
                           float scale, int window, float softcap,
                           cudaStream_t stream) {
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
      window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_prefill(const void* q, const void* k, const void* v,
                             void* out, const void* slopes, int B, int S,
                             int H, int Hkv, int hd, const long long* st,
                             float scale, int window, float softcap,
                             cudaStream_t stream) {
  if (hd <= 64)
    return launch_prefill<T, 64>(q, k, v, out, slopes, B, S, H, Hkv, hd, st,
                                 scale, window, softcap, stream);
  if (hd <= 128)
    return launch_prefill<T, 128>(q, k, v, out, slopes, B, S, H, Hkv, hd,
                                  st, scale, window, softcap, stream);
  return launch_prefill<T, 256>(q, k, v, out, slopes, B, S, H, Hkv, hd, st,
                                scale, window, softcap, stream);
}

// ---------------------------------------------------------------------
// Prefill on the tensor cores (bf16, hd % 16 == 0): FlashAttention-2's
// shape with mma.sync.m16n8k16. One block of kMmaWarps warps per (64-row
// q tile, head, batch), each warp owning 16 q rows; flat grid, bottom
// (longest) q tiles first.
// ---------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using dli::cp_async_16;
using dli::cp_async_commit;
using dli::cp_async_wait;
using dli::ldsm_x4;
using dli::ldsm_x4_trans;
using dli::mma_bf16_16816;
using dli::pack_bf16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBQ = 16 * kMmaWarps;   // q rows per block

// Keys per K/V tile: 64, or 32 above hd 128 where the warp's registers
// (Q fragments hd/4, O accumulator hd/2, scores BKV/2) run out. Shared
// rows are padded by 16 bytes, so the 8 rows an ldmatrix reads fall in 8
// different 16-byte bank groups.
template <int HD>
struct MmaTile {
  static constexpr int BKV = HD <= 128 ? 64 : 32;
  static constexpr int P = HD + 8;   // row pitch, elements
  static constexpr size_t smem =
      sizeof(bf16) * (size_t)(kMmaBQ * P + 4 * BKV * P);
};

// cp.async `valid` rows of HD values (row r at src + r*stride) into the
// shared tile at `dst` ([ROWS][HD + 8], a shared address); rows >= valid
// are zero-filled and never read. Where the block's threads cover whole
// rows, each thread keeps one chunk column and walks rows by a constant
// step, so a copy costs a few instructions.
template <int HD, int ROWS>
__device__ __forceinline__ void copy_rows(uint32_t dst, const bf16* src,
                                          long long stride, int valid) {
  constexpr int CH = HD / 8, P = HD + 8;
  if constexpr (kMmaThreads % CH == 0 && ROWS % (kMmaThreads / CH) == 0) {
    constexpr int RP = kMmaThreads / CH;   // rows per pass of the block
    const int r0 = threadIdx.x / CH, c = (threadIdx.x % CH) * 8;
    const uint32_t d0 = dst + (r0 * P + c) * 2;
    const bf16* s0 = src + r0 * stride + c;
    const long long step = RP * stride;
#pragma unroll
    for (int j = 0; j < ROWS / RP; ++j) {
      const bool ok = r0 + j * RP < valid;
      cp_async_16(d0 + j * RP * P * 2, ok ? s0 + j * step : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * CH; i += kMmaThreads) {
      const int r = i / CH, c = (i - r * CH) * 8;
      const bool ok = r < valid;
      cp_async_16(dst + (r * P + c) * 2, ok ? src + r * stride + c : src,
                  ok);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out,
                   const float* __restrict__ slopes, int B, int S, int H,
                   int Hkv, long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   long long o_sb, long long o_ss, long long o_sh,
                   float scale_log2, int window, float scale, float softcap) {
  constexpr int BQ = kMmaBQ, BKV = MmaTile<HD>::BKV, P = MmaTile<HD>::P;
  constexpr int KS = HD / 16;    // k-steps of Q.K^T
  constexpr int NT = BKV / 8;    // 8-key column tiles of S
  constexpr int DT = HD / 8;     // 8-wide column tiles of O
  constexpr uint32_t STAGE = BKV * P * 2;   // bytes of one K or V stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Q [BQ][P], then K [2][BKV][P], then V [2][BKV][P] (bf16), as shared
  // addresses
  const uint32_t q_s = dli::smem_u32(smem_raw);
  const uint32_t k_s = q_s + BQ * P * 2;
  const uint32_t v_s = k_s + 2 * STAGE;

  const int heads = H * B;
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / heads);
  const int hb = blockIdx.x % heads;
  const int h = hb % H, b = hb / H;
  const int kvh = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;   // fragment row / column pair
  const float slope = slopes != nullptr ? slopes[h] * dli::kLog2e : 0.f;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;
  // this lane's ldmatrix row addresses: Q/V fragments take rows
  // (lane & 7) + 8 * bit 3 and columns 8 * bit 4; K fragments (two 8-key
  // column tiles at once) rows (lane & 7) + 8 * bit 4, columns 8 * bit 3
  const int lr = lane & 7, b3 = (lane >> 3) & 1, b4 = lane >> 4;
  const uint32_t q_lane = q_s + ((warp * 16 + lr + b3 * 8) * P + b4 * 8) * 2;
  const uint32_t k_lane = ((lr + b4 * 8) * P + b3 * 8) * 2;
  const uint32_t v_lane = ((lr + b3 * 8) * P + b4 * 8) * 2;

  // causal: keys past the tile's last row never count; window: keys
  // before (first row - window + 1) never count
  const int kv_end = min(S, q0 + BQ);
  int kv_begin = 0;
  if (window > 0) {
    kv_begin = max(0, q0 - window + 1);
    kv_begin -= kv_begin % BKV;
  }
  const int n_tiles = (kv_end - kv_begin + BKV - 1) / BKV;

  copy_rows<HD, BQ>(q_s, q + b * q_sb + q0 * q_ss + h * q_sh, q_ss,
                    min(BQ, S - q0));
  copy_rows<HD, BKV>(k_s, kb + kv_begin * k_ss, k_ss, min(BKV, S - kv_begin));
  copy_rows<HD, BKV>(v_s, vb + kv_begin * v_ss, v_ss, min(BKV, S - kv_begin));
  cp_async_commit();

  uint32_t qf[KS][4];          // Q as A fragments, loaded once
  float o[DT][4];              // O accumulator: rows gr and gr + 8
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max (log2 domain)
  float l0 = 0.f, l1 = 0.f;               // this thread's share of l
  const int row0 = q0 + warp * 16 + gr;   // this thread's rows: +0, +8

  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = kv_begin + it * BKV;
    const uint32_t st = (it & 1) * STAGE;
    if (it + 1 < n_tiles) {   // the next tile's copy flies meanwhile
      const int nx = kv0 + BKV;
      copy_rows<HD, BKV>(k_s + (STAGE - st), kb + nx * k_ss, k_ss,
                         min(BKV, S - nx));
      copy_rows<HD, BKV>(v_s + (STAGE - st), vb + nx * v_ss, v_ss,
                         min(BKV, S - nx));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldsm_x4(qf[ks], q_lane + ks * 32);
    }
    const uint32_t kt = k_s + st + k_lane, vt = v_s + st + v_lane;

    // S = Q K^T: K rows are B's columns (ldmatrix without .trans)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kf[4];
        ldsm_x4(kf, kt + (j * 8 * P + ks * 16) * 2);
        mma_bf16_16816(s[j], qf[ks], kf[0], kf[1]);
        mma_bf16_16816(s[j + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // to the log2 domain: x = s * sc, with sc = scale * log2e folded into
    // the exponent below; with ALiBi x = s * scale * log2e + slope * log2e
    // * (kv - q) here and sc = 1; with a softcap (its own arm) x = cap *
    // tanh(s * (scale / cap)) * log2e (+ the ALiBi term) here and sc = 1.
    // The mask only on the diagonal tile and the window's edge tiles.
    float sc = scale_log2;
    if (softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = kv0 + j * 8 + tq * 2 + (e & 1);
          const int qi = row0 + (e >> 1) * 8;
          const float c = tanhf(s[j][e] * cap_in) * softcap;
          s[j][e] = slopes != nullptr
                        ? fmaf(c, dli::kLog2e, slope * (float)(kj - qi))
                        : c * dli::kLog2e;
        }
      sc = 1.f;
    } else if (slopes != nullptr) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = kv0 + j * 8 + tq * 2 + (e & 1);
          const int qi = row0 + (e >> 1) * 8;
          s[j][e] = fmaf(s[j][e], scale_log2, slope * (float)(kj - qi));
        }
      sc = 1.f;
    }
    if (kv0 + BKV - 1 > q0 || (window > 0 && q0 + BQ - 1 - kv0 >= window)) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = kv0 + j * 8 + tq * 2 + (e & 1);
          const int qi = row0 + (e >> 1) * 8;
          if (kj > qi || (window > 0 && qi - kj >= window))
            s[j][e] = -INFINITY;
        }
    }

    // online softmax on the fragments: a row lives in one lane quad
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * sc), mn1 = fmaxf(m1, mx1 * sc);
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;   // exp2(-inf) = 0
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    const float a0 = dli::fast_exp2(m0 - mu0), a1 = dli::fast_exp2(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = dli::fast_exp2(fmaf(s[j][0], sc, -mu0));
      s[j][1] = dli::fast_exp2(fmaf(s[j][1], sc, -mu0));
      s[j][2] = dli::fast_exp2(fmaf(s[j][2], sc, -mu1));
      s[j][3] = dli::fast_exp2(fmaf(s[j][3], sc, -mu1));
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= a0;
      o[d][1] *= a0;
      o[d][2] *= a1;
      o[d][3] *= a1;
    }

    // O += P V: P's accumulator fragments are A fragments once packed to
    // bf16; V rows are B's rows (ldmatrix .trans)
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vt + (kk * 16 * P + d * 8) * 2);
        mma_bf16_16816(o[d], pa, vf[0], vf[1]);
        mma_bf16_16816(o[d + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = row0 + half * 8;
    if (qi >= S) continue;
    const float l = half ? l1 : l0;
    bf16* orow = out + b * o_sb + qi * o_ss + h * o_sh + tq * 2;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const float x0 = l > 0.f ? o[d][2 * half] / l : 0.f;
      const float x1 = l > 0.f ? o[d][2 * half + 1] / l : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

template <int HD>
cudaError_t launch_prefill_mma(const void* q, const void* k, const void* v,
                               void* out, const void* slopes, int B, int S,
                               int H, int Hkv, const long long* st,
                               float scale, int window, float softcap,
                               cudaStream_t stream) {
  auto kern = prefill_mma_kernel<HD>;
  const size_t smem = MmaTile<HD>::smem;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)((S + kMmaBQ - 1) / kMmaBQ) * H * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<const float*>(slopes), B, S, H, Hkv, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale * dli::kLog2e, window, scale, softcap);
  return cudaGetLastError();
}

#define DLI_PREFILL_MMA_CASE(HD)                                           \
  case HD:                                                                 \
    return launch_prefill_mma<HD>(q, k, v, out, slopes, B, S, H, Hkv, st,  \
                                  scale, window, softcap, stream);

cudaError_t dispatch_prefill_mma(const void* q, const void* k, const void* v,
                                 void* out, const void* slopes, int B, int S,
                                 int H, int Hkv, int hd, const long long* st,
                                 float scale, int window, float softcap,
                                 cudaStream_t stream) {
  switch (hd) {
    DLI_PREFILL_MMA_CASE(16)
    DLI_PREFILL_MMA_CASE(32)
    DLI_PREFILL_MMA_CASE(48)
    DLI_PREFILL_MMA_CASE(64)
    DLI_PREFILL_MMA_CASE(80)
    DLI_PREFILL_MMA_CASE(96)
    DLI_PREFILL_MMA_CASE(112)
    DLI_PREFILL_MMA_CASE(128)
    DLI_PREFILL_MMA_CASE(144)
    DLI_PREFILL_MMA_CASE(160)
    DLI_PREFILL_MMA_CASE(176)
    DLI_PREFILL_MMA_CASE(192)
    DLI_PREFILL_MMA_CASE(208)
    DLI_PREFILL_MMA_CASE(224)
    DLI_PREFILL_MMA_CASE(240)
    DLI_PREFILL_MMA_CASE(256)
  }
  return cudaErrorInvalidValue;
}

#undef DLI_PREFILL_MMA_CASE

// ---------------------------------------------------------------------
// Decode: split_decode.cuh's split-KV pass and merge over the dense cache
// (row r's key t at k + r*k_sb + t*k_ss), under kernel names of their own.
// ---------------------------------------------------------------------

using dli::kCombineWarps;
using dli::kSplitHeads;
using dli::kSplitThreads;
using dli::PoolStrides;

// grid (Hkv * ceil(G / kSplitHeads), B, NS)
template <typename T, int LPK, int CPL>
__global__ void __launch_bounds__(kSplitThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ part,
                    const int* __restrict__ lengths,
                    const float* __restrict__ slopes, int H, int Hkv, int hd,
                    int split, int NS, long long q_sb, long long q_sh,
                    PoolStrides ks, PoolStrides vs, float scale_log2,
                    int window, float scale, float softcap) {
  dli::split_attend<T, LPK, CPL, false>(
      q, k, v, part, nullptr, lengths, slopes, H, Hkv, hd, 1, split, NS,
      q_sb, q_sh, 0, ks, vs, scale_log2, window, scale, softcap);
}

// grid B*H
template <typename T>
__global__ void __launch_bounds__(32 * kCombineWarps)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                      const int* __restrict__ lengths, int B, int H, int hd,
                      int split, int NS, long long o_sb, long long o_sh,
                      int window) {
  dli::split_combine<T>(part, out, lengths, B, H, hd, split, NS, o_sb, o_sh,
                        window);
}

template <typename T, int LPK, int CPL>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          void* out, const void* lengths, const void* slopes,
                          void* part, int B, int H, int Hkv, int hd,
                          int split, int NS, const long long* st,
                          float scale, int window, float softcap,
                          cudaStream_t stream) {
  auto kern = decode_split_kernel<T, LPK, CPL>;
  const size_t smem = dli::split_smem_bytes<T, LPK, CPL, false>(hd, split);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int G = H / Hkv;
  const dim3 grid(Hkv * ((G + kSplitHeads - 1) / kSplitHeads), B, NS);
  kern<<<grid, kSplitThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(part),
      static_cast<const int*>(lengths), static_cast<const float*>(slopes), H,
      Hkv, hd, split, NS, st[0], st[1], PoolStrides{st[2], st[3], st[4]},
      PoolStrides{st[5], st[6], st[7]}, scale * dli::kLog2e, window, scale,
      softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<B * H, 32 * kCombineWarps, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out),
      static_cast<const int*>(lengths), B, H, hd, split, NS, st[8], st[9],
      window);
  return cudaGetLastError();
}

// LPK: the 16-byte chunks of hd rounded up to a power of two, at least 2
// and at most 32 lanes; f32 above hd 128 gives each lane two chunks (as
// paged_attention.cu).
template <typename T>
cudaError_t dispatch_decode(int chunks, const void* q, const void* k,
                            const void* v, void* out, const void* lengths,
                            const void* slopes, void* part, int B, int H,
                            int Hkv, int hd, int split, int NS,
                            const long long* st, float scale, int window,
                            float softcap, cudaStream_t stream) {
#define DLI_DECODE_LAUNCH(LPK, CPL)                                        \
  return launch_decode<T, LPK, CPL>(q, k, v, out, lengths, slopes, part, B, \
                                    H, Hkv, hd, split, NS, st, scale,       \
                                    window, softcap, stream)
  if (chunks <= 2) DLI_DECODE_LAUNCH(2, 1);
  if (chunks <= 4) DLI_DECODE_LAUNCH(4, 1);
  if (chunks <= 8) DLI_DECODE_LAUNCH(8, 1);
  if (chunks <= 16) DLI_DECODE_LAUNCH(16, 1);
  if (chunks <= 32) DLI_DECODE_LAUNCH(32, 1);
  DLI_DECODE_LAUNCH(32, 2);
#undef DLI_DECODE_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides (elements): q b/s/h, k b/s/h,
// v b/s/h, out b/s/h. window <= 0: no window. slopes: [H] f32 or NULL.
// softcap <= 0: no score cap, else cap * tanh(score / cap) on the scaled
// score.
int dli_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* out, const void* slopes, int dtype, int B,
                            int S, int H, int Hkv, int hd,
                            const long long* strides, float scale,
                            int window, float softcap, void* stream) {
  if (hd % 8 != 0 || hd > 256 || hd < 8 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  if (S <= 0 || B <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_prefill<float>(q, k, v, out, slopes, B, S, H, Hkv, hd,
                                   strides, scale, window, softcap, st);
  if (dtype == 1)
    return dispatch_prefill<__nv_bfloat16>(q, k, v, out, slopes, B, S, H,
                                           Hkv, hd, strides, scale, window,
                                           softcap, st);
  return cudaErrorInvalidValue;
}

// The tensor-core prefill: bf16 only, hd a multiple of 16 up to 256;
// arguments as dli_flash_attention_fwd's.
int dli_flash_attention_mma_fwd(const void* q, const void* k, const void* v,
                                void* out, const void* slopes, int B, int S,
                                int H, int Hkv, int hd,
                                const long long* strides, float scale,
                                int window, float softcap, void* stream) {
  if (hd % 16 != 0 || hd > 256 || hd < 16 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  if (S <= 0 || B <= 0) return cudaSuccess;
  return dispatch_prefill_mma(q, k, v, out, slopes, B, S, H, Hkv, hd,
                              strides, scale, window, softcap,
                              static_cast<cudaStream_t>(stream));
}

// strides (elements): q b/h, k b/s/h, v b/s/h, out b/h. lengths: [B] int32
// on the device (read by the kernels; the host never syncs on it). split:
// keys per split (a multiple of 64, at most 4096); NS = ceil(S / split)
// splits of the cache's capacity S. part: B * H * NS * (hd + 2) f32 of
// scratch.
int dli_flash_decode_fwd(const void* q, const void* k, const void* v,
                         void* out, const void* lengths, const void* slopes,
                         void* part, int dtype, int B, int H, int Hkv,
                         int hd, int split, int NS, const long long* strides,
                         float scale, int window, float softcap,
                         void* stream) {
  if (hd % 8 != 0 || hd > 256 || hd < 8 || H % Hkv != 0 || split < 64 ||
      split > 4096 || split % 64 != 0 || NS < 1 || NS > 65535 ||
      B > 65535 || (long long)B * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_decode<float>(hd / 4, q, k, v, out, lengths, slopes,
                                  part, B, H, Hkv, hd, split, NS, strides,
                                  scale, window, softcap, st);
  if (dtype == 1)
    return dispatch_decode<__nv_bfloat16>(hd / 8, q, k, v, out, lengths,
                                          slopes, part, B, H, Hkv, hd, split,
                                          NS, strides, scale, window,
                                          softcap, st);
  return cudaErrorInvalidValue;
}

const char* dli_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
