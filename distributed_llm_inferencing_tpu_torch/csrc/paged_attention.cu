// Paged flash decode for NVIDIA Hopper (sm_90a), split-KV.
//
// Replaces the Pallas TPU kernel of the JAX package
// ops/pallas/paged_attention.py paged_flash_decode (kernel
// _paged_decode_kernel): one query token per serving slot, q [R,1,H,hd],
// against one layer's block pool [NB,bs,Hkv,hd] through block_tables
// [R,MB] and context_lens [R] (fill after this token's write; the query
// sits at context_lens - 1), with an optional static sliding window.
//
// What bounds it on this card, and what the design does about it: it is
// bounded by bytes, the K/V rows of [max(0, len - window), len) of every
// slot (operations are 4*H*hd per key row, far below the bf16 ridge). The
// bytes are only fast to read with many SMs each keeping loads in flight:
//   - Split-KV. paged_split_kernel's grid is (Hkv x head groups, R, NS):
//     each block attends up to 4 query heads of one (slot, kv head) over
//     one fixed range of `split` keys (NS = ceil(MB*bs / split), from the
//     table's width, so the host never reads context_lens). A range at or
//     past the slot's length, or wholly before the window, writes an
//     empty partial (m = -inf, l = 0) and exits; the others write f32
//     partials (m, l, unnormalised acc[hd]) to scratch the wrapper
//     allocated. paged_combine_kernel (one block per (slot, head), its
//     warps over the splits) merges a row's partials by log-sum-exp in a
//     fixed order, so two launches give the same bits; a row whose l sums
//     to 0 writes 0.
//   - Loads in flight. A split first copies its block-table entries into
//     shared memory (every row address resolves from there, a tile
//     ahead); then 64-key K/V tiles (32 for f32 above hd 128) are fetched
//     straight from the pool in its stored layout with 16-byte cp.async
//     into a two-stage ring, the next tile's copy in flight while the
//     current one is computed.
//   - Scores. q stays in registers; a warp takes a set of keys, LPK lanes
//     split one key's hd in 16-byte chunks, so each K element read from
//     shared memory serves every head of the block, and a shuffle
//     reduction over the LPK lanes finishes the dot. Each lane group
//     keeps its own online softmax (m, l, acc) over its keys; the groups
//     merge in shared memory at the end of the split.
// The JAX wrapper transposes the whole pool to [NB,Hkv,bs,hd] on every
// call; here one layer's slice of the [L,...] pool is a strided view and
// nothing is copied. The fused kernel (csrc/fused_decode.cu) keeps the
// single-pass dli::paged_attend of paged_decode.cuh.
//
// Interface: plain C, pointers and the stream as void*, the launcher
// returns its cudaError_t (0 on success) and allocates nothing.

#include "paged_decode.cuh"

namespace {

using dli::cp_async_16;
using dli::cp_async_commit;
using dli::cp_async_wait;
using dli::kMaxSmem;
using dli::load_chunk;
using dli::PoolStrides;
using dli::store_val;

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kHeadsPerBlock = 4;   // query heads one split block attends
constexpr int kCombineWarps = 4;

// LPK lanes per key, CPL 16-byte chunks of hd per lane.
template <typename T, int LPK, int CPL>
struct SplitCfg {
  static constexpr int N = 16 / sizeof(T);       // elements per chunk
  static constexpr int KPW = 32 / LPK;           // keys per warp step
  // keys per tile: 64, or 32 where a lane group spans rows past 512 bytes
  static constexpr int BKV = CPL * LPK * 16 <= 512 ? 64 : 32;
  static constexpr int KPG = BKV / kSplitWarps / KPW;   // keys per group
  static constexpr int E = CPL * N;              // hd values per lane
  static constexpr int NG = kSplitWarps * KPW;   // lane groups per block
  static constexpr size_t kOffBytes = 4 * BKV * sizeof(long long);
};

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// grid (Hkv * ceil(G / kHeadsPerBlock), R, NS), kSplitThreads threads.
// part: [R][H][NS] (m, l) pairs, then [R][H][NS][hd] acc, all f32.
template <typename T, int LPK, int CPL>
__global__ void __launch_bounds__(kSplitThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                   const T* __restrict__ vpool, float* __restrict__ part,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ context_lens, int H, int Hkv,
                   int hd, int bs, int split, int NS, long long q_sr,
                   long long q_sh, long long bt_sr, PoolStrides ks,
                   PoolStrides vs, float scale_log2, int window) {
  using C = SplitCfg<T, LPK, CPL>;
  constexpr int N = C::N, KPW = C::KPW, BKV = C::BKV, KPG = C::KPG;
  constexpr int E = C::E, NG = C::NG, GT = kHeadsPerBlock;
  const int G = H / Hkv;
  const int n_hg = (G + GT - 1) / GT;
  const int kvh = blockIdx.x / n_hg, hg = blockIdx.x % n_hg;
  const int r = blockIdx.y, sp = blockIdx.z, R = gridDim.y;
  const int h0 = kvh * G + hg * GT;        // the block's first query head
  const int ng = min(GT, G - hg * GT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* ml = part;
  float* pacc = part + 2LL * R * H * NS;

  const int len = context_lens[r];
  const int kv_begin = window > 0 ? max(0, len - window) : 0;
  const int s0 = max(sp * split, kv_begin);
  const int s1 = min(sp * split + split, len);
  if (s0 >= s1) {                          // an empty partial
    if (tid < ng) {
      const long long i = ((long long)r * H + h0 + tid) * NS + sp;
      ml[2 * i] = -INFINITY;
      ml[2 * i + 1] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* koff = reinterpret_cast<long long*>(smem_raw);   // [2][BKV]
  long long* voff = koff + 2 * BKV;                           // [2][BKV]
  int* bt_s = reinterpret_cast<int*>(voff + 2 * BKV);         // [split + 2]
  T* Ks = reinterpret_cast<T*>(smem_raw + C::kOffBytes +
                               align16(sizeof(int) * (split + 2)));
  const int P = hd + N;                    // padded row pitch, elements
  T* Vs = Ks + 2 * BKV * P;                // Ks, Vs: [2][BKV][P]

  const int e0 = s0 / bs, e1 = (s1 - 1) / bs;   // table entries it reads
  const int* bt_row = block_tables + r * bt_sr;
  for (int i = tid; i <= e1 - e0; i += kSplitThreads) bt_s[i] = bt_row[e0 + i];

  // q in registers: lane (grp, sub) holds chunks sub, sub + LPK, ... of
  // every head of the block, widened to f32
  const int grp = lane / LPK, sub = lane % LPK;
  const int chunks = hd / N;
  float qr[GT][E];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      const int c = sub + LPK * cc;
      if (g < ng && c < chunks) {
        load_chunk(q + r * q_sr + (long long)(h0 + g) * q_sh + c * N,
                   &qr[g][cc * N]);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) qr[g][cc * N + e] = 0.f;
      }
    }
  __syncthreads();                         // bt_s is filled

  // row addresses of the tile at t0 into koff/voff[st] (threads
  // [st0, st0 + BKV), one row each), a tile before its copy
  const T* kb = kpool + (long long)kvh * ks.sh;
  const T* vb = vpool + (long long)kvh * vs.sh;
  auto resolve = [&](int t0, int st, int st0) {
    const int row = tid - st0, pos = t0 + row;
    if (row >= 0 && row < BKV && pos < s1) {
      const long long blk = bt_s[pos / bs - e0];
      const long long off = pos % bs;
      koff[st * BKV + row] = blk * ks.sb + off * ks.ss;
      voff[st * BKV + row] = blk * vs.sb + off * vs.ss;
    }
  };
  // one tile's K/V rows [t0, t0 + BKV) into stage st; rows >= s1 zeroed.
  // A thread keeps one chunk column (CHP >= chunks slots per row) and
  // walks rows by a constant step.
  constexpr int CHP = LPK * CPL, RPP = kSplitThreads / CHP;
  const int cr = tid % CHP, rr = tid / CHP;
  auto fetch = [&](int t0, int st) {
    if (cr < chunks) {
#pragma unroll
      for (int j = 0; j < BKV / RPP; ++j) {
        const int row = rr + j * RPP;
        const bool ok = t0 + row < s1;
        const int dst = (st * BKV + row) * P + cr * N;
        cp_async_16(Ks + dst, ok ? kb + koff[st * BKV + row] + cr * N : kb,
                    ok);
        cp_async_16(Vs + dst, ok ? vb + voff[st * BKV + row] + cr * N : vb,
                    ok);
      }
    }
    cp_async_commit();
  };

  float m[GT], l[GT], acc[GT][E];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const int n_tiles = (s1 - s0 + BKV - 1) / BKV;
  resolve(s0, 0, 0);
  resolve(s0 + BKV, 1, BKV);
  __syncthreads();
  fetch(s0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = s0 + it * BKV, st = it & 1;
    if (it + 1 < n_tiles) {                // the next tile flies meanwhile
      fetch(t0 + BKV, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // tile it's addresses are spent: resolve tile it + 2's in their place
    if (it + 2 < n_tiles) resolve(t0 + 2 * BKV, st, 0);
    const T* Kt = Ks + st * BKV * P;
    const T* Vt = Vs + st * BKV * P;

    // scores of this group's KPG keys for every head
    float s[KPG][GT];
#pragma unroll
    for (int i = 0; i < KPG; ++i) {
      const int j = warp * (BKV / kSplitWarps) + grp + KPW * i;
      float d[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) d[g] = 0.f;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int c = sub + LPK * cc;
        if (c < chunks) {
          float kv[N];
          load_chunk(Kt + j * P + c * N, kv);
#pragma unroll
          for (int g = 0; g < GT; ++g)
#pragma unroll
            for (int e = 0; e < N; ++e)
              d[g] = fmaf(qr[g][cc * N + e], kv[e], d[g]);
        }
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < GT; ++g)
          d[g] += __shfl_xor_sync(0xffffffffu, d[g], off);
      const bool ok = t0 + j < s1;
#pragma unroll
      for (int g = 0; g < GT; ++g) s[i][g] = ok ? d[g] * scale_log2 : -INFINITY;
    }

    // the group's online softmax (log2 domain)
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mt = s[0][g];
#pragma unroll
      for (int i = 1; i < KPG; ++i) mt = fmaxf(mt, s[i][g]);
      const float mn = fmaxf(m[g], mt);
      const float mu = mn == -INFINITY ? 0.f : mn;   // exp2(-inf) = 0
      const float a = dli::fast_exp2(m[g] - mu);
      m[g] = mn;
      float ps = 0.f;
#pragma unroll
      for (int i = 0; i < KPG; ++i) {
        s[i][g] = dli::fast_exp2(s[i][g] - mu);
        ps += s[i][g];
      }
      l[g] = l[g] * a + ps;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= a;
    }

    // acc += p * V over the same keys and chunks
#pragma unroll
    for (int i = 0; i < KPG; ++i) {
      const int j = warp * (BKV / kSplitWarps) + grp + KPW * i;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int c = sub + LPK * cc;
        if (c < chunks) {
          float vv[N];
          load_chunk(Vt + j * P + c * N, vv);
#pragma unroll
          for (int g = 0; g < GT; ++g)
#pragma unroll
            for (int e = 0; e < N; ++e)
              acc[g][cc * N + e] = fmaf(s[i][g], vv[e], acc[g][cc * N + e]);
        }
      }
    }
    __syncthreads();                       // this stage is consumed
  }

  // merge the NG lane groups' states in the (consumed) tile buffers
  float* gm = reinterpret_cast<float*>(Ks);   // [NG][GT]
  float* gl = gm + NG * GT;                   // [NG][GT]
  float* ga = gl + NG * GT;                   // [NG][GT][hd]
  const int gi = warp * KPW + grp;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (sub == 0) {
      gm[gi * GT + g] = m[g];
      gl[gi * GT + g] = l[g];
    }
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      const int c = sub + LPK * cc;
      if (c < chunks) {
#pragma unroll
        for (int e = 0; e < N; ++e)
          ga[(gi * GT + g) * hd + c * N + e] = acc[g][cc * N + e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < ng * hd; i += kSplitThreads) {
    const int g = i / hd, dd = i - g * hd;
    float M = -INFINITY;
    for (int k = 0; k < NG; ++k) M = fmaxf(M, gm[k * GT + g]);
    const float Mu = M == -INFINITY ? 0.f : M;
    float L = 0.f, A = 0.f;
    for (int k = 0; k < NG; ++k) {
      const float f = dli::fast_exp2(gm[k * GT + g] - Mu);   // empty group: 0
      L += f * gl[k * GT + g];
      A += f * ga[(k * GT + g) * hd + dd];
    }
    const long long pi = ((long long)r * H + h0 + g) * NS + sp;
    pacc[pi * hd + dd] = A;
    if (dd == 0) {
      ml[2 * pi] = M;
      ml[2 * pi + 1] = L;
    }
  }
}

// grid R*H, one block of kCombineWarps warps per (slot, head): merge the
// row's partials. The splits in [first, last) are exactly those with keys
// in the slot's range (each one non-empty). Every warp finds the row's
// max M over all of them; warp w then sums the splits first + w,
// first + w + kCombineWarps, ... in ascending order, and the warps' sums
// are added in warp order: a fixed order, so the same bits every launch.
template <typename T>
__global__ void __launch_bounds__(32 * kCombineWarps)
paged_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                     const int* __restrict__ context_lens, int R, int H,
                     int hd, int split, int NS, long long o_sr,
                     long long o_sh, int window) {
  constexpr int DPL = 256 / 32;            // hd values per lane, at most
  __shared__ float red_acc[kCombineWarps][256];
  __shared__ float red_l[kCombineWarps];
  const int r = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = context_lens[r];
  const int kv_begin = window > 0 ? max(0, len - window) : 0;
  const int first = kv_begin / split;
  const int last = min(NS, (len + split - 1) / split);
  const float* ml = part + 2LL * ((long long)r * H + h) * NS;
  const float* pa = part + 2LL * R * H * NS + ((long long)r * H + h) * NS * hd;
  float M = -INFINITY;
  for (int s = first + lane; s < last; s += 32)
    if (ml[2 * s + 1] > 0.f) M = fmaxf(M, ml[2 * s]);
  M = dli::warp_max(M);
  float L = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int s = first + warp; s < last; s += kCombineWarps) {
    const float ls = ml[2 * s + 1];
    const float f = ls > 0.f ? dli::fast_exp2(ml[2 * s] - M) : 0.f;
    L += f * ls;
    const float* row = pa + (long long)s * hd;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) acc[i] = fmaf(f, row[d], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) red_acc[warp][d] = acc[i];
  }
  if (lane == 0) red_l[warp] = L;
  __syncthreads();
  float Lt = 0.f;
#pragma unroll
  for (int k = 0; k < kCombineWarps; ++k) Lt += red_l[k];
  T* orow = out + r * o_sr + h * o_sh;
  for (int d = threadIdx.x; d < hd; d += 32 * kCombineWarps) {
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < kCombineWarps; ++k) a += red_acc[k][d];
    store_val(orow + d, Lt > 0.f ? a / Lt : 0.f);
  }
}

template <typename T, int LPK, int CPL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const void* bt, const void* lens, void* part, int R,
                   int H, int Hkv, int hd, int bs, int split, int NS,
                   const long long* st, float scale, int window,
                   cudaStream_t stream) {
  using C = SplitCfg<T, LPK, CPL>;
  auto kern = paged_split_kernel<T, LPK, CPL>;
  const size_t tiles = 4 * (size_t)C::BKV * (hd + C::N) * sizeof(T);
  const size_t merge =
      (size_t)C::NG * kHeadsPerBlock * (2 + hd) * sizeof(float);
  const size_t smem = C::kOffBytes + align16(sizeof(int) * (split + 2)) +
                      (tiles > merge ? tiles : merge);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int G = H / Hkv;
  const dim3 grid(Hkv * ((G + kHeadsPerBlock - 1) / kHeadsPerBlock), R, NS);
  kern<<<grid, kSplitThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(part),
      static_cast<const int*>(bt), static_cast<const int*>(lens), H, Hkv, hd,
      bs, split, NS, st[0], st[1], st[2], PoolStrides{st[3], st[4], st[5]},
      PoolStrides{st[6], st[7], st[8]}, scale * dli::kLog2e, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<T><<<R * H, 32 * kCombineWarps, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out),
      static_cast<const int*>(lens), R, H, hd, split, NS, st[9], st[10],
      window);
  return cudaGetLastError();
}

// LPK: the 16-byte chunks of hd rounded up to a power of two, at least 2
// and at most 32 lanes; f32 above hd 128 gives each lane two chunks.
template <typename T>
cudaError_t dispatch(int chunks, const void* q, const void* k, const void* v,
                     void* out, const void* bt, const void* lens, void* part,
                     int R, int H, int Hkv, int hd, int bs, int split, int NS,
                     const long long* st, float scale, int window,
                     cudaStream_t stream) {
#define DLI_SPLIT_LAUNCH(LPK, CPL)                                          \
  return launch<T, LPK, CPL>(q, k, v, out, bt, lens, part, R, H, Hkv, hd,  \
                             bs, split, NS, st, scale, window, stream)
  if (chunks <= 2) DLI_SPLIT_LAUNCH(2, 1);
  if (chunks <= 4) DLI_SPLIT_LAUNCH(4, 1);
  if (chunks <= 8) DLI_SPLIT_LAUNCH(8, 1);
  if (chunks <= 16) DLI_SPLIT_LAUNCH(16, 1);
  if (chunks <= 32) DLI_SPLIT_LAUNCH(32, 1);
  DLI_SPLIT_LAUNCH(32, 2);
#undef DLI_SPLIT_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides (elements): q r/h, block_tables
// r, k pool b/s/h, v pool b/s/h, out r/h. block_tables [R, MB] and
// context_lens [R] are int32 on the device (read by the kernels; the host
// never syncs on them). window <= 0: no window. split: keys per split (a
// multiple of 64, at most 1024); NS = ceil(MB * bs / split) splits. part:
// R * H * NS * (hd + 2) f32 of scratch.
int dli_paged_decode_fwd(const void* q, const void* k, const void* v,
                         void* out, const void* block_tables,
                         const void* context_lens, void* part, int dtype,
                         int R, int H, int Hkv, int hd, int bs, int split,
                         int NS, const long long* strides, float scale,
                         int window, void* stream) {
  if (hd % 8 != 0 || hd > 256 || hd < 8 || H % Hkv != 0 || bs < 1 ||
      split < 64 || split > 1024 || split % 64 != 0 || NS < 1 ||
      NS > 65535 || R > 65535 || (long long)R * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (R <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(hd / 4, q, k, v, out, block_tables, context_lens,
                           part, R, H, Hkv, hd, bs, split, NS, strides,
                           scale, window, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd / 8, q, k, v, out, block_tables,
                                   context_lens, part, R, H, Hkv, hd, bs,
                                   split, NS, strides, scale, window, st);
  return cudaErrorInvalidValue;
}

const char* dli_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
