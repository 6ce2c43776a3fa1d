// Split-KV single-query attention, shared by the dense flash_decode
// (flash_attention.cu: decode_split_kernel + decode_combine_kernel),
// paged_flash_decode (paged_attention.cu: paged_split_kernel +
// paged_combine_kernel) and the attention phase of fused_decode_step
// (fused_decode.cu: fused_cluster_kernel). They differ in how a key row's
// address is found: stride over row r's dense cache [B, S, Hkv, hd], or a
// block table into the pool [NB, bs, Hkv, hd] (PAGED); in where q comes
// from: q in device memory in the cache's dtype (GlobalQ), or the fused
// kernel's f32 q in shared memory (SharedQ); and in which threads run a
// split: a whole block (BlockTeam), or one of the fused kernel's
// kSplitThreads-thread teams on a named barrier (NamedTeam). Each file
// wraps the device functions below in __global__ kernels of its own
// names, so a profile counts each kernel apart.
//
// Bounded by bytes (the K/V rows of [max(0, len - window), len) of every
// row; 4*H*hd operations per key row, far below the bf16 ridge), which
// are only fast to read with many SMs each keeping loads in flight:
//   - The split pass. Grid (Hkv x head groups, R, NS): each block attends
//     up to kSplitHeads query heads of one (row, kv head) over one fixed
//     range of `split` keys. NS comes from the capacity the host knows
//     (the cache's S, the table's MB*bs), so the host never reads the
//     lengths. A range at or past the row's length, or wholly before the
//     window's start, writes an empty partial (m = -inf, l = 0) and exits;
//     the others write f32 partials (m, l, unnormalised acc[hd], log2
//     domain) to scratch the wrapper allocated.
//   - Loads in flight. A paged split first copies its block-table entries
//     into shared memory; both forms resolve each key row's address once,
//     a tile ahead, into shared memory. 64-key K/V tiles (32 for f32
//     above hd 128) are fetched straight from the cache in its stored
//     layout with 16-byte cp.async into a two-stage ring, the next tile's
//     copy in flight while the current one is computed.
//   - Scores. q stays in registers; a warp takes a set of keys, LPK lanes
//     split one key's hd in 16-byte chunks, so each K element read from
//     shared memory serves every head of the block, and a shuffle
//     reduction over the LPK lanes finishes the dot. A score softcap
//     (gemma2: cap * tanh(s * (scale / cap)), tanhf, on the scaled score,
//     not on its log2e multiple; the quotient made once per split) runs
//     in an arm of its own, a uniform
//     branch on softcap > 0, so without a cap the arithmetic and bits are
//     those of the uncapped kernel. ALiBi (dense only) adds slope * (key -
//     query position) after the cap and before the mask. Each lane group
//     keeps its own online softmax (m, l, acc) over its keys; the groups
//     merge in shared memory at the end of the split.
//   - The merge. One block per (row, head), its warps over the splits,
//     merges a row's partials by log-sum-exp in a fixed order, so two
//     launches give the same bits; a row whose l sums to 0 writes 0.

#pragma once

#include "common.cuh"

namespace dli {

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kSplitHeads = 4;   // query heads one split block attends
constexpr int kCombineWarps = 8;

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

// Dynamic shared memory of one split block: row offsets, the paged form's
// table entries, then the K/V ring (reused for the lane groups' merge).
template <typename T, int LPK, int CPL, bool PAGED>
inline size_t split_smem_bytes(int hd, int split) {
  using C = SplitCfg<T, LPK, CPL>;
  const size_t tiles = 4 * (size_t)C::BKV * (hd + C::N) * sizeof(T);
  const size_t merge = (size_t)C::NG * kSplitHeads * (2 + hd) * sizeof(float);
  return C::kOffBytes + (PAGED ? align16(sizeof(int) * (split + 2)) : 0) +
         (tiles > merge ? tiles : merge);
}

// The threads that run one split: the whole block of kSplitThreads
// threads, or team `id` of a larger block (threads [id * kSplitThreads,
// (id + 1) * kSplitThreads), warp-aligned) on named barrier 1 + id.
struct BlockTeam {
  __device__ __forceinline__ int tid() const { return threadIdx.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

struct NamedTeam {
  int id;
  __device__ __forceinline__ int tid() const {
    return threadIdx.x - id * kSplitThreads;
  }
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id + 1), "n"(kSplitThreads)
                 : "memory");
  }
};

// q sources: the 16-byte chunk c (Chunk<T>::N values) of the split's
// query head g, widened to f32. GlobalQ: q in device memory in T, head g
// at base + g * sh. SharedQ: f32 rows [heads][hd] in shared memory
// (16-byte aligned, hd % 4 == 0), read as they are.
template <typename T>
struct GlobalQ {
  const T* base;
  long long sh;
  __device__ __forceinline__ void operator()(int g, int c, float* out) const {
    load_chunk(base + (long long)g * sh + c * Chunk<T>::N, out);
  }
};

template <typename T>
struct SharedQ {
  const float* base;
  int hd;
  __device__ __forceinline__ void operator()(int g, int c, float* out) const {
    const float4* p = reinterpret_cast<const float4*>(
        base + g * hd + c * Chunk<T>::N);
#pragma unroll
    for (int i = 0; i < Chunk<T>::N / 4; ++i) {
      const float4 f = p[i];
      out[4 * i] = f.x;
      out[4 * i + 1] = f.y;
      out[4 * i + 2] = f.z;
      out[4 * i + 3] = f.w;
    }
  }
};

// One split: the ng <= kSplitHeads query heads of the split (q from
// qsrc) against kv head kvh's keys [s0, s1), s0 < s1, of row r (dense:
// stride r over the cache; PAGED: through bt_row, the row's block-table
// entries). slopes: the split's ng ALiBi slopes (dense only) or nullptr.
// softcap > 0: cap the scores at softcap (scale: the unfolded score
// scale it needs); 0: no cap. smem_raw: split_smem_bytes(hd, split) bytes, 16-byte aligned, where
// s1 - s0 <= split. Run by every thread of team tm. On return (past a
// team barrier) the NG lane groups' states lie in shared memory at the
// returned pointer; split_merge_groups reads them.
template <typename T, int LPK, int CPL, bool PAGED, class Team, class QSrc>
__device__ __forceinline__ const float* split_range(
    const Team& tm, unsigned char* smem_raw, const QSrc& qsrc,
    const T* __restrict__ kpool, const T* __restrict__ vpool,
    const int* __restrict__ bt_row, const float* __restrict__ slopes, int r,
    int kvh, int ng, int hd, int bs, int split, int s0, int s1, int len,
    PoolStrides ks, PoolStrides vs, float scale_log2, float scale = 0.f,
    float softcap = 0.f) {
  using C = SplitCfg<T, LPK, CPL>;
  constexpr int N = C::N, KPW = C::KPW, BKV = C::BKV, KPG = C::KPG;
  constexpr int E = C::E, NG = C::NG, GT = kSplitHeads;
  const int tid = tm.tid(), warp = tid >> 5, lane = tid & 31;

  long long* koff = reinterpret_cast<long long*>(smem_raw);   // [2][BKV]
  long long* voff = koff + 2 * BKV;                           // [2][BKV]
  int* bt_s = reinterpret_cast<int*>(voff + 2 * BKV);         // [split + 2]
  T* Ks = reinterpret_cast<T*>(
      smem_raw + C::kOffBytes +
      (PAGED ? align16(sizeof(int) * (split + 2)) : 0));
  const int P = hd + N;                    // padded row pitch, elements
  T* Vs = Ks + 2 * BKV * P;                // Ks, Vs: [2][BKV][P]

  const int e0 = PAGED ? s0 / bs : 0;      // table entries it reads
  if constexpr (PAGED) {
    const int e1 = (s1 - 1) / bs;
    for (int i = tid; i <= e1 - e0; i += kSplitThreads)
      bt_s[i] = bt_row[e0 + i];
  }

  // q in registers: lane (grp, sub) holds chunks sub, sub + LPK, ... of
  // every head of the split, in f32; ALiBi slopes in log2 units
  const int grp = lane / LPK, sub = lane % LPK;
  const int chunks = hd / N;
  float qr[GT][E], sl[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    sl[g] = !PAGED && slopes != nullptr && g < ng ? slopes[g] * kLog2e : 0.f;
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      const int c = sub + LPK * cc;
      if (g < ng && c < chunks) {
        qsrc(g, c, &qr[g][cc * N]);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) qr[g][cc * N + e] = 0.f;
      }
    }
  }
  const float qpos = (float)(len - 1);
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  tm.sync();                               // bt_s is filled

  // row addresses of the tile at t0 into koff/voff[st] (threads
  // [st0, st0 + BKV), one row each), a tile before its copy
  const T* kb = kpool + (long long)kvh * ks.sh;
  const T* vb = vpool + (long long)kvh * vs.sh;
  auto resolve = [&](int t0, int st, int st0) {
    const int row = tid - st0, pos = t0 + row;
    if (row >= 0 && row < BKV && pos < s1) {
      if constexpr (PAGED) {
        const long long blk = bt_s[pos / bs - e0];
        const long long off = pos % bs;
        koff[st * BKV + row] = blk * ks.sb + off * ks.ss;
        voff[st * BKV + row] = blk * vs.sb + off * vs.ss;
      } else {
        koff[st * BKV + row] = r * ks.sb + pos * ks.ss;
        voff[st * BKV + row] = r * vs.sb + pos * vs.ss;
      }
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
  tm.sync();
  fetch(s0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = s0 + it * BKV, st = it & 1;
    if (it + 1 < n_tiles) {                // the next tile flies meanwhile
      fetch(t0 + BKV, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    tm.sync();
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
      if (softcap > 0.f) {             // the cap arm
        const float rel = (float)(t0 + j) - qpos;
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float c = tanhf(d[g] * cap_in) * softcap;
          s[i][g] = !ok ? -INFINITY
                        : (!PAGED && slopes != nullptr
                               ? fmaf(c, kLog2e, sl[g] * rel)
                               : c * kLog2e);
        }
      } else if (!PAGED && slopes != nullptr) {
        const float rel = (float)(t0 + j) - qpos;
#pragma unroll
        for (int g = 0; g < GT; ++g)
          s[i][g] = ok ? fmaf(d[g], scale_log2, sl[g] * rel) : -INFINITY;
      } else {
#pragma unroll
        for (int g = 0; g < GT; ++g)
          s[i][g] = ok ? d[g] * scale_log2 : -INFINITY;
      }
    }

    // the group's online softmax (log2 domain)
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mt = s[0][g];
#pragma unroll
      for (int i = 1; i < KPG; ++i) mt = fmaxf(mt, s[i][g]);
      const float mn = fmaxf(m[g], mt);
      const float mu = mn == -INFINITY ? 0.f : mn;   // exp2(-inf) = 0
      const float a = fast_exp2(m[g] - mu);
      m[g] = mn;
      float ps = 0.f;
#pragma unroll
      for (int i = 0; i < KPG; ++i) {
        s[i][g] = fast_exp2(s[i][g] - mu);
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
    tm.sync();                       // this stage is consumed
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
  tm.sync();
  return gm;
}

// Head g's state over the NG lane groups of a finished split (gm from
// split_range): its max M, denominator L and, returned, acc[dd], all in
// the base of M (log2 domain), the groups added in a fixed order.
template <int NG>
__device__ __forceinline__ float split_merge_groups(const float* gm, int hd,
                                                    int g, int dd, float& M,
                                                    float& L) {
  constexpr int GT = kSplitHeads;
  const float* gl = gm + NG * GT;
  const float* ga = gl + NG * GT;
  M = -INFINITY;
  for (int k = 0; k < NG; ++k) M = fmaxf(M, gm[k * GT + g]);
  const float Mu = M == -INFINITY ? 0.f : M;
  float A = 0.f;
  L = 0.f;
  for (int k = 0; k < NG; ++k) {
    const float f = fast_exp2(gm[k * GT + g] - Mu);   // empty group: 0
    L += f * gl[k * GT + g];
    A += f * ga[(k * GT + g) * hd + dd];
  }
  return A;
}

// The split pass for block (blockIdx.x = kv head x head group, blockIdx.y
// = row r, blockIdx.z = split sp); kSplitThreads threads. part: [R][H][NS]
// (m, l) pairs, then [R][H][NS][hd] acc, all f32. Dense: ks/vs.sb is the
// row stride of the cache, block_tables and bs unused. slopes: [H] f32
// ALiBi slopes or nullptr. softcap: 0, or the score cap (scale: the
// unfolded score scale).
template <typename T, int LPK, int CPL, bool PAGED>
__device__ __forceinline__ void split_attend(
    const T* __restrict__ q, const T* __restrict__ kpool,
    const T* __restrict__ vpool, float* __restrict__ part,
    const int* __restrict__ block_tables, const int* __restrict__ lens,
    const float* __restrict__ slopes, int H, int Hkv, int hd, int bs,
    int split, int NS, long long q_sr, long long q_sh, long long bt_sr,
    PoolStrides ks, PoolStrides vs, float scale_log2, int window,
    float scale, float softcap) {
  using C = SplitCfg<T, LPK, CPL>;
  constexpr int GT = kSplitHeads;
  const int G = H / Hkv;
  const int n_hg = (G + GT - 1) / GT;
  const int kvh = blockIdx.x / n_hg, hg = blockIdx.x % n_hg;
  const int r = blockIdx.y, sp = blockIdx.z, R = gridDim.y;
  const int h0 = kvh * G + hg * GT;        // the block's first query head
  const int ng = min(GT, G - hg * GT);
  const int tid = threadIdx.x;
  float* ml = part;
  float* pacc = part + 2LL * R * H * NS;

  const int len = lens[r];
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
  const float* gm = split_range<T, LPK, CPL, PAGED>(
      BlockTeam{}, smem_raw,
      GlobalQ<T>{q + r * q_sr + (long long)h0 * q_sh, q_sh}, kpool, vpool,
      PAGED ? block_tables + r * bt_sr : nullptr,
      slopes != nullptr ? slopes + h0 : nullptr, r, kvh, ng, hd, bs, split,
      s0, s1, len, ks, vs, scale_log2, scale, softcap);
  for (int i = tid; i < ng * hd; i += kSplitThreads) {
    const int g = i / hd, dd = i - g * hd;
    float M, L;
    const float A = split_merge_groups<C::NG>(gm, hd, g, dd, M, L);
    const long long pi = ((long long)r * H + h0 + g) * NS + sp;
    pacc[pi * hd + dd] = A;
    if (dd == 0) {
      ml[2 * pi] = M;
      ml[2 * pi + 1] = L;
    }
  }
}

// The merge for block blockIdx.x = (row, head), kCombineWarps warps:
// merge the row's partials. The splits in [first, last) are exactly those
// with keys in the row's range (each one non-empty). Every warp finds the
// row's max M over all of them; warp w then sums the splits first + w,
// first + w + kCombineWarps, ... in ascending order, and the warps' sums
// are added in warp order: a fixed order, so the same bits every launch.
template <typename T>
__device__ __forceinline__ void split_combine(
    const float* __restrict__ part, T* __restrict__ out,
    const int* __restrict__ lens, int R, int H, int hd, int split, int NS,
    long long o_sr, long long o_sh, int window) {
  constexpr int DPL = 256 / 32;            // hd values per lane, at most
  __shared__ float red_acc[kCombineWarps][256];
  __shared__ float red_l[kCombineWarps];
  const int r = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = lens[r];
  const int kv_begin = window > 0 ? max(0, len - window) : 0;
  const int first = kv_begin / split;
  const int last = min(NS, (len + split - 1) / split);
  const float* ml = part + 2LL * ((long long)r * H + h) * NS;
  const float* pa = part + 2LL * R * H * NS + ((long long)r * H + h) * NS * hd;
  float M = -INFINITY;
  for (int s = first + lane; s < last; s += 32)
    if (ml[2 * s + 1] > 0.f) M = fmaxf(M, ml[2 * s]);
  M = warp_max(M);
  float L = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int s = first + warp; s < last; s += kCombineWarps) {
    const float ls = ml[2 * s + 1];
    const float f = ls > 0.f ? fast_exp2(ml[2 * s] - M) : 0.f;
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

}  // namespace dli
