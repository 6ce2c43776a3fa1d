// The single-pass paged online-softmax decode of fused_decode.cu
// (paged_attention.cu's own kernel is split-KV, split_decode.cuh): one
// thread block attends the G query heads of one (slot, kv head) against
// the slot's keys in [max(0, len - window), len), read straight out of
// one layer's block pool [NB, bs, Hkv, hd] in its stored layout.
//
// The TPU kernels walk a sequential grid axis over the block table with
// scalar-prefetched block ids driving the DMAs, and load every table
// entry up to MB even past the slot's length. Here the loop over the
// slot's keys runs inside the block: each 64-key tile first resolves its
// rows' pool addresses from the slot's block-table row (device memory, no
// host sync), then loads only rows below `len`. Tiles wholly before the
// window's start and blocks at or past ceil(len / bs) are never read.
// Scores, the running max/denominator and the output accumulator stay in
// f32 in shared memory; a row with no admissible key (len 0, the dummy
// rows of inactive slots) writes 0, as the Pallas kernels' _finish does.

#pragma once

#include "common.cuh"

namespace dli {

constexpr int kPagedThreads = 256;
constexpr int kPagedWarps = kPagedThreads / 32;
constexpr int kPagedBKV = 64;   // keys per tile

// Shared memory (in floats) that paged_attend needs after the caller's
// query rows: two [BKV] row-offset arrays (long long), Acc [G][hd],
// K tile [BKV][hd+1], V tile [BKV][hd], P [G][BKV], m/l/alpha [G].
inline size_t paged_attend_smem_floats(int G, int hd) {
  return (size_t)4 * kPagedBKV + (size_t)G * hd +
         (size_t)kPagedBKV * (hd + 1) + (size_t)kPagedBKV * hd +
         (size_t)G * kPagedBKV + 3 * (size_t)G;
}

// Attend the query rows Qs [G][hd] (f32, shared memory, visible to every
// thread after the first barrier below) and write row g of the context
// to out + g * o_sh. `work` is this function's shared memory (8-byte
// aligned, paged_attend_smem_floats(G, hd) floats). Must be called by
// all kPagedThreads threads of the block.
template <typename T>
__device__ void paged_attend(float* work, const float* Qs,
                             const T* __restrict__ kpool,
                             const T* __restrict__ vpool, PoolStrides ks,
                             PoolStrides vs, const int* __restrict__ bt_row,
                             int len, int bs, int kvh, int G, int hd,
                             float scale, int window, T* __restrict__ out,
                             long long o_sh) {
  constexpr int BKV = kPagedBKV;
  constexpr int N = Chunk<T>::N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kp = hd + 1;             // padded K pitch: no bank conflicts
  long long* koff = reinterpret_cast<long long*>(work);   // [BKV]
  long long* voff = koff + BKV;                           // [BKV]
  float* Acc = reinterpret_cast<float*>(voff + BKV);      // [G][hd]
  float* Ks = Acc + G * hd;                               // [BKV][kp]
  float* Vs = Ks + BKV * kp;                              // [BKV][hd]
  float* Ps = Vs + BKV * hd;                              // [G][BKV]
  float* m_s = Ps + G * BKV;                              // [G]
  float* l_s = m_s + G;                                   // [G]
  float* a_s = l_s + G;                                   // [G]

  for (int i = tid; i < G * hd; i += kPagedThreads) Acc[i] = 0.f;
  for (int i = tid; i < G; i += kPagedThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  const int qpos = len - 1;          // the query sits at len - 1
  const int kv_begin = window > 0 ? max(0, len - window) : 0;
  const int chunks = hd / N;

  for (int kv0 = kv_begin; kv0 < len; kv0 += BKV) {
    __syncthreads();                 // the previous tile is consumed
    const int valid = min(BKV, len - kv0);
    for (int i = tid; i < valid; i += kPagedThreads) {
      const int pos = kv0 + i;
      const long long blk = bt_row[pos / bs];
      const long long off = pos % bs;
      koff[i] = blk * ks.sb + off * ks.ss + (long long)kvh * ks.sh;
      voff[i] = blk * vs.sb + off * vs.ss + (long long)kvh * vs.sh;
    }
    __syncthreads();
    for (int i = tid; i < BKV * chunks; i += kPagedThreads) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * N;
      float kv[N], vv[N];
      if (r < valid) {
        load_chunk(kpool + koff[r] + c, kv);
        load_chunk(vpool + voff[r] + c, vv);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) kv[j] = vv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        Ks[r * kp + c + j] = kv[j];
        Vs[r * hd + c + j] = vv[j];
      }
    }
    __syncthreads();

    for (int i = tid; i < G * BKV; i += kPagedThreads) {
      const int g = i / BKV, j = i - g * BKV;
      const float* qrow = Qs + g * hd;
      const float* krow = Ks + j * kp;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qrow[d], krow[d], s);
      const bool ok = j < valid && (window <= 0 || qpos - (kv0 + j) < window);
      Ps[i] = ok ? s * scale : -INFINITY;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kPagedWarps) {   // one warp per head
      float* prow = Ps + g * BKV;
      float mx = -INFINITY;
      for (int j = lane; j < BKV; j += 32) mx = fmaxf(mx, prow[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int j = lane; j < BKV; j += 32) {
        const float p = expf(prow[j] - m_use);     // masked: exp(-inf) = 0
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

    for (int i = tid; i < G * hd; i += kPagedThreads) {
      const int g = i / hd, d = i - g * hd;
      const float* prow = Ps + g * BKV;
      float a = Acc[i] * a_s[g];
      for (int j = 0; j < valid; ++j) a = fmaf(prow[j], Vs[j * hd + d], a);
      Acc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * hd; i += kPagedThreads) {
    const int g = i / hd, d = i - g * hd;
    const float l = l_s[g];
    store_val(out + g * o_sh + d, l > 0.f ? Acc[i] / l : 0.f);
  }
}

}  // namespace dli
