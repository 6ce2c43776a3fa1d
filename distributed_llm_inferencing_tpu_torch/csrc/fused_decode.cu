// Fused q projection -> RoPE -> paged flash decode for NVIDIA Hopper
// (sm_90a), in the float, int8 and int4 weight forms: one launch of
// thread-block clusters.
//
// Replaces the Pallas TPU kernel of the JAX package
// ops/pallas/fused_decode.py fused_decode_step (kernel _fused_kernel):
// per (slot, kv head), the GEMV of the slot's post-norm hidden row
// x [D] against that kv head's [D, G*hd] column tile of the q weight,
// then rotate-half RoPE from per-slot cos/sin rows (yarn's attn_factor
// already folded in), then paged online-softmax decode over the slot's
// block table. q never leaves the chip: it is summed, scaled and rotated
// in f32 in shared memory and attended from there, never rounded to x's
// dtype.
//
// Weight forms (ops/quant.py layouts), read in their stored bytes:
// float (x's dtype); int8 levels [D, H*hd] with a per-output-channel f32
// scale; int4 split-half biased nibbles [D/2, H*hd] (byte row i: din row
// i low, row i + D/2 high) with the same scale. Levels are made in
// registers, exactly; the f32 sums are multiplied by the scale once per
// column, before RoPE (the TPU kernel's order).
//
// What bounds it on this card: bytes. Per layer the q weight (D*H*hd
// values: 2 bytes each in bf16, 1 in int8, 1/2 in int4; 32/16/8 MiB at
// llama-3-8b width) plus the K/V rows of [max(0, len - window), len) of
// every slot (up to 134 MB at 8 slots of 4096 keys), at 3.35 TB/s: about
// 0.01 ms at the serving lengths and 0.05 ms at full occupancy. The
// operations (2*R*D*H*hd + 4*H*hd*keys) are far below the tensor cores'
// rate. What the parent kernel lost to: 64 blocks, the weight read once
// per slot, synchronous loads, and a single-pass attention per slot.
//
// The design: grid (CS, Hkv, ceil(R / RT)), one thread-block cluster of
// CS blocks per (kv head, row group of RT <= 8 slots), kThreads threads
// a block, one block per SM. The cluster's blocks share their results
// through distributed shared memory (DSMEM), so the step is one launch:
// no workspace, no second kernel, no float atomics, no host read of
// context_lens; every sum is taken in a fixed order, so two launches give
// the same bits. Four phases, separated by cluster barriers:
//
//   A. The q projection. Block rank j owns a contiguous 1/CS slice of
//      the contraction (kchunk stored rows: rows of D, or for int4 packed
//      rows of D/2, each feeding x[d] and x[d + D/2]) for all G*hd
//      columns of its kv head and every slot of the row group, so a row
//      group reads each weight byte from device memory once. x's slice of
//      those rows lands in shared memory by cp.async while the weight
//      starts to stream. Each warp takes units of 128 columns (x KP parts
//      of the slice where the columns are fewer than the warps) and
//      streams its weight bytes in their stored layout through a
//      kStages-deep ring of cp.async copies that only it reads (16-byte
//      copies; 8-byte where quantized rows are not 16-byte aligned),
//      kStages - 1 stages in flight while it computes; the KP parts are
//      added in order in shared memory.
//        bf16 x: mma.sync m16n8k16 bf16 -> f32 on the tensor cores; M is
//      the columns, N the slots (one 8-slot n-tile), K the rows. Thread
//      (g, t) holds 16 consecutive columns of rows 2t, 2t+1, 2t+8, 2t+9
//      of a k-step (int4: packed rows 2t, 2t+1, low nibbles on k-slots
//      0-7 and high nibbles on 8-15, as q4_mma_kernel); its mma j takes
//      columns g*16 + 2j and g*16 + 2j + 1 as its two M rows, so each
//      thread's loads feed its A fragments with byte permutes, no
//      ldmatrix and no repack. A bf16 weight is used as it is; an int8
//      level (-128..127) and an int4 level (-8..7) are exact in bf16.
//      bf16 * bf16 products are exact in the f32 accumulator, so the
//      result differs from the plain version only in the order of its
//      f32 sums.
//        f32 x (the f32 cross-checks): f32 FMAs on the CUDA cores (TF32
//      or bf16 products would round them), lane l of a unit holding
//      columns 4l .. 4l+3 for the 8 slots. The rule is by dtype, never
//      by a failure (ops/fused_decode.py fused_form).
//   B. Reduction, scale and RoPE. Each block owns the (slot, query head)
//      rows i = rank, rank + CS, ... (whole heads, so RoPE's hd/2 partner
//      is its own): it loads the CS partial sums of each element through
//      DSMEM (cluster.map_shared_rank), all in flight at once, adds them
//      in rank order, multiplies by the scale (quantized forms), rotates,
//      and writes the f32 result into every block's copy of q [RT][G*hd].
//   C. Split-KV attention over the cluster (split_decode.cuh's
//      split_range, its q read from shared memory in f32). Each block has
//      kTeams teams of 128 threads (where shared memory holds two K/V
//      rings; else one), the cluster's W = CS x teams workers. The live
//      keys of every (slot, head group of <= 4 heads) form one sequence,
//      each (slot, head group) led by kItemCost keys that stand for a
//      work item's setup; worker w takes the keys in the w-th of W equal
//      spans, cut where it crosses a (slot, head group) and into even
//      work items of <= kSplit keys. So every worker gets about the same
//      time whatever the lengths (the serving lengths 0/1/15/16/17/300/
//      1000/4096 would give a worker that takes fixed ranges of the
//      capacity several times the mean). A team walks its items from
//      context_lens on the device; inside an item: the block-table
//      entries (staged in shared memory during phase A where RT rows fit
//      in kTblBytes), a two-stage 16-byte cp.async K/V ring, lanes
//      splitting hd, q in registers and an online softmax per lane group.
//      A worker merges its items of one (slot, head) into one partial
//      (m, l, acc[hd]) in item order.
//   D. The merge. Each worker pushes its partial of every live (slot,
//      head) row to the row's owner (phase B's), by DSMEM stores (acc
//      only where it attended a key); after a cluster barrier the owner
//      merges the W partials by log-sum-exp in worker order
//      (split_combine's arithmetic) from its own shared memory, writing
//      x's dtype; a row whose l sums to 0 (length 0) writes 0.
// No block leaves early: one with no live item still takes part in every
// barrier, and after the last one no block touches another's memory.
//
// Shared memory (bytes, llama-3-8b bf16, CS = 9, RT = 8, 2 teams):
// meta 128; q [RT][G*hd] f32 16 KiB; block tables [RT][256] 8 KiB; then
// one region the phases reuse: A's x slice 7.4 KiB + weight ring 8 warps
// x 4 stages x 4 KiB = 128 KiB + partial q [KP = 2][RT][512] f32 32 KiB;
// C's teams' partials [2][RT][G] (m, l) + acc [2][RT][G][hd] f32 32.5 KiB
// + two K/V rings of split_smem_bytes(128, kSplit) (74 KiB each); D's
// partials + inbox [W][own][hd + 2]: 204.7 KiB in all, under the 227 KiB
// a block may use. The host plan (plan_for) shrinks RT (8, 4, 2, 1), then
// the teams (2, 1), then stops staging the tables, until a shape fits:
// hd 256, f32, and MQA's wide G*hd take fewer.
//
// The cluster size: the largest CS from 16 down to 9 for which
// cudaOccupancyMaxActiveClusters says Hkv clusters run at once (one row
// group of every kv head; sizes above 8 need
// cudaFuncAttributeNonPortableClusterSizeAllowed), else the portable 8.
// Measured on an H100 SXM (PERF.md, Findings): at one block per SM only 7
// clusters of 16, 14 or 12 fit at once, 9 of 9 and 15 of 8, so
// llama-3-8b's 8 kv heads take CS = 9 (72 SMs); CS = 16 ran 1.3-1.45x
// slower (its eighth cluster waits for a free GPC), CS = 8 4-7% slower
// (profile_fused.py).
//
// Interface: plain C, pointers and the stream as void*, the launcher
// returns its cudaError_t (0 on success) and allocates nothing.

#include <cooperative_groups.h>

#include <mutex>

#include "split_decode.cuh"

namespace cg = cooperative_groups;

namespace {

using dli::cp_async_16;
using dli::cp_async_4;
using dli::cp_async_8;
using dli::cp_async_commit;
using dli::cp_async_wait;
using dli::fast_exp2;
using dli::int4_level;
using dli::int8_level;
using dli::kMaxSmem;
using dli::kSplitHeads;
using dli::kSplitThreads;
using dli::mma_bf16_16816;
using dli::PoolStrides;
using dli::smem_u32;

enum WForm { kFloat = 0, kInt8 = 1, kInt4 = 2 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTeams = kThreads / kSplitThreads;   // attention teams, at most
constexpr int kCols = 128;          // q columns of one warp unit
constexpr int kStages = 4;          // weight ring depth per warp
constexpr int kStageBytes = 4096;   // one warp's ring stage
constexpr int kRT = 8;              // slots of a row group, at most
constexpr int kSplit = 1024;        // keys of one work item, at most
constexpr int kItemCost = 128;      // a work item's setup, in keys
constexpr int kMeta = 128;          // per-slot key ranges (shared memory)
constexpr int kMaxCS = 16;          // cluster size, at most
constexpr int kTblBytes = 16384;    // block tables staged, at most (bytes)

// stored weight rows of one ring stage (4 KiB per warp in every form):
// the tensor-core form (bf16 x) 1 k-step of 16 rows (float), 2 (int8),
// or 4 k-steps of 8 packed rows (int4); the CUDA-core form (f32 x) 8
// rows of 16 bytes a lane (float) or 32 rows of 4 bytes (int8, int4)
template <bool MMA, int FORM>
__host__ __device__ constexpr int stage_rows() {
  return MMA ? (FORM == kFloat ? 16 : 32) : (FORM == kFloat ? 8 : 32);
}

__host__ __device__ constexpr size_t al16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

struct Args {
  const void* x;
  const void* w;
  const float* wscale;
  const float* rope_cos;
  const float* rope_sin;
  const void* kpool;
  const void* vpool;
  void* out;
  const int* bt;
  const int* lens;
  int R, D, H, Hkv, hd, bs, window;
  long long x_sr, w_sd, cs_sr, bt_sr, o_sr, o_sh;
  PoolStrides ks, vs;
  float scale_log2;
  // the plan (plan_for)
  int rows;     // stored weight rows: D, or D/2 for int4
  int kchunk;   // stored rows per cluster rank, a multiple of stage_rows
  int RT;       // slots per row group
  int NCG;      // column units of kCols
  int KP;       // contraction parts per column unit
  int teams;    // attention teams per block
  int al16;     // quantized rows start 16-byte aligned
  int tbl_pitch;   // table entries staged per slot (0: read in place)
  // shared memory: absolute offsets of the tables and the region U,
  // then offsets in U (phase A: x slice at 0, ring, partial q; phases C
  // and D: the teams' partials at 0, then the K/V rings or the inbox)
  int off_tbl, off_u, off_ring, off_part, off_kv, kv_bytes;
};

// bf16 bits of two exactly representable floats, `lo` in the low half
__device__ __forceinline__ uint32_t bf16_pair_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// two bf16 int4 levels n - 8 from the nibbles at bits 0-3 and 16-19 of t
// (q4_mma_kernel's bf16_levels)
__device__ __forceinline__ uint32_t bf16_levels(uint32_t t) {
  const uint32_t v = (t & 0x000F000Fu) | 0x43004300u;   // 128 + n
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));    // * 1 - 136
  return d;
}

template <typename T, int FORM, int LPK, int CPL>
__global__ void __launch_bounds__(kThreads, 1)
fused_cluster_kernel(const Args a) {
  constexpr bool MMA = sizeof(T) == 2;
  constexpr int SR = stage_rows<MMA, FORM>();
  constexpr int GT = kSplitHeads;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int CS = (int)cluster.num_blocks();
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hd = a.hd, G = a.H / a.Hkv, GHD = G * hd;
  const int RT = a.RT, r0 = blockIdx.z * RT;
  const int live = min(RT, a.R - r0);    // slots of this row group
  const int n_hg = (G + GT - 1) / GT;

  // meta: per-slot key ranges [s_beg, s_len) of phase C
  int* s_len = reinterpret_cast<int*>(smem);     // [kRT]
  int* s_beg = s_len + kRT;                      // [kRT] window start
  float* qall = reinterpret_cast<float*>(smem + kMeta);   // [RT][GHD]
  int* tbl = reinterpret_cast<int*>(smem + a.off_tbl);   // [RT][tbl_pitch]
  unsigned char* U = smem + a.off_u;
  const int nbp = a.teams * RT * G;
  float* bm = reinterpret_cast<float*>(U);   // [teams][RT][G]
  float* bl = bm + nbp;                                    // [teams][RT][G]
  float* bacc = bl + nbp;                          // [teams][RT][G][hd]

  if (tid < kRT) {
    int len = 0, beg = 0;
    if (tid < live) {
      len = a.lens[r0 + tid];
      beg = a.window > 0 ? max(0, len - a.window) : 0;
    }
    s_len[tid] = len;
    s_beg[tid] = min(beg, len);
  }

  // ------------------------------------------------------------------
  // phase A: partial q [KP][RT][PC] over this rank's slice of the rows
  // ------------------------------------------------------------------
  const int k0 = rank * a.kchunk;
  const int k1 = min(a.rows, k0 + a.kchunk);
  const int nst = k1 > k0 ? (k1 - k0 + SR - 1) / SR : 0;
  const int PC = a.NCG * kCols;
  float* part = reinterpret_cast<float*>(U + a.off_part);
  unsigned char* ring = U + a.off_ring + warp * kStages * kStageBytes;
  const uint32_t ring_s = smem_u32(ring);
  const int gq = lane >> 2, tq = lane & 3;
  const int XP = a.kchunk + 8;           // x slice pitch (tensor-core form)
  const long long wcol0 = (long long)kvh * GHD;

  // stage `stage` of the rank's slice, columns of unit cgi, into `slot`
  auto issue = [&](int cgi, int stage, int slot) {
    const int srow = k0 + stage * SR;
    const uint32_t dst = ring_s + slot * kStageBytes;
    if constexpr (MMA) {
      const int col = cgi * kCols + gq * 16;
      if constexpr (FORM == kFloat) {
        const T* w = static_cast<const T*>(a.w);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int row = srow + 2 * tq + (rr & 1) + (rr >> 1) * 8;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool ok = row < k1 && col + 8 * h < GHD;
            cp_async_16(dst + (rr * 2 + h) * 512 + lane * 16,
                        ok ? w + row * a.w_sd + wcol0 + col + 8 * h : w, ok);
          }
        }
      } else {
        const uint8_t* w = static_cast<const uint8_t*>(a.w);
        constexpr int KSTEPS = FORM == kInt8 ? 2 : 4;   // k-steps a stage
        constexpr int RPS = FORM == kInt8 ? 4 : 2;      // rows a lane, a step
        constexpr int KROWS = FORM == kInt8 ? 16 : 8;   // rows a k-step
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
          for (int rr = 0; rr < RPS; ++rr) {
            const int row = srow + ks * KROWS + 2 * tq + (rr & 1) +
                            (rr >> 1) * 8;
            const uint32_t d = dst + (ks * RPS + rr) * 512 + lane * 16;
            const uint8_t* src = w + row * a.w_sd + wcol0 + col;
            const bool ok = row < k1 && col < GHD;
            if (a.al16) {
              cp_async_16(d, ok ? src : w, ok);
            } else {
              const bool ok2 = row < k1 && col + 8 < GHD;
              cp_async_8(d, ok ? src : w, ok);
              cp_async_8(d + 8, ok2 ? src + 8 : w, ok2);
            }
          }
      }
    } else {
      const int col = cgi * kCols + lane * 4;
      const bool cok = col < GHD;
      if constexpr (FORM == kFloat) {
        const float* w = static_cast<const float*>(a.w);
#pragma unroll
        for (int rr = 0; rr < SR; ++rr) {
          const int row = srow + rr;
          const bool ok = cok && row < k1;
          cp_async_16(dst + rr * 512 + lane * 16,
                      ok ? w + row * a.w_sd + wcol0 + col : w, ok);
        }
      } else {
        const uint8_t* w = static_cast<const uint8_t*>(a.w);
#pragma unroll
        for (int rr = 0; rr < SR; ++rr) {
          const int row = srow + rr;
          const bool ok = cok && row < k1;
          cp_async_4(dst + rr * 128 + lane * 4,
                     ok ? w + row * a.w_sd + wcol0 + col : w, ok);
        }
      }
    }
    cp_async_commit();
  };

  // x's slice, by cp.async (its copies land while the first stages of
  // the weight ring are issued): bf16 [8][XP] by slot (int4: low rows,
  // then high rows), or f32 [kchunk][8] by row (int4: [kchunk][16], low
  // slots then high); zeros past the live slots and the rows
  unsigned char* xs = U;
  const int half_d = a.D / 2;
  if constexpr (MMA) {
    const T* xg = static_cast<const T*>(a.x);
    T* xb = reinterpret_cast<T*>(xs);
    constexpr int CW = FORM == kInt4 ? 4 : 8;   // elements a copy
    const int nch = a.kchunk / CW;
    for (int i = tid; i < kRT * nch; i += kThreads) {
      const int n = i / nch, kk = (i - n * nch) * CW;
      const int row = k0 + kk;
      const bool ok = n < live && row < a.rows;
      const T* src = xg + (long long)(r0 + n) * a.x_sr + row;
      if constexpr (FORM == kInt4) {
        cp_async_8(smem_u32(xb + n * XP + kk), ok ? src : xg, ok);
        cp_async_8(smem_u32(xb + (kRT + n) * XP + kk),
                   ok ? src + half_d : xg, ok);
      } else {
        cp_async_16(xb + n * XP + kk, ok ? src : xg, ok);
      }
    }
  } else {
    constexpr int XW = FORM == kInt4 ? 2 * kRT : kRT;
    float* xf = reinterpret_cast<float*>(xs);
    const float* xg = static_cast<const float*>(a.x);
    for (int i = tid; i < XW * a.kchunk; i += kThreads) {
      const int kk = i / XW, c = i - kk * XW;
      const int n = c % kRT, row = k0 + kk;
      const bool ok = n < live && row < a.rows;
      const float* src = xg + (long long)(r0 + n) * a.x_sr + row +
                         (c >= kRT ? half_d : 0);
      cp_async_4(smem_u32(xf + i), ok ? src : xg, ok);
    }
  }
  cp_async_commit();

  const int units = a.NCG * a.KP;
  auto unit_range = [&](int u, int& sb, int& n_my) {
    const int kp = u % a.KP;
    sb = kp * nst / a.KP;
    n_my = (kp + 1) * nst / a.KP - sb;
  };
  // the first unit's ring fills while x's slice lands
  if (warp < units) {
    int sb, n_my;
    unit_range(warp, sb, n_my);
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_my) issue(warp / a.KP, sb + i, i);
      else cp_async_commit();
    }
  }
  if (warp < units) cp_async_wait<kStages - 1>();   // x's copies
  else cp_async_wait<0>();
  __syncthreads();
  // the live slots' block-table entries, for phase C: copies that join
  // the next group and land while A streams
  for (int i = tid; i < live * a.tbl_pitch; i += kThreads) {
    const int n = i / a.tbl_pitch, e = i - n * a.tbl_pitch;
    const bool ok = e * a.bs < s_len[n];
    cp_async_4(smem_u32(tbl + i),
               ok ? a.bt + (r0 + n) * a.bt_sr + e : a.bt, ok);
  }

  for (int u = warp; u < units; u += kWarps) {
    const int cgi = u / a.KP, kp = u % a.KP;
    int sb, n_my;
    unit_range(u, sb, n_my);
    if (u != warp) {
#pragma unroll
      for (int i = 0; i < kStages - 1; ++i) {
        if (i < n_my) issue(cgi, sb + i, i);
        else cp_async_commit();
      }
    }
    float* pk = part + (size_t)kp * RT * PC;
    if constexpr (MMA) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      const unsigned short* xb = reinterpret_cast<const unsigned short*>(xs);
      for (int i = 0; i < n_my; ++i) {
        cp_async_wait<kStages - 2>();      // stage i has landed
        const unsigned char* st = ring + (i % kStages) * kStageBytes;
        const int kk0 = (sb + i) * SR;     // its first row in the slice
        if constexpr (FORM == kFloat) {
          uint32_t rw[4][8];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint4 v = *reinterpret_cast<const uint4*>(
                  st + (rr * 2 + h) * 512 + lane * 16);
              rw[rr][4 * h] = v.x;
              rw[rr][4 * h + 1] = v.y;
              rw[rr][4 * h + 2] = v.z;
              rw[rr][4 * h + 3] = v.w;
            }
          const unsigned short* xr = xb + gq * XP + kk0 + 2 * tq;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            // rows (2t, 2t+1) of column g*16+2j, then of +1; rows +8
            const uint32_t af[4] = {
                __byte_perm(rw[0][j], rw[1][j], 0x5410),
                __byte_perm(rw[0][j], rw[1][j], 0x7632),
                __byte_perm(rw[2][j], rw[3][j], 0x5410),
                __byte_perm(rw[2][j], rw[3][j], 0x7632)};
            mma_bf16_16816(acc[j], af, b0, b1);
          }
        } else if constexpr (FORM == kInt8) {
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            uint32_t rw[4][4];
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) {
              const uint4 v = *reinterpret_cast<const uint4*>(
                  st + (ks * 4 + rr) * 512 + lane * 16);
              rw[rr][0] = v.x;
              rw[rr][1] = v.y;
              rw[rr][2] = v.z;
              rw[rr][3] = v.w;
            }
            const unsigned short* xr = xb + gq * XP + kk0 + ks * 16 + 2 * tq;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int wi = j >> 1, sh = 16 * (j & 1);
              const uint32_t af[4] = {
                  bf16_pair_exact(int8_level(rw[0][wi], sh),
                                  int8_level(rw[1][wi], sh)),
                  bf16_pair_exact(int8_level(rw[0][wi], sh + 8),
                                  int8_level(rw[1][wi], sh + 8)),
                  bf16_pair_exact(int8_level(rw[2][wi], sh),
                                  int8_level(rw[3][wi], sh)),
                  bf16_pair_exact(int8_level(rw[2][wi], sh + 8),
                                  int8_level(rw[3][wi], sh + 8))};
              mma_bf16_16816(acc[j], af, b0, b1);
            }
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const uint4 w0 = *reinterpret_cast<const uint4*>(
                st + (ks * 2) * 512 + lane * 16);
            const uint4 w1 = *reinterpret_cast<const uint4*>(
                st + (ks * 2 + 1) * 512 + lane * 16);
            const int pp = kk0 + ks * 8 + 2 * tq;
            const uint32_t b0 =
                *reinterpret_cast<const uint32_t*>(xb + gq * XP + pp);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
                xb + (kRT + gq) * XP + pp);
            const uint32_t wa[4] = {w0.x, w0.y, w0.z, w0.w};
            const uint32_t wb[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              // bytes [row p col c, row p col c+1, row p+1 col c, +1]
              const uint32_t tw = __byte_perm(wa[j >> 1], wb[j >> 1],
                                              (j & 1) ? 0x7632 : 0x5410);
              const uint32_t af[4] = {bf16_levels(tw), bf16_levels(tw >> 8),
                                      bf16_levels(tw >> 4),
                                      bf16_levels(tw >> 12)};
              mma_bf16_16816(acc[j], af, b0, b1);
            }
          }
        }
        // refill the slot read in the previous step (in registers now)
        if (i + kStages - 1 < n_my)
          issue(cgi, sb + i + kStages - 1, (i + kStages - 1) % kStages);
        else
          cp_async_commit();
      }
      cp_async_wait<0>();
      // accumulator (j, e) of thread (g, t): slot 2t + (e & 1), column
      // g*16 + 2j + (e >> 1)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cgi * kCols + gq * 16 + 2 * j, n0 = 2 * tq;
        if (n0 < RT)
          *reinterpret_cast<float2*>(pk + n0 * PC + c) =
              make_float2(acc[j][0], acc[j][2]);
        if (n0 + 1 < RT)
          *reinterpret_cast<float2*>(pk + (n0 + 1) * PC + c) =
              make_float2(acc[j][1], acc[j][3]);
      }
    } else {
      float acc[kRT][4];
#pragma unroll
      for (int n = 0; n < kRT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
      const float* xf = reinterpret_cast<const float*>(xs);
      for (int i = 0; i < n_my; ++i) {
        cp_async_wait<kStages - 2>();
        const unsigned char* st = ring + (i % kStages) * kStageBytes;
        const int kk0 = (sb + i) * SR;
#pragma unroll 4
        for (int rr = 0; rr < SR; ++rr) {
          float wv[4], wh[4];
          if constexpr (FORM == kFloat) {
            const float4 v =
                *reinterpret_cast<const float4*>(st + rr * 512 + lane * 16);
            wv[0] = v.x;
            wv[1] = v.y;
            wv[2] = v.z;
            wv[3] = v.w;
          } else {
            const uint32_t word =
                *reinterpret_cast<const uint32_t*>(st + rr * 128 + lane * 4);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if constexpr (FORM == kInt8) {
                wv[c] = int8_level(word, 8 * c);
              } else {
                wv[c] = int4_level(word, 8 * c);
                wh[c] = int4_level(word, 8 * c + 4);
              }
            }
          }
          constexpr int XW = FORM == kInt4 ? 2 * kRT : kRT;
          const float4* xr =
              reinterpret_cast<const float4*>(xf + (kk0 + rr) * XW);
          float xv[XW];
#pragma unroll
          for (int q = 0; q < XW / 4; ++q) {
            const float4 f = xr[q];
            xv[4 * q] = f.x;
            xv[4 * q + 1] = f.y;
            xv[4 * q + 2] = f.z;
            xv[4 * q + 3] = f.w;
          }
#pragma unroll
          for (int n = 0; n < kRT; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[n][c] = fmaf(xv[n], wv[c], acc[n][c]);
              if constexpr (FORM == kInt4)
                acc[n][c] = fmaf(xv[kRT + n], wh[c], acc[n][c]);
            }
        }
        if (i + kStages - 1 < n_my)
          issue(cgi, sb + i + kStages - 1, (i + kStages - 1) % kStages);
        else
          cp_async_commit();
      }
      cp_async_wait<0>();
      const int c = cgi * kCols + lane * 4;
#pragma unroll
      for (int n = 0; n < kRT; ++n)
        if (n < RT)
          *reinterpret_cast<float4*>(pk + n * PC + c) =
              make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();   // the tables' copies too
  if (a.KP > 1) {   // the parts of the slice, added in order
    __syncthreads();
    for (int i = tid; i < RT * PC; i += kThreads) {
      float v = part[i];
      for (int kp = 1; kp < a.KP; ++kp) v += part[(size_t)kp * RT * PC + i];
      part[i] = v;
    }
  }
  cluster.sync();   // every block's partial q is complete

  // ------------------------------------------------------------------
  // phase B: q rows (slot n, head g) = qi = rank, rank + CS, ...: the
  // ranks' partials summed in rank order (all loads in flight first),
  // scaled, rotated, sent to every block
  // ------------------------------------------------------------------
  const bool rope = a.rope_cos != nullptr;
  const int half = hd / 2;
  const int EB = rope ? half : hd;       // elements a thread pair covers
  const int nq = RT * G;
  const int nown = nq > rank ? (nq - rank + CS - 1) / CS : 0;
  for (int i = tid; i < nown * EB; i += kThreads) {
    const int oi = i / EB, e = i - oi * EB;
    const int qi = rank + oi * CS;
    const int n = qi / G, g = qi - n * G;
    const int col = g * hd + e;
    float p0[kMaxCS], p1[kMaxCS];
#pragma unroll
    for (int q = 0; q < kMaxCS; ++q) {
      p0[q] = p1[q] = 0.f;
      if (q < CS) {
        const float* pp = cluster.map_shared_rank(part, q) + n * PC + col;
        p0[q] = pp[0];
        if (rope) p1[q] = pp[half];
      }
    }
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCS; ++q) {
      if (q < CS) {
        v0 += p0[q];
        v1 += p1[q];
      }
    }
    const int r = r0 + n;
    if (n < live) {
      if (FORM != kFloat) {
        v0 *= a.wscale[wcol0 + col];
        if (rope) v1 *= a.wscale[wcol0 + col + half];
      }
      if (rope) {
        const float* cr = a.rope_cos + r * a.cs_sr;
        const float* sr = a.rope_sin + r * a.cs_sr;
        // rotate-half: q*cos + concat(-q[hd/2:], q[:hd/2])*sin
        const float o0 = v0 * cr[e] + (-v1) * sr[e];
        const float o1 = v1 * cr[e + half] + v0 * sr[e + half];
        v0 = o0;
        v1 = o1;
      }
    } else {
      v0 = v1 = 0.f;
    }
    for (int q = 0; q < CS; ++q) {
      float* qq = cluster.map_shared_rank(qall, q) + n * GHD + col;
      qq[0] = v0;
      if (rope) qq[half] = v1;
    }
  }
  cluster.sync();   // q is complete in every block; partials are dead

  // ------------------------------------------------------------------
  // phase C: worker (rank, team) attends items w, w + W, ...
  // ------------------------------------------------------------------
  for (int i = tid; i < nbp; i += kThreads) {
    bm[i] = -INFINITY;
    bl[i] = 0.f;
  }
  for (int i = tid; i < nbp * hd; i += kThreads) bacc[i] = 0.f;
  __syncthreads();
  const int team = tid / kSplitThreads;
  if (team < a.teams) {
    using C = dli::SplitCfg<T, LPK, CPL>;
    const dli::NamedTeam tm{team};
    const int ttid = tm.tid();
    unsigned char* kv = U + a.off_kv + team * a.kv_bytes;
    // The live keys of every (slot, head group), slot by slot, head
    // group by head group, each led by kItemCost keys that stand for its
    // setup, as one sequence of K; worker wk takes [K*wk/W, K*(wk+1)/W):
    // the live keys in it, cut where it crosses a (slot, head group) and
    // into even pieces of <= kSplit keys
    const int W = CS * a.teams, wk = rank * a.teams + team;
    long long K = 0;
    for (int n = 0; n < kRT; ++n) {
      const int c = s_len[n] - s_beg[n];
      K += c > 0 ? (long long)n_hg * (c + kItemCost) : 0;
    }
    const long long lo = K * wk / W, hi = K * (wk + 1) / W;
    long long o = 0;
    for (int it = 0; it < kRT * n_hg; ++it) {
      const int n = it / n_hg, hg = it - n * n_hg;
      const int c = s_len[n] - s_beg[n];
      if (c <= 0) continue;
      const long long k0s = o + kItemCost;   // its first live key
      o = k0s + c;
      const long long a0 = k0s > lo ? k0s : lo;
      const long long a1 = o < hi ? o : hi;
      if (a0 >= a1) continue;
      const int ks0 = s_beg[n] + (int)(a0 - k0s);
      const int nk = (int)(a1 - a0);
      const int np = (nk + kSplit - 1) / kSplit;
      for (int pi = 0; pi < np; ++pi) {
        const int s0 = ks0 + (int)((long long)nk * pi / np);
        const int s1 = ks0 + (int)((long long)nk * (pi + 1) / np);
        const int len = s_len[n];
        const int ng = min(GT, G - hg * GT);
        const int r = r0 + n;
        const float* gm = dli::split_range<T, LPK, CPL, true>(
            tm, kv, dli::SharedQ<T>{qall + n * GHD + hg * GT * hd, hd},
            static_cast<const T*>(a.kpool), static_cast<const T*>(a.vpool),
            a.tbl_pitch ? tbl + n * a.tbl_pitch : a.bt + r * a.bt_sr, nullptr,
            r, kvh, ng, hd, a.bs, kSplit, s0, s1,
            len, a.ks, a.vs, a.scale_log2);
        // merge the item into the worker's partial of (n, head) in order
        const int pb = (team * RT + n) * G + hg * GT;
        for (int i = ttid; i < ng * hd; i += kSplitThreads) {
          const int g = i / hd, dd = i - g * hd;
          float M, L;
          const float A = dli::split_merge_groups<C::NG>(gm, hd, g, dd, M, L);
          const float mo = bm[pb + g];
          const float mn = fmaxf(mo, M);
          const float mu = mn == -INFINITY ? 0.f : mn;
          float* ac = bacc + (size_t)(pb + g) * hd + dd;
          *ac = *ac * fast_exp2(mo - mu) + A * fast_exp2(M - mu);
        }
        tm.sync();                         // every reader of bm is done
        for (int g = ttid; g < ng; g += kSplitThreads) {
          float M, L;
          dli::split_merge_groups<C::NG>(gm, hd, g, 0, M, L);
          const float mo = bm[pb + g];
          const float mn = fmaxf(mo, M);
          const float mu = mn == -INFINITY ? 0.f : mn;
          bl[pb + g] = bl[pb + g] * fast_exp2(mo - mu) + L * fast_exp2(M - mu);
          bm[pb + g] = mn;
        }
        tm.sync();                         // the item's smem is free
      }
    }
  }
  cluster.sync();   // every worker's partials are complete

  // ------------------------------------------------------------------
  // phase D: each worker pushes its partial of every live (slot, head)
  // row qi to the row's owner (rank qi % CS), which merges the W
  // partials of its rows by log-sum-exp in worker order
  // ------------------------------------------------------------------
  const int Wt = CS * a.teams;
  const int HP = hd + 2;                 // m, l, acc[hd]
  const int own = (RT * G + CS - 1) / CS;
  const int nq2 = live * G;
  float* inbox = reinterpret_cast<float*>(U + a.off_kv);   // [Wt][own][HP]
  for (int rr = warp; rr < a.teams * nq2; rr += kWarps) {   // a warp a row
    const int t = rr / nq2, qi = rr - t * nq2;
    const int n = qi / G, g = qi - n * G;
    const int idx = (t * RT + n) * G + g;
    float* dst = cluster.map_shared_rank(inbox, qi % CS) +
                 ((size_t)(rank * a.teams + t) * own + qi / CS) * HP;
    const float l = bl[idx];
    if (lane == 0) {
      dst[0] = bm[idx];
      dst[1] = l;
    }
    if (l > 0.f)   // a worker that attended none of the row's keys: no acc
      for (int e = lane; e < hd; e += 32)
        dst[2 + e] = bacc[(size_t)idx * hd + e];
  }
  cluster.sync();   // every row's partials are in its owner's inbox

  const int nown2 = nq2 > rank ? (nq2 - rank + CS - 1) / CS : 0;
  for (int oi = warp; oi < nown2; oi += kWarps) {   // a warp a row
    // lane w: worker w's (m, l) and weight (Wt <= 32)
    float mw = -INFINITY, lw = 0.f;
    if (lane < Wt) {
      const float* pw = inbox + ((size_t)lane * own + oi) * HP;
      mw = pw[0];
      lw = pw[1];
    }
    const float M = dli::warp_max(lw > 0.f ? mw : -INFINITY);
    const float fl = lw > 0.f ? fast_exp2(mw - M) : 0.f;
    float fw[kMaxCS * kTeams];           // every worker's weight, in order
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kMaxCS * kTeams; ++w) {
      fw[w] = __shfl_sync(0xffffffffu, fl, w);
      L += fw[w] * __shfl_sync(0xffffffffu, lw, w);   // 0 past Wt
    }
    const int qi = rank + oi * CS, n = qi / G, g = qi - n * G;
    T* orow = static_cast<T*>(a.out) + (r0 + n) * a.o_sr +
              (long long)(kvh * G + g) * a.o_sh;
    for (int dd = lane; dd < hd; dd += 32) {
      const float* pa = inbox + (size_t)oi * HP + 2 + dd;
      float A = 0.f;
#pragma unroll
      for (int w = 0; w < kMaxCS * kTeams; ++w)
        if (w < Wt && fw[w] != 0.f)
          A = fmaf(fw[w], pa[(size_t)w * own * HP], A);
      dli::store_val(orow + dd, L > 0.f ? A / L : 0.f);
    }
  }
}

// ---------------------------------------------------------------------
// host side: the plan, the cluster size, the launch
// ---------------------------------------------------------------------

struct Plan {
  int CS, RT, NCG, KP, teams, kchunk, tbl_pitch;
  int off_tbl, off_u, off_ring, off_part, off_kv, kv_bytes;
  size_t smem;
};

// The shared-memory layout of one (CS, RT, teams) choice; smem = 0 where
// it does not fit a block.
template <typename T, int FORM, int LPK, int CPL>
Plan layout(int CS, int RT, int teams, int tbl_pitch, int D, int G, int hd) {
  constexpr bool MMA = sizeof(T) == 2;
  constexpr int SR = stage_rows<MMA, FORM>();
  Plan p = {};
  p.CS = CS;
  p.RT = RT;
  p.teams = teams;
  p.tbl_pitch = tbl_pitch;
  const int GHD = G * hd;
  const int rows = FORM == kInt4 ? D / 2 : D;
  const int per = (rows + CS - 1) / CS;
  p.kchunk = (per + SR - 1) / SR * SR;
  p.NCG = (GHD + kCols - 1) / kCols;
  p.KP = p.NCG >= kWarps ? 1 : kWarps / p.NCG;
  const size_t qall = al16((size_t)RT * GHD * 4);
  const size_t bpart = al16((size_t)teams * RT * G * (hd + 2) * 4);
  const int xw = FORM == kInt4 ? 2 : 1;
  const size_t xs = al16(MMA ? (size_t)kRT * (p.kchunk + 8) * 2 * xw
                             : (size_t)p.kchunk * kRT * 4 * xw);
  const size_t ring = (size_t)kWarps * kStages * kStageBytes;
  const size_t part = (size_t)p.KP * RT * p.NCG * kCols * 4;
  const size_t phase_a = xs + ring + part;
  const size_t kv = al16(dli::split_smem_bytes<T, LPK, CPL, true>(hd, kSplit));
  const size_t phase_c = bpart + (size_t)teams * kv;
  const int own = (RT * G + CS - 1) / CS;
  const size_t phase_d = bpart + (size_t)CS * teams * (hd + 2) * own * 4;
  size_t u = phase_a > phase_c ? phase_a : phase_c;
  if (phase_d > u) u = phase_d;
  const size_t tbl = al16((size_t)RT * tbl_pitch * 4);
  p.off_tbl = (int)(kMeta + qall);
  p.off_u = (int)(kMeta + qall + tbl);
  p.off_ring = (int)xs;
  p.off_part = (int)(xs + ring);
  p.off_kv = (int)bpart;
  p.kv_bytes = (int)kv;
  const size_t total = kMeta + qall + tbl + u;
  p.smem = total <= (size_t)kMaxSmem ? total : 0;
  return p;
}

// The largest RT (8, 4, 2, 1), then the most teams (2, 1), then the
// tables staged (where RT rows of bt_sr entries take <= kTblBytes) or
// read in place, that fit
template <typename T, int FORM, int LPK, int CPL>
Plan plan_for(int CS, int D, int G, int hd, long long bt_sr) {
  for (int RT = kRT; RT >= 1; RT /= 2)
    for (int teams = kTeams; teams >= 1; --teams)
      for (int staged = 1; staged >= 0; --staged) {
        if (staged && (long long)RT * bt_sr * 4 > kTblBytes) continue;
        const Plan p = layout<T, FORM, LPK, CPL>(
            CS, RT, teams, staged ? (int)bt_sr : 0, D, G, hd);
        if (p.smem) return p;
      }
  return Plan{};
}

// The plan of one shape: the largest cluster size CS from 16 down to 9
// for which the occupancy API says Hkv clusters (one row group of every
// kv head) run at once, else the portable 8; `fit` is that answer for the
// size kept. Cached per instantiation for the last shape and device, so
// the host asks once per shape, not per call.
template <typename T, int FORM, int LPK, int CPL>
cudaError_t choose_plan(int D, int G, int hd, int Hkv, long long bt_sr,
                        Plan& p, int& fit) {
  auto kern = fused_cluster_kernel<T, FORM, LPK, CPL>;
  static std::mutex mu;
  static long long key[6] = {-1, -1, -1, -1, -1, -1};
  static Plan cached;
  static int cached_fit;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const long long want[6] = {D, G, hd, Hkv, bt_sr, dev};
  std::lock_guard<std::mutex> lock(mu);
  bool same = true;
  for (int i = 0; i < 6; ++i) same = same && key[i] == want[i];
  if (same) {
    p = cached;
    fit = cached_fit;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  p = Plan{};
  for (int CS = kMaxCS; CS >= 8; --CS) {
    const Plan c = plan_for<T, FORM, LPK, CPL>(CS, D, G, hd, bt_sr);
    if (!c.smem) continue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CS, Hkv, 1);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = c.smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&fit, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (fit >= (CS > 8 ? Hkv : 1)) {
      p = c;
      break;
    }
  }
  if (!p.smem) return cudaErrorInvalidConfiguration;
  cached = p;
  cached_fit = fit;
  for (int i = 0; i < 6; ++i) key[i] = want[i];
  return cudaSuccess;
}

template <typename T, int FORM, int LPK, int CPL>
cudaError_t launch(Args a, cudaStream_t stream, int* plan_out) {
  auto kern = fused_cluster_kernel<T, FORM, LPK, CPL>;
  Plan p;
  int fit = 0;
  cudaError_t perr = choose_plan<T, FORM, LPK, CPL>(
      a.D, a.H / a.Hkv, a.hd, a.Hkv, a.bt_sr, p, fit);
  if (perr != cudaSuccess) return perr;
  if (plan_out != nullptr) {   // report the plan, launch nothing
    plan_out[0] = p.CS;
    plan_out[1] = p.RT;
    plan_out[2] = p.teams;
    plan_out[3] = (int)p.smem;
    plan_out[4] = fit;
    return cudaSuccess;
  }
  a.rows = FORM == kInt4 ? a.D / 2 : a.D;
  a.kchunk = p.kchunk;
  a.RT = p.RT;
  a.NCG = p.NCG;
  a.KP = p.KP;
  a.teams = p.teams;
  a.tbl_pitch = p.tbl_pitch;
  a.off_tbl = p.off_tbl;
  a.off_u = p.off_u;
  a.off_ring = p.off_ring;
  a.off_part = p.off_part;
  a.off_kv = p.off_kv;
  a.kv_bytes = p.kv_bytes;
  const int groups = (a.R + p.RT - 1) / p.RT;
  if (groups > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.CS, a.Hkv, groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// LPK: hd's 16-byte chunks rounded up to a power of two, at least 2 and
// at most 32 lanes; f32 above hd 128 gives each lane two chunks (as
// paged_attention.cu's dispatch)
template <typename T, int FORM>
cudaError_t dispatch(const Args& a, cudaStream_t st, int* plan) {
  const int chunks = a.hd / dli::Chunk<T>::N;
  if (chunks <= 2) return launch<T, FORM, 2, 1>(a, st, plan);
  if (chunks <= 4) return launch<T, FORM, 4, 1>(a, st, plan);
  if (chunks <= 8) return launch<T, FORM, 8, 1>(a, st, plan);
  if (chunks <= 16) return launch<T, FORM, 16, 1>(a, st, plan);
  if (chunks <= 32) return launch<T, FORM, 32, 1>(a, st, plan);
  return launch<T, FORM, 32, 2>(a, st, plan);
}

template <typename T>
cudaError_t dispatch_form(int form, const Args& a, cudaStream_t st,
                          int* plan) {
  if (form == kFloat) return dispatch<T, kFloat>(a, st, plan);
  if (form == kInt8) return dispatch<T, kInt8>(a, st, plan);
  if (form == kInt4) return dispatch<T, kInt4>(a, st, plan);
  return cudaErrorInvalidValue;
}

bool bad_shape(int form, int D, int H, int Hkv, int hd, int bs) {
  return hd % 8 != 0 || hd > 256 || hd < 8 || Hkv < 1 || H % Hkv != 0 ||
         bs < 1 || D % 8 != 0 || D < 8 || Hkv > 65535 || form < kFloat ||
         form > kInt4;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, pools, out; w in the float form).
// form: 0 = float w [D, H*hd]; 1 = int8 q [D, H*hd] + wscale [H*hd] f32;
// 2 = int4 p4 [D/2, H*hd] uint8 + wscale. x and w 16-byte aligned with
// rows a multiple of 8 elements apart. rope_cos/rope_sin: [R, hd] f32 or
// both NULL (no RoPE). strides (elements): x r, w d (row), cos/sin r,
// block_tables r, k pool b/s/h, v pool b/s/h, out r/h. block_tables
// [R, MB] and context_lens [R] are int32 on the device, read by the
// kernel (the host never syncs on them). window <= 0: no window.
int dli_fused_decode_fwd(const void* x, const void* w, const void* wscale,
                         const void* rope_cos, const void* rope_sin,
                         const void* k, const void* v, void* out,
                         const void* block_tables, const void* context_lens,
                         int dtype, int form, int R, int D, int H, int Hkv,
                         int hd, int bs, const long long* strides,
                         float scale, int window, void* stream) {
  if (bad_shape(form, D, H, Hkv, hd, bs) ||
      (rope_cos == nullptr) != (rope_sin == nullptr) ||
      (form != kFloat && wscale == nullptr))
    return cudaErrorInvalidValue;
  if (R <= 0) return cudaSuccess;
  Args a = {};
  a.x = x;
  a.w = w;
  a.wscale = static_cast<const float*>(wscale);
  a.rope_cos = static_cast<const float*>(rope_cos);
  a.rope_sin = static_cast<const float*>(rope_sin);
  a.kpool = k;
  a.vpool = v;
  a.out = out;
  a.bt = static_cast<const int*>(block_tables);
  a.lens = static_cast<const int*>(context_lens);
  a.R = R;
  a.D = D;
  a.H = H;
  a.Hkv = Hkv;
  a.hd = hd;
  a.bs = bs;
  a.window = window;
  a.x_sr = strides[0];
  a.w_sd = strides[1];
  a.cs_sr = strides[2];
  a.bt_sr = strides[3];
  a.ks = PoolStrides{strides[4], strides[5], strides[6]};
  a.vs = PoolStrides{strides[7], strides[8], strides[9]};
  a.o_sr = strides[10];
  a.o_sh = strides[11];
  a.scale_log2 = scale * dli::kLog2e;
  // quantized rows: 16-byte copies where every row's column tile starts
  // 16-byte aligned, else two 8-byte copies
  a.al16 = a.w_sd % 16 == 0 && ((long long)(H / Hkv) * hd) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_form<float>(form, a, st, nullptr);
  if (dtype == 1) return dispatch_form<__nv_bfloat16>(form, a, st, nullptr);
  return cudaErrorInvalidValue;
}

// The launch plan dli_fused_decode_fwd takes for a shape (bt_sr: the
// block tables' row stride), launching nothing: plan[0..4] = cluster
// size CS, slots per row group RT,
// attention teams per block, dynamic shared memory bytes, and the
// occupancy API's count of co-resident clusters of that size.
int dli_fused_decode_plan(int dtype, int form, int D, int H, int Hkv,
                          int hd, int bt_sr, int* plan) {
  if (bad_shape(form, D, H, Hkv, hd, 1) || plan == nullptr || bt_sr < 1)
    return cudaErrorInvalidValue;
  Args a = {};
  a.D = D;
  a.H = H;
  a.Hkv = Hkv;
  a.hd = hd;
  a.bt_sr = bt_sr;
  if (dtype == 0) return dispatch_form<float>(form, a, nullptr, plan);
  if (dtype == 1) return dispatch_form<__nv_bfloat16>(form, a, nullptr, plan);
  return cudaErrorInvalidValue;
}

const char* dli_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
