// q4_matmul and q4_matmul_row for NVIDIA Hopper (sm_90a):
// y = x @ unpack(p4) * scale.
//
// Replaces the Pallas TPU kernel of the JAX package
// ops/pallas/quant_matmul.py _q4_pallas (_biased_kernel / _signed_kernel),
// which serves both q4_matmul and, per tp shard, q4_matmul_row:
// x [b <= 32, din] (f32 or bf16) against the split-half packed int4
// weight p4 [din/2, dout] uint8 (byte row i holds din row i in its low
// nibble and din row i + din/2 in its high nibble, each biased by +8),
// times the per-output-channel f32 scale, out [b, dout] in x's dtype. The
// unpacked weight never exists in device memory: each byte is unpacked
// in registers and feeds two products, against x[:, i] and
// x[:, i + din/2].
//
// Two forms, picked by the wrapper from x's dtype (ops/quant_matmul.py
// q4_form), never by a failure:
//   - q4_mma_kernel, bf16 x (the serving path): the products on the
//     tensor cores (mma.sync m16n8k16 bf16 -> f32), see its section below.
//   - q4_matmul_kernel, f32 x (the f32 cross-checks): the products on the
//     CUDA cores in f32, as TF32 or bf16 products would change them.
//
// What bounds it on this card, and what the designs do about it: the
// work is bounded by bytes, half a byte per weight (llama-3-8b: 8 MiB for
// q or o, 28 MiB for gate, up or down, 250 MiB for the head), read once.
// At the byte bound the card reads 6.7e12 weights/s; on the CUDA cores
// each weight then costs b FMAs plus its unpack, which at b = 8 is more
// than the f32 peak: the CUDA-core form is issue-bound there. The
// tensor-core form does the b products of a weight in the mma and spends
// about 1.5 instructions per weight on its level (one prmt per byte pair,
// then a LOP3 and a bf16x2 FMA per two levels), with several k-steps of
// weight bytes per warp in flight in a cp.async ring.
//
// The -8 bias: every nibble is made into its level n - 8 before its
// product (the JAX package's _signed_kernel form). The bf16 form of the
// TPU kernel instead multiplies the biased nibble and subtracts 8 * sum(x)
// at the end; that is the same sum, but the f32 accumulator then carries
// a large correction term and its rounding error. Here the levels are
// exact (in f32: n in the mantissa of 2^23, minus 2^23 + 8; in bf16: n in
// the mantissa of 128, minus 136), x is exact in f32 and bf16, every
// product is exact in f32, sums are f32, and the result is scaled and
// rounded to x's dtype once. So either form differs from the plain
// version (unpack, f32 matmul, scale, one rounding) only by the order of
// its f32 sums: at most 2 * din * 2^-24 * sum|x * w| * scale, plus one
// output ulp in bf16. chip_smoke.py holds it to exactly that.
//
// The CUDA-core form: each thread reads 8 neighbouring dout columns of a
// packed row in one 8-byte load, a warp 256 contiguous bytes of the row,
// and keeps four rows' loads in flight. A block covers 256 columns and up
// to 8 rows of x; its 8 warps split the block's share of the contraction
// and their partial sums are added in shared memory in a fixed order.
// Where dout gives too few blocks to fill the card (k and v: dout =
// 1024), the contraction is split over grid.y as well; those partial sums
// go to an f32 workspace and a second small kernel adds them in a fixed
// order, scales and rounds: no float atomics, so two runs give the same
// bits (the tensor-core form adds its splits within a cluster instead).
// x is staged in shared memory 256 packed rows at a time (at b = 32 and
// din = 14336 the whole x would not fit). More than 8 rows of x split
// over grid.z; each row chunk reads the weight again (L2 serves part of
// it).
//
// q4_matmul_row: the same kernels over the chunk-local layout of the
// row-parallel leaves (ops/quant.py repack_int4_rows): each of C equal din
// row groups is its own split-half pack, so packed row i of chunk
// c = i / (din/2C) pairs din rows i + c*din/2C and that + din/2C. Only
// the staging of x (CUDA cores) or its B fragments (tensor cores) read
// that pairing, per packed row, so split-K
// boundaries may fall anywhere, inside a chunk or across one; C = 1 is
// q4_matmul's layout. On a tp rank the rank's slice is one chunk (C = 1)
// and the caller sums the [b, dout] partials across ranks; on one device
// holding the whole chunked leaf one launch covers all C chunks, their
// partial sums added in the same fixed order as any split-K.
//
// Interface: plain C, pointers and the stream as void*, the launcher
// returns its cudaError_t (0 on success) and allocates nothing.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using dli::int4_level;
using dli::kMaxSmem;
using dli::load_val;
using dli::store_val;

constexpr int kThreads = 256;
constexpr int kColThreads = 32;                  // one warp across columns
constexpr int kKWarps = kThreads / kColThreads;  // warps over the contraction
constexpr int kCols = 8;                         // columns per thread
constexpr int kTileN = kColThreads * kCols;      // columns per block
constexpr int kRowsMax = 8;                      // x rows per block
constexpr int kTileK = 256;                      // packed rows of x in smem
constexpr int kUnroll = 4;                       // packed-row loads in flight

__device__ __forceinline__ void fma_word(float (&acc)[kCols], int j0,
                                         uint32_t word, float xl, float xh) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc[j0 + j] = fmaf(xl, int4_level(word, 8 * j), acc[j0 + j]);
    acc[j0 + j] = fmaf(xh, int4_level(word, 8 * j + 4), acc[j0 + j]);
  }
}

// grid (ceil(dout / kTileN), ksplit, ceil(b / kRowsMax)), kThreads.
// Block (n, s, z): columns [n*kTileN, +kTileN), packed rows
// [s*kchunk, +kchunk), x rows [z*kRowsMax, +RB). ksplit == 1: writes out
// (scaled, rounded); else writes f32 partial sums part[s][row][col].
// ch: packed rows per split-half chunk (din/2 for the global layout).
template <typename T, int RB>
__global__ void __launch_bounds__(kThreads)
q4_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ p4,
                 const float* __restrict__ scale, T* __restrict__ out,
                 float* __restrict__ part, int b, int din, int dout,
                 long long x_sr, long long o_sr, int kchunk, int ch) {
  extern __shared__ float smem[];
  // phase 1: Xlo [kTileK][RB], Xhi [kTileK][RB]; phase 2: Red
  // [kKWarps][RB][kTileN]
  float* Xlo = smem;
  float* Xhi = smem + kTileK * RB;
  float* Red = smem;
  const int half = din / 2;
  const int tid = threadIdx.x;
  const int lane = tid % kColThreads, warp = tid / kColThreads;
  const int col = blockIdx.x * kTileN + lane * kCols;
  const int r0 = blockIdx.z * kRowsMax;
  const int nr = min(RB, b - r0);
  const int k0 = blockIdx.y * kchunk;
  const int k1 = min(half, k0 + kchunk);
  const T* xb = x + r0 * x_sr;

  float acc[RB][kCols];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;

  for (int kt = k0; kt < k1; kt += kTileK) {
    const int n = min(kTileK, k1 - kt);
    __syncthreads();                 // the previous tile is consumed
    for (int i = tid; i < n * RB; i += kThreads) {
      const int k = i / RB, r = i - k * RB;
      const bool live = r < nr;
      const int row = kt + k;               // packed row
      const int lo = row + (row / ch) * ch;  // its low nibble's din row
      Xlo[i] = live ? load_val(xb + r * x_sr + lo) : 0.f;
      Xhi[i] = live ? load_val(xb + r * x_sr + lo + ch) : 0.f;
    }
    __syncthreads();
    if (col < dout) {
      for (int i0 = warp; i0 < n; i0 += kKWarps * kUnroll) {
        uint2 wv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kKWarps;
          if (i < n)
            wv[u] = *reinterpret_cast<const uint2*>(
                p4 + (long long)(kt + i) * dout + col);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kKWarps;
          if (i < n) {
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              const float xl = Xlo[i * RB + r], xh = Xhi[i * RB + r];
              fma_word(acc[r], 0, wv[u].x, xl, xh);
              fma_word(acc[r], 4, wv[u].y, xl, xh);
            }
          }
        }
      }
    }
  }
  __syncthreads();                   // Xlo/Xhi are dead: Red reuses them
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      Red[(warp * RB + r) * kTileN + lane * kCols + j] = acc[r][j];
  __syncthreads();
  for (int o = tid; o < RB * kTileN; o += kThreads) {
    const int r = o / kTileN, c = blockIdx.x * kTileN + (o - r * kTileN);
    if (r >= nr || c >= dout) continue;
    float s = Red[o];
    for (int w = 1; w < kKWarps; ++w) s += Red[w * RB * kTileN + o];
    if (gridDim.y == 1)
      store_val(out + (r0 + r) * o_sr + c, s * scale[c]);
    else
      part[((long long)blockIdx.y * b + r0 + r) * dout + c] = s;
  }
}

// out[r][c] = (sum over s of part[s][r][c], s in order) * scale[c]
template <typename T>
__global__ void q4_finish_kernel(const float* __restrict__ part,
                                 const float* __restrict__ scale,
                                 T* __restrict__ out, int ksplit, int b,
                                 int dout, long long o_sr) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)b * dout) return;
  const int r = (int)(i / dout), c = (int)(i - (long long)r * dout);
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k)
    s += part[((long long)k * b + r) * dout + c];
  store_val(out + r * o_sr + c, s * scale[c]);
}

template <typename T, int RB>
cudaError_t launch_rb(const T* x, const uint8_t* p4, const float* scale,
                      T* out, float* part, int b, int din, int dout,
                      long long x_sr, long long o_sr, int ksplit, int ch,
                      cudaStream_t stream) {
  auto kern = q4_matmul_kernel<T, RB>;
  const size_t xs = 2 * kTileK * RB, red = kKWarps * RB * kTileN;
  const size_t smem = sizeof(float) * (xs > red ? xs : red);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int half = din / 2;
  const int kchunk = (half + ksplit - 1) / ksplit;
  const dim3 grid((dout + kTileN - 1) / kTileN, ksplit,
                  (b + kRowsMax - 1) / kRowsMax);
  kern<<<grid, kThreads, smem, stream>>>(x, p4, scale, out, part, b, din,
                                         dout, x_sr, o_sr, kchunk, ch);
  err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return err;
  const long long total = (long long)b * dout;
  q4_finish_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      part, scale, out, ksplit, b, dout, o_sr);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// The tensor-core form (bf16 x): out^T = W^T x^T with
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32; dout columns are M, x's
// rows N (one to four 8-row n-tiles), din K.
//
// K: the 16 k-slots of one mma take 8 packed rows r .. r+7, their low
// nibbles on slots 0-7 and their high nibbles on slots 8-15. Thread
// (group g = lane / 4, t = lane % 4) holds slots 2t, 2t+1 (low nibbles of
// packed rows r+2t, r+2t+1) and 2t+8, 2t+9 (their high nibbles): each
// byte it loads feeds an A register pair, with no shuffles. Only x's B
// fragments read which din row a slot is (lo = row + (row / ch) * ch,
// and lo + ch), so q4_matmul_row's chunk-local pairing costs nothing.
// M: thread (g, t) loads 16 consecutive dout bytes of packed rows r+2t
// and r+2t+1 (columns g*16 .. g*16+15 of the warp's 128); its mma j takes
// columns g*16 + 2j and g*16 + 2j + 1 as its two M rows, so the weight
// streams in its stored layout, each row of a warp's load 128 contiguous
// bytes, with no ldmatrix and no repack; the epilogue writes each
// accumulator to its true column.
// Levels: OR the nibble into the mantissa of bf16 128 (0x4300 | n is
// 128 + n) and subtract 136 with one bf16x2 FMA: n - 8, exactly.
//
// A block is 4 warps on 128 columns; they split the block's share of the
// contraction in contiguous runs of k-steps (8 packed rows), each warp
// streaming its run through its own kMmaStages-deep cp.async ring in
// shared memory (the weight bytes and x's B fragments of a k-step), so
// kMmaStages - 1 k-steps of loads per warp are in flight while it
// computes. The warps' sums are added in shared memory in warp order.
// Where dout gives too few blocks, the contraction is split over grid.y
// into at most 8 blocks that form one thread block cluster: each output
// adds the blocks' sums in rank order through distributed shared memory,
// with no workspace, no second kernel and no float atomics, so two
// launches give the same bits. (Measured on an H100: 3 stages and 4 warps
// beat 2, 4, 5 and 8 stages and 8 or 16 warps; doing 1/8 of the products
// did not speed it up, so it is bound by the weight stream, which reaches
// about 1.7 TB/s on the 250 MiB head in chip_smoke.py.)
// ---------------------------------------------------------------------

using dli::cp_async_16;
using dli::cp_async_4;
using dli::cp_async_8;
using dli::cp_async_commit;
using dli::cp_async_wait;
using dli::mma_bf16_16816;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaCols = 128;        // columns per block (one warp's width)
constexpr int kMmaStages = 3;        // k-steps per warp ring
constexpr int kStepRows = 8;         // packed rows per k-step (16 din rows)
constexpr int kWStage = 2 * 32 * 16; // weight bytes of a k-step per warp
constexpr int kMmaMaxSplit = 8;      // blocks of a cluster (portable size)

template <int NT>
struct MmaCfg {
  static constexpr int STAGE = kWStage + NT * 32 * 8;   // + x fragments
  static constexpr size_t ring = (size_t)kMmaWarps * kMmaStages * STAGE;
  static constexpr size_t red =
      (size_t)kMmaWarps * 8 * NT * kMmaCols * sizeof(float);
  static constexpr size_t smem = ring > red ? ring : red;
};

// two bf16 levels n - 8 from the nibbles at bits 0-3 and 16-19 of t
__device__ __forceinline__ uint32_t bf16_levels(uint32_t t) {
  const uint32_t v = (t & 0x000F000Fu) | 0x43004300u;   // 128 + n
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));    // * 1 - 136
  return d;
}

// grid (ceil(dout / kMmaCols), ksplit), kMmaThreads threads. Block (n, s):
// columns [n*kMmaCols, +kMmaCols), packed rows [s*kchunk, +kchunk), all b
// <= 8*NT rows of x. AL: dout % 16 == 0, p4 16-byte aligned, an even
// chunk length ch, x rows 4-byte aligned (16-byte weight copies, x
// fragments copied into the ring); else 8-byte weight copies and x read
// as it is used.
template <int NT, bool AL>
__global__ void __launch_bounds__(kMmaThreads)
q4_mma_kernel(const __nv_bfloat16* __restrict__ x,
              const uint8_t* __restrict__ p4,
              const float* __restrict__ scale,
              __nv_bfloat16* __restrict__ out,
              int b, int dout, long long x_sr, long long o_sr, int half,
              int kchunk, int ch) {
  using C = MmaCfg<NT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int cb = blockIdx.x * kMmaCols;
  const int col = cb + g * 16;             // this thread's 16 columns
  const int k0 = blockIdx.y * kchunk;
  const int k1 = min(half, k0 + kchunk);
  const int nsteps = (k1 - k0 + kStepRows - 1) / kStepRows;
  const int s_begin = warp * nsteps / kMmaWarps;   // this warp's k-steps
  const int n_my = (warp + 1) * nsteps / kMmaWarps - s_begin;
  unsigned char* ring = smem_raw + warp * kMmaStages * C::STAGE;
  const uint32_t ring_s = dli::smem_u32(ring);
  const unsigned short* xr = reinterpret_cast<const unsigned short*>(x);

  // The warp's next k-step into ring slot `slot` (k-steps are issued in
  // order): rows p, p + 1 of this thread's columns (zero past k1 or dout)
  // and, with AL, its B fragments (zero for rows of x past b and packed
  // rows past k1). p's chunk (pc) and place in it (pr) advance with p, so
  // the chunk pairing costs no division per step.
  int p = k0 + s_begin * kStepRows + 2 * tq;
  int pc = p / ch, pr = p - pc * ch;
  const uint8_t* wsrc = p4 + (long long)p * dout + col;
  auto issue = [&](int slot) {
    const uint32_t dst = ring_s + slot * C::STAGE;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const bool ok = col < dout && p + rr < k1;
      const uint8_t* src = wsrc + rr * dout;
      const uint32_t d = dst + rr * 512 + lane * 16;
      if constexpr (AL) {
        cp_async_16(d, ok ? src : p4, ok);
      } else {
        const bool ok2 = ok && col + 8 < dout;
        cp_async_8(d, ok ? src : p4, ok);
        cp_async_8(d + 8, ok2 ? src + 8 : p4, ok2);
      }
    }
    if constexpr (AL) {
      const int lo = p + pc * ch;          // p even, ch even: lo + 1 pairs
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int n = 8 * t + g;
        const bool ok = n < b && p < k1;
        const __nv_bfloat16* xs = x + n * x_sr + lo;
        const uint32_t d = dst + kWStage + t * 256 + lane * 8;
        cp_async_4(d, ok ? xs : x, ok);
        cp_async_4(d + 4, ok ? xs + ch : x, ok);
      }
    }
    cp_async_commit();
    p += kStepRows;
    wsrc += (long long)kStepRows * dout;
    for (pr += kStepRows; pr >= ch; pr -= ch) ++pc;
  };

  float acc[8][NT][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][t][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kMmaStages - 1; ++i) {
    if (i < n_my) issue(i);
    else cp_async_commit();
  }
  for (int i = 0; i < n_my; ++i) {
    cp_async_wait<kMmaStages - 2>();       // k-step i has landed
    const unsigned char* st = ring + (i % kMmaStages) * C::STAGE;
    const uint4 w0 = *reinterpret_cast<const uint4*>(st + lane * 16);
    const uint4 w1 = *reinterpret_cast<const uint4*>(st + 512 + lane * 16);
    uint32_t xb[NT][2];
    if constexpr (AL) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const uint2 v =
            *reinterpret_cast<const uint2*>(st + kWStage + t * 256 + lane * 8);
        xb[t][0] = v.x;
        xb[t][1] = v.y;
      }
    } else {
      const int pp = k0 + (s_begin + i) * kStepRows + 2 * tq;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int n = 8 * t + g;
        uint32_t lo2 = 0, hi2 = 0;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = pp + rr;
          if (n < b && row < k1) {
            const long long lo = n * x_sr + row + (row / ch) * ch;
            lo2 |= (uint32_t)xr[lo] << (16 * rr);
            hi2 |= (uint32_t)xr[lo + ch] << (16 * rr);
          }
        }
        xb[t][0] = lo2;
        xb[t][1] = hi2;
      }
    }
    const uint32_t wa[4] = {w0.x, w0.y, w0.z, w0.w};
    const uint32_t wb[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // bytes [row p col c, row p col c+1, row p+1 col c, row p+1 col c+1]
      const uint32_t tw =
          __byte_perm(wa[j >> 1], wb[j >> 1], (j & 1) ? 0x7632 : 0x5410);
      const uint32_t af[4] = {bf16_levels(tw), bf16_levels(tw >> 8),
                              bf16_levels(tw >> 4), bf16_levels(tw >> 12)};
#pragma unroll
      for (int t = 0; t < NT; ++t)
        mma_bf16_16816(acc[j][t], af, xb[t][0], xb[t][1]);
    }
    // refill the slot read in the previous step (its values are in
    // registers by now)
    if (i + kMmaStages - 1 < n_my)
      issue((i + kMmaStages - 1) % kMmaStages);
    else
      cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();                         // the rings are dead: Red reuses

  // Red [warp][8*NT rows][kMmaCols]: accumulator (j, t) of thread (g, tq)
  // is rows 8t + 2tq (+1) x columns g*16 + 2j (+1)
  float* red = reinterpret_cast<float*>(smem_raw);
  constexpr int RR = 8 * NT;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int n0 = 8 * t + 2 * tq, cl = g * 16 + 2 * j;
      float* r0 = red + ((warp * RR) + n0) * kMmaCols + cl;
      *reinterpret_cast<float2*>(r0) = make_float2(acc[j][t][0], acc[j][t][2]);
      *reinterpret_cast<float2*>(r0 + kMmaCols) =
          make_float2(acc[j][t][1], acc[j][t][3]);
    }
  __syncthreads();
  // the block's sum over its warps, in warp order, into red[0]
  for (int o = tid; o < RR * kMmaCols; o += kMmaThreads) {
    float v = red[o];
#pragma unroll
    for (int w = 1; w < kMmaWarps; ++w) v += red[w * RR * kMmaCols + o];
    red[o] = v;
  }
  // the contraction's splits are the cluster's blocks (grid.y): each
  // output adds every block's sum in rank order through distributed
  // shared memory, the outputs shared out over the blocks
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ks = (int)cluster.num_blocks();
  for (int o = (int)cluster.block_rank() * kMmaThreads + tid;
       o < RR * kMmaCols; o += ks * kMmaThreads) {
    const int r = o / kMmaCols, c = cb + (o - r * kMmaCols);
    if (r >= b || c >= dout) continue;
    float v = 0.f;
    for (int q = 0; q < ks; ++q) v += cluster.map_shared_rank(red, q)[o];
    out[r * o_sr + c] = __float2bfloat16(v * scale[c]);
  }
  cluster.sync();   // no block leaves while another reads its sums
}

template <int NT, bool AL>
cudaError_t launch_mma_nt(const __nv_bfloat16* x, const uint8_t* p4,
                          const float* scale, __nv_bfloat16* out, int b,
                          int din, int dout, long long x_sr, long long o_sr,
                          int kchunk, int ksplit, int ch,
                          cudaStream_t stream) {
  auto kern = q4_mma_kernel<NT, AL>;
  const size_t smem = MmaCfg<NT>::smem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((dout + kMmaCols - 1) / kMmaCols, ksplit);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ksplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, x, p4, scale, out, b, dout, x_sr,
                           o_sr, din / 2, kchunk, ch);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool AL>
cudaError_t launch_mma_al(const __nv_bfloat16* x, const uint8_t* p4,
                          const float* scale, __nv_bfloat16* out, int b,
                          int din, int dout, long long x_sr, long long o_sr,
                          int kchunk, int ksplit, int ch, cudaStream_t st) {
#define DLI_MMA_NT(NT)                                                   \
  return launch_mma_nt<NT, AL>(x, p4, scale, out, b, din, dout, x_sr,    \
                               o_sr, kchunk, ksplit, ch, st)
  if (b <= 8) DLI_MMA_NT(1);
  if (b <= 16) DLI_MMA_NT(2);
  if (b <= 24) DLI_MMA_NT(3);
  DLI_MMA_NT(4);
#undef DLI_MMA_NT
}

template <typename T>
cudaError_t launch(const void* x, const void* p4, const void* scale,
                   void* out, void* part, int b, int din, int dout,
                   long long x_sr, long long o_sr, int ksplit, int ch,
                   cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(p4);
  const float* sp = static_cast<const float*>(scale);
  T* op = static_cast<T*>(out);
  float* pp = static_cast<float*>(part);
  if (b == 1)
    return launch_rb<T, 1>(xp, wp, sp, op, pp, b, din, dout, x_sr, o_sr,
                           ksplit, ch, st);
  if (b == 2)
    return launch_rb<T, 2>(xp, wp, sp, op, pp, b, din, dout, x_sr, o_sr,
                           ksplit, ch, st);
  if (b <= 4)
    return launch_rb<T, 4>(xp, wp, sp, op, pp, b, din, dout, x_sr, o_sr,
                           ksplit, ch, st);
  return launch_rb<T, kRowsMax>(xp, wp, sp, op, pp, b, din, dout, x_sr,
                                o_sr, ksplit, ch, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, out). x [b, din] with row stride
// x_sr, p4 [din/2, dout] uint8 contiguous and 8-byte aligned, scale [dout]
// f32, out [b, dout] with row stride o_sr. ksplit >= 1 splits the
// contraction; ksplit > 1 needs part, an f32 workspace of ksplit*b*dout.
// chunks: the pack's chunk-local split-half groups (din % (2 * chunks) ==
// 0); 1 is the global layout of q4_matmul.
int dli_q4_matmul(const void* x, const void* p4, const void* scale,
                  void* out, void* part, int dtype, int b, int din, int dout,
                  long long x_sr, long long o_sr, int ksplit, int chunks,
                  void* stream) {
  if (din < 2 || dout < 8 || dout % 8 != 0 || ksplit < 1 ||
      ksplit > din / 2 || (ksplit > 1 && part == nullptr) || b < 0 ||
      b > 32 || chunks < 1 || din % (2 * chunks) != 0)
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ch = din / (2 * chunks);
  if (dtype == 0)
    return launch<float>(x, p4, scale, out, part, b, din, dout, x_sr, o_sr,
                         ksplit, ch, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, p4, scale, out, part, b, din, dout, x_sr,
                                 o_sr, ksplit, ch, st);
  return cudaErrorInvalidValue;
}

// The tensor-core form: bf16 x and out, arguments as dli_q4_matmul's,
// except that the contraction split is given as kchunk (packed rows per
// split, a multiple of 8) and ksplit = ceil(din/2 / kchunk) <= 8 splits,
// which are one cluster's blocks and need no workspace.
int dli_q4_matmul_mma(const void* x, const void* p4, const void* scale,
                      void* out, int b, int din, int dout, long long x_sr,
                      long long o_sr, int kchunk, int ksplit, int chunks,
                      void* stream) {
  const int half = din / 2;
  if (din < 2 || dout < 8 || dout % 8 != 0 || kchunk < 8 || kchunk % 8 ||
      ksplit < 1 || ksplit > kMmaMaxSplit ||
      (half + kchunk - 1) / kchunk != ksplit || b < 0 || b > 32 ||
      chunks < 1 || din % (2 * chunks) != 0)
    return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ch = din / (2 * chunks);
  const bool al = dout % 16 == 0 && ch % 2 == 0 && x_sr % 2 == 0 &&
                  reinterpret_cast<uintptr_t>(p4) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 4 == 0;
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto wp = static_cast<const uint8_t*>(p4);
  auto sp = static_cast<const float*>(scale);
  auto op = static_cast<__nv_bfloat16*>(out);
  if (al)
    return launch_mma_al<true>(xp, wp, sp, op, b, din, dout, x_sr, o_sr,
                               kchunk, ksplit, ch, st);
  return launch_mma_al<false>(xp, wp, sp, op, b, din, dout, x_sr, o_sr,
                              kchunk, ksplit, ch, st);
}

const char* dli_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
