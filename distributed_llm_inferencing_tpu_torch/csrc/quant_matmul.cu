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
// The -8 bias: every nibble is sign-extended before its product (the
// JAX package's _signed_kernel form). The bf16 form of the TPU kernel
// instead multiplies the biased nibble and subtracts 8 * sum(x) at the
// end; that is the same sum, but the f32 accumulator then carries a large
// correction term and its rounding error. Here the levels n - 8 are made
// exactly in one FADD (n in the mantissa of 2^23, minus 2^23 + 8), x is
// widened to f32, products and sums are f32, and the result is scaled and
// rounded to x's dtype once. So the kernel differs from the plain version
// (unpack, f32 matmul, scale, one rounding) only by the order of its f32
// sums: at most 2 * din * 2^-24 * sum|x * w| * scale, plus one output
// ulp in bf16. chip_smoke.py holds it to exactly that.
//
// What bounds it on this card, and what the design does about it: it is
// bounded by bytes, half a byte per weight (llama-3-8b: 8 MiB for q or o,
// 28 MiB for gate, up or down, 250 MiB for the head), read once. Each
// thread reads 8 neighbouring dout columns of a packed row in one 8-byte
// load, a warp 256 contiguous bytes of the row, and keeps four rows'
// loads in flight. A block covers 256 columns and up to 8 rows of x; its
// 8 warps split the block's share of the contraction and their partial
// sums are added in shared memory in a fixed order. Where dout gives too
// few blocks to fill the card (k and v: dout = 1024), the contraction is
// split over grid.y as well; those partial sums go to an f32 workspace
// and a second small kernel adds them in a fixed order, scales and
// rounds: no float atomics, so two runs give the same bits. x is staged
// in shared memory 256 packed rows at a time (at b = 32 and din = 14336
// the whole x would not fit). More than 8 rows of x split over grid.z;
// each row chunk reads the weight again (L2 serves part of it).
//
// q4_matmul_row: the same kernel over the chunk-local layout of the
// row-parallel leaves (ops/quant.py repack_int4_rows): each of C equal din
// row groups is its own split-half pack, so packed row i of chunk
// c = i / (din/2C) pairs din rows i + c*din/2C and that + din/2C. Only
// the staging of x reads that pairing, per packed row, so split-K
// boundaries may fall anywhere, inside a chunk or across one; C = 1 is
// q4_matmul's layout. On a tp rank the rank's slice is one chunk (C = 1)
// and the caller sums the [b, dout] partials across ranks; on one device
// holding the whole chunked leaf one launch covers all C chunks, their
// partial sums added in the same fixed order as any split-K.
//
// Interface: plain C, pointers and the stream as void*, the launcher
// returns its cudaError_t (0 on success) and allocates nothing.

#include "common.cuh"

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

const char* dli_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
