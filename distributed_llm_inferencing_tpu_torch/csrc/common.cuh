// Device helpers shared by the port's CUDA kernels (csrc/*.cu): 16-byte
// vector loads widened to f32, typed stores, tile loads into shared
// memory, cp.async copies, ldmatrix / mma.sync fragments and warp
// reductions. Header only; every source that includes it
// is rebuilt when it changes (ops/build.py hashes *.cuh into each
// library's name).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dli {

constexpr int kMaxSmem = 232448;   // per-block dynamic shared memory cap

// Strides (elements) of one layer's K or V: a paged pool [NB, bs, Hkv, hd]
// or a dense cache [B, S, Hkv, hd]; hd contiguous.
struct PoolStrides {
  long long sb, ss, sh;
};

// 16-byte vector loads: 4 floats or 8 bf16 values, widened to f32.
template <typename T> struct Chunk;
template <> struct Chunk<float> { static constexpr int N = 4; };
template <> struct Chunk<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load_chunk(const float* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Quantized weight levels, exactly, without an int-to-float conversion:
// an 8-bit value v placed in the mantissa of 2^23 reads as 2^23 + v.
// int4_level: the biased nibble n (0..15) at bit `shift` of `word`, as
// n - 8 (the split-half packing of ops/quant.py). int8_level: the signed
// byte at bit `shift`, as its value (v ^ 0x80 is v + 128 unsigned).
__device__ __forceinline__ float int4_level(uint32_t word, int shift) {
  return __uint_as_float(0x4B000000u | ((word >> shift) & 0xFu)) -
         8388616.0f;   // 2^23 + 8
}
__device__ __forceinline__ float int8_level(uint32_t word, int shift) {
  return __uint_as_float(0x4B000000u | (((word >> shift) & 0xFFu) ^ 0x80u)) -
         8388736.0f;   // 2^23 + 128
}

__device__ __forceinline__ float load_val(const float* p) { return *p; }
__device__ __forceinline__ float load_val(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Copy `rows` rows of hd values (row r starts at base + r*row_stride) into
// shared memory as f32 with row pitch `pitch`. Rows >= `valid` are zeroed
// and never read from global memory.
template <typename T>
__device__ void load_tile(float* dst, int pitch, const T* base,
                          long long row_stride, int rows, int valid, int hd) {
  constexpr int N = Chunk<T>::N;
  const int chunks = hd / N;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * N;
    float vals[N];
    if (r < valid) {
      load_chunk(base + r * row_stride + c, vals);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) vals[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) dst[r * pitch + c + j] = vals[j];
  }
}

// ---------------------------------------------------------------------
// Asynchronous copies and tensor-core fragments (sm_80+ PTX, used by the
// bf16 prefill, the split-KV decodes and the int4 matmul).
// ---------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses L1; with valid == false the
// destination is zero-filled and nothing is read. dst: a shared address.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  cp_async_16(smem_u32(dst), src, valid);
}

// 4- and 8-byte global -> shared copies (through L1), zero-filled and
// reading nothing when valid == false. dst: a shared address aligned to
// the size, src likewise.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices from shared address `a`; lanes 8i..8i+7 give the
// row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// c[16x8] += a[16x16] (row) * b[16x8] (col), bf16 inputs, f32 accumulate
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (2^-inf = 0; results below 2^-126
// flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats as one bf16 pair register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace dli
