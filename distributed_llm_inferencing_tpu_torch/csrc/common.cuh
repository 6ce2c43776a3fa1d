// Device helpers shared by the port's CUDA kernels (csrc/*.cu): 16-byte
// vector loads widened to f32, typed stores, tile loads into shared
// memory and warp reductions. Header only; every source that includes it
// is rebuilt when it changes (ops/build.py hashes *.cuh into each
// library's name).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dli {

constexpr int kMaxSmem = 232448;   // per-block dynamic shared memory cap

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
