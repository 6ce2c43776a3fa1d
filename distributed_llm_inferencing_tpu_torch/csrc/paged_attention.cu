// Paged flash decode for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
// ops/pallas/paged_attention.py paged_flash_decode (kernel
// _paged_decode_kernel): one query token per serving slot, q [R,1,H,hd],
// against one layer's block pool [NB,bs,Hkv,hd] through block_tables
// [R,MB] and context_lens [R] (fill after this token's write; the query
// sits at context_lens - 1), with an optional static sliding window.
//
// What bounds it on this card, and what the design does about it: it is
// bounded by bytes, the K/V rows of [0, len) of every slot (operations are
// 4*H*hd per key row, far below the bf16 ridge). The JAX wrapper
// transposes the whole pool to [NB,Hkv,bs,hd] on every call; this kernel
// reads the pool in its stored layout through strides, so one layer's
// slice of the [L,...] pool is a view and nothing is copied. One thread
// block per (kv head, slot) reads each K/V row of its slot once for all G
// query heads of the group (csrc/paged_decode.cuh) and stops at the
// slot's length; at R=8 and Hkv=8 that is 64 blocks on 132 SMs, the known
// limit of this first version (split-KV is the next step).
//
// Interface: plain C, pointers and the stream as void*, the launcher
// returns its cudaError_t (0 on success) and allocates nothing.

#include "paged_decode.cuh"

namespace {

using dli::kMaxSmem;
using dli::kPagedThreads;
using dli::load_tile;
using dli::PoolStrides;

// grid (Hkv, R), kPagedThreads threads; smem: Qs [G][hd] + paged_attend's
template <typename T>
__global__ void __launch_bounds__(kPagedThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, T* __restrict__ out,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ context_lens, int H, int Hkv,
                    int hd, int bs, long long q_sr, long long q_sh,
                    long long bt_sr, PoolStrides ks, PoolStrides vs,
                    long long o_sr, long long o_sh, float scale,
                    int window) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int kvh = blockIdx.x, r = blockIdx.y;
  float* Qs = smem;                  // [G][hd]
  load_tile(Qs, hd, q + r * q_sr + (long long)kvh * G * q_sh, q_sh, G, G,
            hd);
  dli::paged_attend<T>(Qs + G * hd, Qs, kpool, vpool, ks, vs,
                       block_tables + r * bt_sr, context_lens[r], bs, kvh, G,
                       hd, scale, window,
                       out + r * o_sr + (long long)kvh * G * o_sh, o_sh);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const void* bt, const void* lens, int R, int H, int Hkv,
                   int hd, int bs, const long long* st, float scale,
                   int window, cudaStream_t stream) {
  auto kern = paged_decode_kernel<T>;
  const int G = H / Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)G * hd + dli::paged_attend_smem_floats(G, hd));
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, R);
  kern<<<grid, kPagedThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<const int*>(bt), static_cast<const int*>(lens), H, Hkv, hd,
      bs, st[0], st[1], st[2], PoolStrides{st[3], st[4], st[5]},
      PoolStrides{st[6], st[7], st[8]}, st[9], st[10], scale, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides (elements): q r/h, block_tables
// r, k pool b/s/h, v pool b/s/h, out r/h. block_tables [R, MB] and
// context_lens [R] are int32 on the device (read by the kernel; the host
// never syncs on them). window <= 0: no window.
int dli_paged_decode_fwd(const void* q, const void* k, const void* v,
                         void* out, const void* block_tables,
                         const void* context_lens, int dtype, int R, int H,
                         int Hkv, int hd, int bs, const long long* strides,
                         float scale, int window, void* stream) {
  if (hd % 8 != 0 || hd > 256 || hd < 8 || H % Hkv != 0 || bs < 1)
    return cudaErrorInvalidValue;
  if (R <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, block_tables, context_lens, R, H, Hkv,
                         hd, bs, strides, scale, window, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, block_tables, context_lens, R,
                                 H, Hkv, hd, bs, strides, scale, window, st);
  return cudaErrorInvalidValue;
}

const char* dli_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
