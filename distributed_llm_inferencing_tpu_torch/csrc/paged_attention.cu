// Paged flash decode for NVIDIA Hopper (sm_90a), split-KV.
//
// Replaces the Pallas TPU kernel of the JAX package
// ops/pallas/paged_attention.py paged_flash_decode (kernel
// _paged_decode_kernel): one query token per serving slot, q [R,1,H,hd],
// against one layer's block pool [NB,bs,Hkv,hd] through block_tables
// [R,MB] and context_lens [R] (fill after this token's write; the query
// sits at context_lens - 1), with an optional static sliding window and
// an optional score softcap (gemma2's cap * tanh(s / cap); its arm in
// split_decode.cuh).
//
// What bounds it on this card, and what the design does about it: it is
// bounded by bytes, the K/V rows of [max(0, len - window), len) of every
// slot. The kernels are split_decode.cuh's split-KV design (a split pass
// over fixed key ranges with cp.async tiles in flight, then a fixed-order
// log-sum-exp merge), instantiated with block-table addressing: a split
// first copies its table entries into shared memory and resolves every
// row's pool address from there, a tile ahead. NS = ceil(MB*bs / split)
// comes from the table's width, so the host never reads context_lens.
// The dense flash_decode (flash_attention.cu) shares the same code.
// The JAX wrapper transposes the whole pool to [NB,Hkv,bs,hd] on every
// call; here one layer's slice of the [L,...] pool is a strided view and
// nothing is copied. The fused kernel (csrc/fused_decode.cu) runs the
// same split loop (split_range) on q held in its shared memory.
//
// Interface: plain C, pointers and the stream as void*, the launcher
// returns its cudaError_t (0 on success) and allocates nothing.

#include "split_decode.cuh"

namespace {

using dli::kCombineWarps;
using dli::kMaxSmem;
using dli::kSplitHeads;
using dli::kSplitThreads;
using dli::PoolStrides;

// grid (Hkv * ceil(G / kSplitHeads), R, NS): split_decode.cuh's split
// pass over the block tables
template <typename T, int LPK, int CPL>
__global__ void __launch_bounds__(kSplitThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                   const T* __restrict__ vpool, float* __restrict__ part,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ context_lens, int H, int Hkv,
                   int hd, int bs, int split, int NS, long long q_sr,
                   long long q_sh, long long bt_sr, PoolStrides ks,
                   PoolStrides vs, float scale_log2, int window,
                   float scale, float softcap) {
  dli::split_attend<T, LPK, CPL, true>(
      q, kpool, vpool, part, block_tables, context_lens, nullptr, H, Hkv,
      hd, bs, split, NS, q_sr, q_sh, bt_sr, ks, vs, scale_log2, window,
      scale, softcap);
}

// grid R*H: split_decode.cuh's merge
template <typename T>
__global__ void __launch_bounds__(32 * kCombineWarps)
paged_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                     const int* __restrict__ context_lens, int R, int H,
                     int hd, int split, int NS, long long o_sr,
                     long long o_sh, int window) {
  dli::split_combine<T>(part, out, context_lens, R, H, hd, split, NS, o_sr,
                        o_sh, window);
}

template <typename T, int LPK, int CPL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const void* bt, const void* lens, void* part, int R,
                   int H, int Hkv, int hd, int bs, int split, int NS,
                   const long long* st, float scale, int window,
                   float softcap, cudaStream_t stream) {
  auto kern = paged_split_kernel<T, LPK, CPL>;
  const size_t smem = dli::split_smem_bytes<T, LPK, CPL, true>(hd, split);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int G = H / Hkv;
  const dim3 grid(Hkv * ((G + kSplitHeads - 1) / kSplitHeads), R, NS);
  kern<<<grid, kSplitThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(part),
      static_cast<const int*>(bt), static_cast<const int*>(lens), H, Hkv, hd,
      bs, split, NS, st[0], st[1], st[2], PoolStrides{st[3], st[4], st[5]},
      PoolStrides{st[6], st[7], st[8]}, scale * dli::kLog2e, window, scale,
      softcap);
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
                     float softcap, cudaStream_t stream) {
#define DLI_SPLIT_LAUNCH(LPK, CPL)                                          \
  return launch<T, LPK, CPL>(q, k, v, out, bt, lens, part, R, H, Hkv, hd,  \
                             bs, split, NS, st, scale, window, softcap,    \
                             stream)
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
// never syncs on them). window <= 0: no window. softcap <= 0: no score
// cap, else cap * tanh(score / cap) on the scaled score. split: keys per split (a
// multiple of 64, at most 1024); NS = ceil(MB * bs / split) splits. part:
// R * H * NS * (hd + 2) f32 of scratch.
int dli_paged_decode_fwd(const void* q, const void* k, const void* v,
                         void* out, const void* block_tables,
                         const void* context_lens, void* part, int dtype,
                         int R, int H, int Hkv, int hd, int bs, int split,
                         int NS, const long long* strides, float scale,
                         int window, float softcap, void* stream) {
  if (hd % 8 != 0 || hd > 256 || hd < 8 || H % Hkv != 0 || bs < 1 ||
      split < 64 || split > 1024 || split % 64 != 0 || NS < 1 ||
      NS > 65535 || R > 65535 || (long long)R * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (R <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(hd / 4, q, k, v, out, block_tables, context_lens,
                           part, R, H, Hkv, hd, bs, split, NS, strides,
                           scale, window, softcap, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd / 8, q, k, v, out, block_tables,
                                   context_lens, part, R, H, Hkv, hd, bs,
                                   split, NS, strides, scale, window,
                                   softcap, st);
  return cudaErrorInvalidValue;
}

const char* dli_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
