// SASP masked-grid GEMM for Hopper (sm_90a): the dense-grid ablation.
//
// Replaces: src/repro/kernels/sasp_gemm/kernel.py::sasp_gemm_masked and
// its body _masked_kernel.
//
// Computes out = x @ (W ⊙ mask) from the DENSE weight w (K, N) and a
// block mask (KB, NB) int32: bk = K / KB, bn = N / NB. Every (k, n)
// block is visited and its multiply-adds are predicated on mask[k, n].
// That is the clock-gating design the paper names as the inferior
// alternative to skipping tiles (kernel.py:317-322): it saves operations,
// not bytes. The tile-skip kernel (sasp_gemm.cu) reads only the live
// blocks; this one reads every weight byte.
//
// Numerics mirror the TPU kernel: each weight is rounded to x's type
// before the product (w.astype(x.dtype)), products are summed in fp32,
// one k-block's partial at a time in ascending k, and the output is cast
// to x's type once.
//
// Design. The body is kblock_gemm.cuh's: one thread block owns one (BM
// rows x 32 columns) output tile inside column-block n and loops over all
// KB k-blocks itself. Each k-block's x slice and weight slice are staged
// in shared memory UNCONDITIONALLY: a store to shared memory is a side
// effect the compiler keeps, so the weight bytes are read from device
// memory whatever the mask says (a global load whose value went unused
// would be deleted). Only the multiply-adds are skipped where the block
// is pruned (MaskPolicy::live); the branch is uniform over the thread
// block.
//
// Bound. At decode (M about 4) the kernel must read the whole dense
// weight: bytes, K * N * sizeof(w) / 3.35 TB/s, twice the tile-skip
// kernel's at 50% sparsity. This first version uses fp32 FMAs on the
// CUDA cores and no copy pipelining; PERF.md records how far it is from
// the bound.
#include "kblock_gemm.cuh"

namespace {

using kblock::from_f;
using kblock::to_f;

// w.astype(x.dtype) of the TPU kernel: round to x's type, then widen.
template <typename TX, typename TW>
struct MaskPolicy {
  using W = TW;
  const int* mask;  // (KB, NB), nonzero = keep
  __device__ __forceinline__ float load(TW v) const { return to_f(from_f<TX>(to_f(v))); }
  __device__ __forceinline__ bool live(int b) const { return mask[b] != 0; }
  __device__ __forceinline__ float finish(float part, int) const { return part; }
};

template <typename TX>
cudaError_t launch_x(int w_dtype, const void* x, const void* w,
                     const int* mask, void* out, int M, int K, int N, int KB,
                     int NB, cudaStream_t stream) {
  switch (w_dtype) {
    case 0:
      return kblock::launch<TX>(x, w, MaskPolicy<TX, float>{mask}, out, M, K,
                                N, KB, NB, stream);
    case 1:
      return kblock::launch<TX>(x, w, MaskPolicy<TX, __nv_bfloat16>{mask}, out,
                                M, K, N, KB, NB, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K) in x_dtype (0 fp32, 1 bf16); w (K, N) in w_dtype (0 fp32,
// 1 bf16); mask (KB, NB) int32, nonzero = keep; out (M, N) in x_dtype.
extern "C" int sasp_gemm_masked_launch(const void* x, const void* w,
                                       const int* mask, void* out, int M,
                                       int K, int N, int KB, int NB,
                                       int x_dtype, int w_dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0)
    err = launch_x<float>(w_dtype, x, w, mask, out, M, K, N, KB, NB, s);
  else if (x_dtype == 1)
    err = launch_x<__nv_bfloat16>(w_dtype, x, w, mask, out, M, K, N, KB, NB, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
