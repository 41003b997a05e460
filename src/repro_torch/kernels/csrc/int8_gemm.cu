// Dense weight-only int8 GEMM for Hopper (sm_90a): the paper's FP32_INT8
// configuration without pruning.
//
// Replaces: src/repro/kernels/int8_gemm/kernel.py::int8_gemm and its body
// _int8_kernel.
//
// Computes out = x @ dequant(w_q) from x (M, K) fp32 or bf16, w_q (K, N)
// int8 and one fp32 scale per (bk, bn) block, scale (KB, NB): bk = K / KB,
// bn = N / NB. Numerics mirror the TPU kernel: x is widened to fp32 (also
// when it is bf16), the int8 weight is widened in registers, each
// k-block's partial product is summed in fp32 and multiplied by
// scale[k, n] before it is added to the fp32 accumulator, in ascending k;
// the output is cast to x's type once. (Dequantizing first and then
// multiplying rounds differently; the tests hold this kernel to its plain
// version tightly and to that reference loosely.)
//
// Design. The body is kblock_gemm.cuh's: one thread block owns one (BM
// rows x 32 columns) output tile inside column-block n and loops over the
// KB k-blocks itself; each k-block is staged in shared memory in 32-deep
// slices, every thread keeps R rows of one column in registers, and the
// block's scale is applied once per k-block partial (ScalePolicy::finish).
// The weight stays int8 in device memory: a quarter of the fp32 bytes.
//
// Bound. At decode (M about 4) the kernel must read the int8 weight once:
// bytes, K * N / 3.35 TB/s. At prefill it is bound by operations. This
// first version uses fp32 FMAs on the CUDA cores and no copy pipelining;
// PERF.md records how far it is from either bound.
#include "kblock_gemm.cuh"

namespace {

struct ScalePolicy {
  using W = int8_t;
  const float* scale;  // (KB, NB) fp32
  __device__ __forceinline__ float load(int8_t v) const { return static_cast<float>(v); }
  __device__ __forceinline__ bool live(int) const { return true; }
  __device__ __forceinline__ float finish(float part, int b) const { return part * scale[b]; }
};

}  // namespace

// x (M, K) in x_dtype (0 fp32, 1 bf16); wq (K, N) int8; scale (KB, NB)
// fp32; out (M, N) in x_dtype.
extern "C" int int8_gemm_launch(const void* x, const void* wq,
                                const float* scale, void* out, int M, int K,
                                int N, int KB, int NB, int x_dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0)
    err = kblock::launch<float>(x, wq, ScalePolicy{scale}, out, M, K, N, KB,
                                NB, s);
  else if (x_dtype == 1)
    err = kblock::launch<__nv_bfloat16>(x, wq, ScalePolicy{scale}, out, M, K,
                                        N, KB, NB, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
