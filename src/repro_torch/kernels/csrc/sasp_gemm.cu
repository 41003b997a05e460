// SASP tile-skip GEMM for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sasp_gemm/kernel.py::sasp_gemm and its
// bodies _sasp_kernel, _sasp_kernel_bias, _sasp_kernel_int8,
// _sasp_kernel_int8_bias (first/last flags from _flags).
//
// Computes out = act(x @ (W ⊙ mask) + bias) from the packed visit list:
// vals (nnz, bk, bn) surviving blocks (fp32 / bf16, or int8 with one fp32
// scale per visit), visits sorted by (n, k), col_ptr (NB + 1) the first
// visit of each output column-block (derived from kn at load).
//
// Numerics mirror the TPU kernel: the fp variant rounds each weight to
// x's type before the product and accumulates in fp32; the int8 variant
// works in fp32 and scales each visit's partial product by its scale.
// Empty output columns own one zero visit and flush act(bias); dup-last
// padding visits are zero blocks and add exactly nothing.
//
// Design. The Pallas kernel carries a VMEM accumulator across a
// sequential grid axis. Thread blocks here run in no order, so one block
// owns one (BM rows x 32 columns) output tile of one column-block and
// walks that column's visits itself: each visit stages the x tile and
// the weight block in shared memory in 32-deep slices, every thread keeps
// R rows of one column in registers, and the flush (bias, activation,
// cast) happens once, from registers, after the last visit. A row's
// result never depends on the batch size: each output is summed in the
// same order whatever M is.
//
// Bound. At decode (M = slots, about 4) the kernel must stream every
// surviving weight block once: it is bound by bytes (the weights), about
// nnz * bk * bn * sizeof(w) / 3.35 TB/s. At prefill it is bound by
// operations. This first version uses fp32 FMAs on the CUDA cores (no
// tensor cores) and no copy pipelining; PERF.md records how far it is
// from either bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NC = 32;       // output columns per thread block
constexpr int KC = 32;       // k-slice staged in shared memory
constexpr int THREADS = 256; // 8 warps: warp w owns rows w, w+8, ...

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// w.astype(x.dtype) of the TPU kernel: round to x's type, then widen.
template <typename TX> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<TX>(v));
}

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case 1: return v / (1.0f + expf(-v));                       // silu
    case 2: {                                                   // gelu (tanh)
      const float c = 0.7978845608028654f;
      return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    case 3: return fmaxf(v, 0.0f);                              // relu
    default: return v;
  }
}

template <typename TX, typename TW, bool QUANT, int R>
__global__ void __launch_bounds__(THREADS)
sasp_gemm_kernel(const TX* __restrict__ x, const TW* __restrict__ vals,
                 const int* __restrict__ kcoord, const int* __restrict__ col_ptr,
                 const float* __restrict__ scales, const float* __restrict__ bias,
                 TX* __restrict__ out, int M, int K, int N, int bk, int bn,
                 int act) {
  constexpr int BM = 8 * R;
  __shared__ float xs[BM][KC];
  __shared__ float ws[KC][NC];
  const int nsub = (bn + NC - 1) / NC;
  const int nb = blockIdx.x / nsub;
  const int c0 = (blockIdx.x % nsub) * NC;
  const int ncols = min(NC, bn - c0);
  const int m0 = blockIdx.y * BM;
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;

  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;

  const int v0 = col_ptr[nb];
  const int v1 = col_ptr[nb + 1];
  for (int v = v0; v < v1; ++v) {
    const int kb = kcoord[v];
    const TW* wblk = vals + static_cast<size_t>(v) * bk * bn;
    float part[R];
#pragma unroll
    for (int i = 0; i < R; ++i) part[i] = 0.0f;
    for (int k0 = 0; k0 < bk; k0 += KC) {
      const int kc = min(KC, bk - k0);
      for (int i = threadIdx.x; i < BM * KC; i += THREADS) {
        const int r = i / KC, c = i % KC;
        float val = 0.0f;
        if (m0 + r < M && c < kc)
          val = to_f(x[static_cast<size_t>(m0 + r) * K +
                       static_cast<size_t>(kb) * bk + k0 + c]);
        xs[r][c] = val;
      }
      for (int i = threadIdx.x; i < KC * NC; i += THREADS) {
        const int r = i / NC, c = i % NC;
        float val = 0.0f;
        if (r < kc && c < ncols) {
          const float w = to_f(wblk[static_cast<size_t>(k0 + r) * bn + c0 + c]);
          val = QUANT ? w : round_to<TX>(w);
        }
        ws[r][c] = val;
      }
      __syncthreads();
#pragma unroll 8
      for (int q = 0; q < KC; ++q) {
        const float w = ws[q][tx];
#pragma unroll
        for (int i = 0; i < R; ++i) part[i] = fmaf(xs[ty + 8 * i][q], w, part[i]);
      }
      __syncthreads();
    }
    if (QUANT) {
      const float s = scales[v];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] += part[i] * s;
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] += part[i];
    }
  }

  if (tx < ncols) {
    const int col = nb * bn + c0 + tx;
    const float b = bias ? bias[col] : 0.0f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = m0 + ty + 8 * i;
      if (r < M)
        out[static_cast<size_t>(r) * N + col] = from_f<TX>(apply_act(acc[i] + b, act));
    }
  }
}

template <typename TX, typename TW, bool QUANT>
cudaError_t launch_typed(const void* x, const void* vals, const int* kcoord,
                         const int* col_ptr, const float* scales,
                         const float* bias, void* out, int M, int K, int N,
                         int bk, int bn, int act, cudaStream_t stream) {
  const int nb = N / bn;
  const int nsub = (bn + NC - 1) / NC;
  if (M <= 8) {
    dim3 grid(nb * nsub, (M + 7) / 8);
    sasp_gemm_kernel<TX, TW, QUANT, 1><<<grid, THREADS, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(vals), kcoord,
        col_ptr, scales, bias, static_cast<TX*>(out), M, K, N, bk, bn, act);
  } else {
    dim3 grid(nb * nsub, (M + 63) / 64);
    sasp_gemm_kernel<TX, TW, QUANT, 8><<<grid, THREADS, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(vals), kcoord,
        col_ptr, scales, bias, static_cast<TX*>(out), M, K, N, bk, bn, act);
  }
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_x(int w_dtype, const void* x, const void* vals,
                     const int* kcoord, const int* col_ptr,
                     const float* scales, const float* bias, void* out,
                     int M, int K, int N, int bk, int bn, int act,
                     cudaStream_t stream) {
  switch (w_dtype) {
    case 0: return launch_typed<TX, float, false>(x, vals, kcoord, col_ptr, scales,
                                                 bias, out, M, K, N, bk, bn, act, stream);
    case 1: return launch_typed<TX, __nv_bfloat16, false>(x, vals, kcoord, col_ptr,
                                                         scales, bias, out, M, K, N,
                                                         bk, bn, act, stream);
    case 2: return launch_typed<TX, int8_t, true>(x, vals, kcoord, col_ptr, scales,
                                                 bias, out, M, K, N, bk, bn, act, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K) in x_dtype (0 fp32, 1 bf16); vals (nnz, bk, bn) in w_dtype
// (0 fp32, 1 bf16, 2 int8 with scales); kcoord = kn[0] (nnz,) int32;
// col_ptr (N/bn + 1,) int32; bias (N,) fp32 or null; out (M, N) in
// x_dtype; act 0 none, 1 silu, 2 gelu (tanh), 3 relu.
extern "C" int sasp_gemm_launch(const void* x, const void* vals,
                                const int* kcoord, const int* col_ptr,
                                const float* scales, const float* bias,
                                void* out, int M, int K, int N, int bk,
                                int bn, int x_dtype, int w_dtype, int act,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0)
    err = launch_x<float>(w_dtype, x, vals, kcoord, col_ptr, scales, bias, out,
                          M, K, N, bk, bn, act, s);
  else if (x_dtype == 1)
    err = launch_x<__nv_bfloat16>(w_dtype, x, vals, kcoord, col_ptr, scales,
                                  bias, out, M, K, N, bk, bn, act, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
