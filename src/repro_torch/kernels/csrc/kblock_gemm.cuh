// Dense-grid k-block GEMM body of int8_gemm.cu (the masked grid, which
// shared it, now runs on tile_mma.cuh beside the tile-skip kernel).
//
// Computes out (M, N) from x (M, K) and a dense weight w (K, N) split
// into (bk, bn) blocks, bk = K / KB, bn = N / NB. One thread block owns
// one (BM rows x 32 columns) output tile inside column-block n and loops
// over all KB k-blocks in ascending order, as the Pallas kernels' VMEM
// accumulator does across their sequential k grid axis. Each k-block's x
// slice and weight slice are staged in shared memory in 32-deep slices
// (x widened to fp32), every thread keeps R rows of one column in
// registers, and each k-block's partial is summed in fp32 before it is
// added to the fp32 accumulator; the output is cast to x's type once.
//
// A policy says what the kernel adds to the plain k-block loop:
//   W                     the weight's type in device memory;
//   load(w[i])            a weight as the product uses it;
//   live(b)               whether k-block b = kb * NB + n takes part; the
//                         staging loads run either way, only the
//                         multiply-adds are predicated (uniform over the
//                         thread block);
//   finish(part, b)       the k-block partial as it is added.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace kblock {

constexpr int NC = 32;       // output columns per thread block
constexpr int KC = 32;       // k-slice staged in shared memory
constexpr int THREADS = 256; // 8 warps: warp w owns rows w, w+8, ...

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename TX, int R, typename Policy>
__global__ void __launch_bounds__(THREADS)
kblock_gemm_kernel(const TX* __restrict__ x,
                   const typename Policy::W* __restrict__ w, Policy pol,
                   TX* __restrict__ out, int M, int K, int N, int KB, int NB) {
  constexpr int BM = 8 * R;
  __shared__ float xs[BM][KC];
  __shared__ float ws[KC][NC];
  const int bk = K / KB;
  const int bn = N / NB;
  const int nsub = (bn + NC - 1) / NC;
  const int nb = blockIdx.x / nsub;
  const int c0 = (blockIdx.x % nsub) * NC;
  const int ncols = min(NC, bn - c0);
  const int col0 = nb * bn + c0;
  const int m0 = blockIdx.y * BM;
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;

  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;

  for (int kb = 0; kb < KB; ++kb) {
    const int b = kb * NB + nb;
    const bool live = pol.live(b);
    float part[R];
#pragma unroll
    for (int i = 0; i < R; ++i) part[i] = 0.0f;
    for (int k0 = 0; k0 < bk; k0 += KC) {
      const int kc = min(KC, bk - k0);
      const int kabs = kb * bk + k0;
      for (int i = threadIdx.x; i < BM * KC; i += THREADS) {
        const int r = i / KC, c = i % KC;
        float val = 0.0f;
        if (m0 + r < M && c < kc)
          val = to_f(x[static_cast<size_t>(m0 + r) * K + kabs + c]);
        xs[r][c] = val;
      }
      for (int i = threadIdx.x; i < KC * NC; i += THREADS) {
        const int r = i / NC, c = i % NC;
        float val = 0.0f;
        if (r < kc && c < ncols)
          val = pol.load(w[static_cast<size_t>(kabs + r) * N + col0 + c]);
        ws[r][c] = val;
      }
      __syncthreads();
      if (live) {
#pragma unroll 8
        for (int q = 0; q < KC; ++q) {
          const float wv = ws[q][tx];
#pragma unroll
          for (int i = 0; i < R; ++i) part[i] = fmaf(xs[ty + 8 * i][q], wv, part[i]);
        }
      }
      __syncthreads();
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] += pol.finish(part[i], b);
    }
  }

  if (tx < ncols) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = m0 + ty + 8 * i;
      if (r < M) out[static_cast<size_t>(r) * N + col0 + tx] = from_f<TX>(acc[i]);
    }
  }
}

// 8-row tiles (R = 1) up to 8 rows, else 64-row tiles (R = 8).
template <typename TX, typename Policy>
cudaError_t launch(const void* x, const void* w, Policy pol, void* out, int M,
                   int K, int N, int KB, int NB, cudaStream_t stream) {
  const int nsub = (N / NB + NC - 1) / NC;
  const TX* xt = static_cast<const TX*>(x);
  const typename Policy::W* wt = static_cast<const typename Policy::W*>(w);
  TX* ot = static_cast<TX*>(out);
  if (M <= 8) {
    dim3 grid(NB * nsub, (M + 7) / 8);
    kblock_gemm_kernel<TX, 1, Policy><<<grid, THREADS, 0, stream>>>(
        xt, wt, pol, ot, M, K, N, KB, NB);
  } else {
    dim3 grid(NB * nsub, (M + 63) / 64);
    kblock_gemm_kernel<TX, 8, Policy><<<grid, THREADS, 0, stream>>>(
        xt, wt, pol, ot, M, K, N, KB, NB);
  }
  return cudaGetLastError();
}

}  // namespace kblock
