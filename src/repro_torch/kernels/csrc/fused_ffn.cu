// Fused gated FFN over surviving d_ff column-blocks, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sasp_gemm/kernel.py::sasp_fused_ffn and its
// bodies _fused_ffn_kernel (fp) and _fused_ffn_kernel_int8.
//
// Computes out = act(x@W1v + b1) * (x@W3v + b3) @ W2v + b2, visit by
// visit: w1v/w3v (nv, d, bf) up-projection column-blocks, w2v (nv, bf, d)
// the matching down-projection row-blocks, b1/b3 (nv, bf), b2 (d,). The
// (M, d_ff) intermediate lives only as a (rows x bf) tile in shared
// memory and never reaches device memory.
//
// Numerics mirror the TPU kernel. fp: weights are rounded to x's type,
// products accumulate in fp32, h = act(u) * g is rounded to x's type
// before the down-projection. int8: everything in fp32, each visit's
// partial products scaled by s1 / s3 / s2, h kept in fp32.
//
// Design. The Pallas kernel walks the visits as a sequential grid axis
// with one (bm, d) accumulator. At decode M is the slot count (about 4),
// so row tiles give no parallelism: here the visits are split into
// S = ceil(nv / vps) contiguous groups, vps chosen from nv alone (never
// from M), and thread block (split, row tile) accumulates its group's
// contribution to a (4, d) fp32 tile in shared memory, then writes it as
// its own partial. A second kernel adds the S partials in split order and
// adds b2: no atomics, and a row's result does not depend on the batch
// size. Per visit, the up-projections split d over 8 warps (lane = d_ff
// column), their 8 slices are added in a fixed order, and the
// down-projection gives every thread columns j, j+256, ... of the tile.
//
// Bound. At decode every surviving weight byte is read once: bound by
// bytes, 3 * nv * d * bf * sizeof(w) / 3.35 TB/s. At prefill the row
// tiles re-read the weights once per 4 rows, and the products run as fp32
// FMAs on the CUDA cores; this first version trades speed for a simple,
// exact schedule, and PERF.md records its distance from the bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int FBM = 4;        // rows per thread block
constexpr int THREADS = 256;  // 8 warps
constexpr int SLICES = THREADS / 32;
constexpr int MAX_BF = 32;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename TX> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<TX>(v));
}

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case 1: return v / (1.0f + expf(-v));
    case 2: {
      const float c = 0.7978845608028654f;
      return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    case 3: return fmaxf(v, 0.0f);
    default: return v;
  }
}

template <typename TX, typename TW, bool QUANT>
__global__ void __launch_bounds__(THREADS)
fused_ffn_partial_kernel(const TX* __restrict__ x, const TW* __restrict__ w1v,
                         const TW* __restrict__ w3v, const TW* __restrict__ w2v,
                         const float* __restrict__ s1, const float* __restrict__ s3,
                         const float* __restrict__ s2, const float* __restrict__ b1,
                         const float* __restrict__ b3, float* __restrict__ partial,
                         int M, int d, int bf, int nv, int vps, int act) {
  extern __shared__ float smem[];
  float* acc = smem;                                   // FBM * d
  float* red = acc + FBM * d;                          // SLICES * FBM * 2 * MAX_BF
  float* hs = red + SLICES * FBM * 2 * MAX_BF;         // FBM * MAX_BF

  const int split = blockIdx.x;
  const int m0 = blockIdx.y * FBM;
  const int rows = min(FBM, M - m0);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int sl = tid / 32;
  const int dchunk = (d + SLICES - 1) / SLICES;
  const int d0 = min(d, sl * dchunk);
  const int d1 = min(d, d0 + dchunk);

  for (int i = tid; i < FBM * d; i += THREADS) acc[i] = 0.0f;

  const int va = split * vps;
  const int vb = min(nv, va + vps);
  for (int v = va; v < vb; ++v) {
    // up-projections: this warp's d-slice, lane = d_ff column
    float au[FBM], ag[FBM];
#pragma unroll
    for (int m = 0; m < FBM; ++m) { au[m] = 0.0f; ag[m] = 0.0f; }
    if (lane < bf) {
      const TW* p1 = w1v + static_cast<size_t>(v) * d * bf + lane;
      const TW* p3 = w3v + static_cast<size_t>(v) * d * bf + lane;
#pragma unroll 4
      for (int kd = d0; kd < d1; ++kd) {
        float w1 = to_f(p1[static_cast<size_t>(kd) * bf]);
        float w3 = to_f(p3[static_cast<size_t>(kd) * bf]);
        if (!QUANT) { w1 = round_to<TX>(w1); w3 = round_to<TX>(w3); }
#pragma unroll
        for (int m = 0; m < FBM; ++m) {
          const float xv = m < rows ? to_f(x[static_cast<size_t>(m0 + m) * d + kd]) : 0.0f;
          au[m] = fmaf(xv, w1, au[m]);
          ag[m] = fmaf(xv, w3, ag[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < FBM; ++m) {
      red[((sl * FBM + m) * 2 + 0) * MAX_BF + lane] = au[m];
      red[((sl * FBM + m) * 2 + 1) * MAX_BF + lane] = ag[m];
    }
    __syncthreads();
    if (tid < FBM * MAX_BF) {
      const int m = tid / MAX_BF, c = tid % MAX_BF;
      float h = 0.0f;
      if (c < bf) {
        float u = 0.0f, g = 0.0f;
        for (int k = 0; k < SLICES; ++k) {
          u += red[((k * FBM + m) * 2 + 0) * MAX_BF + c];
          g += red[((k * FBM + m) * 2 + 1) * MAX_BF + c];
        }
        if (QUANT) { u *= s1[v]; g *= s3[v]; }
        u += b1[static_cast<size_t>(v) * bf + c];
        g += b3[static_cast<size_t>(v) * bf + c];
        h = apply_act(u, act) * g;
        if (!QUANT) h = round_to<TX>(h);
      }
      hs[m * MAX_BF + c] = h;
    }
    __syncthreads();
    // down-projection into the shared accumulator
    const TW* p2 = w2v + static_cast<size_t>(v) * bf * d;
    const float sc = QUANT ? s2[v] : 1.0f;
    for (int j = tid; j < d; j += THREADS) {
      float dv[FBM];
#pragma unroll
      for (int m = 0; m < FBM; ++m) dv[m] = 0.0f;
      for (int f = 0; f < bf; ++f) {
        float w = to_f(p2[static_cast<size_t>(f) * d + j]);
        if (!QUANT) w = round_to<TX>(w);
#pragma unroll
        for (int m = 0; m < FBM; ++m) dv[m] = fmaf(hs[m * MAX_BF + f], w, dv[m]);
      }
#pragma unroll
      for (int m = 0; m < FBM; ++m) acc[m * d + j] += QUANT ? dv[m] * sc : dv[m];
    }
    __syncthreads();
  }
  float* dst = partial + (static_cast<size_t>(split) * M + m0) * d;
  for (int i = tid; i < rows * d; i += THREADS) dst[i] = acc[i];
}

template <typename TX>
__global__ void fused_ffn_reduce_kernel(const float* __restrict__ partial,
                                        const float* __restrict__ b2,
                                        TX* __restrict__ out, int S, int M, int d) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(M) * d;
  if (i >= total) return;
  float a = 0.0f;
  for (int s = 0; s < S; ++s) a += partial[static_cast<size_t>(s) * total + i];
  out[i] = from_f<TX>(a + b2[i % d]);
}

size_t smem_bytes(int d) {
  return sizeof(float) * (static_cast<size_t>(FBM) * d +
                          SLICES * FBM * 2 * MAX_BF + FBM * MAX_BF);
}

template <typename TX, typename TW, bool QUANT>
cudaError_t launch_partial(const void* x, const void* w1v, const void* w3v,
                           const void* w2v, const float* s1, const float* s3,
                           const float* s2, const float* b1, const float* b3,
                           float* partial, int M, int d, int bf, int nv, int vps,
                           int act, cudaStream_t stream) {
  const int smem = static_cast<int>(smem_bytes(d));
  auto kern = fused_ffn_partial_kernel<TX, TW, QUANT>;
  // The shared-memory limit is raised once per template instance and
  // device, and again only for a larger d.
  static int smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem_set[dev] < smem) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = smem;
  }
  const int S = (nv + vps - 1) / vps;
  dim3 grid(S, (M + FBM - 1) / FBM);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w1v),
      static_cast<const TW*>(w3v), static_cast<const TW*>(w2v), s1, s3, s2, b1,
      b3, partial, M, d, bf, nv, vps, act);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_partial_x(int w_dtype, const void* x, const void* w1v,
                             const void* w3v, const void* w2v, const float* s1,
                             const float* s3, const float* s2, const float* b1,
                             const float* b3, float* partial, int M, int d,
                             int bf, int nv, int vps, int act,
                             cudaStream_t stream) {
  switch (w_dtype) {
    case 0: return launch_partial<TX, float, false>(x, w1v, w3v, w2v, s1, s3, s2, b1,
                                                   b3, partial, M, d, bf, nv, vps,
                                                   act, stream);
    case 1: return launch_partial<TX, __nv_bfloat16, false>(x, w1v, w3v, w2v, s1, s3,
                                                           s2, b1, b3, partial, M, d,
                                                           bf, nv, vps, act, stream);
    case 2: return launch_partial<TX, int8_t, true>(x, w1v, w3v, w2v, s1, s3, s2, b1,
                                                   b3, partial, M, d, bf, nv, vps,
                                                   act, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Largest d the shared-memory accumulator admits (4 rows of fp32).
extern "C" int fused_ffn_max_d() {
  return static_cast<int>((227 * 1024 - smem_bytes(0)) / (sizeof(float) * FBM));
}

// x (M, d) in x_dtype (0 fp32, 1 bf16); w1v/w3v (nv, d, bf), w2v
// (nv, bf, d) in w_dtype (0 fp32, 1 bf16, 2 int8 with s1/s3/s2 (nv,));
// b1/b3 (nv, bf) fp32; partial (S, M, d) fp32 scratch with
// S = ceil(nv / vps); b2 (d,) fp32; out (M, d) in x_dtype.
extern "C" int fused_ffn_launch(const void* x, const void* w1v,
                                const void* w3v, const void* w2v,
                                const float* s1, const float* s3,
                                const float* s2, const float* b1,
                                const float* b3, const float* b2,
                                float* partial, void* out, int M, int d,
                                int bf, int nv, int vps, int x_dtype,
                                int w_dtype, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf > MAX_BF || bf < 1 || vps < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (x_dtype == 0)
    err = launch_partial_x<float>(w_dtype, x, w1v, w3v, w2v, s1, s3, s2, b1, b3,
                                  partial, M, d, bf, nv, vps, act, s);
  else if (x_dtype == 1)
    err = launch_partial_x<__nv_bfloat16>(w_dtype, x, w1v, w3v, w2v, s1, s3, s2,
                                          b1, b3, partial, M, d, bf, nv, vps, act, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  const int S = (nv + vps - 1) / vps;
  const size_t total = static_cast<size_t>(M) * d;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  if (x_dtype == 0)
    fused_ffn_reduce_kernel<float><<<blocks, threads, 0, s>>>(
        partial, b2, static_cast<float*>(out), S, M, d);
  else
    fused_ffn_reduce_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        partial, b2, static_cast<__nv_bfloat16*>(out), S, M, d);
  return static_cast<int>(cudaGetLastError());
}
