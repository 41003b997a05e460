// Flash attention for Hopper (sm_90a): online softmax over key blocks.
//
// Replaces: src/repro/kernels/flash_attn/kernel.py::flash_attention and
// its body _flash_kernel, with the GQA fold of flash_attn/ops.py::mha.
//
// Computes out[h] = softmax(q[h] k[h/G]^T * D^-0.5, masked) v[h/G] for
// q (H, Sq, D), k and v (H/G, Sk, D), all of one type (fp32 or bf16),
// and 1-D int32 absolute positions shared by every head: key j is
// visible to query i iff 0 <= q_pos[i] - kv_pos[j] < window. Numerics
// mirror the TPU kernel (kernel.py:24-63): scores are fp32 dots of the
// q/k values, times D^-0.5; masked scores are NEG_INF = -1e30 (not
// -inf) and their p is zeroed; l sums the fp32 p; p is rounded to v's
// type before p @ v; the accumulator is fp32; the flush divides by
// max(l, 1e-20), so a row that sees no key comes out 0. GQA reads kv head
// h / G instead of repeating K and V G times as ops.mha does.
//
// Design. The Pallas kernel walks the key blocks on a sequential grid
// axis with (m, l, acc) in VMEM. Here one thread block of 4 warps owns
// 16 query rows of one head and walks every key block of 32 keys itself,
// keeping (m, l, acc) in registers: warp w owns rows 4w..4w+3, lane c
// scores key c of the block, and for p @ v lane c owns output columns
// c, c + 32, …. The q tile stays in shared memory; K (rows padded by one
// float against bank conflicts) and V tiles are staged per block. A key
// block that no row of the tile can see is skipped before it is loaded:
// it would leave (m, l, acc) exactly unchanged. Ragged Sq and Sk are
// masked inside the tile.
//
// Bound. Prefill attention is bound by operations, 4 * Sq * Sk * D per
// head for the visible pairs; decode (Sq = 1) by the bytes of K and V.
// This first version uses fp32 FMAs on the CUDA cores, no tensor cores
// and no copy pipelining; PERF.md records how far it is from the bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 16;        // query rows per thread block
constexpr int BK = 32;        // keys per block (one per lane)
constexpr int THREADS = 128;  // 4 warps
constexpr int RW = BQ / (THREADS / 32);  // rows per warp
constexpr float NEG_INF = -1.0e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ qpos,
             const int* __restrict__ kpos, T* __restrict__ out, int Sq,
             int Sk, int G, int window, float scale) {
  constexpr int DV = (D + 31) / 32;   // output columns per lane
  __shared__ float qs[BQ][D];
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];
  __shared__ float ps[BQ][BK];
  __shared__ int qp_s[BQ];
  __shared__ int kp_s[BK];

  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* qh = q + static_cast<size_t>(h) * Sq * D;
  const T* kh = k + static_cast<size_t>(h / G) * Sk * D;
  const T* vh = v + static_cast<size_t>(h / G) * Sk * D;

  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qs[r][d] = q0 + r < Sq ? to_f(qh[static_cast<size_t>(q0 + r) * D + d]) : 0.0f;
  }
  if (threadIdx.x < BQ)
    qp_s[threadIdx.x] = q0 + threadIdx.x < Sq ? qpos[q0 + threadIdx.x] : 0;

  float m[RW], l[RW], acc[RW][DV];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.0f;
#pragma unroll
    for (int j = 0; j < DV; ++j) acc[rr][j] = 0.0f;
  }

  for (int c0 = 0; c0 < Sk; c0 += BK) {
    if (threadIdx.x < BK)
      kp_s[threadIdx.x] = c0 + threadIdx.x < Sk ? kpos[c0 + threadIdx.x] : 0;
    __syncthreads();
    int seen = 0;
    for (int i = threadIdx.x; i < BQ * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int delta = qp_s[r] - kp_s[c];
      seen |= (q0 + r < Sq && c0 + c < Sk && delta >= 0 && delta < window);
    }
    if (!__syncthreads_or(seen)) continue;   // uniform: no row sees a key

    for (int i = threadIdx.x; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const bool in = c0 + c < Sk;
      const size_t off = static_cast<size_t>(c0 + c) * D + d;
      ks[c][d] = in ? to_f(kh[off]) : 0.0f;
      vs[c][d] = in ? to_f(vh[off]) : 0.0f;
    }
    __syncthreads();

    float s[RW];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) s[rr] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kv = ks[lane][d];
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) s[rr] = fmaf(qs[warp * RW + rr][d], kv, s[rr]);
    }
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp * RW + rr;
      const int delta = qp_s[r] - kp_s[lane];
      const bool vis = q0 + r < Sq && c0 + lane < Sk && delta >= 0 && delta < window;
      const float sv = vis ? s[rr] * scale : NEG_INF;
      const float m_new = fmaxf(m[rr], warp_max(sv));
      const float p = vis ? expf(sv - m_new) : 0.0f;
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(p);
      m[rr] = m_new;
      ps[r][lane] = round_to<T>(p);
#pragma unroll
      for (int j = 0; j < DV; ++j) acc[rr][j] *= corr;
    }
    __syncwarp();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
#pragma unroll
      for (int j = 0; j < DV; ++j) {
        const int d = lane + 32 * j;
        if (d < D) {
          const float vv = vs[c][d];
#pragma unroll
          for (int rr = 0; rr < RW; ++rr)
            acc[rr][j] = fmaf(ps[warp * RW + rr][c], vv, acc[rr][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = q0 + warp * RW + rr;
    if (r >= Sq) continue;
    const float den = fmaxf(l[rr], 1e-20f);
    T* orow = out + (static_cast<size_t>(h) * Sq + r) * D;
#pragma unroll
    for (int j = 0; j < DV; ++j) {
      const int d = lane + 32 * j;
      if (d < D) orow[d] = from_f<T>(acc[rr][j] / den);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* qpos, const int* kpos, void* out, int H,
                         int Sq, int Sk, int D, int G, int window,
                         float scale, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, H);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch (D) {
    case 16: flash_kernel<T, 16><<<grid, THREADS, 0, stream>>>(qt, kt, vt, qpos, kpos, ot, Sq, Sk, G, window, scale); break;
    case 32: flash_kernel<T, 32><<<grid, THREADS, 0, stream>>>(qt, kt, vt, qpos, kpos, ot, Sq, Sk, G, window, scale); break;
    case 64: flash_kernel<T, 64><<<grid, THREADS, 0, stream>>>(qt, kt, vt, qpos, kpos, ot, Sq, Sk, G, window, scale); break;
    case 128: flash_kernel<T, 128><<<grid, THREADS, 0, stream>>>(qt, kt, vt, qpos, kpos, ot, Sq, Sk, G, window, scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q (H, Sq, D), k and v (H / G, Sk, D), out (H, Sq, D), all in dtype
// (0 fp32, 1 bf16); q_pos (Sq,) and kv_pos (Sk,) int32; D in
// {16, 32, 64, 128}; scale = D^-0.5 rounded to fp32 by the caller, as
// the TPU kernel's Python float is.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 const int* qpos, const int* kpos, void* out,
                                 int H, int Sq, int Sk, int D, int G,
                                 int window, float scale, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_typed<float>(q, k, v, qpos, kpos, out, H, Sq, Sk, D, G, window,
                              scale, s);
  else if (dtype == 1)
    err = launch_typed<__nv_bfloat16>(q, k, v, qpos, kpos, out, H, Sq, Sk, D, G,
                                      window, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
