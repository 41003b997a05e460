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
// scales each visit's fp32 partial product by its scale. Each visit's
// product is summed on its own and then added, as the Pallas kernel adds
// one dot per visit. Empty output columns own one zero visit and flush
// act(bias); padding visits are zero blocks and add exactly nothing.
//
// Design. The Pallas kernel carries a VMEM accumulator across a
// sequential grid axis. Here a thread block owns one (bm rows x 32 or 16
// columns) output tile of one column-block and walks that column's
// visits through tile_mma.cuh's ring: cp.async keeps several visits' x
// and weight tiles in flight, the visits' k-blocks (and int8 scales) are
// read once into shared memory, and the products run on the tensor cores
// (mma.sync bf16, fp32 accumulators) for bf16 x, or as fp32 FMAs for fp32
// x (TF32 would round x) and for block shapes the MMA cannot take. The
// caller (gemm.py, schedule.py) picks the variant from the types and the
// block shape.
//
// Visit groups. One block per column would give wq 256 blocks and wk/wv
// 32 on 132 SMs, each walking some 80 visits one after another. Each
// column's visits are split into G groups by k-block: group g takes the
// visits whose k-block lies in [g*KB/G, (g+1)*KB/G). G comes from the
// block grid (NB, KB) alone (about 8 blocks per SM, groups of at least 16
// k-blocks: wq 5, wk/wv 10, wo 7), so the split is a function of the
// weight; each group writes an fp32 partial and tile::reduce_groups adds
// them in group order, then bias, activation and cast. With G = 1 the
// block flushes directly.
//
// Rows. The tile's height follows M (16 rows at decode; up to 12 warps
// of 32 rows at prefill; FMA 8 or 64), with consecutive blocks on the
// same column so that row tiles find the column's weights in L2. A row's
// sums run over the same visits in the same order whatever M is.
//
// Bound. At decode (M = slots, about 4) the kernel must stream every
// surviving weight block once: bytes, nnz * bk * bn * sizeof(w) / 3.35
// TB/s. At prefill (168 rows) each visit also reads its (M x bk) slice of
// x, from L2: 220 MB at wq against 42 MB of weights, which is what holds
// the kernel back there (PERF.md).
#include "tile_mma.cuh"

namespace {

using tile::Geom;

struct GemmArgs {
  const void* x;
  const void* vals;
  const int* kcoord;
  const int* col_ptr;
  const float* scales;
  const float* bias;
  void* out;
  float* partial;  // (G, M, N) fp32 when G > 1
  int M, K, N, bk, bn, KB, G, act;
};

// step i = visit v0 + i of this block's column and group
template <typename TX, typename TW>
struct VisitSrc {
  const char* x;       // row m0, column 0 of x
  size_t a_ld;
  int rows;
  const TW* vals;      // column c0 of visit v0's block
  tile::Steps<int> kc;       // the visits' k-blocks
  tile::Steps<float> sc;     // their scales (int8)
  int bk, bn, ncols;
  __device__ tile::TileDesc a_tile() const {
    return {{x}, {0}, 1, rows, bk * static_cast<int>(sizeof(TX)), 0, a_ld,
            bk * sizeof(TX)};
  }
  __device__ size_t a_off(int i) const {
    return static_cast<size_t>(kc.at(i)) * bk * sizeof(TX);
  }
  __device__ tile::TileDesc w_tile() const {
    return {{reinterpret_cast<const char*>(vals)}, {0}, 1, bk,
            ncols * static_cast<int>(sizeof(TW)), 0, bn * sizeof(TW),
            static_cast<size_t>(bk) * bn * sizeof(TW)};
  }
  __device__ size_t w_off(int i) const {
    return static_cast<size_t>(i) * bk * bn * sizeof(TW);
  }
  __device__ bool live(int) const { return true; }
  __device__ float scale(int i) const { return sc.at(i); }
};

// The column's visits [c_lo, c_hi) are read once: their k-blocks go to
// kc_s (where they fit), and with G > 1 the group's visits [lo, hi) are
// found in the same pass: the first visit with k >= klo and the first
// with k >= khi. A linear search, so that the per-call BSR view's zero
// padding (k = 0 after the live visits) lands in the last group that
// holds live visits.
__device__ int2 scan_column(const int* kcoord, int c_lo, int c_hi, int klo,
                            int khi, bool split, int* kc_s) {
  __shared__ int lo_s, hi_s;
  if (threadIdx.x == 0) { lo_s = c_lo; hi_s = c_hi; }
  const int len = c_hi - c_lo;
  const bool keep = len <= tile::MAX_PRELOAD;
  if (split && threadIdx.x == 0) lo_s = c_hi;
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int k = kcoord[c_lo + i];
    if (keep) kc_s[i] = k;
    if (split) {
      if (k >= klo) atomicMin(&lo_s, c_lo + i);
      if (k >= khi) atomicMin(&hi_s, c_lo + i);
    }
  }
  __syncthreads();
  return make_int2(lo_s, hi_s);
}

template <typename TX, typename TW, bool QUANT, int W, int T, bool MMA>
__global__ void __launch_bounds__(MMA ? tile::MMA_THREADS : tile::FMA_THREADS)
sasp_gemm_kernel(GemmArgs p, Geom gm) {
  extern __shared__ __align__(128) char smem[];
  const int nsub = (p.bn + gm.bn - 1) / gm.bn;
  const int nb = blockIdx.y / nsub;
  const int c0 = (blockIdx.y % nsub) * gm.bn;
  const int ncols = min(gm.bn, p.bn - c0);
  const int m0 = blockIdx.x * gm.bm;
  const int rows = min(gm.bm, p.M - m0);
  const int grp = blockIdx.z;

  const int c_lo = p.col_ptr[nb], c_hi = p.col_ptr[nb + 1];
  __shared__ int kc_s[tile::MAX_PRELOAD];
  __shared__ float sc_s[QUANT ? tile::MAX_PRELOAD : 1];
  const int2 span = scan_column(p.kcoord, c_lo, c_hi, grp * p.KB / p.G,
                                (grp + 1) * p.KB / p.G, p.G > 1, kc_s);
  const int v0 = span.x, v1 = span.y;
  tile::Steps<int> kc;
  if (c_hi - c_lo <= tile::MAX_PRELOAD) {
    kc = tile::Steps<int>{p.kcoord + v0, kc_s + (v0 - c_lo), 1};
  } else {
    __syncthreads();   // kc_s is rewritten below
    kc = tile::preload(kc_s, p.kcoord + v0, v1 - v0);
  }
  tile::Steps<float> sc{};
  if constexpr (QUANT) sc = tile::preload(sc_s, p.scales + v0, v1 - v0);
  __syncthreads();
  VisitSrc<TX, TW> src{static_cast<const char*>(p.x) +
                           static_cast<size_t>(m0) * p.K * sizeof(TX),
                       static_cast<size_t>(p.K) * sizeof(TX), rows,
                       static_cast<const TW*>(p.vals) +
                           static_cast<size_t>(v0) * p.bk * p.bn + c0,
                       kc, sc, p.bk, p.bn, ncols};
  const float* C = tile::accumulate_tile<TX, TW, !QUANT, W, T, MMA, true, QUANT>(
      src, v1 - v0, gm, smem);

  const int cs = gm.bn + tile::C_PAD;
  const int col0 = nb * p.bn + c0;
  for (int i = threadIdx.x; i < rows * ncols; i += blockDim.x) {
    const int r = i / ncols, c = i - r * ncols;
    const float v = C[r * cs + c];
    const size_t o = static_cast<size_t>(m0 + r) * p.N + col0 + c;
    if (p.G == 1) {
      const float b = p.bias ? p.bias[col0 + c] : 0.0f;
      static_cast<TX*>(p.out)[o] = tile::from_f<TX>(tile::apply_act(v + b, p.act));
    } else {
      p.partial[static_cast<size_t>(grp) * p.M * p.N + o] = v;
    }
  }
}

template <typename TX, typename TW, bool QUANT, int W, int T, bool MMA>
cudaError_t launch_tiles(const GemmArgs& p, const Geom& gm, cudaStream_t stream) {
  const int smem = tile::smem_bytes(gm);
  auto kern = sasp_gemm_kernel<TX, TW, QUANT, W, T, MMA>;
  cudaError_t err = tile::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int nsub = (p.bn + gm.bn - 1) / gm.bn;
  dim3 grid((p.M + gm.bm - 1) / gm.bm, (p.N / p.bn) * nsub, p.G);
  kern<<<grid, gm.threads, smem, stream>>>(p, gm);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.G == 1) return err;
  return tile::launch_reduce<TX>(p.partial, p.G, p.M, p.N, p.bias, p.act, p.out,
                                 stream);
}

// variant 1 (MMA): bf16 x, bk and bn multiples of 16; tiles of 32 (or 16)
// columns of a column-block. variant 0 (FMA): 32-column tiles.
template <typename TX, typename TW, bool QUANT>
cudaError_t launch_variant(const GemmArgs& p, int variant, cudaStream_t stream) {
  if (variant == 1) {
    if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
      if (p.bk % 16 != 0 || p.bn % 16 != 0) return cudaErrorInvalidValue;
      const Geom gm = tile::mma_geom(p.M, p.bk, p.bn % 32 == 0 ? 32 : 16, 1,
                                     sizeof(TX), sizeof(TW));
      if (gm.pw == 16)
        return gm.tm == 1 ? launch_tiles<TX, TW, QUANT, 16, 1, true>(p, gm, stream)
                          : launch_tiles<TX, TW, QUANT, 16, 2, true>(p, gm, stream);
      return gm.tm == 1 ? launch_tiles<TX, TW, QUANT, 32, 1, true>(p, gm, stream)
                        : launch_tiles<TX, TW, QUANT, 32, 2, true>(p, gm, stream);
    }
    return cudaErrorInvalidValue;
  }
  const Geom gm = tile::fma_geom(p.M, p.bk, 32, sizeof(TX), sizeof(TW));
  if (p.M <= 8) return launch_tiles<TX, TW, QUANT, 32, 0, false>(p, gm, stream);
  return launch_tiles<TX, TW, QUANT, 32, 1, false>(p, gm, stream);
}

template <typename TX>
cudaError_t launch_x(int w_dtype, const GemmArgs& p, int variant,
                     cudaStream_t stream) {
  switch (w_dtype) {
    case 0: return launch_variant<TX, float, false>(p, variant, stream);
    case 1: return launch_variant<TX, __nv_bfloat16, false>(p, variant, stream);
    case 2: return launch_variant<TX, int8_t, true>(p, variant, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K) in x_dtype (0 fp32, 1 bf16); vals (nnz, bk, bn) in w_dtype
// (0 fp32, 1 bf16, 2 int8 with scales); kcoord = kn[0] (nnz,) int32;
// col_ptr (N/bn + 1,) int32; bias (N,) fp32 or null; out (M, N) in
// x_dtype; act 0 none, 1 silu, 2 gelu (tanh), 3 relu. variant 1 = MMA,
// 0 = FMA; groups G >= 1 visit groups per column, partial (G, M, N) fp32
// scratch when G > 1.
extern "C" int sasp_gemm_launch(const void* x, const void* vals,
                                const int* kcoord, const int* col_ptr,
                                const float* scales, const float* bias,
                                void* out, float* partial, int M, int K,
                                int N, int bk, int bn, int x_dtype,
                                int w_dtype, int act, int variant, int groups,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups < 1 || (groups > 1 && partial == nullptr) || bk < 1 || bn < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  GemmArgs p{x, vals, kcoord, col_ptr, scales, bias, out, partial,
             M, K, N, bk, bn, K / bk, groups, act};
  cudaError_t err;
  if (x_dtype == 0)
    err = launch_x<float>(w_dtype, p, variant, s);
  else if (x_dtype == 1)
    err = launch_x<__nv_bfloat16>(w_dtype, p, variant, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
