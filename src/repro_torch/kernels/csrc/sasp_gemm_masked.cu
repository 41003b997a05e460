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
// Design. The k-loop is tile_mma.cuh's, the tile-skip kernel's, with a
// predicate: a thread block owns one (bm rows x BN columns) output tile
// inside column-block n and walks the k-blocks of its group, staging
// every tile in shared memory UNCONDITIONALLY with cp.async (a copy to
// shared memory is a side effect the compiler keeps, so every weight byte
// is read whatever the mask says) and issuing the MMA or FMA only where
// the block is live (uniform over the thread block). The variant, the
// row tile and the groups (k-block ranges [g*KB/G, (g+1)*KB/G), G from
// the block grid) follow the same rules as the tile-skip kernel's, so on
// the same weights and mask the two add the same partials in the same
// order: the outputs are bit-identical.
//
// Bound. At decode (M about 4) the kernel must read the whole dense
// weight: bytes, K * N * sizeof(w) / 3.35 TB/s, twice the tile-skip
// kernel's at 50% sparsity.
#include "tile_mma.cuh"

namespace {

using tile::Geom;

struct MaskedArgs {
  const void* x;
  const void* w;
  const int* mask;
  void* out;
  float* partial;  // (G, M, N) fp32 when G > 1
  int M, K, N, KB, NB, bk, bn, G;
};

// step i = k-block k0 + i of column-block nb
template <typename TX, typename TW>
struct KBlockSrc {
  const char* x;       // row m0, column k0 * bk of x
  size_t a_ld;
  int rows;
  const TW* wp;        // row k0 * bk, column c0 of column-block nb
  tile::Steps<int> live_kb;  // mask[k0 + i, nb]
  int bk, N, ncols;
  __device__ tile::TileDesc a_tile() const {
    return {{x}, {0}, 1, rows, bk * static_cast<int>(sizeof(TX)), 0, a_ld,
            bk * sizeof(TX)};
  }
  __device__ size_t a_off(int i) const {
    return static_cast<size_t>(i) * bk * sizeof(TX);
  }
  __device__ tile::TileDesc w_tile() const {
    return {{reinterpret_cast<const char*>(wp)}, {0}, 1, bk,
            ncols * static_cast<int>(sizeof(TW)), 0, N * sizeof(TW),
            static_cast<size_t>(bk) * N * sizeof(TW)};
  }
  __device__ size_t w_off(int i) const {
    return static_cast<size_t>(i) * bk * N * sizeof(TW);
  }
  __device__ bool live(int i) const { return live_kb.at(i) != 0; }
  __device__ float scale(int) const { return 1.0f; }
};

template <typename TX, typename TW, int W, int T, bool MMA>
__global__ void __launch_bounds__(MMA ? tile::MMA_THREADS : tile::FMA_THREADS)
masked_gemm_kernel(MaskedArgs p, Geom gm) {
  extern __shared__ __align__(128) char smem[];
  const int nsub = (p.bn + gm.bn - 1) / gm.bn;
  const int nb = blockIdx.y / nsub;
  const int c0 = (blockIdx.y % nsub) * gm.bn;
  const int ncols = min(gm.bn, p.bn - c0);
  const int m0 = blockIdx.x * gm.bm;
  const int rows = min(gm.bm, p.M - m0);
  const int grp = blockIdx.z;
  const int k0 = grp * p.KB / p.G, k1 = (grp + 1) * p.KB / p.G;
  const int col0 = nb * p.bn + c0;

  __shared__ int mask_s[tile::MAX_PRELOAD];
  const tile::Steps<int> live_kb =
      tile::preload(mask_s, p.mask + static_cast<size_t>(k0) * p.NB + nb, k1 - k0, p.NB);
  __syncthreads();
  KBlockSrc<TX, TW> src{static_cast<const char*>(p.x) +
                            (static_cast<size_t>(m0) * p.K +
                             static_cast<size_t>(k0) * p.bk) * sizeof(TX),
                        static_cast<size_t>(p.K) * sizeof(TX), rows,
                        static_cast<const TW*>(p.w) +
                            static_cast<size_t>(k0) * p.bk * p.N + col0,
                        live_kb, p.bk, p.N, ncols};
  const float* C = tile::accumulate_tile<TX, TW, true, W, T, MMA, true, false>(
      src, k1 - k0, gm, smem);

  const int cs = gm.bn + tile::C_PAD;
  for (int i = threadIdx.x; i < rows * ncols; i += blockDim.x) {
    const int r = i / ncols, c = i - r * ncols;
    const float v = C[r * cs + c];
    const size_t o = static_cast<size_t>(m0 + r) * p.N + col0 + c;
    // the tile-skip kernel's flush with no bias: act(acc + 0)
    if (p.G == 1)
      static_cast<TX*>(p.out)[o] = tile::from_f<TX>(tile::apply_act(v + 0.0f, 0));
    else
      p.partial[static_cast<size_t>(grp) * p.M * p.N + o] = v;
  }
}

template <typename TX, typename TW, int W, int T, bool MMA>
cudaError_t launch_tiles(const MaskedArgs& p, const Geom& gm, cudaStream_t stream) {
  const int smem = tile::smem_bytes(gm);
  auto kern = masked_gemm_kernel<TX, TW, W, T, MMA>;
  cudaError_t err = tile::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int nsub = (p.bn + gm.bn - 1) / gm.bn;
  dim3 grid((p.M + gm.bm - 1) / gm.bm, p.NB * nsub, p.G);
  kern<<<grid, gm.threads, smem, stream>>>(p, gm);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.G == 1) return err;
  return tile::launch_reduce<TX>(p.partial, p.G, p.M, p.N, nullptr, 0, p.out,
                                 stream);
}

// the tile-skip kernel's variants and tiles (sasp_gemm.cu launch_variant)
template <typename TX, typename TW>
cudaError_t launch_variant(const MaskedArgs& p, int variant, cudaStream_t stream) {
  if (variant == 1) {
    if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
      if (p.bk % 16 != 0 || p.bn % 16 != 0) return cudaErrorInvalidValue;
      const Geom gm = tile::mma_geom(p.M, p.bk, p.bn % 32 == 0 ? 32 : 16, 1,
                                     sizeof(TX), sizeof(TW));
      if (gm.pw == 16)
        return gm.tm == 1 ? launch_tiles<TX, TW, 16, 1, true>(p, gm, stream)
                          : launch_tiles<TX, TW, 16, 2, true>(p, gm, stream);
      return gm.tm == 1 ? launch_tiles<TX, TW, 32, 1, true>(p, gm, stream)
                        : launch_tiles<TX, TW, 32, 2, true>(p, gm, stream);
    }
    return cudaErrorInvalidValue;
  }
  const Geom gm = tile::fma_geom(p.M, p.bk, 32, sizeof(TX), sizeof(TW));
  if (p.M <= 8) return launch_tiles<TX, TW, 32, 0, false>(p, gm, stream);
  return launch_tiles<TX, TW, 32, 1, false>(p, gm, stream);
}

template <typename TX>
cudaError_t launch_x(int w_dtype, const MaskedArgs& p, int variant,
                     cudaStream_t stream) {
  switch (w_dtype) {
    case 0: return launch_variant<TX, float>(p, variant, stream);
    case 1: return launch_variant<TX, __nv_bfloat16>(p, variant, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K) in x_dtype (0 fp32, 1 bf16); w (K, N) in w_dtype (0 fp32,
// 1 bf16); mask (KB, NB) int32, nonzero = keep; out (M, N) in x_dtype.
// variant, groups and partial as for sasp_gemm_launch.
extern "C" int sasp_gemm_masked_launch(const void* x, const void* w,
                                       const int* mask, void* out,
                                       float* partial, int M, int K, int N,
                                       int KB, int NB, int x_dtype,
                                       int w_dtype, int variant, int groups,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups < 1 || groups > KB || (groups > 1 && partial == nullptr) ||
      KB < 1 || NB < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  MaskedArgs p{x, w, mask, out, partial, M, K, N, KB, NB, K / KB, N / NB, groups};
  cudaError_t err;
  if (x_dtype == 0)
    err = launch_x<float>(w_dtype, p, variant, s);
  else if (x_dtype == 1)
    err = launch_x<__nv_bfloat16>(w_dtype, p, variant, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
