// Gated FFN over surviving d_ff column-blocks, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sasp_gemm/kernel.py::sasp_fused_ffn and its
// bodies _fused_ffn_kernel (fp) and _fused_ffn_kernel_int8.
//
// Computes out = act(x@W1v + b1) * (x@W3v + b3) @ W2v + b2 over the nv
// visits: w1v/w3v (nv, d, bf) up-projection column-blocks, w2v (nv, bf,
// d) the matching down-projection row-blocks (one (nv*bf, d) matrix),
// b1/b3 (nv, bf), b2 (d,).
//
// Numerics mirror the TPU kernel. fp: weights are rounded to x's type,
// products accumulate in fp32, h = act(u) * g is rounded to x's type
// before the down-projection. int8: everything in fp32, each visit's
// partial products scaled by s1 / s3 / s2, h kept in fp32.
//
// Design: two launches on tile_mma.cuh's mainloop, one schedule for
// every M, each weight byte read once per call.
//  (a) up:   thread block (row tile, visit v, and v + 1 at prefill)
//            computes x @ [W1v | W3v] over 64-deep slices of d (both
//            slabs of each visit staged side by side), then the gated
//            epilogue h = act(u*s1 + b1) * (g*s3 + b3), written to H
//            (M, nv*bf) in x's type (fp; the reference's own rounding) or
//            fp32 (int8).
//  (b) down: thread block (row tile, 64 columns of d at decode or 128 at
//            prefill, visit group) computes H @ W2v over its group's
//            visits, one bf-deep step per visit (int8: each visit's
//            partial times s2). The visit groups ([g*vps, (g+1)*vps), vps
//            from nv and d alone) write fp32 partials that
//            tile::reduce_groups adds in group order, then b2 and the
//            cast; with one group the block flushes.
// The (M, d_ff) intermediate H now passes through device memory: 8.6 MB
// at 168 rows in bf16 against 786 MB of weights, and in return every
// weight is read once whatever M is. Keeping h on chip (the previous
// design) forced a (rows x d) fp32 accumulator per block, so few rows
// per block (4), so the weights were read once per 4 rows at prefill,
// and a (splits, M, d) fp32 partial buffer (688 MB at 168 rows).
// Tensor cores run (a) for bf16 x and (b) for bf16 h (fp path); fp32 x
// and the int8 path's fp32 h run as FMAs. fp (b) accumulates the visits
// straight into its fp32 tile; int8 (b) scales each visit's partial.
//
// Bound. Bytes at decode and prefill alike: 3 * nv * d * bf * sizeof(w)
// / 3.35 TB/s (0.235 ms at qwen3-32b's 5120 / 25600 in bf16); at 168
// rows the tensor-core work (0.134 ms at peak) comes close, and the
// re-reads of x and H from L2 (1.2 GB) hold the kernel back (PERF.md).
#include "tile_mma.cuh"

namespace {

using tile::Geom;

struct FfnArgs {
  const void* x;
  const void* w1v;
  const void* w3v;
  const void* w2v;
  const float* s1;
  const float* s3;
  const float* s2;
  const float* b1;
  const float* b3;
  const float* b2;
  void* h;         // (M, nv*bf) in x's type (fp) or fp32 (int8)
  float* partial;  // (G, M, d) fp32 when G > 1
  void* out;
  int M, d, bf, nv, act, ks, G, vps;
};

// up-projection of the block's visits v0 .. v0 + nvis - 1: step i = rows
// [i*ks, (i+1)*ks) of each visit's W1v and W3v slabs, side by side in the
// tile as [u of v0 | g of v0 | u of v0+1 | g of v0+1 | ...]
template <typename TX, typename TW>
struct UpSrc {
  const char* x;
  size_t a_ld;
  int rows;
  const TW* w1;    // w1v[v0]
  const TW* w3;
  int ks, bf, d, nvis;
  __device__ tile::TileDesc a_tile() const {
    return {{x}, {0}, 1, rows, ks * static_cast<int>(sizeof(TX)), 0, a_ld,
            ks * sizeof(TX)};
  }
  __device__ size_t a_off(int i) const {
    return static_cast<size_t>(i) * ks * sizeof(TX);
  }
  __device__ tile::TileDesc w_tile() const {
    const int row = bf * sizeof(TW);
    const size_t slab = static_cast<size_t>(d) * bf;
    tile::TileDesc t{};
    t.nseg = 2 * nvis;
    for (int j = 0; j < nvis; ++j) {
      t.base[2 * j] = reinterpret_cast<const char*>(w1 + j * slab);
      t.base[2 * j + 1] = reinterpret_cast<const char*>(w3 + j * slab);
      t.dst_col[2 * j] = 2 * j * row;
      t.dst_col[2 * j + 1] = (2 * j + 1) * row;
    }
    t.rows = ks;
    t.row_bytes = row;
    t.ld = row;
    t.gran = static_cast<size_t>(ks) * row;
    return t;
  }
  __device__ size_t w_off(int i) const {
    return static_cast<size_t>(i) * ks * bf * sizeof(TW);
  }
  __device__ bool live(int) const { return true; }
  __device__ float scale(int) const { return 1.0f; }
};

template <typename TX, typename TW, bool QUANT, int W, int T, bool MMA>
__global__ void __launch_bounds__(MMA ? tile::MMA_THREADS : tile::FMA_THREADS)
ffn_up_kernel(FfnArgs p, Geom gm, int vpb) {
  using TH = typename std::conditional<QUANT, float, TX>::type;
  extern __shared__ __align__(128) char smem[];
  const int v0 = blockIdx.y * vpb;
  const int nvis = min(vpb, p.nv - v0);
  const int m0 = blockIdx.x * gm.bm;
  const int rows = min(gm.bm, p.M - m0);
  const size_t wv = static_cast<size_t>(v0) * p.d * p.bf;
  UpSrc<TX, TW> src{static_cast<const char*>(p.x) +
                        static_cast<size_t>(m0) * p.d * sizeof(TX),
                    static_cast<size_t>(p.d) * sizeof(TX), rows,
                    static_cast<const TW*>(p.w1v) + wv,
                    static_cast<const TW*>(p.w3v) + wv, p.ks, p.bf, p.d, nvis};
  const float* C = tile::accumulate_tile<TX, TW, !QUANT, W, T, MMA, false, false>(
      src, p.d / p.ks, gm, smem);

  const int cs = gm.bn + tile::C_PAD;
  const size_t ldh = static_cast<size_t>(p.nv) * p.bf;
  const int per_row = nvis * p.bf;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, jf = i - r * per_row;
    const int j = jf / p.bf, f = jf - j * p.bf, v = v0 + j;
    float u = C[r * cs + 2 * j * p.bf + f], g = C[r * cs + (2 * j + 1) * p.bf + f];
    if (QUANT) { u *= p.s1[v]; g *= p.s3[v]; }
    u += p.b1[static_cast<size_t>(v) * p.bf + f];
    g += p.b3[static_cast<size_t>(v) * p.bf + f];
    static_cast<TH*>(p.h)[(m0 + r) * ldh + static_cast<size_t>(v) * p.bf + f] =
        tile::from_f<TH>(tile::apply_act(u, p.act) * g);
  }
}

// down-projection: step i = visit v0 + i, H columns [v*bf, (v+1)*bf)
template <typename TH, typename TW>
struct DownSrc {
  const char* h;   // row m0, column v0 * bf of H
  size_t a_ld;
  int rows;
  const TW* w2;    // w2v[v0], column n0
  tile::Steps<float> s2;     // the visits' scales (int8)
  int bf, d, ncols;
  __device__ tile::TileDesc a_tile() const {
    return {{h}, {0}, 1, rows, bf * static_cast<int>(sizeof(TH)), 0, a_ld,
            bf * sizeof(TH)};
  }
  __device__ size_t a_off(int i) const {
    return static_cast<size_t>(i) * bf * sizeof(TH);
  }
  __device__ tile::TileDesc w_tile() const {
    return {{reinterpret_cast<const char*>(w2)}, {0}, 1, bf,
            ncols * static_cast<int>(sizeof(TW)), 0, d * sizeof(TW),
            static_cast<size_t>(bf) * d * sizeof(TW)};
  }
  __device__ size_t w_off(int i) const {
    return static_cast<size_t>(i) * bf * d * sizeof(TW);
  }
  __device__ bool live(int) const { return true; }
  __device__ float scale(int i) const { return s2.at(i); }
};

// fp: the visits accumulate straight into the fp32 tile; int8: each
// visit's partial is scaled by its s2, as the reference scales it.
template <typename TX, typename TW, bool QUANT, int W, int T, bool MMA>
__global__ void __launch_bounds__(MMA ? tile::MMA_THREADS : tile::FMA_THREADS)
ffn_down_kernel(FfnArgs p, Geom gm) {
  using TH = typename std::conditional<QUANT, float, TX>::type;
  extern __shared__ __align__(128) char smem[];
  const int n0 = blockIdx.y * gm.bn;
  const int ncols = min(gm.bn, p.d - n0);
  const int m0 = blockIdx.x * gm.bm;
  const int rows = min(gm.bm, p.M - m0);
  const int grp = blockIdx.z;
  const int v0 = grp * p.vps, v1 = min(p.nv, v0 + p.vps);
  const size_t ldh = static_cast<size_t>(p.nv) * p.bf;
  __shared__ float s2_s[QUANT ? tile::MAX_PRELOAD : 1];
  tile::Steps<float> s2{};
  if constexpr (QUANT) {
    s2 = tile::preload(s2_s, p.s2 + v0, v1 - v0);
    __syncthreads();
  }
  DownSrc<TH, TW> src{static_cast<const char*>(p.h) +
                          (m0 * ldh + static_cast<size_t>(v0) * p.bf) * sizeof(TH),
                      ldh * sizeof(TH), rows,
                      static_cast<const TW*>(p.w2v) +
                          static_cast<size_t>(v0) * p.bf * p.d + n0,
                      s2, p.bf, p.d, ncols};
  const float* C = tile::accumulate_tile<TH, TW, !QUANT, W, T, MMA, QUANT, QUANT>(
      src, v1 - v0, gm, smem);

  const int cs = gm.bn + tile::C_PAD;
  for (int i = threadIdx.x; i < rows * ncols; i += blockDim.x) {
    const int r = i / ncols, c = i - r * ncols;
    const float v = C[r * cs + c];
    const size_t o = static_cast<size_t>(m0 + r) * p.d + n0 + c;
    if (p.G == 1)
      static_cast<TX*>(p.out)[o] = tile::from_f<TX>(v + p.b2[n0 + c]);
    else
      p.partial[static_cast<size_t>(grp) * p.M * p.d + o] = v;
  }
}

template <typename TX, typename TW, bool QUANT, int W, int T, bool MMA>
cudaError_t launch_up(const FfnArgs& p, const Geom& gm, int vpb, cudaStream_t stream) {
  const int smem = tile::smem_bytes(gm);
  auto kern = ffn_up_kernel<TX, TW, QUANT, W, T, MMA>;
  cudaError_t err = tile::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.M + gm.bm - 1) / gm.bm, (p.nv + vpb - 1) / vpb);
  kern<<<grid, gm.threads, smem, stream>>>(p, gm, vpb);
  return cudaGetLastError();
}

template <typename TX, typename TW, bool QUANT, int W, int T, bool MMA>
cudaError_t launch_down(const FfnArgs& p, const Geom& gm, cudaStream_t stream) {
  const int smem = tile::smem_bytes(gm);
  auto kern = ffn_down_kernel<TX, TW, QUANT, W, T, MMA>;
  cudaError_t err = tile::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.M + gm.bm - 1) / gm.bm, (p.d + gm.bn - 1) / gm.bn, p.G);
  kern<<<grid, gm.threads, smem, stream>>>(p, gm);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.G == 1) return err;
  return tile::launch_reduce<TX>(p.partial, p.G, p.M, p.d, p.b2, 0, p.out, stream);
}

// variant 1 (MMA): bf16 x, ks a multiple of 16, 2bf in {16, 32, 64}; a
// block takes one visit at decode, two at prefill (both share each x
// tile). variant 0 (FMA): one 64-column tile holds [u | g] of one visit.
template <typename TX, typename TW, bool QUANT>
cudaError_t up_variant(const FfnArgs& p, int variant, cudaStream_t s) {
  if (variant == 1) {
    if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
      const int w = 2 * p.bf;
      if (p.ks % 16 != 0 || (w != 16 && w != 32 && w != 64))
        return cudaErrorInvalidValue;
      const Geom gm = tile::mma_geom(p.M, p.ks, w, 2, sizeof(TX), sizeof(TW));
      const int vpb = gm.bn / w;
      if (gm.pw == 16)
        return gm.tm == 1 ? launch_up<TX, TW, QUANT, 16, 1, true>(p, gm, vpb, s)
                          : launch_up<TX, TW, QUANT, 16, 2, true>(p, gm, vpb, s);
      if (gm.pw == 32)
        return gm.tm == 1 ? launch_up<TX, TW, QUANT, 32, 1, true>(p, gm, vpb, s)
                          : launch_up<TX, TW, QUANT, 32, 2, true>(p, gm, vpb, s);
      return gm.tm == 1 ? launch_up<TX, TW, QUANT, 64, 1, true>(p, gm, vpb, s)
                        : launch_up<TX, TW, QUANT, 64, 2, true>(p, gm, vpb, s);
    }
    return cudaErrorInvalidValue;
  }
  const Geom gm = tile::fma_geom(p.M, p.ks, 64, sizeof(TX), sizeof(TW));
  if (p.M <= 8) return launch_up<TX, TW, QUANT, 64, 0, false>(p, gm, 1, s);
  return launch_up<TX, TW, QUANT, 64, 1, false>(p, gm, 1, s);
}

// variant 1 (MMA): fp path with bf16 h, bf a multiple of 16, d of 64; 64
// columns of d per block at decode, 128 at prefill. variant 0 (FMA): 64.
template <typename TX, typename TW, bool QUANT>
cudaError_t down_variant(const FfnArgs& p, int variant, cudaStream_t s) {
  using TH = typename std::conditional<QUANT, float, TX>::type;
  if (variant == 1) {
    if constexpr (std::is_same<TX, __nv_bfloat16>::value && !QUANT) {
      if (p.bf % 16 != 0 || p.d % 64 != 0) return cudaErrorInvalidValue;
      const Geom gm = tile::mma_geom(p.M, p.bf, 64, 2, sizeof(TH), sizeof(TW));
      if (gm.pw == 16) return launch_down<TX, TW, QUANT, 16, 1, true>(p, gm, s);
      return gm.tm == 1 ? launch_down<TX, TW, QUANT, 64, 1, true>(p, gm, s)
                        : launch_down<TX, TW, QUANT, 64, 2, true>(p, gm, s);
    }
    return cudaErrorInvalidValue;
  }
  const Geom gm = tile::fma_geom(p.M, p.bf, 64, sizeof(TH), sizeof(TW));
  if (p.M <= 8) return launch_down<TX, TW, QUANT, 64, 0, false>(p, gm, s);
  return launch_down<TX, TW, QUANT, 64, 1, false>(p, gm, s);
}

template <typename TX, typename TW, bool QUANT>
cudaError_t launch_typed(const FfnArgs& p, int up, int down, cudaStream_t s) {
  cudaError_t err = up_variant<TX, TW, QUANT>(p, up, s);
  if (err != cudaSuccess) return err;
  return down_variant<TX, TW, QUANT>(p, down, s);
}

template <typename TX>
cudaError_t launch_x(int w_dtype, const FfnArgs& p, int up, int down,
                     cudaStream_t s) {
  switch (w_dtype) {
    case 0: return launch_typed<TX, float, false>(p, up, down, s);
    case 1: return launch_typed<TX, __nv_bfloat16, false>(p, up, down, s);
    case 2: return launch_typed<TX, int8_t, true>(p, up, down, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, d) in x_dtype (0 fp32, 1 bf16); w1v/w3v (nv, d, bf), w2v
// (nv, bf, d) in w_dtype (0 fp32, 1 bf16, 2 int8 with s1/s3/s2 (nv,));
// b1/b3 (nv, bf), b2 (d,) fp32; h (M, nv*bf) scratch in x_dtype (fp) or
// fp32 (int8); partial (G, M, d) fp32 scratch when G > 1; out (M, d) in
// x_dtype. ks: depth of an up-projection step (divides d); up / down:
// variant of each phase (1 MMA, 0 FMA); G groups of vps visits in the
// down-projection.
extern "C" int fused_ffn_launch(const void* x, const void* w1v,
                                const void* w3v, const void* w2v,
                                const float* s1, const float* s3,
                                const float* s2, const float* b1,
                                const float* b3, const float* b2, void* h,
                                float* partial, void* out, int M, int d,
                                int bf, int nv, int x_dtype, int w_dtype,
                                int act, int ks, int up, int down,
                                int groups, int vps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf < 1 || bf > 32 || ks < 1 || d % ks != 0 || groups < 1 || vps < 1 ||
      (groups - 1) * vps >= nv || (groups > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  FfnArgs p{x, w1v, w3v, w2v, s1, s3, s2, b1, b3, b2, h, partial, out,
            M, d, bf, nv, act, ks, groups, vps};
  cudaError_t err;
  if (x_dtype == 0)
    err = launch_x<float>(w_dtype, p, up, down, s);
  else if (x_dtype == 1)
    err = launch_x<__nv_bfloat16>(w_dtype, p, up, down, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
