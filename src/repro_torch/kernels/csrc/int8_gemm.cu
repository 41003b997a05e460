// Dense weight-only int8 GEMM for Hopper (sm_90a): the paper's FP32_INT8
// configuration without pruning.
//
// Replaces: src/repro/kernels/int8_gemm/kernel.py::int8_gemm and its body
// _int8_kernel.
//
// Computes out = x @ dequant(w_q) from x (M, K) fp32 or bf16, w_q (K, N)
// int8 and one fp32 scale per (bk, bn) block, scale (KB, NB): bk = K / KB,
// bn = N / NB. Numerics follow the TPU kernel: the int8 weight is widened
// exactly, each k-block's partial product is summed in fp32 and multiplied
// by scale[k, n] before it is added to the fp32 accumulator, in ascending
// k within a k-group; the output is cast to x's type once.
//
// Bound. At decode (M about 4) the kernel must read the int8 weight once:
// bytes, K * N / 3.35 TB/s. At prefill (168 rows) it is bound by
// operations (bf16 tensor cores for bf16 x, fp32 FMAs for fp32 x).
//
// Design. The pipeline is tile_mma.cuh's (a cp.async ring of x and weight
// tiles in 16-byte pieces, one barrier per stage); the loop body is this
// file's, since the weight is dense and a tile spans several scale blocks
// (the masked grid's body applies one scale to a whole tile). It replaces
// kblock_gemm.cuh, the first version's body (fp32 FMAs, one byte a thread,
// no split over k), which had no other user and is gone.
//   * A thread block owns a (bm x BN) output tile, BN = 128 columns (MMA)
//     or 64 (FMA): up to 16 scale blocks of 8 columns, so one x tile
//     serves them all. Each output element keeps its own scale index; the
//     group's scales sit in shared memory.
//   * The k-blocks are split into G groups (a function of K, N, bk and the
//     variant, never of M; kernels/int8_gemm/schedule.py), each group one
//     block along grid z, and tile::reduce_groups adds the groups' fp32
//     partials in order. At decode wk/wv has 8 column tiles x 17 groups.
//   * MMA (bf16 x, bk 16, 32, 64 or 128): mma.sync m16n8k16, x through
//     ldmatrix; a pipeline step is one whole k-block, so its first product
//     starts from a zero accumulator with no branch (a branch between the
//     two forms had ptxas fence every MMA). A warp owns 32 columns; lane
//     (g, t) of the B fragment of n-tile j stands for physical column
//     4g + j, so that one 32-bit shared load per k row gives the lane its
//     bytes of four n-tiles. An int8 byte becomes bf16 exactly: 0x4B0000uu
//     is 2^23 + u as fp32 (u the byte plus 128), one subtraction gives the
//     integer, whose top 16 bits are its bf16 (at most 8 significant
//     bits). Two partials alternate by k-block: k-block i - 1's is scaled
//     into the accumulator after k-block i's products are issued, so the
//     flush does not wait on them. Decode blocks are 16 x 128 (4 warps);
//     prefill blocks 96 x 128 (8 warps of 3 m-tiles), 4 k-blocks a stage,
//     written out, so that a barrier comes every 96 MMAs of a warp.
//   * FMA (fp32 x, or other block depths, bk = 8 among them): a thread
//     owns 4 columns (one 32-bit weight load per k) x TR rows, fp32 FMAs
//     in ascending k.
// A row's sum is the same chain of steps whatever M and the block shape,
// so a row's result never depends on the rows beside it.
#include "tile_mma.cuh"

namespace {

using tile::Geom;

constexpr int PW = 32;            // MMA: columns per warp
constexpr int MMA_BN = 128;       // MMA: columns per block (4 warps wide)
constexpr int FMA_BN = 64;        // FMA: columns per block
constexpr int FMA_CG = FMA_BN / 4;  // FMA: column groups of 4
constexpr int SCALE_CAP = 2048;   // a group's scales kept in shared memory

struct Int8Args {
  const void* x;
  const int8_t* w;
  const float* scale;
  void* out;
  float* partial;  // (G, M, N) fp32 when G > 1
  int M, K, N, KB, NB, bk, bn, G;
};

// the four signed bytes of w as exact fp32 values
__device__ __forceinline__ void widen4(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;   // byte + 128, unsigned
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + j)) - 8388736.0f;
}

// b if ODD, else a, chosen at compile time (a choice at run time would give
// the arrays an address and put them in local memory)
template <bool ODD, typename A>
__device__ __forceinline__ A& pick(A& a, A& b) {
  if constexpr (ODD) return b;
  else return a;
}

// bf16x2 of two fp32 integers of at most 8 significant bits (exact)
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// d = A @ B: the first product of a k-block (the accumulator starts at 0)
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// KS: the step depth (a compile-time constant, so that the k-loop unrolls);
// U: steps a stage where it is fixed at compile time (4: MMA at prefill),
// else 1
template <typename TX, bool MMA, int T, int KS, int U = 1>
__global__ void __launch_bounds__(256)
int8_gemm_kernel(Int8Args p, Geom gm) {
  extern __shared__ __align__(128) char smem[];
  __shared__ float sc_s[SCALE_CAP];
  const int tid = threadIdx.x;
  const int col0 = blockIdx.y * gm.bn;
  const int ncols = min(gm.bn, p.N - col0);
  const int m0 = blockIdx.x * gm.bm;
  const int rows = min(gm.bm, p.M - m0);
  const int grp = blockIdx.z;
  const int kb0 = grp * p.KB / p.G, kb1 = (grp + 1) * p.KB / p.G;
  const int nkb = kb1 - kb0;
  const int q0 = col0 / p.bn;
  const int nq = (col0 + ncols - 1) / p.bn - q0 + 1;
  const bool kept = nkb * nq <= SCALE_CAP;
  if (kept)
    for (int i = tid; i < nkb * nq; i += blockDim.x)
      sc_s[i] = p.scale[static_cast<size_t>(kb0 + i / nq) * p.NB + q0 + i % nq];
  // (the ring's first barrier publishes sc_s)
  auto scale_at = [&](int kbl, int q) {
    return kept ? sc_s[kbl * nq + q]
                : p.scale[static_cast<size_t>(kb0 + kbl) * p.NB + q0 + q];
  };

  const int spk = p.bk / KS;             // steps per k-block
  const int n = nkb * spk;
  const int ns = (n + gm.u - 1) / gm.u;
  constexpr int XB = sizeof(TX);
  tile::TileDesc ad{{static_cast<const char*>(p.x) +
                     (static_cast<size_t>(m0) * p.K + static_cast<size_t>(kb0) * p.bk) * XB},
                    {0}, 1, rows, gm.ks * XB, gm.xs_stride,
                    static_cast<size_t>(p.K) * XB, static_cast<size_t>(gm.ks) * XB};
  tile::TileDesc wd{{reinterpret_cast<const char*>(p.w) +
                     static_cast<size_t>(kb0) * p.bk * p.N + col0},
                    {0}, 1, gm.ks, ncols, gm.ws_stride,
                    static_cast<size_t>(p.N), static_cast<size_t>(gm.ks) * p.N};
  const tile::CopyPlan ap = tile::plan_copy(ad), wp = tile::plan_copy(wd);
  auto load = [&](int s, char* st) {
    for (int j = 0; j < gm.u; ++j) {
      const int i = s * gm.u + j;
      if (i >= n) break;
      tile::copy_tile(ap, ad, st + j * gm.xs_bytes, static_cast<size_t>(i) * gm.ks * XB);
      tile::copy_tile(wp, wd, st + gm.u * gm.xs_bytes + j * gm.ws_bytes,
                      static_cast<size_t>(i) * gm.ks * p.N);
    }
  };
  float* C = reinterpret_cast<float*>(smem);
  const int cs = gm.bn + tile::C_PAD;

  if constexpr (MMA) {
    static_assert(std::is_same<TX, __nv_bfloat16>::value, "MMA takes bf16 x");
    constexpr int TM = T;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int wi = warp % gm.wm, wj = warp / gm.wm;
    const int r0 = 16 * TM * wi, wc = PW * wj;
    const bool active = wj < gm.wn && r0 < rows && wc < ncols;
    // element e of n-tile j is physical column wc + 8t + 4e + j
    int qi[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        qi[j][e] = min((col0 + wc + 8 * t + 4 * e + j) / p.bn - q0, nq - 1);
    // A step is one k-block (KS = bk). Two partials: k-block i - 1's is
    // scaled into acc after k-block i's products have been issued, so the
    // flush does not wait on them.
    float acc[TM][4][4], pa[TM][4][4], pb[TM][4][4];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
    auto flush = [&](const float (&part)[TM][4][4], int kbl) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s0 = scale_at(kbl, qi[j][0]), s1 = scale_at(kbl, qi[j][1]);
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          acc[m][j][0] += part[m][j][0] * s0;
          acc[m][j][1] += part[m][j][1] * s1;
          acc[m][j][2] += part[m][j][2] * s0;
          acc[m][j][3] += part[m][j][3] * s1;
        }
      }
    };
    auto step = [&](auto odd_tag, int i, const char* xs, const char* ws) {
      constexpr bool ODD = decltype(odd_tag)::value;
      auto& part = pick<ODD>(pa, pb);
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        uint32_t a[TM][4];
#pragma unroll
        for (int m = 0; m < TM; ++m)
          tile::ldmatrix_x4(a[m], xs + (r0 + 16 * m + (lane & 15)) * gm.xs_stride +
                                      (kk + (lane >> 4) * 8) * 2);
        const char* wrow = ws + (kk + 2 * t) * gm.ws_stride + wc + 4 * g;
        float f0[4], f1[4], f8[4], f9[4];
        widen4(*reinterpret_cast<const uint32_t*>(wrow), f0);
        widen4(*reinterpret_cast<const uint32_t*>(wrow + gm.ws_stride), f1);
        widen4(*reinterpret_cast<const uint32_t*>(wrow + 8 * gm.ws_stride), f8);
        widen4(*reinterpret_cast<const uint32_t*>(wrow + 9 * gm.ws_stride), f9);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t b0 = pack_exact(f0[j], f1[j]);
          const uint32_t b1 = pack_exact(f8[j], f9[j]);
#pragma unroll
          for (int m = 0; m < TM; ++m) {
            if (kk == 0) mma_bf16_zero(part[m][j], a[m], b0, b1);
            else tile::mma_bf16_nv(part[m][j], a[m], b0, b1);
          }
        }
      }
      if (i > 0) flush(pick<!ODD>(pa, pb), i - 1);
    };
    tile::run_ring(smem, gm, ns, load, [&](int s, const char* st) {
      if (!active) return;
      if constexpr (U == 4) {
        // 4 steps a stage, written out: step jj's parity is jj's
        auto at = [&](auto odd_tag, int jj) {
          const int i = s * U + jj;
          if (i < n)
            step(odd_tag, i, st + jj * gm.xs_bytes, st + U * gm.xs_bytes + jj * gm.ws_bytes);
        };
        at(std::false_type{}, 0);
        at(std::true_type{}, 1);
        at(std::false_type{}, 2);
        at(std::true_type{}, 3);
      } else {
        for (int jj = 0; jj < gm.u; ++jj) {
          const int i = s * gm.u + jj;
          if (i >= n) break;
          const char* xs = st + jj * gm.xs_bytes;
          const char* ws = st + gm.u * gm.xs_bytes + jj * gm.ws_bytes;
          if (i & 1) step(std::true_type{}, i, xs, ws);
          else step(std::false_type{}, i, xs, ws);
        }
      }
    });
    if (active && n > 0) {
      if ((n - 1) & 1) flush(pb, n - 1);
      else flush(pa, n - 1);
    }
    if (active) {
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const int r = r0 + 16 * m + g;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = wc + 8 * t + j;
          C[r * cs + c] = acc[m][j][0];
          C[r * cs + c + 4] = acc[m][j][1];
          C[(r + 8) * cs + c] = acc[m][j][2];
          C[(r + 8) * cs + c + 4] = acc[m][j][3];
        }
      }
    }
  } else {
    constexpr int TR = T;
    constexpr int RG = 256 / FMA_CG;   // row groups
    const int cg = tid % FMA_CG, rg = tid / FMA_CG;
    int qi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) qi[j] = min((col0 + 4 * cg + j) / p.bn - q0, nq - 1);
    float acc[TR][4], part[TR][4];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = part[r][j] = 0.0f;
    const bool active = rg < rows && 4 * cg < ncols;
    int sub = 0, kbl = 0;   // the step's place in its k-block, the k-block
    tile::run_ring(smem, gm, ns, load, [&](int s, const char* st) {
      if (!active) return;
      for (int jj = 0; jj < gm.u; ++jj) {
        if (s * gm.u + jj >= n) break;
        const char* xs = st + jj * gm.xs_bytes;
        const char* ws = st + gm.u * gm.xs_bytes + jj * gm.ws_bytes + 4 * cg;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          float f[4];
          widen4(*reinterpret_cast<const uint32_t*>(ws + k * gm.ws_stride), f);
#pragma unroll
          for (int r = 0; r < TR; ++r) {
            const float xv = tile::to_f(
                reinterpret_cast<const TX*>(xs + (rg + r * RG) * gm.xs_stride)[k]);
#pragma unroll
            for (int j = 0; j < 4; ++j) part[r][j] = fmaf(xv, f[j], part[r][j]);
          }
        }
        if (++sub == spk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float sj = scale_at(kbl, qi[j]);
#pragma unroll
            for (int r = 0; r < TR; ++r) {
              acc[r][j] += part[r][j] * sj;
              part[r][j] = 0.0f;
            }
          }
          sub = 0;
          ++kbl;
        }
      }
    });
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) C[(rg + r * RG) * cs + 4 * cg + j] = acc[r][j];
  }
  __syncthreads();

  for (int i = tid; i < rows * ncols; i += blockDim.x) {
    const int r = i / ncols, c = i - r * ncols;
    const float v = C[r * cs + c];
    const size_t o = static_cast<size_t>(m0 + r) * p.N + col0 + c;
    if (p.G == 1)
      static_cast<TX*>(p.out)[o] = tile::from_f<TX>(v);
    else
      p.partial[static_cast<size_t>(grp) * p.M * p.N + o] = v;
  }
}

template <typename TX, bool MMA, int T, int KS>
cudaError_t launch_tiles(const Int8Args& p, const Geom& gm, cudaStream_t stream) {
  const int smem = tile::smem_bytes(gm);
  auto kern = int8_gemm_kernel<TX, MMA, T, KS, 1>;
  if constexpr (MMA)
    if (gm.u == 4) kern = int8_gemm_kernel<TX, MMA, T, KS, 4>;
  cudaError_t err = tile::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.M + gm.bm - 1) / gm.bm, (p.N + gm.bn - 1) / gm.bn, p.G);
  kern<<<grid, gm.threads, smem, stream>>>(p, gm);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.G == 1) return err;
  return tile::launch_reduce<TX>(p.partial, p.G, p.M, p.N, nullptr, 0, p.out,
                                 stream);
}

template <typename TX, bool MMA, int T>
cudaError_t launch_depth(const Int8Args& p, Geom& gm, int budget, int steps,
                         cudaStream_t stream) {
  // MMA: a step is a whole k-block (16, 32, 64 or 128 deep); FMA: the
  // deepest of 32, 16, 8, 4 that divides bk. The wrapper sends no other.
  if (MMA)
    gm.ks = p.bk;
  else
    gm.ks = p.bk % 32 == 0 ? 32 : (p.bk % 16 == 0 ? 16 : (p.bk % 8 == 0 ? 8 : 4));
  if (p.bk % gm.ks) return cudaErrorInvalidValue;
  tile::finish_geom(gm, sizeof(TX), 1, budget);
  if (steps > gm.u && 2 * steps * (gm.xs_bytes + gm.ws_bytes) <= budget) {
    // several steps a stage: fewer barriers
    gm.u = steps;
    gm.stage_bytes = (steps * (gm.xs_bytes + gm.ws_bytes) + 127) / 128 * 128;
    gm.stages = budget / gm.stage_bytes;
    gm.stages = gm.stages < 2 ? 2 : (gm.stages > tile::MAX_STAGES ? tile::MAX_STAGES : gm.stages);
  }
  switch (gm.ks) {
    case 128:
      if constexpr (MMA) return launch_tiles<TX, MMA, T, 128>(p, gm, stream);
      break;
    case 64:
      if constexpr (MMA) return launch_tiles<TX, MMA, T, 64>(p, gm, stream);
      break;
    case 32: return launch_tiles<TX, MMA, T, 32>(p, gm, stream);
    case 16: return launch_tiles<TX, MMA, T, 16>(p, gm, stream);
    case 8:
      if constexpr (!MMA) return launch_tiles<TX, MMA, T, 8>(p, gm, stream);
      break;
    case 4:
      if constexpr (!MMA) return launch_tiles<TX, MMA, T, 4>(p, gm, stream);
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename TX>
cudaError_t launch_variant(const Int8Args& p, int variant, int col_tile,
                           cudaStream_t stream) {
  Geom gm;
  if (variant == 1) {
    if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
      if (col_tile != MMA_BN) return cudaErrorInvalidValue;
      // 4 warps of 32 columns and one m-tile (decode) or two; more rows:
      // 2 x 4 warps of 3 m-tiles each (96 rows: 168 rows are 2 tiles)
      const int tm = p.M <= 16 ? 1 : (p.M <= 32 ? 2 : 3);
      gm.tm = tm;
      gm.wm = p.M <= 32 ? 1 : 2;
      gm.wn = MMA_BN / PW;
      gm.pw = PW;
      gm.bm = 16 * tm * gm.wm;
      gm.bn = MMA_BN;
      gm.threads = 32 * gm.wm * gm.wn;
      // prefill: 4 k-blocks a stage, so that a barrier comes every 96
      // MMAs of a warp, not every 24
      const int budget = p.M <= 32 ? tile::SMALL_BUDGET : tile::BIG_BUDGET;
      const int steps = p.M <= 32 ? 1 : 4;
      if (tm == 1) return launch_depth<TX, true, 1>(p, gm, budget, steps, stream);
      if (tm == 2) return launch_depth<TX, true, 2>(p, gm, budget, steps, stream);
      return launch_depth<TX, true, 3>(p, gm, budget, steps, stream);
    }
    return cudaErrorInvalidValue;
  }
  if (col_tile != FMA_BN) return cudaErrorInvalidValue;
  const int tr = p.M <= 16 ? 1 : 4;
  gm.tm = gm.wm = gm.wn = gm.pw = 0;
  gm.bm = (256 / FMA_CG) * tr;
  gm.bn = FMA_BN;
  gm.threads = 256;
  if (tr == 1) return launch_depth<TX, false, 1>(p, gm, tile::SMALL_BUDGET, 1, stream);
  return launch_depth<TX, false, 4>(p, gm, tile::SMALL_BUDGET, 1, stream);
}

}  // namespace

// x (M, K) in x_dtype (0 fp32, 1 bf16); wq (K, N) int8; scale (KB, NB)
// fp32; out (M, N) in x_dtype. variant 1 = tensor cores (bf16 x, bk a
// multiple of 16), 0 = fp32 FMAs; col_tile the variant's column tile
// (128 or 64); groups the k-block groups, partial (groups, M, N) fp32 when
// groups > 1. All from kernels/int8_gemm/schedule.py.
extern "C" int int8_gemm_launch(const void* x, const void* wq,
                                const float* scale, void* out, float* partial,
                                int M, int K, int N, int KB, int NB,
                                int x_dtype, int variant, int col_tile,
                                int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KB < 1 || NB < 1 || groups < 1 || groups > KB ||
      (groups > 1 && partial == nullptr) || N % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Int8Args p{x, static_cast<const int8_t*>(wq), scale, out, partial,
             M, K, N, KB, NB, K / KB, N / NB, groups};
  cudaError_t err;
  if (x_dtype == 0)
    err = launch_variant<float>(p, variant, col_tile, s);
  else if (x_dtype == 1)
    err = launch_variant<__nv_bfloat16>(p, variant, col_tile, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
