// SASP masked-grid GEMM for Hopper (sm_90a): the dense-grid ablation.
//
// Replaces: src/repro/kernels/sasp_gemm/kernel.py:346
// (sasp_gemm_masked) and its body _masked_kernel.
//
// Computes out = x @ (W ⊙ mask) from the DENSE weight w (K, N) and a
// block mask (KB, NB) int32: bk = K / KB, bn = N / NB. Every (k, n)
// block is visited and its multiply-adds are predicated on mask[k, n].
// That is the clock-gating design the paper names as the inferior
// alternative to skipping tiles (kernel.py:317-322): it saves operations,
// not bytes. The tile-skip kernel (sasp_gemm.cu) reads only the live
// blocks; this one reads every weight byte, whatever the mask says.
//
// Numerics mirror the TPU kernel: each weight is rounded to x's type
// before the product (w.astype(x.dtype)), products are summed in fp32,
// one k-block's partial at a time in ascending k, and the output is cast
// to x's type once. On the same weights and mask the sums are the
// tile-skip kernel's over BSR, bit for bit: the same k-block groups
// (schedule.gemm_groups, group g takes the k-blocks [g*KB/G,
// (g+1)*KB/G)), each group's k-blocks added one partial at a time from
// zero, each partial a chain of mma.sync m16n8k16 over the k-block's
// 16-deep slices from zero, and the groups added in order from zero, as
// tile::reduce_groups adds them.
//
// Bound. Decode (M = 4): the dense weight's bytes, K * N * 2 / 3.35
// TB/s (wq 5120 x 8192 bf16: 0.0251 ms), twice what the tile-skip kernel
// needs at 50% sparsity: the ablation's point. Prefill (M = 168): the
// larger of the same bytes and the live tiles' MACs over 989 TFLOP/s
// (wq: 7.0 GFLOP, 0.0071 ms), so bytes still.
//
// Design, bf16 x and bf16 W (variant "tma"):
//  - Tensor maps over the dense W and over x (tma_ring.cuh), boxes 64
//    columns (128 bytes) wide under the 128-byte swizzle. A stage holds
//    64 rows of k: one box of x (block rows x 64 k) and, per 64 columns
//    of the block's tile, one 64-row W box (one per k-block in a group's
//    last, shorter stage). Every W box is loaded,
//    live or pruned: only the MMA is predicated, so a decode call streams
//    the whole dense weight, as the ablation must.
//  - One producer warp (one thread) keeps the ring full: it waits on a
//    stage's empty barrier, announces its bytes and issues its TMA loads;
//    the consumer warps wait on the full barrier, run ldmatrix + mma.sync
//    on the swizzled tiles and release the stage. No block-wide barrier
//    inside the loop, and no thread spends registers or instructions on
//    the copy's addresses.
//  - Wide output tiles: a block's tile spans several mask column-blocks
//    (128 columns; 64 at decode where 128 would leave SMs idle), so x is
//    read once per wide tile, not once per 32 columns. A warp's 16-column
//    pairs of n-tiles each lie in one column-block: the predicate is one
//    bit of the k-block's mask word, uniform over the warp.
//  - One k-block group a block, (G, M, N) fp32 partials reduced in group
//    order when G > 1, as the tile-skip kernel does: qwen3-32b's
//    projections put 160 to 400 blocks on the card at decode and 80 to
//    400 at prefill. Decode (M <= 16): one 16-row m-tile, 16 columns a
//    warp, four 18 KB stages, three blocks an SM. Prefill: 32 x 64 a
//    warp, up to 6 x 2 warps (192 x 128, the whole of 168 rows, so W is
//    read once), five 40 KB stages.
//  - Tried on the card and left out, all bit-exact, none faster than
//    this layout: a block that walks every group of its tile with the
//    running total in shared memory (no partials); clusters of two column
//    tiles sharing each x box by TMA multicast; and wgmma consumers.
//  - So every k16 step is mma.sync m16n8k16, the tile-skip kernel's
//    instruction. A probe on an H100 found wgmma m64n8k16's fp32 sums
//    equal to mma.sync's over random bf16 tiles, and a wgmma consumer
//    (warpgroups of 64 rows, A from registers, B read from the swizzled
//    W box) passed the bit-for-bit tests; neither is kept, and a kernel
//    that adopts wgmma must first show that equality in a card test. The
//    wgmma consumer was slower at every prefill shape: each k-block's
//    partial must be complete before it is added (acc += part), so every
//    k-block waits on its wgmma group, and a 416-thread block holds 128
//    registers a thread. The MMA is not
//    what bounds this kernel in any case: with every tile pruned (no MMA
//    at all) a prefill call takes most of the time of the real call at
//    50% sparsity (chip_smoke.py phase 2, ``pruned_ms``); moving the bytes
//    into shared memory does.
//
// Other types and shapes (fp32 x: FMAs, no TF32; fp32 W under bf16 x:
// rounded to bf16 in the fragment; k-blocks other than 16, 32, 64 deep
// or column-blocks other than 16, 32, 64, 128 wide) run the shared
// cp.async mainloop of tile_mma.cuh ("mma" / "fma"), one column-block of
// 32 or 16 columns a block, as the tile-skip kernel does.
#include "tile_mma.cuh"
#include "tma_ring.cuh"

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


// ---------------------------------------------------------------------------
// the TMA variant: bf16 x, bf16 W
// ---------------------------------------------------------------------------

constexpr int STAGE_K = 64;      // rows of k a stage holds: one 128-byte x box row
constexpr int BOX_N = 64;        // columns of a W box: 128 bytes
constexpr int HALF_BYTES = STAGE_K * BOX_N * 2;   // a stage's W box column

struct TmaArgs {
  const int* mask;
  void* out;       // (M, N) bf16
  float* partial;  // (G, M, N) fp32 when G > 1
  int M, N, KB, NB, bk, bn, G;
  int bm, bn_t;    // the block's output tile
  int stages;
  int words;       // mask words a block keeps: the k-blocks of its group
  int warps, smem; // the plan's consumer warps and shared memory, checked
};

__host__ __device__ inline int tma_stage_bytes(const TmaArgs& p) { return (p.bm + p.bn_t) * STAGE_K * 2; }

// the ring (aligned to the swizzle's period), its barriers, the mask words
inline int tma_smem_bytes(const TmaArgs& p) {
  return tma::STAGE_ALIGN + p.stages * tma_stage_bytes(p) +
         2 * p.stages * static_cast<int>(sizeof(uint64_t)) +
         p.words * static_cast<int>(sizeof(uint32_t));
}

// acc (the warp's TM m-tiles x PW columns) += k-block j of the stage: one
// partial per 16-column pair of n-tiles whose column-block is live in
// `word` (a pair never straddles two column-blocks: bn is a multiple of
// 16), the partial a chain of mma.sync over the k-block's 16-deep slices
// from zero, then added.
template <int BK, int TM, int PW>
__device__ __forceinline__ void kblock(float (&acc)[TM][PW / 8][4], const char* xs,
                                       const char* ws, int j, uint32_t word,
                                       const int (&bit)[PW / 16], int r0, int c0,
                                       int lane) {
  constexpr int KK = BK / 16;
  uint32_t a[KK][TM][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int m = 0; m < TM; ++m)
      tile::ldmatrix_x4(a[kk][m],
                        xs + tma::swz128(r0 + 16 * m + (lane & 15),
                                         (j * BK + 16 * kk) / 8 + (lane >> 4)));
#pragma unroll
  for (int np = 0; np < PW / 16; ++np) {
    if (!((word >> bit[np]) & 1u)) continue;
    const int n = c0 + 16 * np + (lane >> 4) * 8;
    const char* wh = ws + (n / BOX_N) * HALF_BYTES;
    float part[TM][2][4];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        part[m][h][0] = part[m][h][1] = part[m][h][2] = part[m][h][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      // matrices (k 0-7 | 8-15) x (n 0-7 | 8-15), transposed into the
      // col-major B fragments of n-tiles 2np and 2np + 1
      uint32_t b[4];
      tile::ldmatrix_x4_trans(
          b, wh + tma::swz128(j * BK + 16 * kk + (lane & 15), (n % BOX_N) / 8));
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        tile::mma_bf16_nv(part[m][0], a[kk][m], b[0], b[1]);
        tile::mma_bf16_nv(part[m][1], a[kk][m], b[2], b[3]);
      }
    }
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][2 * np + h][e] += part[m][h][e];
  }
}

// The consumer warps of a block: warp (wi, wj) of a (bm / 16TM) x
// (bn_t / PW) grid walks the ring's stages in the producer's order and
// sums its group's k-blocks, one partial at a time in ascending k.
template <int BK, int TM, int PW>
__device__ __forceinline__ void consume(const TmaArgs& p, const char* smem, uint64_t* full,
                                        uint64_t* empty, const uint32_t* words, int warp,
                                        int lane, int m0, int n0, int g) {
  constexpr int KPS = STAGE_K / BK;   // k-blocks a stage holds
  const int x_bytes = p.bm * STAGE_K * 2;
  const int stage_bytes = tma_stage_bytes(p);
  const int wm = p.bm / (16 * TM);
  const int wi = warp % wm, wj = warp / wm;
  const int r0 = 16 * TM * wi, c0 = PW * wj;
  const bool active = m0 + r0 < p.M && n0 + c0 < p.N;
  int bit[PW / 16];
  uint32_t warp_bits = 0;
#pragma unroll
  for (int q = 0; q < PW / 16; ++q) {
    bit[q] = (c0 + 16 * q) / p.bn;
    warp_bits |= 1u << bit[q];
  }
  float acc[TM][PW / 8][4];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int q = 0; q < PW / 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.0f;

  tma::Ring ring;
  const int kb0 = g * p.KB / p.G, kb1 = (g + 1) * p.KB / p.G;
  for (int kb = kb0; kb < kb1; kb += KPS) {
    const int n = min(KPS, kb1 - kb);
    tma::mbar_wait(full + ring.slot, ring.phase);
    const char* xs = smem + ring.slot * stage_bytes;
    if (active) {
#pragma unroll
      for (int j = 0; j < KPS; ++j) {
        if (j < n) {
          const uint32_t word = words[kb + j - kb0];
          if (word & warp_bits)
            kblock<BK, TM, PW>(acc, xs, xs + x_bytes, j, word, bit, r0, c0, lane);
        }
      }
    }
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(empty + ring.slot);
    ring.next(p.stages);
  }
  if (!active) return;

  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int q = 0; q < PW / 8; ++q) {
      const int col = n0 + c0 + 8 * q + 2 * t;
      if (col >= p.N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + r0 + 16 * m + gq + 8 * h;
        if (row >= p.M) continue;
        const size_t o = static_cast<size_t>(row) * p.N + col;
        if (p.G > 1) {
          *reinterpret_cast<float2*>(p.partial + static_cast<size_t>(g) * p.M * p.N + o) =
              make_float2(acc[m][q][2 * h], acc[m][q][2 * h + 1]);
        } else {
          // the tile-skip kernel's flush with no bias: act(acc + 0)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + o) =
              __floats2bfloat162_rn(acc[m][q][2 * h] + 0.0f, acc[m][q][2 * h + 1] + 0.0f);
        }
      }
    }
}

// Block (m-tile, n-tile, group). Warps 0 .. W-1 consume, warp W
// produces: one thread waits for a free stage, announces its bytes and
// issues its loads, every W box whatever the mask says.
template <int BK, int TM, int PW>
__global__ void __launch_bounds__(TM == 1 ? 32 * 9 : 32 * 13, 1)
masked_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap wmap_stage, TmaArgs p) {
  extern __shared__ char smem_raw[];
  char* smem = smem_raw + ((tma::STAGE_ALIGN -
                            (tma::smem_u32(smem_raw) & (tma::STAGE_ALIGN - 1))) &
                           (tma::STAGE_ALIGN - 1));
  const int x_bytes = p.bm * STAGE_K * 2;
  const int stage_bytes = tma_stage_bytes(p);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * stage_bytes);
  uint64_t* empty = full + p.stages;
  uint32_t* words = reinterpret_cast<uint32_t*>(empty + p.stages);

  const int consumers = blockDim.x / 32 - 1;
  const int m0 = blockIdx.x * p.bm, n0 = blockIdx.y * p.bn_t, g = blockIdx.z;
  const int kb0 = g * p.KB / p.G, kb1 = (g + 1) * p.KB / p.G;
  const int nb0 = n0 / p.bn;
  const int nbt = min(p.bn_t / p.bn, p.NB - nb0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      tma::mbar_init(full + s, 1);
      tma::mbar_init(empty + s, consumers);
    }
    tma::fence_init();
  }
  // bit j of word i: mask[kb0 + i, nb0 + j], the tile's column-blocks
  for (int i = threadIdx.x; i < kb1 - kb0; i += blockDim.x) {
    const int* row = p.mask + static_cast<size_t>(kb0 + i) * p.NB + nb0;
    uint32_t w = 0;
    for (int j = 0; j < nbt; ++j) w |= (row[j] != 0 ? 1u : 0u) << j;
    words[i] = w;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < consumers) {
    consume<BK, TM, PW>(p, smem, full, empty, words, warp, lane, m0, n0, g);
  } else if (lane == 0) {
    constexpr int KPS = STAGE_K / BK;
    const uint32_t w_box = BK * BOX_N * 2;
    const int boxes = p.bn_t / BOX_N;
    tma::Ring ring;
    for (int kb = kb0; kb < kb1; kb += KPS) {
      const int n = min(KPS, kb1 - kb);
      tma::mbar_wait(empty + ring.slot, ring.phase ^ 1u);
      char* st = smem + ring.slot * stage_bytes;
      uint64_t* bar = full + ring.slot;
      tma::mbar_expect_tx(bar, x_bytes + n * boxes * w_box);
      tma::load_2d(st, &xmap, kb * BK, m0, bar);
      if (n == KPS) {
        // a whole stage: one 64-row box per 64 columns
        for (int h = 0; h < boxes; ++h)
          tma::load_2d(st + x_bytes + h * HALF_BYTES, &wmap_stage, n0 + h * BOX_N, kb * BK,
                       bar);
      } else {
        // a group's last, shorter stage: one box per k-block
        for (int j = 0; j < n; ++j)
          for (int h = 0; h < boxes; ++h)
            tma::load_2d(st + x_bytes + h * HALF_BYTES + j * BK * BOX_N * 2, &wmap,
                         n0 + h * BOX_N, (kb + j) * BK, bar);
      }
      ring.next(p.stages);
    }
  }
}

template <int BK, int TM, int PW>
cudaError_t launch_tma_tiles(const CUtensorMap& xm, const CUtensorMap& wm,
                             const CUtensorMap& wsm, const TmaArgs& p,
                             cudaStream_t stream) {
  auto kern = masked_tma_kernel<BK, TM, PW>;
  const int smem = tma_smem_bytes(p);
  const int consumers = (p.bm / (16 * TM)) * (p.bn_t / PW);
  // the plan (schedule.masked_plan) counts the same, or it is refused
  if (consumers != p.warps || smem != p.smem) return cudaErrorInvalidValue;
  cudaError_t err = tile::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.M + p.bm - 1) / p.bm, (p.N + p.bn_t - 1) / p.bn_t, p.G);
  kern<<<grid, 32 * (consumers + 1), smem, stream>>>(xm, wm, wsm, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.G == 1) return err;
  return tile::launch_reduce<__nv_bfloat16>(p.partial, p.G, p.M, p.N, nullptr, 0, p.out,
                                            stream);
}

template <int BK>
cudaError_t launch_tma_depth(const CUtensorMap& xm, const CUtensorMap& wm,
                             const CUtensorMap& wsm, const TmaArgs& p,
                             cudaStream_t stream) {
  // decode: one 16-row m-tile, 16 columns a warp; prefill: 32 x 64 a warp
  if (p.bm == 16) {
    if (p.bn_t / 16 > 8) return cudaErrorInvalidValue;
    return launch_tma_tiles<BK, 1, 16>(xm, wm, wsm, p, stream);
  }
  if (p.bm % 32 != 0 || (p.bm / 32) * (p.bn_t / 64) > 12) return cudaErrorInvalidValue;
  return launch_tma_tiles<BK, 2, 64>(xm, wm, wsm, p, stream);
}

cudaError_t launch_tma(const void* x, const void* w, const TmaArgs& p, int K,
                       cudaStream_t stream) {
  if (p.bn_t % BOX_N != 0 || p.bn_t % p.bn != 0 || p.bn_t / p.bn > 32 ||
      p.stages < 2 || p.bm < 16 || p.bm > 256)
    return cudaErrorInvalidValue;
  // x in (bm x 64) boxes; W in (bk x 64) boxes, one a k-block, and in
  // (64 x 64) boxes, one a whole stage
  CUtensorMap xm, wm, wsm;
  cudaError_t err = tma::bf16_map(
      &xm, {x, static_cast<uint64_t>(p.M), static_cast<uint64_t>(K),
            static_cast<uint64_t>(K) * 2, static_cast<uint32_t>(p.bm), BOX_N});
  for (int i = 0; i < 2 && err == cudaSuccess; ++i)
    err = tma::bf16_map(i == 0 ? &wm : &wsm,
                        {w, static_cast<uint64_t>(K), static_cast<uint64_t>(p.N),
                         static_cast<uint64_t>(p.N) * 2,
                         static_cast<uint32_t>(i == 0 ? p.bk : STAGE_K), BOX_N});
  if (err != cudaSuccess) return err;
  switch (p.bk) {
    case 16: return launch_tma_depth<16>(xm, wm, wsm, p, stream);
    case 32: return launch_tma_depth<32>(xm, wm, wsm, p, stream);
    case 64: return launch_tma_depth<64>(xm, wm, wsm, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K) in x_dtype (0 fp32, 1 bf16); w (K, N) in w_dtype (0 fp32,
// 1 bf16); mask (KB, NB) int32, nonzero = keep; out (M, N) in x_dtype.
// variant: 0 fma, 1 mma (tile_mma.cuh's loop), 2 tma (bf16 x and W; block
// tile bm x bn_t, `stages` ring stages, `warps` consumer warps, `smem`
// bytes of dynamic shared memory: a launch whose warps or smem differ
// from this file's own count is refused). Groups and partial as for
// sasp_gemm_launch: one group a block, (G, M, N) fp32 partials when
// G > 1. All from kernels/sasp_gemm/schedule.py masked_plan.
extern "C" int sasp_gemm_masked_launch(const void* x, const void* w,
                                       const int* mask, void* out,
                                       float* partial, int M, int K, int N,
                                       int KB, int NB, int x_dtype,
                                       int w_dtype, int variant, int groups,
                                       int bm, int bn_t, int stages, int warps,
                                       int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups < 1 || groups > KB || KB < 1 || NB < 1 ||
      (groups > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 2) {
    if (x_dtype != 1 || w_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    TmaArgs p{mask, out, partial, M, N, KB, NB, K / KB, N / NB, groups,
              bm, bn_t, stages, (KB + groups - 1) / groups, warps, smem};
    return static_cast<int>(launch_tma(x, w, p, K, s));
  }
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
