// Shared mainloop of the SASP kernels for Hopper (sm_90a): sasp_gemm.cu,
// sasp_gemm_masked.cu and both phases of fused_ffn.cu. int8_gemm.cu runs
// its own loop body on this ring (run_ring, the copy plans, the reduce of
// split partials); flash_attn.cu takes its cp.async, ldmatrix and mma
// helpers.
//
// Each of those kernels is a GEMM whose k-loop walks a list of k-steps:
// the tile-skip GEMM walks one column's visits, the FFN's up-projection
// the 64-deep slices of d of one or two visits, its down-projection the
// visits of w2v, the masked grid every k-block of one column. A thread
// block owns one (bm x bn) output tile and runs
//
//   for each step i: acc += finish(A_i @ W_i, i)     (or acc += A_i @ W_i)
//
// where A_i is a (bm x ks) tile of the activations and W_i a (ks x bn)
// tile of weights; a source (the Src argument) describes the two tiles,
// where step i finds them, whether step i takes part (live; the masked
// grid's predicate) and its scale (the int8 per-visit scale).
//
// Pipeline. Step i's tiles are copied into a ring of `stages` buffers of
// shared memory with cp.async (16-byte pieces where alignment allows),
// `stages - 1` buffers ahead of the one being multiplied, with one
// __syncthreads per buffer. Small steps (decode) share a buffer, so that
// one barrier covers several. Each thread's pieces of a tile are worked
// out once per block (CopyPlan): a step's copies then cost one add and
// one cp.async each, where a division per piece had cost more than the
// products at decode.
//
// Two ways to multiply a staged step, chosen by the caller from the
// operand types and the tile shape alone (never from M):
//   MMA  bf16 A, weights widened to bf16 on the way into the fragment
//        (bf16 as they are; int8 exactly; fp32 rounded to nearest, the
//        reference's w.astype(x.dtype)); mma.sync m16n8k16 with fp32
//        accumulators. The warps form a grid (mma_geom): at decode one
//        m-tile and the columns 16 per warp; at prefill up to 12 warps
//        of two m-tiles each, each W fragment serving both. ldmatrix
//        feeds A, and W where it is bf16.
//   FMA  everything else (fp32 activations, the int8 FFN's fp32 h, tile
//        shapes the MMA cannot take): fp32 FMAs on the CUDA cores, 256
//        threads, thread = one column x R rows, k in ascending order.
// In both, each output is one thread's (FMA) or one warp's (MMA) sum over
// the same steps in the same order, whatever the number of rows and
// whichever block shape M selects: a row's result never depends on M.
//
// After the last step the fp32 tile goes to shared memory as
// C[bm][bn + 4], from which each kernel's epilogue reads it.
//
// Not used yet: wgmma, TMA and thread-block clusters. At 168 rows the
// block tile (192 x 128 at most, registers-bound with mma.sync) makes the
// up-projection re-read x from L2 once per pair of visits; a wgmma /
// TMA-multicast design would cut that traffic (PERF.md).
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace tile {

constexpr int MAX_WARPS = 12;            // MMA: up to 12 warps of m-tiles
constexpr int MIN_WARPS = 4;             // MMA: warps past the grid only copy
constexpr int MMA_THREADS = 32 * MAX_WARPS;
constexpr int MAX_PRELOAD = 1024;        // per-step scalars kept in shared memory
constexpr int FMA_THREADS = 256;
constexpr int MAX_STAGES = 8;
constexpr int STAGE_BUDGET = 96 * 1024;  // shared memory of the ring
constexpr int BIG_BUDGET = 192 * 1024;   // ... for an MMA block of 8 warps or more
constexpr int SMALL_BUDGET = 48 * 1024;  // ... for a decode or an FMA block
constexpr int C_PAD = 4;                 // floats of padding per C row

// ---------------------------------------------------------------------------
// types and the flush
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// w.astype(x.dtype) of the TPU kernels: round to x's type, then widen.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
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

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int CH>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (CH == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "n"(CH));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Wait until at most n of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_wait_upto(int n) {
  switch (n) {
    case 6: cp_wait<6>(); break;
    case 5: cp_wait<5>(); break;
    case 4: cp_wait<4>(); break;
    case 3: cp_wait<3>(); break;
    case 2: cp_wait<2>(); break;
    case 1: cp_wait<1>(); break;
    default: cp_wait<0>(); break;
  }
}

template <int CH>
__device__ __forceinline__ void copy_rows_ch(char* dst, int dst_stride,
                                             const char* src, size_t src_stride,
                                             int rows, int row_bytes) {
  const int cpr = row_bytes / CH;   // pieces per row
  const int total = rows * cpr;
  int i = threadIdx.x;
  if (i >= total) return;
  // (row, piece) of this thread's first piece, then advanced by the block
  // size without a division per piece
  int r = i / cpr, c = i - r * cpr;
  const int dr = blockDim.x / cpr, dc = blockDim.x - dr * cpr;
  for (; i < total; i += blockDim.x) {
    cp_async<CH>(dst + r * dst_stride + c * CH, src + r * src_stride + c * CH);
    r += dr;
    c += dc;
    if (c >= cpr) { c -= cpr; ++r; }
  }
}

// Issue the copies of `rows` rows of `row_bytes` bytes (a multiple of 4;
// the wrappers check it) into shared memory rows `dst_stride` apart, in
// the widest pieces the source's alignment allows.
__device__ __forceinline__ void copy_rows(char* dst, int dst_stride,
                                          const void* src, size_t src_stride,
                                          int rows, int row_bytes) {
  const unsigned al = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(src) | src_stride | static_cast<size_t>(row_bytes));
  const char* s = static_cast<const char*>(src);
  if ((al & 15) == 0) copy_rows_ch<16>(dst, dst_stride, s, src_stride, rows, row_bytes);
  else if ((al & 7) == 0) copy_rows_ch<8>(dst, dst_stride, s, src_stride, rows, row_bytes);
  else copy_rows_ch<4>(dst, dst_stride, s, src_stride, rows, row_bytes);
}

// The tile a step copies: nseg segments of `rows` rows of `row_bytes`
// bytes, segment s read from base[s] (rows ld bytes apart) into shared
// memory from byte dst_col[s] of each row (rows dst_stride apart). Step
// i reads off(i) bytes past the bases, a multiple of gran.
constexpr int MAX_SEG = 4;
struct TileDesc {
  const char* base[MAX_SEG];
  int dst_col[MAX_SEG];
  int nseg, rows, row_bytes, dst_stride;
  size_t ld, gran;
};

// This thread's pieces of a tile, worked out once per block, so that a
// step's copies cost one add and one cp.async each.
constexpr int MAX_PIECES = 4;
struct CopyPlan {
  const char* src[MAX_PIECES];
  int dst[MAX_PIECES];
  int n;    // this thread's pieces; -1 past MAX_PIECES (copy_tile walks the tile)
  int ch;   // piece size: 16, 8 or 4 bytes
};

__device__ __forceinline__ CopyPlan plan_copy(const TileDesc& t) {
  CopyPlan p;
  size_t al = t.ld | t.gran | static_cast<size_t>(t.row_bytes) |
              static_cast<size_t>(t.dst_stride);
  for (int s = 0; s < t.nseg; ++s)
    al |= reinterpret_cast<uintptr_t>(t.base[s]) | static_cast<size_t>(t.dst_col[s]);
  p.ch = (al & 15) == 0 ? 16 : ((al & 7) == 0 ? 8 : 4);
  const int cpr = t.row_bytes / p.ch;
  const int per_seg = t.rows * cpr;
  const int total = t.nseg * per_seg;
  p.n = 0;
#pragma unroll
  for (int q = 0; q < MAX_PIECES; ++q) {
    p.src[q] = nullptr;
    p.dst[q] = 0;
    const int i = threadIdx.x + q * blockDim.x;
    if (i < total) {
      const int sg = i / per_seg, rem = i - sg * per_seg;
      const int r = rem / cpr, c = rem - r * cpr;
      p.src[q] = t.base[sg] + r * t.ld + c * p.ch;
      p.dst[q] = t.dst_col[sg] + r * t.dst_stride + c * p.ch;
      p.n = q + 1;
    }
  }
  if (total > MAX_PIECES * static_cast<int>(blockDim.x)) p.n = -1;
  return p;
}

template <int CH>
__device__ __forceinline__ void issue_plan(const CopyPlan& p, char* dst, size_t off) {
#pragma unroll
  for (int q = 0; q < MAX_PIECES; ++q)
    if (q < p.n) cp_async<CH>(dst + p.dst[q], p.src[q] + off);
}

__device__ __forceinline__ void copy_tile(const CopyPlan& p, const TileDesc& t,
                                          char* dst, size_t off) {
  if (p.n >= 0) {
    if (p.ch == 16) issue_plan<16>(p, dst, off);
    else if (p.ch == 8) issue_plan<8>(p, dst, off);
    else issue_plan<4>(p, dst, off);
  } else {
    for (int s = 0; s < t.nseg; ++s)
      copy_rows(dst + t.dst_col[s], t.dst_stride, t.base[s] + off, t.ld, t.rows,
                t.row_bytes);
  }
}

// ---------------------------------------------------------------------------
// the shape of a block: its tile, its warps, its ring
// ---------------------------------------------------------------------------

// A block computes a (bm x bn) output tile. MMA: its warps form a grid of
// wm x wn; warp (i, j) owns rows [16*tm*i, 16*tm*(i+1)) (tm m-tiles) and
// columns [pw*j, pw*(j+1)). FMA: 256 threads, thread = one column x R rows.
// A stage of the ring holds u steps: their A tiles, then their W tiles.
struct Geom {
  int bm, ks, bn;            // tile rows, step depth, tile columns
  int tm, wm, wn, pw;        // MMA warp grid (unused by FMA)
  int xs_stride, ws_stride;  // shared-memory row strides (bytes)
  int xs_bytes, ws_bytes;    // one step's A tile, W tile
  int u;                     // steps per stage
  int stage_bytes, stages;
  int threads;
};

constexpr int STAGE_TARGET = 8 * 1024;   // bytes a stage should at least hold
constexpr int MAX_U = 4;

inline void finish_geom(Geom& g, int a_bytes, int w_bytes, int budget) {
  // 16 bytes of padding per row: ldmatrix's eight rows then fall in
  // eight different bank groups, and every row stays 16-byte aligned
  g.xs_stride = g.ks * a_bytes + 16;
  g.ws_stride = g.bn * w_bytes + 16;
  g.xs_bytes = g.bm * g.xs_stride;
  g.ws_bytes = g.ks * g.ws_stride;
  // small steps (decode) share a stage, so that one barrier and one wait
  // cover several of them; the sums do not change
  const int step = g.xs_bytes + g.ws_bytes;
  g.u = STAGE_TARGET / step;
  g.u = g.u < 1 ? 1 : (g.u > MAX_U ? MAX_U : g.u);
  g.stage_bytes = (g.u * step + 127) / 128 * 128;
  const int s = budget / g.stage_bytes;
  g.stages = s < 2 ? 2 : (s > MAX_STAGES ? MAX_STAGES : s);
}

// MMA block for M rows and a tile `width` columns wide (a multiple of 16;
// at most 64): decode (M <= 16) spreads the columns over warps 16 at a
// time; more rows take up to 12 warps of tm m-tiles each (tm = 2 past 32
// rows: each W fragment then serves two m-tiles), in `wide` warp-columns
// of `width` columns each.
inline Geom mma_geom(int M, int ks, int width, int wide, int a_bytes,
                     int w_bytes) {
  Geom g;
  if (M <= 16) {
    g.tm = 1; g.wm = 1; g.pw = 16; g.wn = width / 16;
  } else {
    g.pw = width;
    g.wn = wide;
    g.tm = M > 32 ? 2 : 1;
    const int need = (M + 16 * g.tm - 1) / (16 * g.tm);
    const int cap = MAX_WARPS / g.wn;
    g.wm = need < cap ? need : cap;
  }
  g.bm = 16 * g.tm * g.wm;
  g.bn = g.pw * g.wn;
  g.ks = ks;
  const int warps = g.wm * g.wn;
  g.threads = 32 * (warps > MIN_WARPS ? warps : MIN_WARPS);
  // a block of 8 warps or more holds an SM's registers more or less
  // alone: its ring may take most of the shared memory. A decode block
  // keeps a small ring, so that more blocks share an SM and one block's
  // start (its column's k-blocks, the first copies) overlaps another's
  // stream.
  finish_geom(g, a_bytes, w_bytes,
              warps >= 8 ? BIG_BUDGET : (M <= 16 ? SMALL_BUDGET : STAGE_BUDGET));
  return g;
}

// FMA block: BN columns, 8 rows up to M = 8, else 64.
inline Geom fma_geom(int M, int ks, int bn, int a_bytes, int w_bytes) {
  Geom g;
  g.tm = g.wm = g.wn = g.pw = 0;
  g.bm = M <= 8 ? 8 : 64;
  g.bn = bn;
  g.ks = ks;
  g.threads = FMA_THREADS;
  // FMA blocks are bound by their products: room for four a SM
  finish_geom(g, a_bytes, w_bytes, SMALL_BUDGET);
  return g;
}

inline int smem_bytes(const Geom& g) {
  const int ring = g.stages * g.stage_bytes;
  const int c = g.bm * (g.bn + C_PAD) * static_cast<int>(sizeof(float));
  return ring > c ? ring : c;
}

// Raise a kernel's dynamic shared-memory limit once per kernel and device
// (and again only for a larger size).
template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  constexpr int SLOTS = 512;
  static const void* fn[SLOTS];
  static int dev_of[SLOTS], set[SLOTS];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kern);
  int i = 0;
  while (i < used && !(fn[i] == key && dev_of[i] == dev)) ++i;
  if (i == used) {
    if (used == SLOTS) return cudaErrorMemoryAllocation;
    fn[i] = key;
    dev_of[i] = dev;
    set[i] = 0;
    ++used;
  }
  if (set[i] < bytes) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    set[i] = bytes;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// the ring: one barrier per stage
// ---------------------------------------------------------------------------

// Runs ns stages; load(s, st) issues stage s's copies into buffer st,
// compute(s, st) consumes them. Stage s + stages - 1 is issued into the
// buffer stage s - 1 used, after the barrier every thread passes once it
// has finished stage s - 1.
template <class Load, class Compute>
__device__ __forceinline__ void run_ring(char* smem, const Geom& gm, int ns,
                                         Load load, Compute compute) {
  for (int s = 0; s < gm.stages - 1; ++s) {
    if (s < ns) load(s, smem + s * gm.stage_bytes);
    cp_commit();
  }
  int rd = 0, wr = gm.stages - 1;
  for (int s = 0; s < ns; ++s) {
    cp_wait_upto(gm.stages - 2);
    __syncthreads();
    if (s + gm.stages - 1 < ns) load(s + gm.stages - 1, smem + wr * gm.stage_bytes);
    cp_commit();
    compute(s, smem + rd * gm.stage_bytes);
    rd = rd + 1 == gm.stages ? 0 : rd + 1;
    wr = wr + 1 == gm.stages ? 0 : wr + 1;
  }
  cp_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// MMA: bf16 operands, fp32 accumulators
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same product as mma_bf16, not volatile: the compiler may schedule it
// among other instructions (the flash and int8 kernels' loops).
__device__ __forceinline__ void mma_bf16_nv(float (&d)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

template <typename TW>
__device__ __forceinline__ float w_at(const char* ws, int stride, int k, int n) {
  return to_f(reinterpret_cast<const TW*>(ws + k * stride)[n]);
}

// d (the warp's TM m-tiles x PW columns, from row r0 and column c0 of the
// tile) += A (ks deep) @ W; each W fragment serves the TM m-tiles.
template <typename TW, int PW, int TM>
__device__ __forceinline__ void mma_step(float (&d)[TM][PW / 8][4], const char* xs,
                                         const char* ws, const Geom& gm, int r0,
                                         int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int kk = 0; kk < gm.ks; kk += 16) {
    uint32_t a[TM][4];
#pragma unroll
    for (int m = 0; m < TM; ++m)
      ldmatrix_x4(a[m], xs + (r0 + 16 * m + (lane & 15)) * gm.xs_stride +
                            (kk + (lane >> 4) * 8) * 2);
#pragma unroll
    for (int np = 0; np < PW / 16; ++np) {
      uint32_t b[4];
      if constexpr (std::is_same<TW, __nv_bfloat16>::value) {
        // matrices (k 0-7 | 8-15) x (n 0-7 | 8-15), transposed into the
        // col-major B fragments of n-tiles 2np and 2np + 1
        ldmatrix_x4_trans(b, ws + (kk + (lane & 15)) * gm.ws_stride +
                                 (c0 + 16 * np + (lane >> 4) * 8) * 2);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = c0 + 16 * np + 8 * h + g;
          const int k = kk + 2 * t;
          b[2 * h] = pack_bf16(w_at<TW>(ws, gm.ws_stride, k, n),
                               w_at<TW>(ws, gm.ws_stride, k + 1, n));
          b[2 * h + 1] = pack_bf16(w_at<TW>(ws, gm.ws_stride, k + 8, n),
                                   w_at<TW>(ws, gm.ws_stride, k + 9, n));
        }
      }
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        mma_bf16(d[m][2 * np], a[m], b[0], b[1]);
        mma_bf16(d[m][2 * np + 1], a[m], b[2], b[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// FMA: fp32 on the CUDA cores
// ---------------------------------------------------------------------------

// rows per thread of a 256-thread FMA block BN columns wide
template <int BN, bool BIG>
struct FmaShape {
  static constexpr int RG = FMA_THREADS / BN;     // row groups
  static constexpr int BM = BIG ? 64 : 8;
  static constexpr int R = BM / RG;
  static_assert(R >= 1 && R * RG == BM, "tile shape");
};

// p[j] (row rg + j * RG, column c) += A @ W over ks, in ascending k.
template <typename TA, typename TW, bool ROUND, int BN, int R>
__device__ __forceinline__ void fma_step(float (&p)[R], const char* xs,
                                         const char* ws, const Geom& gm) {
  constexpr int RG = FMA_THREADS / BN;
  const int c = threadIdx.x % BN, rg = threadIdx.x / BN;
  for (int k = 0; k < gm.ks; ++k) {
    float w = w_at<TW>(ws, gm.ws_stride, k, c);
    if (ROUND) w = round_to<TA>(w);
#pragma unroll
    for (int j = 0; j < R; ++j)
      p[j] = fmaf(to_f(reinterpret_cast<const TA*>(
                      xs + (rg + j * RG) * gm.xs_stride)[k]), w, p[j]);
  }
}

// ---------------------------------------------------------------------------
// per-step scalars
// ---------------------------------------------------------------------------

// A per-step scalar (a visit's k-block, its scale, a mask bit) read from
// device memory inside the k-loop puts one memory latency on every step.
// Steps.at(i) reads it from shared memory instead, where it was loaded
// once for all steps (up to MAX_PRELOAD of them; beyond that from src).
// Callers __syncthreads before the first use.
template <typename T>
struct Steps {
  const T* src;    // step i's scalar at src[i * stride]
  const T* kept;   // the first MAX_PRELOAD of them
  int stride;
  __device__ T at(int i) const {
    return i < MAX_PRELOAD ? kept[i] : src[static_cast<size_t>(i) * stride];
  }
};

template <typename T>
__device__ __forceinline__ Steps<T> preload(T* buf, const T* src, int n,
                                            int stride = 1) {
  const int m = n < MAX_PRELOAD ? n : MAX_PRELOAD;
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    buf[i] = src[static_cast<size_t>(i) * stride];
  return Steps<T>{src, buf, stride};
}

// ---------------------------------------------------------------------------
// one output tile
// ---------------------------------------------------------------------------

// Src gives:
//   TileDesc a_tile(), w_tile()   the A tile (rows m0.. of the block) and
//                                 the W tile of step 0;
//   size_t a_off(int i), w_off(int i)  step i's byte offsets from them;
//   int rows                      valid rows of the A tile;
//   bool live(int i)     whether step i takes part (copies run anyway);
//   float scale(int i)   the multiplier of step i's partial (SCALED).
// PARTIAL: each step's product is summed on its own and then added
// (acc += part or acc += part * scale), as the TPU kernels add one dot per
// visit; else the steps accumulate straight into acc.
// MMA: W = PW columns per warp, T = TM m-tiles per warp; FMA: W = BN the
// tile's columns, T = 1 for 64 rows (else 8).
// Returns C, the fp32 tile in shared memory, row stride gm.bn + C_PAD.
template <typename TA, typename TW, bool ROUND, int W, int T, bool MMA,
          bool PARTIAL, bool SCALED, class Src>
__device__ float* accumulate_tile(const Src& src, int n, const Geom& gm,
                                  char* smem) {
  const int ns = (n + gm.u - 1) / gm.u;
  TileDesc ad = src.a_tile(), wd = src.w_tile();
  ad.dst_stride = gm.xs_stride;
  wd.dst_stride = gm.ws_stride;
  const CopyPlan ap = plan_copy(ad), wp = plan_copy(wd);
  auto load = [&](int s, char* st) {
    for (int j = 0; j < gm.u; ++j) {
      const int i = s * gm.u + j;
      if (i >= n) break;
      copy_tile(ap, ad, st + j * gm.xs_bytes, src.a_off(i));
      copy_tile(wp, wd, st + gm.u * gm.xs_bytes + j * gm.ws_bytes, src.w_off(i));
    }
  };
  float* C = reinterpret_cast<float*>(smem);
  const int cs = gm.bn + C_PAD;
  if constexpr (MMA) {
    static_assert(std::is_same<TA, __nv_bfloat16>::value, "MMA takes bf16 A");
    constexpr int PW = W, TM = T;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wi = warp % gm.wm, wj = warp / gm.wm;
    const int r0 = 16 * TM * wi, c0 = PW * wj;
    const bool active = wj < gm.wn && r0 < src.rows;
    float acc[TM][PW / 8][4];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int j = 0; j < PW / 8; ++j)
        acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.0f;
    run_ring(smem, gm, ns, load, [&](int s, const char* st) {
      if (!active) return;
      for (int j = 0; j < gm.u; ++j) {
        const int i = s * gm.u + j;
        if (i >= n) break;
        if (!src.live(i)) continue;
        const char* xs = st + j * gm.xs_bytes;
        const char* ws = st + gm.u * gm.xs_bytes + j * gm.ws_bytes;
        if constexpr (PARTIAL) {
          float part[TM][PW / 8][4];
#pragma unroll
          for (int m = 0; m < TM; ++m)
#pragma unroll
            for (int q = 0; q < PW / 8; ++q)
              part[m][q][0] = part[m][q][1] = part[m][q][2] = part[m][q][3] = 0.0f;
          mma_step<TW, PW, TM>(part, xs, ws, gm, r0, c0, lane);
          const float sc = SCALED ? src.scale(i) : 1.0f;
#pragma unroll
          for (int m = 0; m < TM; ++m)
#pragma unroll
            for (int q = 0; q < PW / 8; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[m][q][e] += SCALED ? part[m][q][e] * sc : part[m][q][e];
        } else {
          mma_step<TW, PW, TM>(acc, xs, ws, gm, r0, c0, lane);
        }
      }
    });
    if (wj < gm.wn) {
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const int r = r0 + 16 * m + g;
#pragma unroll
        for (int q = 0; q < PW / 8; ++q) {
          const int c = c0 + 8 * q + 2 * t;
          C[r * cs + c] = acc[m][q][0];
          C[r * cs + c + 1] = acc[m][q][1];
          C[(r + 8) * cs + c] = acc[m][q][2];
          C[(r + 8) * cs + c + 1] = acc[m][q][3];
        }
      }
    }
  } else {
    constexpr int BN = W;
    using S = FmaShape<BN, T != 0>;
    constexpr int R = S::R;
    float acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = 0.0f;
    run_ring(smem, gm, ns, load, [&](int s, const char* st) {
      for (int j = 0; j < gm.u; ++j) {
        const int i = s * gm.u + j;
        if (i >= n) break;
        if (!src.live(i)) continue;
        const char* xs = st + j * gm.xs_bytes;
        const char* ws = st + gm.u * gm.xs_bytes + j * gm.ws_bytes;
        if constexpr (PARTIAL) {
          float part[R];
#pragma unroll
          for (int q = 0; q < R; ++q) part[q] = 0.0f;
          fma_step<TA, TW, ROUND, BN, R>(part, xs, ws, gm);
          const float sc = SCALED ? src.scale(i) : 1.0f;
#pragma unroll
          for (int q = 0; q < R; ++q) acc[q] += SCALED ? part[q] * sc : part[q];
        } else {
          fma_step<TA, TW, ROUND, BN, R>(acc, xs, ws, gm);
        }
      }
    });
    const int c = threadIdx.x % BN, rg = threadIdx.x / BN;
#pragma unroll
    for (int j = 0; j < R; ++j) C[(rg + j * S::RG) * cs + c] = acc[j];
  }
  __syncthreads();
  return C;
}

// ---------------------------------------------------------------------------
// the fixed-order reduce of split partials
// ---------------------------------------------------------------------------

// out[m, n] = act(sum_g partial[g, m, n] + bias[n]), g = 0, 1, ... in
// order: no atomics, the same sum for every M.
template <typename TO>
__global__ void reduce_groups(const float* __restrict__ partial, int G, int M,
                              int N, const float* __restrict__ bias, int act,
                              TO* __restrict__ out) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float a = 0.0f;
  for (int g = 0; g < G; ++g) a += partial[static_cast<size_t>(g) * total + i];
  const float b = bias ? bias[i % N] : 0.0f;
  out[i] = from_f<TO>(apply_act(a + b, act));
}

template <typename TO>
cudaError_t launch_reduce(const float* partial, int G, int M, int N,
                          const float* bias, int act, void* out,
                          cudaStream_t stream) {
  const size_t total = static_cast<size_t>(M) * N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  reduce_groups<TO><<<blocks, threads, 0, stream>>>(
      partial, G, M, N, bias, act, static_cast<TO*>(out));
  return cudaGetLastError();
}

}  // namespace tile
