// Flash attention for Hopper (sm_90a): online softmax over key tiles.
//
// Replaces: src/repro/kernels/flash_attn/kernel.py::flash_attention and
// its body _flash_kernel, with the GQA fold of flash_attn/ops.py::mha.
//
// Computes out[b, s, h] = softmax(q[b, s, h] k[b, :, h/G]^T * D^-0.5,
// masked) v[b, :, h/G] on strided (B, S, heads, D) views (the last axis
// contiguous): q and out with H heads, k and v with KH = H / G, all of one
// type (fp32 or bf16), and 1-D int32 absolute positions shared by the
// batch and every head: key j is visible to query i iff
// 0 <= q_pos[i] - kv_pos[j] < window. Numerics follow the TPU kernel
// (kernel.py:24-63): fp32 scores of the q/k values times D^-0.5; masked
// scores are NEG_INF = -1e30 (not -inf) and their p is zeroed; l sums the
// fp32 p; p is rounded to v's type before p @ v; the accumulator is fp32;
// the flush divides by max(l, 1e-20), so a row that sees no key is 0. GQA
// reads kv head h / G, never a copy of K and V repeated G times.
//
// Bound. Prefill is bound by operations, 4 * D per visible (query, key)
// pair at the bf16 tensor-core rate; decode (one query) by the bytes of K
// and V.
//
// bf16: tensor cores (flash_mma_kernel).
//   * A thread block of 8 warps owns 256 rows of one (batch, kv head):
//     the rows are the (position, query head) pairs of the G heads that
//     share the kv head, position-major, so the G heads read each K/V
//     tile once (a decode step's 8 heads fill 8 rows of one block). A
//     warp owns two m-tiles of 16 rows, so that each K and V fragment it
//     reads from shared memory serves two MMAs (with one m-tile a warp,
//     the ldmatrix traffic matched the tensor cores' time); Q fragments
//     are read from shared memory as they are used.
//   * K/V tiles of 64 keys stay bf16 in a three-stage cp.async ring (16-byte
//     pieces; key rows past Sk are read clamped to the last key, finite,
//     and masked), one barrier a tile. S = Q K^T is mma.sync m16n8k16 (K through ldmatrix)
//     into fp32 fragments; the online softmax runs on those fragments
//     with quad shuffles for the row max; P is rounded to bf16 in
//     registers (the reference's p.astype(v.dtype)) and fed straight back
//     as the A operand of P V (V through ldmatrix.trans). exp2
//     (ex2.approx, 2 ulp) with log2(e) folded into the scale.
//   * Every key tile is classified from position bounds (key tile bounds
//     from a small pre-pass; query tile bounds by the block):
//     skip when no pair can be visible (no load, (m, l, acc) unchanged),
//     full when every pair is visible and no row or key is ragged (no mask
//     arithmetic), partial otherwise (masked per element). The rule is
//     kernels/flash_attn/kernel.py::tile_class, which the plain version
//     runs too.
//   * Query tiles run heaviest (latest) first, so the causal tail does not
//     finish last.
//   * Not done: a split over key tiles for decode ("flash decoding"). It
//     may not depend on Sq (the sum order would then change with the
//     number of queries), and at prefill its partials would take
//     splits x B x Sq x H x D fp32; one query against 4096 keys runs 32
//     blocks, one warp of each busy (PERF.md).
// fp32: fp32 FMAs on the CUDA cores (flash_fma_kernel; TF32 would keep
// about 3 digits): a block owns 16 query rows of one head and walks key
// blocks of 32, skipping a block that no row can see.
#include "tile_mma.cuh"

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, s, h;   // elements between batches, positions, heads
};

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* qpos;
  const int* kpos;
  const int* kt_bounds;   // (key tiles, 2): min and max kv_pos of a tile
  Strides qs, ks, vs, os;
  int B, H, KH, G, Sq, Sk, window;
  float scale;            // D^-0.5 rounded to fp32
};

// ---------------------------------------------------------------------------
// fp32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 16;        // query rows per thread block
constexpr int BK = 32;        // keys per block (one per lane)
constexpr int THREADS = 128;  // 4 warps
constexpr int RW = BQ / (THREADS / 32);  // rows per warp

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

// One block: 16 query rows of one (batch, head); warp w owns rows
// 4w..4w+3, lane c scores key c of the block and owns output columns
// c, c + 32, ... of p @ v. K rows are padded by one float against bank
// conflicts.
template <int D>
__global__ void __launch_bounds__(THREADS) flash_fma_kernel(FlashArgs p) {
  constexpr int DV = (D + 31) / 32;   // output columns per lane
  __shared__ float qs[BQ][D];
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];
  __shared__ float ps[BQ][BK];
  __shared__ int qp_s[BQ];
  __shared__ int kp_s[BK];

  const int hl = blockIdx.y;
  const int b = hl / p.H, h = hl % p.H, kvh = h / p.G;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int Sq = p.Sq, Sk = p.Sk, window = p.window;
  const float* qh = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
  const float* kh = static_cast<const float*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const float* vh = static_cast<const float*>(p.v) + b * p.vs.b + kvh * p.vs.h;

  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qs[r][d] = q0 + r < Sq ? qh[(q0 + r) * p.qs.s + d] : 0.0f;
  }
  if (threadIdx.x < BQ)
    qp_s[threadIdx.x] = q0 + threadIdx.x < Sq ? p.qpos[q0 + threadIdx.x] : 0;

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
      kp_s[threadIdx.x] = c0 + threadIdx.x < Sk ? p.kpos[c0 + threadIdx.x] : 0;
    __syncthreads();
    int seen = 0;
    for (int i = threadIdx.x; i < BQ * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const long long delta = static_cast<long long>(qp_s[r]) - kp_s[c];
      seen |= (q0 + r < Sq && c0 + c < Sk && delta >= 0 && delta < window);
    }
    if (!__syncthreads_or(seen)) continue;   // uniform: no row sees a key

    for (int i = threadIdx.x; i < BK * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const bool in = c0 + c < Sk;
      ks[c][d] = in ? kh[(c0 + c) * p.ks.s + d] : 0.0f;
      vs[c][d] = in ? vh[(c0 + c) * p.vs.s + d] : 0.0f;
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
      const long long delta = static_cast<long long>(qp_s[r]) - kp_s[lane];
      const bool vis = q0 + r < Sq && c0 + lane < Sk && delta >= 0 && delta < window;
      const float sv = vis ? s[rr] * p.scale : NEG_INF;
      const float m_new = fmaxf(m[rr], warp_max(sv));
      const float pv = vis ? expf(sv - m_new) : 0.0f;
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + warp_sum(pv);
      m[rr] = m_new;
      ps[r][lane] = pv;
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
    float* orow = static_cast<float*>(p.out) + b * p.os.b + h * p.os.h + r * p.os.s;
#pragma unroll
    for (int j = 0; j < DV; ++j) {
      const int d = lane + 32 * j;
      if (d < D) orow[d] = acc[rr][j] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TM = 2;     // m-tiles of 16 rows per warp
constexpr int MQ = 256;   // rows per block: 8 warps x 32
constexpr int MK = 64;    // keys per tile
constexpr int MT = 256;   // threads
constexpr int SKIP = 0, PARTIAL = 1, FULL = 2;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct MmaSmem {
  static constexpr int STRIDE = D * 2 + 16;   // bytes per row: ldmatrix's 8
                                              // rows fall in 8 bank groups
  static constexpr int Q_BYTES = MQ * STRIDE;
  static constexpr int KV_BYTES = MK * STRIDE;
  static constexpr int STAGE = 2 * KV_BYTES + MK * 4;   // K, V, kv_pos
  static constexpr int STAGES = 3;
  static constexpr int TOTAL = Q_BYTES + STAGES * STAGE;
};

// min and max kv_pos of each tile of MK keys
__global__ void key_tile_bounds(const int* __restrict__ kpos, int Sk,
                                int* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j * MK >= Sk) return;
  int mn = kpos[j * MK], mx = mn;
  for (int c = j * MK + 1; c < min(Sk, (j + 1) * MK); ++c) {
    mn = min(mn, kpos[c]);
    mx = max(mx, kpos[c]);
  }
  out[2 * j] = mn;
  out[2 * j + 1] = mx;
}

template <int D>
__global__ void __launch_bounds__(MT) flash_mma_kernel(FlashArgs p) {
  using L = MmaSmem<D>;
  constexpr int PPR = D / 8;   // 16-byte pieces per row
  extern __shared__ __align__(128) char smem[];
  __shared__ long long qb_s[2];
  char* const qsm = smem;
  char* const ring = smem + L::Q_BYTES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int G = p.G, Sk = p.Sk;
  const int R = p.Sq * G;
  const int nqt = (R + MQ - 1) / MQ;
  const int rho0 = (nqt - 1 - blockIdx.x) * MQ;   // heaviest tile first
  const int rows = min(MQ, R - rho0);
  const int b = blockIdx.y / p.KH, kvh = blockIdx.y % p.KH;
  using bf16 = __nv_bfloat16;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.qs.b + kvh * G * p.qs.h;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.vs.b + kvh * p.vs.h;

  // the Q tile (rows past the end read the last row: finite, never stored)
  for (int i = tid; i < MQ * PPR; i += MT) {
    const int r = i / PPR, c = i - r * PPR;
    const int rho = rho0 + min(r, rows - 1);
    const int s = rho / G, gg = rho - s * G;
    tile::cp_async<16>(qsm + r * L::STRIDE + c * 16, qb + s * p.qs.s + gg * p.qs.h + c * 8);
  }
  tile::cp_commit();
  if (warp == 0) {
    long long mn = 0x7fffffffffffffffLL, mx = -mn - 1;
    for (int s = rho0 / G + lane; s <= (rho0 + rows - 1) / G; s += 32) {
      const long long v = p.qpos[s];
      mn = v < mn ? v : mn;
      mx = v > mx ? v : mx;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const long long a = __shfl_xor_sync(0xffffffffu, mn, o);
      const long long c = __shfl_xor_sync(0xffffffffu, mx, o);
      mn = a < mn ? a : mn;
      mx = c > mx ? c : mx;
    }
    if (lane == 0) {
      qb_s[0] = mn;
      qb_s[1] = mx;
    }
  }
  // this thread's rows: g and g + 8 of each of its warp's m-tiles; row
  // (m, h) is 32 warp + 16 m + g + 8 h of the block
  long long qp_r[TM][2];
  bool rv[TM][2];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * TM * warp + 16 * m + g + 8 * h;
      rv[m][h] = r < rows;
      qp_r[m][h] = rv[m][h] ? p.qpos[(rho0 + r) / G] : 0;
    }
  tile::cp_wait<0>();
  __syncthreads();
  const long long qmin = qb_s[0], qmax = qb_s[1];
  const bool ragged_rows = rows < MQ;
  const int r_w = 16 * TM * warp;   // the warp's first row
  const bool active = r_w < rows;

  const int nkt = (Sk + MK - 1) / MK;
  const long long window = p.window;
  auto cls = [&](int j) -> int {   // kernel.py::tile_class
    const long long kmin = p.kt_bounds[2 * j], kmax = p.kt_bounds[2 * j + 1];
    if (qmax - kmin < 0 || qmin - kmax >= window) return SKIP;
    const bool ragged = ragged_rows || (j + 1) * MK > Sk;
    if (!ragged && qmin - kmax >= 0 && qmax - kmin < window) return FULL;
    return PARTIAL;
  };
  auto next = [&](int j) {
    while (j < nkt && cls(j) == SKIP) ++j;
    return j;
  };
  auto load = [&](int j, char* st) {
    const int c0 = j * MK;
    for (int i = tid; i < MK * PPR; i += MT) {
      const int r = i / PPR, c = i - r * PPR;
      const int key = min(c0 + r, Sk - 1);
      tile::cp_async<16>(st + r * L::STRIDE + c * 16, kb + key * p.ks.s + c * 8);
      tile::cp_async<16>(st + L::KV_BYTES + r * L::STRIDE + c * 16,
                         vb + key * p.vs.s + c * 8);
    }
    if (tid < MK)
      tile::cp_async<4>(st + 2 * L::KV_BYTES + tid * 4, p.kpos + min(c0 + tid, Sk - 1));
  };

  float o[TM][D / 8][4];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[m][j][0] = o[m][j][1] = o[m][j][2] = o[m][j][3] = 0.0f;
  float mrow[TM][2], l[TM][2];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    mrow[m][0] = mrow[m][1] = NEG_INF;
    l[m][0] = l[m][1] = 0.0f;
  }
  const float sl2 = p.scale * LOG2E;

  // a ring of 3 tiles: tile n + 2 is copied into the buffer tile n - 1
  // used, once every warp has passed the barrier that follows its work on
  // n - 1, so one barrier a tile suffices
  int cur = next(0), nx1 = cur < nkt ? next(cur + 1) : nkt, buf = 0;
  if (cur < nkt) load(cur, ring);
  tile::cp_commit();
  if (nx1 < nkt) load(nx1, ring + L::STAGE);
  tile::cp_commit();
  while (cur < nkt) {
    const int nx2 = nx1 < nkt ? next(nx1 + 1) : nkt;
    tile::cp_wait<1>();
    __syncthreads();
    const int b2 = buf >= 1 ? buf - 1 : L::STAGES - 1;
    if (nx2 < nkt) load(nx2, ring + b2 * L::STAGE);
    tile::cp_commit();
    const char* st = ring + buf * L::STAGE;
    // one key tile; MASKED: a partial tile, masked per element
    auto tile_step = [&](auto masked_tag) {
      constexpr bool MASKED = decltype(masked_tag)::value;
      // S = Q K^T: each K fragment serves both m-tiles
      float s[TM][MK / 8][4];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int j = 0; j < MK / 8; ++j) s[m][j][0] = s[m][j][1] = s[m][j][2] = s[m][j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[TM][4];
#pragma unroll
        for (int m = 0; m < TM; ++m)
          tile::ldmatrix_x4(qa[m], qsm + (r_w + 16 * m + (lane & 15)) * L::STRIDE +
                                       (16 * kk + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int np = 0; np < MK / 16; ++np) {
          uint32_t kf[4];
          tile::ldmatrix_x4(kf, st + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * L::STRIDE +
                                    (16 * kk + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
          for (int m = 0; m < TM; ++m) {
            tile::mma_bf16_nv(s[m][2 * np], qa[m], kf[0], kf[1]);
            tile::mma_bf16_nv(s[m][2 * np + 1], qa[m], kf[2], kf[3]);
          }
        }
      }
      // element e of key n-tile j: row g + 8 (e >> 1), key 8j + 2t + (e & 1)
      uint32_t vis[TM] = {0xffffffffu, 0xffffffffu};   // bit 4j + e
      if constexpr (MASKED) {
        const int c0 = cur * MK;
        const int* kps = reinterpret_cast<const int*>(st + 2 * L::KV_BYTES);
#pragma unroll
        for (int j = 0; j < MK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 8 * j + 2 * t + (e & 1), h = e >> 1;
            const long long kp = kps[key];
            const bool key_in = c0 + key < Sk;
#pragma unroll
            for (int m = 0; m < TM; ++m) {
              const long long d = qp_r[m][h] - kp;
              if (!(rv[m][h] && key_in && d >= 0 && d < window))
                vis[m] &= ~(1u << (4 * j + e));
            }
          }
      }
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        auto seen = [&](int j, int e) { return !MASKED || ((vis[m] >> (4 * j + e)) & 1u); };
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < MK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = seen(j, e) ? s[m][j][e] * sl2 : NEG_INF;
            s[m][j][e] = v;
            mx[e >> 1] = fmaxf(mx[e >> 1], v);
          }
        float corr[2], lsum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_new = fmaxf(mrow[m][h], mx[h]);
          corr[h] = exp2_approx(mrow[m][h] - m_new);
          mrow[m][h] = m_new;
        }
#pragma unroll
        for (int j = 0; j < MK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pv = seen(j, e) ? exp2_approx(s[m][j][e] - mrow[m][e >> 1]) : 0.0f;
            s[m][j][e] = pv;
            lsum[e >> 1] += pv;
          }
        // this thread's columns; summed over the quad at the flush
        l[m][0] = l[m][0] * corr[0] + lsum[0];
        l[m][1] = l[m][1] * corr[1] + lsum[1];
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[m][j][0] *= corr[0];
          o[m][j][1] *= corr[0];
          o[m][j][2] *= corr[1];
          o[m][j][3] *= corr[1];
        }
      }
      // O += P V: P from the S fragments, rounded to bf16; each V fragment
      // serves both m-tiles
#pragma unroll
      for (int kk = 0; kk < MK / 16; ++kk) {
        uint32_t a[TM][4];
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          a[m][0] = tile::pack_bf16(s[m][2 * kk][0], s[m][2 * kk][1]);
          a[m][1] = tile::pack_bf16(s[m][2 * kk][2], s[m][2 * kk][3]);
          a[m][2] = tile::pack_bf16(s[m][2 * kk + 1][0], s[m][2 * kk + 1][1]);
          a[m][3] = tile::pack_bf16(s[m][2 * kk + 1][2], s[m][2 * kk + 1][3]);
        }
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t vf[4];
          tile::ldmatrix_x4_trans(vf, st + L::KV_BYTES + (16 * kk + (lane & 15)) * L::STRIDE +
                                          (16 * np + (lane >> 4) * 8) * 2);
#pragma unroll
          for (int m = 0; m < TM; ++m) {
            tile::mma_bf16_nv(o[m][2 * np], a[m], vf[0], vf[1]);
            tile::mma_bf16_nv(o[m][2 * np + 1], a[m], vf[2], vf[3]);
          }
        }
      }
    };
    if (active) {
      if (cls(cur) == PARTIAL) tile_step(std::true_type{});
      else tile_step(std::false_type{});
    }
    cur = nx1;
    nx1 = nx2;
    buf = buf + 1 == L::STAGES ? 0 : buf + 1;
  }
  tile::cp_wait<0>();

#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lh = l[m][h];
      lh += __shfl_xor_sync(0xffffffffu, lh, 1);
      lh += __shfl_xor_sync(0xffffffffu, lh, 2);
      if (!rv[m][h]) continue;
      const int rho = rho0 + r_w + 16 * m + g + 8 * h, s = rho / G, gg = rho - s * G;
      bf16* orow = static_cast<bf16*>(p.out) + b * p.os.b + s * p.os.s +
                   (kvh * G + gg) * p.os.h;
      const float den = fmaxf(lh, 1e-20f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
            __floats2bfloat162_rn(o[m][j][2 * h] / den, o[m][j][2 * h + 1] / den);
    }
}

template <int D>
cudaError_t launch_d(const FlashArgs& p, bool mma, cudaStream_t stream) {
  if (!mma) {
    dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
    flash_fma_kernel<D><<<grid, THREADS, 0, stream>>>(p);
    return cudaGetLastError();
  }
  const int nkt = (p.Sk + MK - 1) / MK;
  key_tile_bounds<<<(nkt + 127) / 128, 128, 0, stream>>>(
      p.kpos, p.Sk, const_cast<int*>(p.kt_bounds));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kern = flash_mma_kernel<D>;
  err = tile::allow_smem(kern, MmaSmem<D>::TOTAL);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Sq * p.G + MQ - 1) / MQ, p.B * p.KH);
  kern<<<grid, MT, MmaSmem<D>::TOTAL, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q and out (B, Sq, H, D), k and v (B, Sk, KH, D) as strided views (strides
// in elements; the last axis contiguous), all in dtype (0 fp32, 1 bf16);
// q_pos (Sq,) and kv_pos (Sk,) int32; D in {16, 32, 64, 128}; scale =
// D^-0.5 rounded to fp32 by the caller, as the TPU kernel's Python float
// is. variant 1 = tensor cores (bf16; every stride a multiple of 8 and
// every base 16-byte aligned), 0 = fp32 FMAs. kt_bounds: int32 scratch of
// 2 * ceil(Sk / 64) for the tensor-core variant.
extern "C" int flash_attn_launch(
    const void* q, const void* k, const void* v, const int* qpos,
    const int* kpos, void* out, int* kt_bounds, int B, int H, int KH, int Sq,
    int Sk, int D, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, int window, float scale,
    int dtype, int variant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KH < 1 || H % KH || Sk < 1 || (variant == 1) != (dtype == 1) ||
      (variant == 1 && kt_bounds == nullptr) || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs p{q, k, v, out, qpos, kpos, kt_bounds,
              {qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh}, {osb, oss, osh},
              B, H, KH, H / KH, Sq, Sk, window, scale};
  const bool mma = variant == 1;
  cudaError_t err;
  switch (D) {
    case 16: err = launch_d<16>(p, mma, st); break;
    case 32: err = launch_d<32>(p, mma, st); break;
    case 64: err = launch_d<64>(p, mma, st); break;
    case 128: err = launch_d<128>(p, mma, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
