// A ring of shared-memory stages filled by the Tensor Memory Accelerator
// (TMA) for Hopper (sm_90a): tensor maps over row-major matrices with a
// 128-byte swizzle, the mbarrier pair of each stage, and the producer /
// consumer walk over the ring. First used by sasp_gemm_masked.cu.
//
// A stage is filled by one thread of a producer warp: it waits on the
// stage's `empty` barrier, announces the bytes to come on its `full`
// barrier (arrive.expect_tx) and issues the TMA loads, which complete
// the transaction on `full`. Consumer warps wait on `full`, compute, and
// each warp arrives once on `empty`. Ring position and phase advance the
// same way on both sides (Ring::next), so the two walk the same sequence
// of stages without a block-wide barrier.
//
// Host side: cuTensorMapEncodeTiled is reached through the runtime's
// cudaGetDriverEntryPoint, so the kernels link against no driver library
// (build.py passes no -lcuda). Encoding costs host time, so encoded maps
// are kept in a small cache keyed by (pointer, shape, row pitch, box).
//
// The 128-byte swizzle: TMA writes row r of a box (128 bytes wide) with
// its 16-byte chunk c at chunk c ^ (r % 8), the pattern taken from the
// shared-memory address bits, so a stage must start on a 1024-byte
// boundary; swz128 gives the byte offset of (row, chunk) in such a tile.
// Eight rows read at one chunk (ldmatrix) then fall in eight different
// bank groups.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

constexpr int SWIZZLE_BYTES = 128;   // the widest box row a 128-byte swizzle takes
constexpr int STAGE_ALIGN = 1024;    // the swizzle pattern's period: 8 rows of 128 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row `row` of a swizzled tile
// with 128-byte rows
__device__ __forceinline__ int swz128(int row, int chunk) {
  return row * SWIZZLE_BYTES + ((chunk ^ (row & 7)) << 4);
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// ---------------------------------------------------------------------------
// loads
// ---------------------------------------------------------------------------

// Box of `map` at (inner, outer) element coordinates into dst (1024-byte
// aligned under the 128-byte swizzle); completes on bar. Coordinates past
// the tensor's edge read zeros.
__device__ __forceinline__ void load_2d(void* dst, const CUtensorMap* map, int inner,
                                        int outer, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(inner), "r"(outer)
      : "memory");
}

// ---------------------------------------------------------------------------
// the ring's position
// ---------------------------------------------------------------------------

// Stage `slot` of `stages`, and the parity of the pass over the ring. The
// producer waits on empty[slot] with parity ^ 1 (the first pass finds every
// stage free), consumers on full[slot] with parity.
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows x cols) bf16 matrix, rows `pitch` bytes apart, read in
// boxes of (box_rows x box_cols) with the 128-byte swizzle
// (box_cols * 2 <= 128). Maps are cached by all of these.
struct MapKey {
  const void* ptr;
  uint64_t rows, cols, pitch;
  uint32_t box_rows, box_cols;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols && pitch == o.pitch &&
           box_rows == o.box_rows && box_cols == o.box_cols;
  }
};

inline cudaError_t bf16_map(CUtensorMap* out, const MapKey& k) {
  constexpr int SLOTS = 64;
  static MapKey keys[SLOTS];
  static CUtensorMap maps[SLOTS];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i)
    if (keys[i] == k) {
      *out = maps[i];
      return cudaSuccess;
    }
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (k.box_cols * 2 > SWIZZLE_BYTES || k.box_rows > 256 || k.pitch % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k.ptr) % 16 != 0)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {k.cols, k.rows};
  const cuuint64_t strides[1] = {k.pitch};
  const cuuint32_t box[2] = {k.box_cols, k.box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUtensorMap m;
  const CUresult r = enc(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(k.ptr),
                         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const int i = used < SLOTS ? used++ : next;
  next = (i + 1) % SLOTS;
  keys[i] = k;
  maps[i] = m;
  *out = m;
  return cudaSuccess;
}

}  // namespace tma
