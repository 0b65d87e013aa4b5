// The tile mainloop of the fused cross-entropy's tensor-core kernels
// (fused_xent.cu's forward, fused_xent_bwd.cu's dlogits and gradient
// products).  A block of 288 threads computes one or more BM x BN float32
// tiles C = A B over K, A and B bf16:
// - warp 8 is the producer: its lane 0 loads every BK-deep stage of A and B
//   by TMA into an NS-stage ring in shared memory (128-byte swizzle),
//   signalled by mbarriers (full per stage, expecting the stage's bytes;
//   empty per stage, one arrival per consumer warp);
// - threads 0-255 are two consumer warpgroups of 64 rows each, which take
//   every stage with wgmma.m64n64k16 (two n64 halves per k16 slice) into
//   float32 accumulators in registers, keeping one stage's products in
//   flight while the next is issued (wait_group 1) and releasing a stage
//   once its products are done;
// - A is always an [M, K] row-major tensor read K-major, one box of
//   BK x BM per stage.  B is either [N, K] row-major read K-major
//   (B_KMAJOR, one box of BK x BN, the flash forward's K) or [K, N]
//   row-major read MN-major through the transpose bit (two boxes of
//   64 x BK, the flash forward's V), so neither operand is ever transposed
//   in device memory;
// - rows, columns and depth past the tensors' extents load as zeros (TMA's
//   out-of-bounds fill), except a second MN-major box that lies wholly past
//   N, which is not loaded: it feeds only output columns >= N, which every
//   kernel masks or does not store.
// A consumer thread (warpgroup wg, warp w, lane l) holds rows
// m0 + 64 wg + 16 w + l / 4 (+ 8) of the tile: in accumulator half j,
// registers 4n + 2i + e are row r0 + 8i, column 64 j + 8 n + 2 (l % 4) + e.
#pragma once

#include <stdio.h>

#include "hopper_tc.cuh"

namespace xtc {

using namespace tc;

constexpr int BM = 128;         // rows per tile: two consumer warpgroups
constexpr int BN = 128;         // columns per tile: two n64 halves
constexpr int BK = 64;          // depth of one stage: one 128-byte row
constexpr int THREADS = 288;    // 2 consumer warpgroups + 1 producer warp
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BK * BN * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;

// stages, then NS full and NS empty mbarriers; 1 KB of room to align the
// base (the swizzle atom is 8 rows of 128 bytes)
template <int NS>
struct Ring {
  static constexpr int BAR_OFF = NS * STAGE_BYTES;
  static constexpr int ALLOC = BAR_OFF + 16 * NS + 1024;
};

__device__ __forceinline__ uint32_t ring_base(const uint8_t* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

template <int NS>
__device__ __forceinline__ uint32_t full_bar(uint32_t base, int s) {
  return base + Ring<NS>::BAR_OFF + 8 * s;
}

template <int NS>
__device__ __forceinline__ uint32_t empty_bar(uint32_t base, int s) {
  return base + Ring<NS>::BAR_OFF + 8 * (NS + s);
}

// every thread of the block must call it
template <int NS>
__device__ __forceinline__ void ring_init(uint32_t base) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_bar<NS>(base, s), 1);
      mbar_init(empty_bar<NS>(base, s), 8);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Producer (one thread): the n_k stages of tile (m0, n0) over K, ring
// slots counted on from ``it``.
template <bool B_KMAJOR, int NS>
__device__ __forceinline__ void produce(uint32_t base, const CUtensorMap* amap,
                                        const CUtensorMap* bmap, int m0,
                                        int n0, int N, int n_k, int& it) {
  const bool second = B_KMAJOR || n0 + 64 < N;
  const uint32_t bytes = A_BYTES + (second ? B_BYTES : B_BYTES / 2);
  for (int ks = 0; ks < n_k; ++ks, ++it) {
    const int s = it % NS;
    const uint32_t sA = base + s * STAGE_BYTES, sB = sA + A_BYTES;
    const uint32_t full = full_bar<NS>(base, s);
    mbar_wait(empty_bar<NS>(base, s), ((it / NS) & 1) ^ 1);
    mbar_expect_tx(full, bytes);
    const int k0 = ks * BK;
    tma_load_2d(sA, amap, full, k0, m0);
    if (B_KMAJOR) {
      tma_load_2d(sB, bmap, full, k0, n0);
    } else {
      tma_load_2d(sB, bmap, full, n0, k0);
      if (second) tma_load_2d(sB + BK * 128, bmap, full, n0 + 64, k0);
    }
  }
}

// Consumer warpgroup ``wg``: acc (+)= its 64 rows of A times B over the
// n_k stages (``accumulate`` false overwrites acc), ring slots counted on
// from ``it`` in step with the producer.
template <bool B_KMAJOR, int NS>
__device__ __forceinline__ void consume(uint32_t base, float (&acc)[2][32],
                                        int wg, int lane, int n_k,
                                        bool accumulate, int& it) {
  for (int ks = 0; ks < n_k; ++ks, ++it) {
    const int s = it % NS;
    const uint32_t sA = base + s * STAGE_BYTES + wg * 64 * 128;
    const uint32_t sB = base + s * STAGE_BYTES + A_BYTES;
    mbar_wait(full_bar<NS>(base, s), (it / NS) & 1);
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    wg_fence();
#pragma unroll
    for (int kin = 0; kin < BK / 16; ++kin) {
      const uint64_t da = make_desc(sA + kin * 32, 16, 1024);
      const int scale = accumulate || ks > 0 || kin > 0;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (B_KMAJOR)
          wgmma_ss(acc[j], da, make_desc(sB + j * 64 * 128 + kin * 32, 16,
                                         1024), scale);
        else
          wgmma_ss_tb(acc[j], da, make_desc(sB + j * BK * 128 +
                                            kin * 16 * 128, BK * 128, 1024),
                      scale);
      }
    }
    wg_commit();
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    wg_wait1();                 // the previous stage's products are done
    if (ks > 0 && lane == 0) mbar_arrive(empty_bar<NS>(base, (it - 1) % NS));
  }
  wg_wait0();
  reg_fence(acc[0]);
  reg_fence(acc[1]);
  if (n_k > 0 && lane == 0) mbar_arrive(empty_bar<NS>(base, (it - 1) % NS));
}

// TMA map of a contiguous [rows, cols] bf16 tensor (cols % 8 == 0, so
// rows are 16-byte aligned), read in boxes of 64 columns x box_rows rows
// with the 128-byte swizzle; elements past either extent load as zeros.
inline int make_map_2d(CUtensorMap* map, const void* ptr, int rows, int cols,
                       int box_rows) {
  EncodeTiled enc = encoder();
  if (!enc) return ENCODE_ERROR;
  const cuuint64_t dims[2] = {(cuuint64_t)cols,
                              (cuuint64_t)(rows > 1 ? rows : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
}

inline const char* error_string(int code) {
  if (code >= ENCODE_ERROR) {
    static char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - ENCODE_ERROR);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)code);
}

}  // namespace xtc
