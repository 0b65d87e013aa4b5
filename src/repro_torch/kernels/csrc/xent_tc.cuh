// The tile mainloop of the fused cross-entropy's tensor-core kernels
// (fused_xent.cu's forward, fused_xent_bwd.cu's dlogits and gradient
// products).  A block of 288 threads computes one or more BM x BN float32
// tiles C = A B over K, A and B bf16:
// - warp 8 is the producer: its lane 0 loads every BK-deep stage of A and B
//   by TMA into an NS-stage ring in shared memory (128-byte swizzle),
//   signalled by mbarriers (full per stage, expecting the stage's bytes;
//   empty per stage, one arrival per consumer warp).  It runs ahead across
//   tiles: while the consumers finish a tile (its epilogue), the next
//   tile's first stages are already loading;
// - threads 0-255 are two consumer warpgroups of 64 rows each, which take
//   every stage with one wgmma.m64n256k16 per k16 slice (the whole tile
//   width in one instruction: 10 KB of A and B read from shared memory for
//   2^19 flop; an m64n64 instruction reads 4 KB for 2^17, all that the
//   shared-memory port delivers, and keeps the tensor cores waiting) into
//   float32 accumulators in registers, keeping one stage's products in
//   flight while the next is issued (wait_group 1) and releasing a stage
//   once its products are done;
// - a stage holds NA tiles of A (NA = 2: dh's hi and lo, both against the
//   stage's one tile of W, so W is loaded once for both products) and one
//   of B;
// - A is always an [M, K] row-major tensor read K-major, one box of
//   BK x BM per stage.  B is either [N, K] row-major read K-major
//   (B_KMAJOR, one box of BK x BN) or [K, N] row-major read MN-major
//   through the transpose bit (four boxes of 64 x BK), so neither operand
//   is ever transposed in device memory;
// - every tensor map is [rows, cols] with a row pitch of its own (a
//   multiple of 8 elements, at least cols: W [d, V] may sit in a
//   [d, ceil8(V)] buffer), and rows, columns and depth past the extents
//   load as zeros (TMA's out-of-bounds fill; a pitch's pad columns are
//   never read), except an MN-major box that lies wholly past N, which is
//   not loaded: it feeds only output columns >= N, which every kernel
//   masks or does not store.
// A consumer thread (warpgroup wg, warp w, lane l) holds rows
// m0 + 64 wg + 16 w + l / 4 (+ 8) of the tile: register 4n + 2i + e is row
// r0 + 8i, column 8 n + 2 (l % 4) + e, for n in [0, BN / 8).
#pragma once

#include <stdio.h>

#include "hopper_tc.cuh"

namespace xtc {

using namespace tc;

constexpr int BM = 128;         // rows per tile: two consumer warpgroups
constexpr int BN = 256;         // columns per tile: one m64n256 wgmma
constexpr int BK = 64;          // depth of one stage: one 128-byte row
constexpr int THREADS = 288;    // 2 consumer warpgroups + 1 producer warp
constexpr int ACC = BN / 2;     // accumulator registers of a consumer thread
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BK * BN * 2;
constexpr int B_BOX_BYTES = BK * 64 * 2;   // one MN-major box of B

// NS full and NS empty mbarriers in the first KB, then NS stages of NA A
// tiles and one B tile, then ``epi`` bytes of epilogue staging (a kernel's
// own); 1 KB of room to align the base (the swizzle atom is 8 rows of 128
// bytes)
template <int NA, int NS>
struct Ring {
  static_assert(16 * NS <= 1024, "the mbarriers take the first KB");
  static constexpr int STAGE = NA * A_BYTES + B_BYTES;
  static constexpr int EPI_OFF = 1024 + NS * STAGE;
  static constexpr int alloc(int epi) { return EPI_OFF + epi + 1024; }
};

__device__ __forceinline__ uint32_t ring_base(const uint8_t* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

template <int NA, int NS>
__device__ __forceinline__ uint32_t full_bar(uint32_t base, int s) {
  return base + 8 * s;
}

template <int NA, int NS>
__device__ __forceinline__ uint32_t empty_bar(uint32_t base, int s) {
  return base + 8 * (NS + s);
}

template <int NA, int NS>
__device__ __forceinline__ uint32_t stage_addr(uint32_t base, int s) {
  return base + 1024 + s * Ring<NA, NS>::STAGE;
}

// every thread of the block must call it
template <int NA, int NS>
__device__ __forceinline__ void ring_init(uint32_t base) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_bar<NA, NS>(base, s), 1);
      mbar_init(empty_bar<NA, NS>(base, s), 8);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

#define XTC_D8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A . B over one k16 slice, 64 x 256: A K-major in shared memory, B
// K-major (TB = 0) or MN-major (TB = 1, imm-trans-b) in shared memory;
// scale_d = 0 overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[ACC], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : XTC_D8(0), XTC_D8(8), XTC_D8(16), XTC_D8(24), XTC_D8(32),
        XTC_D8(40), XTC_D8(48), XTC_D8(56), XTC_D8(64), XTC_D8(72),
        XTC_D8(80), XTC_D8(88), XTC_D8(96), XTC_D8(104), XTC_D8(112),
        XTC_D8(120)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

#undef XTC_D8

// Producer (one thread): stages k_first .. k_first + n_k - 1 of tile
// (m0, n0), ring slots counted on from ``it``; a2map is the second A of an
// NA = 2 ring (unused otherwise).
template <bool B_KMAJOR, int NA, int NS>
__device__ __forceinline__ void produce(uint32_t base, const CUtensorMap* amap,
                                        const CUtensorMap* a2map,
                                        const CUtensorMap* bmap, int m0,
                                        int n0, int N, int k_first, int n_k,
                                        int& it) {
  // MN-major boxes of 64 columns that hold a column < N
  const int boxes = B_KMAJOR ? 1 : min(BN / 64, (N - n0 + 63) / 64);
  const uint32_t bytes =
      NA * A_BYTES + (B_KMAJOR ? B_BYTES : boxes * B_BOX_BYTES);
  for (int ks = 0; ks < n_k; ++ks, ++it) {
    const int s = it % NS;
    const uint32_t sA = stage_addr<NA, NS>(base, s);
    const uint32_t sB = sA + NA * A_BYTES;
    const uint32_t full = full_bar<NA, NS>(base, s);
    mbar_wait(empty_bar<NA, NS>(base, s), ((it / NS) & 1) ^ 1);
    mbar_expect_tx(full, bytes);
    const int k0 = (k_first + ks) * BK;
    tma_load_2d(sA, amap, full, k0, m0);
    if (NA == 2) tma_load_2d(sA + A_BYTES, a2map, full, k0, m0);
    if (B_KMAJOR) {
      tma_load_2d(sB, bmap, full, k0, n0);
    } else {
      for (int q = 0; q < boxes; ++q)
        tma_load_2d(sB + q * B_BOX_BYTES, bmap, full, n0 + 64 * q, k0);
    }
  }
}

// Consumer warpgroup ``wg``: acc (+)= its 64 rows of A (the sum of both A
// tiles' products with NA = 2) times B over the n_k stages (``accumulate``
// false overwrites acc), ring slots counted on from ``it`` in step with the
// producer.
template <bool B_KMAJOR, int NA, int NS>
__device__ __forceinline__ void consume(uint32_t base, float (&acc)[ACC],
                                        int wg, int lane, int n_k,
                                        bool accumulate, int& it) {
  for (int ks = 0; ks < n_k; ++ks, ++it) {
    const int s = it % NS;
    const uint32_t sA = stage_addr<NA, NS>(base, s) + wg * 64 * 128;
    const uint32_t sB = stage_addr<NA, NS>(base, s) + NA * A_BYTES;
    mbar_wait(full_bar<NA, NS>(base, s), (it / NS) & 1);
    reg_fence(acc);
    wg_fence();
#pragma unroll
    for (int kin = 0; kin < BK / 16; ++kin) {
      const uint64_t db =
          B_KMAJOR ? make_desc(sB + kin * 32, 16, 1024)
                   : make_desc(sB + kin * 16 * 128, B_BOX_BYTES, 1024);
#pragma unroll
      for (int a = 0; a < NA; ++a)
        wgmma_n256<B_KMAJOR ? 0 : 1>(
            acc, make_desc(sA + a * A_BYTES + kin * 32, 16, 1024), db,
            accumulate || ks > 0 || kin > 0 || a > 0);
    }
    wg_commit();
    reg_fence(acc);
    wg_wait1();                 // the previous stage's products are done
    if (ks > 0 && lane == 0)
      mbar_arrive(empty_bar<NA, NS>(base, (it - 1) % NS));
  }
  wg_wait0();
  reg_fence(acc);
  if (n_k > 0 && lane == 0) mbar_arrive(empty_bar<NA, NS>(base, (it - 1) % NS));
}

// -- the epilogue's TMA stores ----------------------------------------------
// A tile of bf16 leaves through shared memory: the consumers write it into
// boxes of 128 rows x 64 columns laid out as the 128-byte swizzle lays them
// (the 16-byte unit u of row r at unit u ^ (r % 8): a warp's eight rows land
// on distinct banks), then one thread stores the boxes by TMA, which clips
// rows and columns past the tensor's extents, and goes on: the store drains
// while the next tile's products run.

constexpr int EPI_BOX_BYTES = BM * 64 * 2;    // 16 KB

// byte offset of (row r, column c) in a swizzled box, c in [0, 64)
__device__ __forceinline__ uint32_t box_offset(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

// the consumers' generic-proxy writes of shared memory, visible to TMA
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 256 consumer threads (named barrier 1; the producer warp is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%1, %2}], [%3];\n"
      :: "l"((uint64_t)map), "r"(col), "r"(row), "r"(src)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void zero(float (&acc)[ACC]) {
#pragma unroll
  for (int x = 0; x < ACC; ++x) acc[x] = 0.f;
}

// TMA map of a [rows, cols] bf16 tensor whose rows lie ``pitch`` elements
// apart (pitch % 8 == 0 and >= cols, so rows are 16-byte aligned), read in
// boxes of 64 columns x box_rows rows with the 128-byte swizzle; elements
// past either extent, a pitch's pad columns among them, load as zeros.
inline int make_map_2d(CUtensorMap* map, const void* ptr, int rows, int cols,
                       int pitch, int box_rows) {
  EncodeTiled enc = encoder();
  if (!enc) return ENCODE_ERROR;
  const cuuint64_t dims[2] = {(cuuint64_t)cols,
                              (cuuint64_t)(rows > 1 ? rows : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * 2};
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

// the number of SMs of the current device (0 if it cannot be read)
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
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
