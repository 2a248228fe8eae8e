// A tensor-core GEMM block for Hopper (sm_90a): C[M, N] = A[M, K] W^T with
// a fused epilogue, where A is a row-major bf16 activation and W a torch
// Linear weight [N, K] (bf16).  Both operands are K-major, the layout
// `wgmma` takes without a transpose.  Either may instead be MN-major
// (kAMN, kBMN): A stored [K, M] (a weight gradient's dy^T), B stored
// [K, N] (a weight used from its "out" side, x of a weight gradient); TMA
// loads them in boxes of 64 k rows x 64 M or N columns and `wgmma` reads
// them with its transpose bits.
//
// A CTA is three warpgroups: warpgroup 0 is the producer (one thread starts
// TMA loads; `setmaxnreg` gives its registers away), warpgroups 1 and 2 are
// the consumers, each owning 64 rows of a 128 x BN output tile.  A and W
// tiles come in through TMA (`cp.async.bulk.tensor`, 128-byte swizzle) as
// 64-deep k slices into a ring of stages; each stage has a full and an
// empty `mbarrier`.  The consumers run `wgmma.mma_async` m64nBNk16 (bf16
// in, f32 out) on the stage that has landed, keep one group in flight and
// release a stage once the group that read it has retired.  The
// accumulators stay in registers until the epilogue (bias, scale, residual,
// quick-GELU) works on them; it stages each 128-byte-wide chunk of columns
// in shared memory and stores it with TMA, which clips the rows and columns
// past M and N (TMA also fills rows and k past the ends of A and W with
// zeros).
//
// CTAs run in clusters of two on row tiles m and m + 1 of the same column
// tile: each CTA loads its own A tile and half of the W tile and multicasts
// that half into both CTAs' shared memory, so a CTA reads (128 + BN / 2) x
// 128 bytes from L2 a 64-deep k step instead of (128 + BN) x 128.  A stage
// is refilled once the consumers of both CTAs have released it (the empty
// barriers count both).  Clusters are persistent: cluster c walks tile
// pairs c, c + clusters, ... (columns fastest, so the clusters that run at
// once share A's row blocks), and the producer runs ahead into the next
// tile while the consumers finish the last one's epilogue.
//
// What bounds it on the H100 (PERF.md §5): the products alone (the probe
// epilogue) run 720 to 810 TFLOP/s at K3's and K4's shapes (Wo, with two
// tiles a cluster, 590 to 670); the epilogue, which both consumer
// warpgroups run at once while the tensor cores wait, takes the rest (the
// card's tensor-core peak is 989).
//
// One launch may cover up to three weights of the same shape (K3's q, k
// and v): the column tile picks the weight, its bias and its output.  A
// weight gradient's launch splits K into ranges of ksplit rows: each range
// is a tile pair of its own and writes its f32 partial [M, N] at row
// range * M of the output, which a fixed-order pass sums (kEpiPart).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (no link against libcuda)
#include <dlfcn.h>

#include "cluster.cuh"
#include "common.cuh"

namespace ladiff {
namespace sm90 {

constexpr int kBM = 128;           // rows of an output tile (two warpgroups)
constexpr int kBK = 64;            // k of a stage: one 128-byte bf16 row
constexpr int kGemmThreads = 384;  // producer + two consumer warpgroups
constexpr int kCluster = 2;        // CTAs sharing a W tile (row tiles)
constexpr int kABytes = kBM * kBK * 2;

// Fused epilogues on the accumulator registers (v = acc + bias[col]).
enum Epilogue : int {
  kEpiBias = 0,       // bf16(v * scale) for weight 0, bf16(v) for the rest
  kEpiResidF32 = 1,   // f32(v + resid) with resid bf16 [M, N]
  kEpiGelu = 2,       // bf16(quick_gelu(v))
  kEpiResidBf16 = 3,  // bf16(v + resid) with resid f32 [M, N]
  // a measurement probe: stores nothing but each warp's sum of its
  // accumulators, added into out[0][0], so that the products are timed
  // alone (chip_smoke.py clip_breakdown)
  kEpiProbe = 4,
  kEpiAdd = 5,        // bf16(v + resid) with resid bf16; bias may be null
  // bf16(resid + v * keep) with the keep-mask element row N + col of mask
  // mask_id (the layer's residual dropout), resid bf16
  kEpiAddDrop = 6,
  // bf16(acc), no bias; and delta[row, h] = sum over head h's dh columns of
  // bf16(acc) * resid (resid bf16 [M, N]: ctx); a column tile holds whole
  // heads (N <= BN, or BN a multiple of dh)
  kEpiDctx = 7,
  kEpiPart = 8,       // f32(acc) at output row range * M + row, no bias
};

// The ring's stages by tile width, beside the epilogue's staging buffers
// (two 8 KB buffers of 64 rows x 128 bytes per consumer warpgroup), in the
// 227 KB a CTA may use.
constexpr int kEpiBuf = 64 * 128;
constexpr int kEpiBytes = 2 * 2 * kEpiBuf;
template <int BN>
struct GemmCfg {
  static_assert(BN == 128 || BN == 192 || BN == 256, "BN");
  static constexpr int kStages = BN == 128 ? 6 : 4;
  static constexpr int kBBytes = BN * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // 1024 bytes of slack to align the ring (the 128-byte swizzle repeats
  // every 1024), the ring, the epilogue's buffers, then a full and an
  // empty barrier a stage
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes +
                                  kEpiBytes +
                                  2 * kStages * sizeof(uint64_t);
};

struct GemmArgs {
  int M, N, K;       // rows, columns of each weight, depth
  int mats;          // weights in the launch (1 or 3)
  int tiles_n;       // column tiles of each weight
  int pairs_m;       // pairs of row tiles
  int splits, ksplit;  // K ranges of ksplit rows (1 and K but for kEpiPart)
  float scale;       // kEpiBias: applied to weight 0's outputs
  const bf16* bias[3];
  void* out[3];      // [M, N] each: bf16, or f32 for kEpiResidF32, kEpiPart
  // [M, N]: bf16 (kEpiResidF32, kEpiAdd, kEpiAddDrop, kEpiDctx's ctx) or
  // f32 (kEpiResidBf16)
  const void* resid;
  Dropout drop;      // kEpiAddDrop
  uint32_t mask_id;
  float* delta;      // kEpiDctx: [M, H], head width dh
  int H, dh;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.  A
// wait of more than ~2^34 cycles (seconds) can only be a deadlock: the
// thread traps, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (!t0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 34)) {
      __trap();
    }
  }
}

// Loads the box at (c0 inner, c1 outer) of a 2-D tensor map into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The same into this CTA and its cluster peers in `mask`, at the same
// shared-memory offsets, each CTA's barrier at `bar`'s offset counting the
// bytes that land in it.
__device__ __forceinline__ void tma_load_2d_mc(void* dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int c0, int c1,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask),
      "r"(c0), "r"(c1)
      : "memory");
}

// Stores the box at (c0 inner, c1 outer) of a 2-D tensor map from shared
// memory (rows and columns past the tensor's ends are not written), as one
// bulk group of this thread.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's bulk groups still read shared
// memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Shared-memory writes of this thread made visible to TMA (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A barrier of the 128 threads of one consumer warpgroup (id 1 or 2).
__device__ __forceinline__ void warpgroup_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Arrives on the barrier at `bar`'s offset in CTA `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, int rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                   peer_addr(smem_u32(bar), rank))
               : "memory");
}

// The wgmma descriptor of a K-major operand tile in shared memory written
// by TMA with the 128-byte swizzle: rows of 64 bf16 (128 bytes), 8-row
// groups 1024 bytes apart (stride byte offset), the leading byte offset
// unused for this layout.  Advancing k by 16 moves the start by 32 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// The same for an MN-major operand tile: boxes of 64 k rows x 64 M or N
// elements (128 bytes a row, the 128-byte swizzle), 8-row k groups 1024
// bytes apart (stride byte offset), consecutive 64-element M / N blocks
// kMNBox bytes apart (leading byte offset).  Advancing k by 16 moves the
// start by 16 rows, 2048 bytes.
constexpr int kMNBox = 64 * kBK * 2;
__device__ __forceinline__ uint64_t smem_desc_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(kMNBox >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define LADIFF_F8(d, i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define LADIFF_F32(d, i) \
  LADIFF_F8(d, i), LADIFF_F8(d, i + 8), LADIFF_F8(d, i + 16), \
      LADIFF_F8(d, i + 24)
#define LADIFF_R0_63                                                    \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "        \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "        \
  "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "        \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "        \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "        \
  "%62, %63"
#define LADIFF_R64_95                                                   \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "                \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "        \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define LADIFF_R96_127                                                  \
  ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "    \
  "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "  \
  "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

// d[64 x BN] (+)= A[64 x 16] W[BN x 16]^T from shared memory descriptors;
// scale_d 0 overwrites d; TA / TB 1: A / B MN-major (transposed).  d's
// layout: for each 8-column group j, thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1) in
// d[4 j .. 4 j + 3].
template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (BN == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" LADIFF_R0_63
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : LADIFF_F32(d, 0), LADIFF_F32(d, 32)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (BN == 192) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {" LADIFF_R0_63
            LADIFF_R64_95 "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
        : LADIFF_F32(d, 0), LADIFF_F32(d, 32), LADIFF_F32(d, 64)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" LADIFF_R0_63
            LADIFF_R64_95 LADIFF_R96_127 "}, %128, %129, p, 1, 1, %131, %132;"
        "\n}\n"
        : LADIFF_F32(d, 0), LADIFF_F32(d, 32), LADIFF_F32(d, 64),
          LADIFF_F32(d, 96)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

#undef LADIFF_F8
#undef LADIFF_F32
#undef LADIFF_R0_63
#undef LADIFF_R64_95
#undef LADIFF_R96_127

// quick_gelu(v) = v sigmoid(1.702 v) = v (1 + tanh(0.851 v)) / 2 with the
// hardware's tanh (one MUFU operation, absolute error ~2^-11, well under
// the bf16 rounding of the result): the epilogue of fc1 is bound by the
// special-function unit, which exp and a division would use twice.
__device__ __forceinline__ float quick_gelu_fast(float v) {
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(0.851f * v));
  return v * fmaf(0.5f, t, 0.5f);
}

// The epilogue of one consumer warpgroup: its 64 rows of the tile at
// (m0, n0) of weight `mat`, from the accumulator registers, in chunks of
// 128 bytes of columns (64 bf16 or 32 f32).  A chunk's values go to one of
// the warpgroup's two staging buffers in shared memory (rows of 128 bytes,
// 16-byte units swizzled by row % 8 as TMA's 128-byte swizzle has them, so
// the warp's stores hit 32 banks), and one thread stores the buffer with
// TMA at output row orow while the next chunk is computed: the global
// writes overlap the rest of the epilogue and the next tile's products, and
// TMA clips the rows and columns past M and N.  The bias and residual
// values of a chunk are loaded together (at clamped addresses, without
// branches) before any is used.
template <int BN, int EPI>
__device__ __forceinline__ void gemm_epilogue(const float (&acc)[BN / 2],
                                              const GemmArgs& g,
                                              const CUtensorMap* omap,
                                              unsigned char* bufs, int& seq,
                                              int mat, int m0, int n0,
                                              int orow) {
  constexpr bool kF32 = EPI == kEpiResidF32 || EPI == kEpiPart;
  constexpr bool kResid = EPI == kEpiResidF32 || EPI == kEpiResidBf16 ||
                          EPI == kEpiAdd || EPI == kEpiAddDrop;
  constexpr bool kBias = EPI != kEpiDctx && EPI != kEpiPart;
  constexpr int kCW = kF32 ? 32 : 64;  // columns of a chunk
  constexpr int kJ = kCW / 8;          // column groups of a chunk
  const int t = threadIdx.x & 127, lane = t & 31, q = lane & 3;
  const int r0 = 16 * (t >> 5) + (lane >> 2);  // row in the 64 (+ 8)
  const int col0 = n0 + 2 * q;
  const bool elected = t == 0;
  const int bar = threadIdx.x >> 7;  // named barrier 1 or 2
  const bf16* bias =
      mat == 0 ? g.bias[0] : (mat == 1 ? g.bias[1] : g.bias[2]);
  const bool has_bias = kBias && bias != nullptr;  // kEpiAdd: may be null
  const float sc = (EPI == kEpiBias && mat == 0) ? g.scale : 1.f;
  if (m0 >= g.M) return;  // the odd row tile past M: nothing to store
  if constexpr (EPI == kEpiProbe) {  // rows past M and N hold zeros
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum += acc[i];
    sum = warp_sum(sum);
    if ((threadIdx.x & 31) == 0) atomicAdd(static_cast<float*>(g.out[0]), sum);
    return;
  }
  const int rows[2] = {min(m0 + r0, g.M - 1), min(m0 + r0 + 8, g.M - 1)};
  // kEpiDctx loads ctx as the others load their residual, for delta
  constexpr bool kLoadR = kResid || EPI == kEpiDctx;
  // a 256-wide tile's accumulators leave too few registers to hold a whole
  // chunk's bias and bf16 residual (ptxas spills): those load in two halves
  constexpr int kLoads = (BN == 256 && kLoadR && !kF32) ? 2 : 1;
  constexpr int kJL = kJ / kLoads;
  // kEpiDctx: each row's sum over the current head's columns so far, the
  // column groups left in that head, the head
  float dpart[2] = {0.f, 0.f};
  int dleft = EPI == kEpiDctx ? g.dh / 8 : 0;
  int dhead = EPI == kEpiDctx ? n0 / g.dh : 0;
#pragma unroll
  for (int ch = 0; ch < BN / kCW; ++ch) {
    if (n0 + ch * kCW >= g.N) break;  // the same for the whole warpgroup
    // buffers alternate over the warpgroup's chunks, across tiles too; the
    // store that last read this one (two chunks ago) is done
    unsigned char* buf = bufs + (seq++ & 1) * kEpiBuf;
#pragma unroll
    for (int hl = 0; hl < kLoads; ++hl) {
      float2 b[kJL], r[kJL][2];
#pragma unroll
      for (int jj = 0; jj < kJL; ++jj) {
        const int col =
            min(col0 + 8 * (ch * kJ + hl * kJL + jj), g.N - 2);  // N even
        b[jj] = has_bias ? __bfloat1622float2(__ldg(
                               reinterpret_cast<const __nv_bfloat162*>(
                                   bias + col)))
                         : make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const size_t o = (size_t)rows[i] * g.N + col;
          if constexpr (EPI == kEpiResidBf16)
            r[jj][i] =
                __ldg(reinterpret_cast<const float2*>(g.resid) + o / 2);
          else if constexpr (kLoadR)
            r[jj][i] = __bfloat1622float2(__ldg(
                reinterpret_cast<const __nv_bfloat162*>(g.resid) + o / 2));
        }
      }
      if (hl == 0) {  // the first loads are in flight across the barrier
        if (elected) bulk_wait_read<1>();
        warpgroup_bar(bar);
      }
#pragma unroll
      for (int jj = 0; jj < kJL; ++jj) {
        const int u = hl * kJL + jj;  // the column group in the chunk
        const int j = ch * kJ + u;
        // kEpiAddDrop: the keep-mask words of the quad's two lane pairs'
        // 4-element blocks (element row N + col): the pair's even lane
        // draws row r0's block, the odd lane row r0 + 8's, and each hands
        // the other the two words it needs (one Philox a 4 elements)
        uint32_t kb[2][2];
        if constexpr (EPI == kEpiAddDrop) {
          const int odd = q & 1;
          const uint64_t blk =
              ((uint64_t)(m0 + r0 + 8 * odd) * g.N + n0 + 8 * j) / 4 +
              (q >> 1);
          const uint4 w = philox4x32_10(
              make_uint4(static_cast<uint32_t>(blk),
                         static_cast<uint32_t>(blk >> 32), g.mask_id, 0u),
              g.drop.key0, g.drop.key1);
          const uint32_t s0 = odd ? w.x : w.z, s1 = odd ? w.y : w.w;
          const uint32_t v0 = __shfl_xor_sync(0xffffffffu, s0, 1);
          const uint32_t v1 = __shfl_xor_sync(0xffffffffu, s1, 1);
          const uint32_t o0 = odd ? w.z : w.x, o1 = odd ? w.w : w.y;
          kb[odd][0] = o0;  // own row: r0 (even lane) or r0 + 8 (odd)
          kb[odd][1] = o1;
          kb[odd ^ 1][0] = v0;
          kb[odd ^ 1][1] = v1;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r0 + 8 * i;
          float v0 = acc[4 * j + 2 * i] + b[jj].x;
          float v1 = acc[4 * j + 2 * i + 1] + b[jj].y;
          if constexpr (EPI == kEpiAddDrop) {
            v0 *= kb[i][0] < g.drop.thresh ? g.drop.inv_keep : 0.f;
            v1 *= kb[i][1] < g.drop.thresh ? g.drop.inv_keep : 0.f;
          }
          if constexpr (kResid) {
            v0 += r[jj][i].x;
            v1 += r[jj][i].y;
          }
          if constexpr (EPI == kEpiBias) {
            v0 *= sc;
            v1 *= sc;
          } else if constexpr (EPI == kEpiGelu) {
            v0 = quick_gelu_fast(v0);
            v1 = quick_gelu_fast(v1);
          }
          unsigned char* rp = buf + row * 128;
          if constexpr (kF32) {  // 8 bytes at byte 32 u + 8 q of the row
            const int w = 2 * u + (q >> 1);
            *reinterpret_cast<float2*>(rp + ((w ^ (row & 7)) << 4) +
                                       8 * (q & 1)) = make_float2(v0, v1);
          } else {  // 4 bytes at byte 16 u + 4 q of the row
            const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(rp + ((u ^ (row & 7)) << 4) +
                                               4 * q) = o;
            if constexpr (EPI == kEpiDctx) {  // delta from dctx as stored
              const float2 f = __bfloat1622float2(o);
              dpart[i] += f.x * r[jj][i].x + f.y * r[jj][i].y;
            }
          }
        }
        if constexpr (EPI == kEpiDctx) {
          // the head's last column group (the same point for the whole
          // warp): the quad's sums to delta
          if (--dleft == 0) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float d = quad_sum(dpart[i]);
              const int row = m0 + r0 + 8 * i;
              if (q == 0 && row < g.M)
                g.delta[(size_t)row * g.H + dhead] = d;
              dpart[i] = 0.f;
            }
            ++dhead;
            dleft = g.dh / 8;
          }
        }
      }
    }
    fence_proxy_async();
    warpgroup_bar(bar);
    if (elected) tma_store_2d(omap, buf, n0 + ch * kCW, orow);
  }
}

// Each tile pair p of a launch: column tile nt (weight nt / tiles_n) of
// row tiles 2 pm and 2 pm + 1 over K range s (p = (s pairs_m + pm) mats
// tiles_n + nt: columns fastest).
struct TilePair {
  int mat, m0, n0;
  int k0, nk;  // first k row, 64-deep slices
  int orow;    // the output row of m0
};
template <int BN>
__device__ __forceinline__ TilePair tile_pair(const GemmArgs& g, int p,
                                              int rank) {
  const int per_row = g.mats * g.tiles_n, nt = p % per_row;
  const int pr = p / per_row, pm = pr % g.pairs_m, s = pr / g.pairs_m;
  const int m0 = (pm * kCluster + rank) * kBM, k0 = s * g.ksplit;
  const int kn = min(g.K - k0, g.ksplit);
  return {nt / g.tiles_n, m0, nt % g.tiles_n * BN, k0, (kn + kBK - 1) / kBK,
          s * g.M + m0};
}

template <int BN, int EPI, bool kAMN, bool kBMN>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap tma_a,
                 const __grid_constant__ CUtensorMap tma_w0,
                 const __grid_constant__ CUtensorMap tma_w1,
                 const __grid_constant__ CUtensorMap tma_w2,
                 const __grid_constant__ CUtensorMap tma_o0,
                 const __grid_constant__ CUtensorMap tma_o1,
                 const __grid_constant__ CUtensorMap tma_o2,
                 const GemmArgs g) {
  using Cfg = GemmCfg<BN>;
  constexpr int S = Cfg::kStages;
  constexpr int kHalfB = Cfg::kBBytes / kCluster;  // W rows a CTA loads
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* epi = ring + S * Cfg::kStageBytes;  // 1024-aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + kEpiBytes);
  uint64_t* empty = full + S;
  const int wg = threadIdx.x >> 7, rank = cluster_rank();
  const int pairs = g.pairs_m * g.mats * g.tiles_n * g.splits;
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);  // the producer's arrive (+ the TMA bytes)
      // lane 0 of each consumer warp of both CTAs
      mbar_init(&empty[s], 8 * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the peer's multicasts and arrivals find the barriers initialized
  cluster_sync();

  if (wg == 0) {
    // producer: the ring's stages are free on the first lap (parity 1 of
    // a fresh barrier counts as completed)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int p = cluster; p < pairs; p += clusters) {
        const TilePair t = tile_pair<BN>(g, p, rank);
        const CUtensorMap* wmap =
            t.mat == 0 ? &tma_w0 : (t.mat == 1 ? &tma_w1 : &tma_w2);
        // a row tile (MN-major: a 64-row half) wholly past M loads no A:
        // its outputs are never stored
        const int a_boxes = kAMN ? (t.m0 < g.M) + (t.m0 + 64 < g.M)
                                 : (t.m0 < g.M ? 2 : 0);
        for (int kt = 0; kt < t.nk; ++kt) {
          const int kc = t.k0 + kt * kBK;
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * Cfg::kStageBytes;
          mbar_expect_tx(&full[stage], Cfg::kStageBytes -
                                           (2 - a_boxes) * (kABytes / 2));
          if constexpr (kAMN) {
            for (int h = 0; h < a_boxes; ++h)
              tma_load_2d(st + h * kMNBox, &tma_a, &full[stage],
                          t.m0 + 64 * h, kc);
          } else if (a_boxes) {
            tma_load_2d(st, &tma_a, &full[stage], kc, t.m0);
          }
          if constexpr (kBMN) {  // the CTAs take the 64-column boxes in turn
            for (int b = rank; b < BN / 64; b += kCluster)
              tma_load_2d_mc(st + kABytes + b * kMNBox, wmap, &full[stage],
                             t.n0 + 64 * b, kc, (1 << kCluster) - 1);
          } else {
            tma_load_2d_mc(st + kABytes + rank * kHalfB, wmap, &full[stage],
                           kc, t.n0 + rank * (BN / kCluster),
                           (1 << kCluster) - 1);
          }
          if (++stage == S) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      // every stage released by both CTAs' consumers before this CTA may
      // exit: the peer's last arrivals land in this CTA's barriers
      for (int i = 0; i < S; ++i) {
        mbar_wait(&empty[stage], phase ^ 1);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;  // rows 64 c .. 64 c + 63 of the tile
    const bool signal = (threadIdx.x & 31) == 0;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int stage = 0, seq = 0;
    uint32_t phase = 0;
    auto release = [&](int s) {
      if (signal)
        for (int r = 0; r < kCluster; ++r) mbar_arrive_cluster(&empty[s], r);
    };
    for (int p = cluster; p < pairs; p += clusters) {
      const TilePair t = tile_pair<BN>(g, p, rank);
      int prev = 0;
      for (int kt = 0; kt < t.nk; ++kt) {
        mbar_wait(&full[stage], phase);
        // this warpgroup's 64 rows: 8 KB into the stage in both layouts
        const uint32_t a =
            smem_u32(ring + stage * Cfg::kStageBytes) + c * (kABytes / 2);
        const uint32_t b = smem_u32(ring + stage * Cfg::kStageBytes + kABytes);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_bf16<BN, kAMN, kBMN>(
              acc, kAMN ? smem_desc_mn(a + 2048 * kk) : smem_desc(a + 32 * kk),
              kBMN ? smem_desc_mn(b + 2048 * kk) : smem_desc(b + 32 * kk),
              (kt | kk) != 0);
        wgmma_commit();
        // the group before this one has retired: its stage is free
        wgmma_wait<1>();
        fence_regs(acc);
        if (kt > 0) release(prev);
        prev = stage;
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(prev);
      const CUtensorMap* omap =
          t.mat == 0 ? &tma_o0 : (t.mat == 1 ? &tma_o1 : &tma_o2);
      gemm_epilogue<BN, EPI>(acc, g, omap, epi + c * 2 * kEpiBuf, seq,
                             t.mat, t.m0 + 64 * c, t.n0, t.orow + 64 * c);
    }
    // the last stores have read their buffers before the CTA exits
    if ((threadIdx.x & 127) == 0) bulk_wait_all();
  }
}

// cuTensorMapEncodeTiled from the libcuda.so.1 that the process has loaded
// (the libraries link only the CUDA runtime).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiledFn>(
                   dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major output [rows, cols] (bf16, or f32) written
// in boxes of 64 rows x 128 bytes with the 128-byte swizzle.
static inline bool make_out_map(CUtensorMap* map, const void* base, int rows,
                                int cols, bool f32) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t esize = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / esize), 64};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of a row-major bf16 matrix [rows, K] read in boxes of
// box_rows x 64 with the 128-byte swizzle; rows and k past the ends read
// as zeros.  False where the encoder refuses it (base or row stride not
// 16-byte aligned, a box too large).
static inline bool make_kmajor_map(CUtensorMap* map, const void* base,
                                   int rows, int K, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

static inline cudaLaunchConfig_t cluster_config(size_t smem, int ctas,
                                                 cudaStream_t stream,
                                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kGemmThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The tensor map of a row-major bf16 matrix [rows, cols] read as an
// MN-major operand (rows the k of the product) in boxes of 64 rows x 64
// columns with the 128-byte swizzle; rows and columns past the ends read as
// zeros.  False where the encoder refuses it.
static inline bool make_mn_map(CUtensorMap* map, const void* base, int rows,
                               int cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)kBK};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches C = A W^T with epilogue EPI on `ctas` persistent CTAs (clusters
// of kCluster).  A [M, K] (kAMN: stored [K, M]); w[i] [N, K] (kBMN: stored
// [K, N]) for i < g.mats.  g.splits K ranges of g.ksplit rows (a multiple
// of 64; kEpiPart only, M a multiple of 64: out[0] is [splits M, N]).
template <int BN, int EPI, bool kAMN = false, bool kBMN = false>
static inline cudaError_t gemm_sm90(const bf16* A, const bf16* const* w,
                                    GemmArgs g, int ctas,
                                    cudaStream_t stream) {
  static SmemGrant grant;  // one per instantiation and library
  constexpr bool kF32 = EPI == kEpiResidF32 || EPI == kEpiPart;
  if (ctas <= 0 || ctas % kCluster || g.M <= 0 || g.N <= 0 || g.K <= 0)
    return cudaErrorInvalidValue;
  if (g.splits < 1 ||
      (g.splits > 1 &&
       (EPI != kEpiPart || g.ksplit <= 0 || g.ksplit % kBK ||
        (long long)(g.splits - 1) * g.ksplit >= g.K ||
        (long long)g.splits * g.ksplit < g.K)) ||
      (EPI == kEpiPart && g.M % 64) || ((kAMN || kBMN) && g.mats != 1))
    return cudaErrorInvalidValue;
  if (g.splits == 1) g.ksplit = g.K;
  if ((EPI == kEpiResidF32 || EPI == kEpiResidBf16 || EPI == kEpiAdd ||
       EPI == kEpiAddDrop) &&
      !g.resid)
    return cudaErrorInvalidValue;
  if (EPI == kEpiDctx &&
      (!g.resid || !g.delta || g.dh < 8 || g.dh % 8 || g.N != g.H * g.dh ||
       (g.N > BN && BN % g.dh)))
    return cudaErrorInvalidValue;
  if (!allow_smem(gemm_sm90_kernel<BN, EPI, kAMN, kBMN>, GemmCfg<BN>::kSmem,
                  grant))
    return cudaErrorInvalidValue;
  CUtensorMap ma, mw[3], mo[3];
  if (!(kAMN ? make_mn_map(&ma, A, g.K, g.M)
             : make_kmajor_map(&ma, A, g.M, g.K, kBM)))
    return cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i) {
    if (i >= g.mats) {  // never read
      mw[i] = mw[0];
      mo[i] = mo[0];
    } else if (!(kBMN ? make_mn_map(&mw[i], w[i], g.K, g.N)
                      : make_kmajor_map(&mw[i], w[i], g.N, g.K,
                                        BN / kCluster))) {
      return cudaErrorInvalidValue;
    } else if (EPI == kEpiProbe) {
      mo[i] = ma;  // the probe stores through no map
    } else if (!make_out_map(&mo[i], g.out[i], g.splits * g.M, g.N, kF32)) {
      return cudaErrorInvalidValue;
    }
  }
  g.tiles_n = (g.N + BN - 1) / BN;
  g.pairs_m = (g.M + kCluster * kBM - 1) / (kCluster * kBM);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(GemmCfg<BN>::kSmem, ctas, stream, attr);
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, gemm_sm90_kernel<BN, EPI, kAMN, kBMN>, ma,
                         mw[0], mw[1], mw[2], mo[0], mo[1], mo[2], g);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Clusters of the GEMM block that can be resident at once (0 when the
// query fails): the persistent launch's cluster count.
static inline int gemm_sm90_cluster_slots() {
  static SmemGrant grant;
  if (!allow_smem(gemm_sm90_kernel<256, kEpiBias, false, false>,
                  GemmCfg<256>::kSmem, grant))
    return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(GemmCfg<256>::kSmem, kCluster, nullptr, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(
          &n, gemm_sm90_kernel<256, kEpiBias, false, false>, &cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

}  // namespace sm90
}  // namespace ladiff
