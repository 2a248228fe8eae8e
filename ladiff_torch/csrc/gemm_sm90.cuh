// A tensor-core GEMM block for Hopper (sm_90a): C[M, N] = A[M, K] W^T with
// a fused epilogue, where A is a row-major bf16 activation and W a torch
// Linear weight [N, K] (bf16).  Both operands are K-major, the layout
// `wgmma` takes without a transpose.
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
// and v): the column tile picks the weight, its bias and its output.
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
  float scale;       // kEpiBias: applied to weight 0's outputs
  const bf16* bias[3];
  void* out[3];      // [M, N] each: bf16, or f32 for kEpiResidF32
  const void* resid; // [M, N]: bf16 (kEpiResidF32) or f32 (kEpiResidBf16)
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
// scale_d 0 overwrites d.  d's layout: for each 8-column group j, thread t
// of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns
// 8 j + 2 (t % 4) (+ 1) in d[4 j .. 4 j + 3].
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (BN == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" LADIFF_R0_63
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : LADIFF_F32(d, 0), LADIFF_F32(d, 32)
        : "l"(da), "l"(db), "r"(scale_d));
  } else if constexpr (BN == 192) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {" LADIFF_R0_63
            LADIFF_R64_95 "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
        : LADIFF_F32(d, 0), LADIFF_F32(d, 32), LADIFF_F32(d, 64)
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" LADIFF_R0_63
            LADIFF_R64_95 LADIFF_R96_127 "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : LADIFF_F32(d, 0), LADIFF_F32(d, 32), LADIFF_F32(d, 64),
          LADIFF_F32(d, 96)
        : "l"(da), "l"(db), "r"(scale_d));
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
// TMA while the next chunk is computed: the global writes overlap the rest
// of the epilogue and the next tile's products, and TMA clips the rows and
// columns past M and N.  The bias and residual values of a chunk are loaded
// together (at clamped addresses, without branches) before any is used.
template <int BN, int EPI>
__device__ __forceinline__ void gemm_epilogue(const float (&acc)[BN / 2],
                                              const GemmArgs& g,
                                              const CUtensorMap* omap,
                                              unsigned char* bufs, int& seq,
                                              int mat, int m0, int n0) {
  constexpr bool kF32 = EPI == kEpiResidF32;
  constexpr bool kResid = EPI == kEpiResidF32 || EPI == kEpiResidBf16;
  constexpr int kCW = kF32 ? 32 : 64;  // columns of a chunk
  constexpr int kJ = kCW / 8;          // column groups of a chunk
  const int t = threadIdx.x & 127, lane = t & 31, q = lane & 3;
  const int r0 = 16 * (t >> 5) + (lane >> 2);  // row in the 64 (+ 8)
  const int col0 = n0 + 2 * q;
  const bool elected = t == 0;
  const int bar = threadIdx.x >> 7;  // named barrier 1 or 2
  const bf16* bias =
      mat == 0 ? g.bias[0] : (mat == 1 ? g.bias[1] : g.bias[2]);
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
#pragma unroll
  for (int ch = 0; ch < BN / kCW; ++ch) {
    if (n0 + ch * kCW >= g.N) break;  // the same for the whole warpgroup
    float2 b[kJ], r[kJ][2];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int col = min(col0 + 8 * (ch * kJ + jj), g.N - 2);  // N even
      b[jj] = __bfloat1622float2(
          __ldg(reinterpret_cast<const __nv_bfloat162*>(bias + col)));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const size_t o = (size_t)rows[i] * g.N + col;
        if constexpr (EPI == kEpiResidF32)
          r[jj][i] = __bfloat1622float2(__ldg(
              reinterpret_cast<const __nv_bfloat162*>(g.resid) + o / 2));
        else if constexpr (EPI == kEpiResidBf16)
          r[jj][i] = __ldg(reinterpret_cast<const float2*>(g.resid) + o / 2);
      }
    }
    // buffers alternate over the warpgroup's chunks, across tiles too; the
    // store that last read this one (two chunks ago) is done
    unsigned char* buf = bufs + (seq++ & 1) * kEpiBuf;
    if (elected) bulk_wait_read<1>();
    warpgroup_bar(bar);
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int j = ch * kJ + jj;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        float v0 = acc[4 * j + 2 * i] + b[jj].x;
        float v1 = acc[4 * j + 2 * i + 1] + b[jj].y;
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
        if constexpr (kF32) {  // 8 bytes at byte 32 jj + 8 q of the row
          const int u = 2 * jj + (q >> 1);
          *reinterpret_cast<float2*>(rp + ((u ^ (row & 7)) << 4) +
                                     8 * (q & 1)) = make_float2(v0, v1);
        } else {  // 4 bytes at byte 16 jj + 4 q of the row
          *reinterpret_cast<__nv_bfloat162*>(rp + ((jj ^ (row & 7)) << 4) +
                                             4 * q) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    fence_proxy_async();
    warpgroup_bar(bar);
    if (elected) tma_store_2d(omap, buf, n0 + ch * kCW, m0);
  }
}

// Each tile pair p of a launch: column tile nt (weight nt / tiles_n) of
// row tiles 2 (p / per_row) and 2 (p / per_row) + 1.
struct TilePair {
  int mat, m0, n0;
};
template <int BN>
__device__ __forceinline__ TilePair tile_pair(const GemmArgs& g, int p,
                                              int rank) {
  const int per_row = g.mats * g.tiles_n, nt = p % per_row;
  return {nt / g.tiles_n, (p / per_row * kCluster + rank) * kBM,
          nt % g.tiles_n * BN};
}

template <int BN, int EPI>
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
  const int pairs =
      (g.M + kCluster * kBM - 1) / (kCluster * kBM) * g.mats * g.tiles_n;
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  const int nk = (g.K + kBK - 1) / kBK;
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
        // a row tile wholly past M (the odd last one) loads no A: its
        // outputs are never stored
        const bool load_a = t.m0 < g.M;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * Cfg::kStageBytes;
          mbar_expect_tx(&full[stage],
                         Cfg::kStageBytes - (load_a ? 0 : kABytes));
          if (load_a) tma_load_2d(st, &tma_a, &full[stage], kt * kBK, t.m0);
          tma_load_2d_mc(st + kABytes + rank * kHalfB, wmap, &full[stage],
                         kt * kBK, t.n0 + rank * (BN / kCluster),
                         (1 << kCluster) - 1);
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
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint32_t a = smem_u32(ring + stage * Cfg::kStageBytes) +
                           c * (64 * kBK * 2);
        const uint32_t b = smem_u32(ring + stage * Cfg::kStageBytes + kABytes);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_bf16<BN>(acc, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk),
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
                             t.mat, t.m0 + 64 * c, t.n0);
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

// Launches C = A W^T with epilogue EPI on `ctas` persistent CTAs (clusters
// of kCluster).  A [M, K]; w[i] [N, K] for i < g.mats.
template <int BN, int EPI>
static inline cudaError_t gemm_sm90(const bf16* A, const bf16* const* w,
                                    GemmArgs g, int ctas,
                                    cudaStream_t stream) {
  static SmemGrant grant;  // one per instantiation and library
  if (ctas <= 0 || ctas % kCluster) return cudaErrorInvalidValue;
  if (!allow_smem(gemm_sm90_kernel<BN, EPI>, GemmCfg<BN>::kSmem, grant))
    return cudaErrorInvalidValue;
  CUtensorMap ma, mw[3], mo[3];
  if (!make_kmajor_map(&ma, A, g.M, g.K, kBM)) return cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i) {
    if (i >= g.mats) {  // never read
      mw[i] = mw[0];
      mo[i] = mo[0];
    } else if (!make_kmajor_map(&mw[i], w[i], g.N, g.K, BN / kCluster)) {
      return cudaErrorInvalidValue;
    } else if (EPI == kEpiProbe) {
      mo[i] = ma;  // the probe stores through no map
    } else if (!make_out_map(&mo[i], g.out[i], g.M, g.N,
                             EPI == kEpiResidF32)) {
      return cudaErrorInvalidValue;
    }
  }
  g.tiles_n = (g.N + BN - 1) / BN;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(GemmCfg<BN>::kSmem, ctas, stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, gemm_sm90_kernel<BN, EPI>,
                                           ma, mw[0], mw[1], mw[2], mo[0],
                                           mo[1], mo[2], g);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Clusters of the GEMM block that can be resident at once (0 when the
// query fails): the persistent launch's cluster count.
static inline int gemm_sm90_cluster_slots() {
  static SmemGrant grant;
  if (!allow_smem(gemm_sm90_kernel<256, kEpiBias>, GemmCfg<256>::kSmem,
                  grant))
    return 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(GemmCfg<256>::kSmem, kCluster, nullptr, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, gemm_sm90_kernel<256, kEpiBias>,
                                     &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

}  // namespace sm90
}  // namespace ladiff
