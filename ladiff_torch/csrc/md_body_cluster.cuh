// The MD-trans denoiser layer body on a thread-block cluster, shared by
// kernel K1 (md_layer.cu, one layer per launch) and kernel 11 (md_stack.cu,
// the whole skip stack per launch); its stylized-FFN segment
// (md_stylized_ffn) is also kernel 6 (stylized_ffn.cu) on its own, and its
// one-token cross-attention segment (md_value_stats, md_ca_rows,
// md_ca_project) kernel 7 (stylize.cu).  See ladiff_torch/ops/md_layer.py
// for the math, ladiff_torch/ops/md_stack.py for the stack,
// ladiff_torch/ops/stylized_ffn.py for kernel 6 and
// ladiff_torch/ops/stylize.py for kernel 7.
//
// A cluster of C = D / 64 CTAs owns one row group: whole samples, at most
// 96 latent rows and 48 extra rows (text, time).  CTA c computes columns
// [64 c, 64 c + 64) of every D-wide product and F / C of the hidden columns
// of each FFN.  H is a multiple of C, so the CTA's q / k / v columns are
// whole heads (the published D 256, H 4 takes C = 4, one head per CTA) and
// attention stays inside the CTA.  A group is as large as it takes for the
// clusters to fill the card once: 2B = 512 samples of 5 rows are 29 groups
// of 18 samples (90 rows) on the 30 clusters of 4 an H100 holds at once.
//
// Exchanges go through distributed shared memory (st.shared::cluster to a
// peer's address from mapa) and end in a cluster barrier:
//   - the next A operand: each CTA writes its bf16 column slice into every
//     peer's copy (ctx, LN1's output, x3, the stylized FFN's AdaLN rows,
//     the cross-attention's AdaLN rows, the stack's next x and skip rows);
//   - a LayerNorm: each warp sends the (mean, M2) of its 16 columns of its
//     rows; each CTA combines the 4 C partials in rank order (Chan's
//     formula), so every CTA holds the same statistics;
//   - the FFN's second product (K = F) is split along k: per 256-column
//     hidden chunk each CTA sends its f32 partial of each peer's 64 columns
//     to that peer (a reduce-scatter), keeps its own in registers, and adds
//     the received ones in rank and chunk order: deterministic.
// Products are mma.sync.m16n8k16 bf16 -> f32 with register accumulators.
// Warp w of the 8 owns columns 16 (w % 4) .. + 15 of the CTA's 64 and every
// other 16-row tile (tiles 2 i + w / 4), so two warps share each scheduler
// and a partial group keeps both row halves busy (16 warps would cap the
// registers at 128, below what the accumulators need).  A reaches the
// tensor cores through ldmatrix (the next 16-deep step's fragments load
// before this step's products issue), and the CTA's weight slices stream
// through a four-stage cp.async ring of 64-deep k slices in the order the
// body consumes them (a per-launch table, md_seg), across products and
// layers, so a product's first slices are in flight during the previous
// one.  The residual stream stays in f32 registers of the CTA's columns;
// epilogues (bias, residual, LayerNorm, AdaLN, SiLU, ReLU / GELU) run on
// the accumulators.
//
// Element e of accumulator [i][nt] of a thread (lane l, warp w) sits at
// row 16 (2 i + w / 4) + l / 4 + 8 (e / 2) and column
// 16 (w % 4) + 8 nt + 2 (l % 4) + e % 2 of the CTA's 64.
#pragma once

#include "cluster.cuh"
#include "tail64.cuh"

namespace ladiff {

constexpr int kMDParams = 24;  // ops/md_layer.py _PARAM_ORDER

// Elements of each of the 24 tensors of one layer, in _PARAM_ORDER.
__host__ __device__ inline size_t md_param_numel(int k, int D, int F1,
                                                 int F2) {
  const size_t d = D;
  switch (k) {
    case 0: return 3 * d * d;   // sa_in_w
    case 1: return 3 * d;       // sa_in_b
    case 2: case 14: case 22: return d * d;  // sa_out_w, ca_w, fp_w
    case 6: case 8: return (size_t)F1 * d;   // w1, w2
    case 7: return F1;                       // b1
    case 16: case 18: return (size_t)F2 * d; // fw1, fw2
    case 17: return F2;                      // fb1
    default: return d;  // biases and LayerNorm weights of width D
  }
}

constexpr int kCW = 64;            // columns of a CTA (D / C)
constexpr int kCThreads = 256;     // 8 warps: 4 column slices x 2 row halves
constexpr int kCLT = 6;            // latent row tiles: 96 rows
constexpr int kCET = 3;            // extra row tiles: 48 rows
constexpr int kCRows = 16 * kCLT;
constexpr int kCExtra = 16 * kCET;
constexpr int kCMT = (kCLT + 1) / 2;          // latent tiles of a warp
constexpr int kCKVT = (kCLT + kCET + 1) / 2;  // latent and extra tiles
constexpr int kCKT = 64;           // k per ring stage
constexpr int kCStages = 4;
constexpr int kCLdW = kCKT + 8;
constexpr int kCStageEl = kCW * kCLdW;
constexpr int kCHC = 256;          // FFN hidden columns per chunk and CTA
constexpr int kCLdQ = kCW + 8;     // q / k / v rows
constexpr int kCMaxC = 4;
constexpr int kCSegs = 48;        // weight segments of a layer, at most

// All arguments of the kernels (K1: L = 1, no skip tensors; kernels 6 and
// 7: L = 1, rows grouped as B = M samples of T = 1 row, no extra rows, the
// rows' real samples ss_t rows each; kernel 6: ffn_only, no kvalid, the
// AdaLN row of row i at ffn_ss + (i / ss_t) ffn_stride, the stylized FFN's
// tensors at w[16..23] and F1 = F2; kernel 7: ca_only, the rows' mask in
// kvalid, one value row per real sample, the AdaLN row of row i at ca_ss +
// (i / ss_t) ca_stride, the cross-attention's tensors at w[12..15]).
struct MDClusterArgs {
  const bf16* x;        // [B T, D]
  const bf16* extra;    // [B E, D]
  const float* kvalid;  // [B T]
  const bf16* value;    // K1 [B, D]; stack [L, B, D]
  const bf16 *ca_ss, *ffn_ss;  // K1 [1 or B, 2D]; stack [L, 2D]
  const bf16* w[kMDParams];    // K1 one layer's; stack [L, ...] each
  const bf16 *lin_w, *lin_b, *norm_w, *norm_b;  // stack: [nb, D, 2D] ...
  bf16* skips;          // stack: [nb, B T, D] scratch
  bf16* out;            // [B T, D]
  int B, T, E, D, H, F1, F2, L, ca_stride, ffn_stride;
  int spg, groups, C;   // samples per row group, row groups, cluster size
  int ffn_only, ca_only;  // kernel 6 / kernel 7: one segment alone
  int ss_t;             // kernels 6 and 7: rows a sample
};

__host__ __device__ inline int md_chunks(int F, int C) {
  return (F / C + kCHC - 1) / kCHC;
}

// Shared memory: the A operand (latent rows); one region for q / k / v,
// then the FFN's hidden chunk, then a D-wide A operand (the AdaLN rows, the
// skip rows); the received FFN partials, which hold the extra rows until
// the k / v product has read them; the weight ring; the LayerNorm partials
// [4 C][96] (mean, M2); per-row (mean, rstd); per-sample value statistics;
// the rows' latent validity; the weight segments (md_seg).  Mirrored by
// ops/md_layer.py md_smem_bytes.
struct MDCLayout {
  size_t xa, big, recv, ring, stats, rowstat, sstat, kvs, segs, total;
};

__host__ __device__ inline MDCLayout md_cluster_layout(int D, int F1,
                                                      int F2) {
  const int C = D / kCW;
  const int nch = md_chunks(F1, C) > md_chunks(F2, C) ? md_chunks(F1, C)
                                                       : md_chunks(F2, C);
  const size_t ld = D + 8;
  const size_t qkv = (size_t)(kCRows + 2 * (kCRows + kCExtra)) * kCLdQ * 2;
  const size_t hid = (size_t)kCRows * (kCHC + 8) * 2;
  const size_t wide = (size_t)kCRows * ld * 2;
  const size_t part = (size_t)(C - 1) * nch * kCRows * kCW * 4;
  const size_t ext = (size_t)kCExtra * ld * 2;
  size_t big = qkv > hid ? qkv : hid;
  big = big > wide ? big : wide;
  MDCLayout L;
  L.xa = 0;
  L.big = align128(L.xa + kCRows * ld * 2);
  L.recv = align128(L.big + big);
  L.ring = align128(L.recv + (part > ext ? part : ext));
  L.stats = align128(L.ring + (size_t)kCStages * kCStageEl * 2);
  L.rowstat = align128(L.stats + (size_t)4 * C * kCRows * 8);
  L.sstat = align128(L.rowstat + (size_t)kCRows * 8);
  L.kvs = align128(L.sstat + (size_t)kCRows * 8);
  L.segs = align128(L.kvs + (size_t)kCRows * 4);
  L.total = align128(L.segs + (size_t)kCSegs * 32);
  return L;
}

// Kernel 7's CTA (ca_only): the A operand (the AdaLN rows, D wide) in big,
// the ring, the per-sample value statistics, the rows' mask and the segment
// table; it has no x rows, FFN partials or LayerNorm partials, whose
// regions alias big.  Mirrored by ops/stylize.py stylize_smem_bytes.
__host__ __device__ inline MDCLayout md_ca_layout(int D) {
  MDCLayout L = {};
  L.ring = align128((size_t)kCRows * (D + 8) * 2);
  L.sstat = align128(L.ring + (size_t)kCStages * kCStageEl * 2);
  L.kvs = align128(L.sstat + (size_t)kCRows * 8);
  L.segs = align128(L.kvs + (size_t)kCRows * 4);
  L.total = align128(L.segs + (size_t)kCSegs * 32);
  return L;
}

inline size_t md_cluster_bytes(const MDClusterArgs& a) {
  return a.ca_only ? md_ca_layout(a.D).total
                   : md_cluster_layout(a.D, a.F1, a.F2).total;
}

// Weight segments of one FFN and its projection (md_seg): the 64-column
// first-product passes and C second-product passes per hidden chunk, then
// the projection.
__host__ __device__ inline int md_ffn_nsegs(int D, int F) {
  const int C = D / kCW;
  return F / C / kCW + md_chunks(F, C) * C + 1;
}

// Weight segments of a layer: the skip Linear, q / k / v, the
// out-projection, then the two FFNs'.
__host__ __device__ inline int md_nsegs(int D, int F1, int F2) {
  return 5 + md_ffn_nsegs(D, F1) + md_ffn_nsegs(D, F2);
}

// The shapes the body takes (ops/md_layer.py md_layer_supported, the launch
// geometry of md_geometry).
inline bool md_cluster_valid(const MDClusterArgs& a) {
  if (a.B < 1 || a.T < 1 || a.T > 32 || a.E < 1 || a.E > 32 || a.D < kCW ||
      a.D % kCW || a.D / kCW > kCMaxC || a.C != a.D / kCW || a.H < 1 ||
      a.H % a.C || a.D % a.H || (a.D / a.H) % 8 || a.F1 < a.D ||
      a.F1 % a.D || a.F2 < a.D || a.F2 % a.D || a.L < 1 || a.L % 2 == 0)
    return false;
  if (md_nsegs(a.D, a.F1, a.F2) >= kCSegs) return false;
  if (a.spg < 1 || a.spg * a.T > kCRows || a.spg * a.E > kCExtra ||
      a.groups != (a.B + a.spg - 1) / a.spg)
    return false;
  return (a.ca_stride == 0 || a.ca_stride == 2 * a.D) &&
         (a.ffn_stride == 0 || a.ffn_stride == 2 * a.D);
}

// The shapes kernels 6 and 7 take (ops/stylized_ffn.py
// stylized_ffn_supported, ops/stylize.py broadcast_stylize_supported, the
// launch geometry of stylized_ffn_geometry): groups of at most 96 rows.
inline bool seg_cluster_valid(const MDClusterArgs& a) {
  if (a.B < 1 || a.T != 1 || a.E != 0 || a.L != 1 || a.ss_t < 1 ||
      a.B % a.ss_t || a.D < kCW || a.D % kCW || a.D / kCW > kCMaxC ||
      a.C != a.D / kCW)
    return false;
  if (a.spg < 1 || a.spg > kCRows || a.groups != (a.B + a.spg - 1) / a.spg)
    return false;
  if (a.ca_only) return a.ca_stride == 0 || a.ca_stride == 2 * a.D;
  return a.F2 >= a.D && a.F2 % a.D == 0 && a.F1 == a.F2 &&
         md_ffn_nsegs(a.D, a.F2) < kCSegs &&
         (a.ffn_stride == 0 || a.ffn_stride == 2 * a.D);
}

// ---------------------------------------------------------------------------
// The CTA's view.

struct SegRow;

struct MDCta {
  bf16 *xa, *big, *ring, *ext;
  SegRow* segs;
  float *recv, *kvs;
  float2 *stats, *rowstat, *sstat;
  int ld, c, C, D, T, E, ns, nrow, nerow, ml, me, nch, s0;
  size_t row0;
};

__device__ __forceinline__ MDCta md_cta(unsigned char* smem,
                                        const MDClusterArgs& a,
                                        const MDCLayout& L) {
  MDCta m;
  m.xa = reinterpret_cast<bf16*>(smem + L.xa);
  m.big = reinterpret_cast<bf16*>(smem + L.big);
  m.recv = reinterpret_cast<float*>(smem + L.recv);
  m.ext = reinterpret_cast<bf16*>(smem + L.recv);
  m.ring = reinterpret_cast<bf16*>(smem + L.ring);
  m.stats = reinterpret_cast<float2*>(smem + L.stats);
  m.rowstat = reinterpret_cast<float2*>(smem + L.rowstat);
  m.sstat = reinterpret_cast<float2*>(smem + L.sstat);
  m.kvs = reinterpret_cast<float*>(smem + L.kvs);
  m.segs = reinterpret_cast<SegRow*>(smem + L.segs);
  m.ld = a.D + 8;
  m.C = a.C;
  m.c = cluster_rank();
  m.D = a.D;
  m.T = a.T;
  m.E = a.E;
  m.s0 = (blockIdx.x / a.C) * a.spg;
  m.ns = min(a.spg, a.B - m.s0);
  m.nrow = m.ns * a.T;
  m.nerow = m.ns * a.E;
  m.ml = (m.nrow + 15) / 16;
  m.me = (m.nerow + 15) / 16;
  m.nch = md_chunks(a.F1, a.C) > md_chunks(a.F2, a.C) ? md_chunks(a.F1, a.C)
                                                     : md_chunks(a.F2, a.C);
  m.row0 = (size_t)m.s0 * a.T;
  return m;
}
__device__ __forceinline__ MDCta md_cta(unsigned char* smem,
                                        const MDClusterArgs& a) {
  return md_cta(smem, a, md_cluster_layout(a.D, a.F1, a.F2));
}

// A thread's place: column slice wc and row half rh of its warp, row g and
// column pair tq in the 16 x 8 accumulator tile.
struct CLane {
  int wc, rh, g, tq;
};
__device__ __forceinline__ CLane clane() {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return {warp & 3, warp >> 2, lane >> 2, lane & 3};
}
// The row tile of the warp's i-th tile, and the row and column of its
// elements (half hf of the tile, column tile nt of the warp's two).
__device__ __forceinline__ int ctile(const CLane& t, int i) {
  return 2 * i + t.rh;
}
__device__ __forceinline__ int crow(const CLane& t, int i, int hf) {
  return 16 * ctile(t, i) + t.g + 8 * hf;
}
__device__ __forceinline__ int ccol(const CLane& t, int nt) {
  return 16 * t.wc + 8 * nt + 2 * t.tq;
}
// The element of column col in row row of a received partial [96][64] (an
// XOR swizzle of the 8-column groups: 2-way bank conflicts).
__device__ __forceinline__ int rpart(int row, int col) {
  return row * kCW + (col ^ ((row & 3) << 3));
}

template <int MT>
__device__ __forceinline__ void czero(float (&v)[MT][2][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[i][nt][e] = 0.f;
}

// ---------------------------------------------------------------------------
// The weight stream.  Segment i of a layer is 64 weight rows (the CTA's
// output columns) of nk 64-deep k slices, row stride ldw, in the order the
// body consumes them: the skip Linear (stack output blocks), k, v, q, the
// out-projection, the ReLU FFN, the cross-attention projection, the
// stylized FFN, its projection.  Layer l's copy starts at
// base + (l - lmin) lstride; layers below lmin have none (the skip Linear
// belongs to the output blocks).  The table is built once per launch in
// shared memory, so moving to the next segment is one shared load.

struct SegRow {
  const bf16* base;
  long long lstride;
  int ldw, nk, lmin, pad;
};

// Segment i (nk -1 past the layer's last).  An FFN's segments: per hidden
// chunk j, the first product's passes of 64 hidden columns (K = D), then
// the second product's passes for the peers' columns and last the CTA's
// own (K = the chunk).  Kernel 6 (ffn_only) has the stylized FFN's alone,
// kernel 7 (ca_only) the cross-attention projection alone.
__device__ inline SegRow md_seg(const MDClusterArgs& a, int i, int c) {
  const int D = a.D, C = a.C, nk = D / kCKT;
  const auto prm = [&](int k, size_t off, int ldw, int n) {
    return SegRow{a.w[k] + off,
                  (long long)md_param_numel(k, D, a.F1, a.F2), ldw, n, 0, 0};
  };
  if (a.ca_only)
    return i == 0 ? prm(14, (size_t)c * kCW * D, D, nk)
                  : SegRow{nullptr, 0, 0, -1, 0, 0};
  if (!a.ffn_only) {
    if (i == 0)  // layer l > nb: output block l - nb - 1
      return SegRow{a.lin_w + (size_t)c * kCW * 2 * D, 2LL * D * D, 2 * D,
                    a.lin_w ? 2 * D / kCKT : 0, (a.L - 1) / 2 + 1, 0};
    // 1: k, 2: v, 3: q (parts 1, 2, 0 of the in-projection), 4: out
    if (i <= 3) return prm(0, ((size_t)(i % 3) * D + c * kCW) * D, D, nk);
    if (i == 4) return prm(2, (size_t)c * kCW * D, D, nk);
    i -= 5;
  }
  for (int f = a.ffn_only ? 1 : 0; f < 2; ++f) {
    const int F = f ? a.F2 : a.F1, Fc = F / C, k1 = f ? 16 : 6;
    for (int j = 0; j * kCHC < Fc; ++j) {
      const int cw = min(kCHC, Fc - j * kCHC), np1 = cw / kCW;
      if (i < np1)
        return prm(k1, (size_t)(c * Fc + j * kCHC + i * kCW) * D, D, nk);
      if (i < np1 + C) {
        const int p = (c + 1 + i - np1) % C;
        return prm(k1 + 2, (size_t)p * kCW * F + c * Fc + j * kCHC, F,
                   cw / kCKT);
      }
      i -= np1 + C;
    }
    // the cross-attention projection after the ReLU FFN, the stylized
    // FFN's after it
    if (i == 0) return prm(f ? 22 : 14, (size_t)c * kCW * D, D, nk);
    i -= 1;
  }
  return SegRow{nullptr, 0, 0, -1, 0, 0};
}

struct MDStream {
  int nload, cons;  // slices issued, consumed
  int l, i, kt;     // the next slice: layer, segment, slice
  const bf16* w;    // its segment's weight rows, ldw, nk
  int ldw, nk;
};

// Moves the cursor to the first segment at or after (l, i) that layer l
// has (l = L past the last layer).
__device__ __forceinline__ void stream_seek(MDStream& s,
                                            const MDClusterArgs& a,
                                            const MDCta& m) {
  while (s.l < a.L) {
    const SegRow& r = m.segs[s.i];
    if (r.nk < 0) {
      ++s.l;
      s.i = 0;
    } else if (r.nk == 0 || s.l < r.lmin) {
      ++s.i;
    } else {
      s.w = r.base + (s.l - r.lmin) * r.lstride;
      s.ldw = r.ldw;
      s.nk = r.nk;
      return;
    }
  }
}

// Issues the next slice into ring slot nload % kCStages (an empty group past
// the last layer); one commit group per call.
__device__ __forceinline__ void stream_load(MDStream& s,
                                            const MDClusterArgs& a,
                                            const MDCta& m) {
  if (s.l < a.L) {
    bf16* dst = m.ring + (s.nload % kCStages) * kCStageEl;
    const bf16* src = s.w + s.kt * kCKT;
    for (int v = threadIdx.x; v < kCW * (kCKT / 8); v += kCThreads) {
      const int n = v / (kCKT / 8), k8 = (v % (kCKT / 8)) * 8;
      cp_async16(dst + n * kCLdW + k8, src + (size_t)n * s.ldw + k8);
    }
    if (++s.kt == s.nk) {
      s.kt = 0;
      ++s.i;
      stream_seek(s, a, m);
    }
  }
  cp_async_commit();
  ++s.nload;
}

// The segment table, then the first slices in flight.  Starts with a
// barrier (the table is written).
__device__ __forceinline__ void stream_start(MDStream& s,
                                             const MDClusterArgs& a,
                                             const MDCta& m) {
  for (int i = threadIdx.x; i < kCSegs; i += kCThreads)
    m.segs[i] = md_seg(a, i, m.c);
  __syncthreads();
  s.nload = s.cons = s.kt = 0;
  s.l = s.i = 0;
  stream_seek(s, a, m);
#pragma unroll
  for (int k = 0; k < kCStages - 1; ++k) stream_load(s, a, m);
}

// acc[i][2][4] += A W^T over the next nk slices of the stream for the
// warp's row tiles 2 i + rh whose bit is set in tmask (warp-uniform).  Row
// tile r < kCLT reads A rows 16 r.. (k slice kt from A0 + 64 kt below ksplit,
// from A1 + 64 (kt - ksplit) from it on: the stack's skip Linear [x, skip]);
// tile kCLT + e reads rows 16 e.. of Ae (the extra rows).  Starts each slice
// with __syncthreads.
template <int MT>
__device__ __forceinline__ void cgemm(float (&acc)[MT][2][4], const bf16* A0,
                                      const bf16* A1, const bf16* Ae,
                                      int lda, int nk, int ksplit,
                                      unsigned tmask, MDStream& s,
                                      const MDClusterArgs& a,
                                      const MDCta& m) {
  const CLane t = clane();
  const int lane = threadIdx.x & 31;
  const int aoff = (lane & 15) * lda + (lane >> 4) * 8;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kCStages - 2>();
    __syncthreads();  // slice `cons` landed for all; slot cons - 1 is free
    const bf16* st = m.ring + (s.cons % kCStages) * kCStageEl;
    stream_load(s, a, m);
    ++s.cons;
    const bf16* A = (kt < ksplit ? A0 + kt * kCKT : A1 + (kt - ksplit) * kCKT)
                    + aoff;
    const bf16* E = Ae + kt * kCKT + aoff;
    const bf16* bp = st +
                     (16 * t.wc + (lane & 7) + ((lane >> 4) << 3)) * kCLdW +
                     ((lane >> 3) & 1) * 8;
    // the fragments of the next 16-deep step are loaded before this step's
    // products issue (the asm keeps program order), so their latency hides
    uint32_t b[2][4], af[2][MT][4];
    auto frags = [&](int kk, uint32_t(&bb)[4], uint32_t(&aa)[MT][4]) {
      ldsm4(bb, bp + kk);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = ctile(t, i);
        if ((tmask >> r) & 1u)
          ldsm4(aa[i], r < kCLT ? A + 16 * r * lda + kk
                                : E + 16 * (r - kCLT) * lda + kk);
      }
    };
    frags(0, b[0], af[0]);
#pragma unroll
    for (int q = 0; q < kCKT / 16; ++q) {
      if (q + 1 < kCKT / 16)
        frags(16 * (q + 1), b[(q + 1) & 1], af[(q + 1) & 1]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if ((tmask >> ctile(t, i)) & 1u) {
          mma16816(acc[i][0], af[q & 1][i], b[q & 1][0], b[q & 1][1]);
          mma16816(acc[i][1], af[q & 1][i], b[q & 1][2], b[q & 1][3]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// Epilogues on the accumulators.

// dst[row][col] = bf16(acc + bias[col]) for the CTA's 64 columns of the
// warp's tiles in tmask (dst: the CTA-local q / k / v tile; extra tile
// kCLT + e at rows kCRows + 16 e..).
template <int MT>
__device__ __forceinline__ void store_biased_cl(const float (&acc)[MT][2][4],
                                                const bf16* bias, bf16* dst,
                                                unsigned tmask) {
  const CLane t = clane();
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = ccol(t, nt);
    const float2 bv = ldg2(bias + col);
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if ((tmask >> ctile(t, i)) & 1u)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          st2(dst + crow(t, i, hf) * kCLdQ + col, acc[i][nt][2 * hf] + bv.x,
              acc[i][nt][2 * hf + 1] + bv.y);
  }
}

// v += acc + bias[64 c + col]
__device__ __forceinline__ void add_biased(float (&v)[kCMT][2][4],
                                           const float (&acc)[kCMT][2][4],
                                           const bf16* bias, int c) {
  const CLane t = clane();
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const float2 bv = ldg2(bias + c * kCW + ccol(t, nt));
#pragma unroll
    for (int i = 0; i < kCMT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        v[i][nt][2 * hf] += acc[i][nt][2 * hf] + bv.x;
        v[i][nt][2 * hf + 1] += acc[i][nt][2 * hf + 1] + bv.y;
      }
  }
}

// The CTA's slice of v as bf16 into buf (row stride m.ld; rows of the
// active tiles, zero past nrow).
__device__ __forceinline__ void store_slice(const float (&v)[kCMT][2][4],
                                            bf16* buf, const MDCta& m) {
  const CLane t = clane();
#pragma unroll
  for (int i = 0; i < kCMT; ++i)
    if (ctile(t, i) < m.ml)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = crow(t, i, hf);
          const bool in = row < m.nrow;
          st2(buf + row * m.ld + m.c * kCW + ccol(t, nt),
              in ? v[i][nt][2 * hf] : 0.f, in ? v[i][nt][2 * hf + 1] : 0.f);
        }
}

// The CTA's 64-column slice of the active rows of buf (row stride m.ld) into
// the same place of every peer (the caller's cluster barrier follows).
__device__ __forceinline__ void copy_slice(const bf16* buf, const MDCta& m) {
  __syncthreads();  // the slice is written
  const uint32_t base = smem_addr(buf);
  for (int v = threadIdx.x; v < 16 * m.ml * (kCW / 8); v += kCThreads) {
    const int off = v / (kCW / 8) * m.ld + m.c * kCW + (v % (kCW / 8)) * 8;
    const uint4 val = *reinterpret_cast<const uint4*>(buf + off);
    for (int d = 1; d < m.C; ++d)
      st_peer(peer_addr(base + off * 2, (m.c + d) % m.C), val);
  }
}

// copy_slice, then a cluster barrier: afterwards every CTA holds all D
// columns.
__device__ __forceinline__ void push_slice(const bf16* buf, const MDCta& m) {
  copy_slice(buf, m);
  cluster_sync();
}

// A LayerNorm's statistics over the cluster's D columns: each warp's
// (mean, M2) of its 16 columns of each of its active rows to every CTA's
// stats[4 c + wc][row].  The caller's cluster barrier follows.
__device__ __forceinline__ void stats_push(const float (&v)[kCMT][2][4],
                                           const MDCta& m) {
  const CLane t = clane();
  const uint32_t base = smem_addr(m.stats);
#pragma unroll
  for (int i = 0; i < kCMT; ++i)
    if (ctile(t, i) < m.ml)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float* p0 = &v[i][0][2 * hf];
        const float* p1 = &v[i][1][2 * hf];
        const float mw = quad_sum(p0[0] + p0[1] + p1[0] + p1[1]) / 16.f;
        const float d0 = p0[0] - mw, d1 = p0[1] - mw, d2 = p1[0] - mw,
                    d3 = p1[1] - mw;
        const float m2 = quad_sum(d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3);
        if (t.tq == 0) {
          const uint32_t a =
              base + ((4 * m.c + t.wc) * kCRows + crow(t, i, hf)) * 8;
          for (int d = 0; d < m.C; ++d) st_peer(peer_addr(a, d), mw, m2);
        }
      }
}

// After the barrier: every active row's (mean, rstd) from the 4 C partials
// in rank order (Chan's combination of equal counts) into rowstat.
__device__ __forceinline__ void stats_combine(const MDCta& m) {
  const int n = 4 * m.C;
  for (int row = threadIdx.x; row < 16 * m.ml; row += kCThreads) {
    float2 p[4 * kCMaxC];
    float mean = 0.f;
#pragma unroll
    for (int s = 0; s < 4 * kCMaxC; ++s)
      if (s < n) {
        p[s] = m.stats[s * kCRows + row];
        mean += p[s].x;
      }
    mean /= n;
    float m2 = 0.f;
#pragma unroll
    for (int s = 0; s < 4 * kCMaxC; ++s)
      if (s < n) {
        const float d = p[s].x - mean;
        m2 += p[s].y + 16.f * d * d;
      }
    m.rowstat[row] = make_float2(mean, rsqrtf(m2 / m.D + kLnEps));
  }
  __syncthreads();
}

// v <- LayerNorm(v) with g, b of the D columns (statistics: stats_push, a
// cluster barrier, stats_combine).
__device__ __forceinline__ void ln_apply(float (&v)[kCMT][2][4],
                                         const MDCta& m, const bf16* g,
                                         const bf16* b) {
  const CLane t = clane();
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = m.c * kCW + ccol(t, nt);
    const float2 gv = ldg2(g + col), bv = ldg2(b + col);
#pragma unroll
    for (int i = 0; i < kCMT; ++i)
      if (ctile(t, i) < m.ml)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 st = m.rowstat[crow(t, i, hf)];
          float* e = &v[i][nt][2 * hf];
          e[0] = (e[0] - st.x) * st.y * gv.x + bv.x;
          e[1] = (e[1] - st.x) * st.y * gv.y + bv.y;
        }
  }
}

// v <- LayerNorm over the cluster, with its statistics exchanged.
__device__ __forceinline__ void cluster_ln(float (&v)[kCMT][2][4],
                                           const MDCta& m, const bf16* g,
                                           const bf16* b) {
  stats_push(v, m);
  cluster_sync();
  stats_combine(m);
  ln_apply(v, m, g, b);
}

// ---------------------------------------------------------------------------
// The FFN of the active rows, A (bf16, D wide) in xa: y = the CTA's columns
// of act(A W1^T + b1) W2^T (act: 0 ReLU, 1 erf GELU; without b2).  Per
// hidden chunk: the first product in 64-column passes into the hidden chunk
// (bf16, in big), then the second for each peer's columns, sent to it, and
// last the CTA's own, accumulated in y; after the chunks one cluster
// barrier, then the received partials added in rank and chunk order.
__device__ __forceinline__ void md_ffn(float (&y)[kCMT][2][4],
                                       const bf16* b1, int F, int act,
                                       MDStream& s, const MDClusterArgs& a,
                                       const MDCta& m) {
  const CLane t = clane();
  const int D = m.D, C = m.C, c = m.c, Fc = F / C, ldh = kCHC + 8;
  const unsigned lat = (1u << m.ml) - 1u;
  const uint32_t rbase = smem_addr(m.recv);
  bf16* hid = m.big;
  czero(y);
  for (int j = 0; j * kCHC < Fc; ++j) {
    const int cw = min(kCHC, Fc - j * kCHC);
    for (int p1 = 0; p1 < cw / kCW; ++p1) {
      float u[kCMT][2][4];
      czero(u);
      cgemm<kCMT>(u, m.xa, m.xa, m.xa, m.ld, D / kCKT, D / kCKT, lat, s, a,
                  m);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = p1 * kCW + ccol(t, nt);
        const float2 bv = ldg2(b1 + c * Fc + j * kCHC + col);
#pragma unroll
        for (int i = 0; i < kCMT; ++i)
          if (ctile(t, i) < m.ml)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const float h0 = u[i][nt][2 * hf] + bv.x;
              const float h1 = u[i][nt][2 * hf + 1] + bv.y;
              st2(hid + crow(t, i, hf) * ldh + col,
                  act ? gelu_erf(h0) : fmaxf(h0, 0.f),
                  act ? gelu_erf(h1) : fmaxf(h1, 0.f));
            }
      }
    }
    for (int d = 0; d < C; ++d) {
      const int p = (c + 1 + d) % C;
      if (p == c) {
        cgemm<kCMT>(y, hid, hid, hid, ldh, cw / kCKT, cw / kCKT, lat, s, a,
                    m);
        continue;
      }
      float u[kCMT][2][4];
      czero(u);
      cgemm<kCMT>(u, hid, hid, hid, ldh, cw / kCKT, cw / kCKT, lat, s, a, m);
      const uint32_t slot =
          rbase + ((c < p ? c : c - 1) * m.nch + j) * kCRows * kCW * 4;
#pragma unroll
      for (int i = 0; i < kCMT; ++i)
        if (ctile(t, i) < m.ml)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
              st_peer(peer_addr(slot + rpart(crow(t, i, hf), ccol(t, nt)) * 4,
                                p),
                      u[i][nt][2 * hf], u[i][nt][2 * hf + 1]);
    }
  }
  cluster_sync();
  for (int src = 0; src < C; ++src) {
    if (src == c) continue;
    for (int j = 0; j * kCHC < Fc; ++j) {
      const float* rp =
          m.recv + (size_t)((src < c ? src : src - 1) * m.nch + j) * kCRows *
                       kCW;
#pragma unroll
      for (int i = 0; i < kCMT; ++i)
        if (ctile(t, i) < m.ml)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const float2 q = *reinterpret_cast<const float2*>(
                  rp + rpart(crow(t, i, hf), ccol(t, nt)));
              y[i][nt][2 * hf] += q.x;
              y[i][nt][2 * hf + 1] += q.y;
            }
    }
  }
}

// ---------------------------------------------------------------------------
// Attention: row r of sample s sees its T latents (masked by their
// validity, kvs) and its E extra rows (always valid); 8 lanes per (row,
// head), DPL = Dh / 8 dimensions each; the context goes to the CTA's slice
// of xa.

template <int N>
__device__ __forceinline__ void ld_dims(const bf16* p, float (&f)[N]) {
  if constexpr (N == 1) {
    f[0] = tof(*p);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p + i));
      f[i] = v.x;
      f[i + 1] = v.y;
    }
  }
}

template <int DPL>
__device__ __forceinline__ void md_attend(const MDCta& m) {
  constexpr int kDh = 8 * DPL, kHp = kCW / kDh;
  const bf16* qs = m.big;
  const bf16* ks = qs + kCRows * kCLdQ;
  const bf16* vs = ks + (kCRows + kCExtra) * kCLdQ;
  const int li = threadIdx.x & 7, grp = threadIdx.x >> 3;
  const int ntask = m.nrow * kHp, nk = m.T + m.E;
  const float scale = rsqrtf((float)kDh);
  // a uniform trip count, so all 32 lanes reach every shuffle
  for (int base = 0; base < ntask; base += kCThreads / 8) {
    const int task = base + grp;
    const bool act = task < ntask;
    const int row = act ? task / kHp : 0, h = act ? task % kHp : 0;
    const int smp = row / m.T, col = h * kDh + li * DPL;
    float q[DPL], o[DPL];
    ld_dims<DPL>(qs + row * kCLdQ + col, q);
#pragma unroll
    for (int d = 0; d < DPL; ++d) o[d] = 0.f;
    float mx = -INFINITY, l = 0.f;
    // keys in chunks of 8: the chunk's scores are independent (one round of
    // shuffles for all 8), then one online-softmax update per chunk
    for (int j0 = 0; j0 < nk; j0 += 8) {
      float sc[8];
      int kr[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = min(j0 + u, nk - 1);
        kr[u] = j < m.T ? smp * m.T + j : kCRows + smp * m.E + (j - m.T);
        float kf[DPL];
        ld_dims<DPL>(ks + kr[u] * kCLdQ + col, kf);
        sc[u] = 0.f;
#pragma unroll
        for (int d = 0; d < DPL; ++d) sc[u] += q[d] * kf[d];
      }
#pragma unroll
      for (int o2 = 1; o2 < 8; o2 <<= 1)
#pragma unroll
        for (int u = 0; u < 8; ++u)
          sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o2);
      float cmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = j0 + u;
        sc[u] = j >= nk ? -INFINITY
                        : sc[u] * scale +
                              ((j < m.T && m.kvs[kr[u]] <= 0.5f) ? kNegInf
                                                                 : 0.f);
        cmax = fmaxf(cmax, sc[u]);
      }
      const float mn = fmaxf(mx, cmax), corr = __expf(mx - mn);
      l *= corr;
#pragma unroll
      for (int d = 0; d < DPL; ++d) o[d] *= corr;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float p = __expf(sc[u] - mn);
        float vf[DPL];
        ld_dims<DPL>(vs + kr[u] * kCLdQ + col, vf);
        l += p;
#pragma unroll
        for (int d = 0; d < DPL; ++d) o[d] += p * vf[d];
      }
      mx = mn;
    }
    if (act) {
      const float inv = 1.f / l;
      bf16* dst = m.xa + row * m.ld + m.c * kCW + col;
#pragma unroll
      for (int d = 0; d < DPL; ++d) dst[d] = tob(o[d] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// Rows in.

// The group's extra rows into ext (zero rows past the group): cp.async
// copies started (async) or plain loads.
template <bool kAsync>
__device__ __forceinline__ void md_load_extra(const MDClusterArgs& a,
                                              const MDCta& m) {
  const int D = a.D, nv = D / 8;
  for (int i = threadIdx.x; i < 16 * m.me * nv; i += kCThreads) {
    const int e = i / nv, cc = (i % nv) * 8;
    const bool in = e < m.nerow;
    const bf16* src = a.extra + ((size_t)m.s0 * a.E + (in ? e : 0)) * D + cc;
    bf16* dst = m.ext + e * m.ld + cc;
    if (kAsync)
      cp_async16_zfill(dst, src, in);
    else
      *reinterpret_cast<uint4*>(dst) =
          in ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
  }
}

// Starts a launch: the group's x rows into xa and extra rows into ext (zero
// rows past the group), the rows' latent validity into kvs, the weight
// stream's first slices in flight; returns with r the CTA's columns of x.
__device__ __forceinline__ void md_start(float (&r)[kCMT][2][4],
                                         MDStream& s, const MDClusterArgs& a,
                                         const MDCta& m) {
  const CLane t = clane();
  const int D = a.D, nv = D / 8;
  for (int i = threadIdx.x; i < 16 * m.ml * nv; i += kCThreads) {
    const int row = i / nv, cc = (i % nv) * 8;
    const bool in = row < m.nrow;
    cp_async16_zfill(m.xa + row * m.ld + cc,
                     a.x + (m.row0 + (in ? row : 0)) * D + cc, in);
  }
  md_load_extra<true>(a, m);
  cp_async_commit();
  for (int row = threadIdx.x; row < kCRows; row += kCThreads)
    m.kvs[row] =
        row < m.nrow && a.kvalid ? ldgf(a.kvalid + m.row0 + row) : 0.f;
  stream_start(s, a, m);
  cp_async_wait<kCStages - 1>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kCMT; ++i)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = crow(t, i, hf);
        float2 v = make_float2(0.f, 0.f);
        if (ctile(t, i) < m.ml && row < m.nrow)
          v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              m.xa + row * m.ld + m.c * kCW + ccol(t, nt)));
        r[i][nt][2 * hf] = v.x;
        r[i][nt][2 * hf + 1] = v.y;
      }
}

// ---------------------------------------------------------------------------
// The stylized FFN segment on the group's rows, layer l's tensors 16..23 of
// _PARAM_ORDER (their weights the stream's next segments).  Pre: xa holds
// the segment's input (every CTA, all D columns), r the CTA's columns of it
// (f32).  y = the GELU FFN of xa + b2 -> LayerNorm -> AdaLN -> SiLU -> the
// projection, added to r.  The AdaLN (scale, shift) row of the group's row
// `row` is ss + ((rbase + row) / T) ss_stride (0: one row for all; padding
// rows take the group's last row's).  K1 and kernel 11 pass the row
// group's first sample's row and rbase 0, kernel 6 its first row's index.
__device__ __forceinline__ void md_stylized_ffn(float (&r)[kCMT][2][4],
                                                MDStream& s,
                                                const MDClusterArgs& a,
                                                const MDCta& m, int l,
                                                const bf16* ss, int ss_stride,
                                                size_t rbase, int T) {
  const CLane t = clane();
  const int D = m.D, c = m.c, nk = D / kCKT;
  const unsigned lat = (1u << m.ml) - 1u;
  const auto wp = [&](int k) {
    return a.w[k] + (size_t)l * md_param_numel(k, D, a.F1, a.F2);
  };
  float y[kCMT][2][4];
  md_ffn(y, wp(17), a.F2, 1, s, a, m);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const float2 bv = ldg2(wp(19) + c * kCW + ccol(t, nt));
#pragma unroll
    for (int i = 0; i < kCMT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        y[i][nt][2 * hf] += bv.x;
        y[i][nt][2 * hf + 1] += bv.y;
      }
  }
  cluster_ln(y, m, wp(20), wp(21));
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = c * kCW + ccol(t, nt);
#pragma unroll
    for (int i = 0; i < kCMT; ++i)
      if (ctile(t, i) < m.ml)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = crow(t, i, hf);
          const bf16* st =
              ss + (size_t)((rbase + min(row, m.nrow - 1)) / T) * ss_stride;
          const float2 sc = ldg2(st + col), sh = ldg2(st + D + col);
          float* e = &y[i][nt][2 * hf];
          e[0] = silu(e[0] * (1.f + sc.x) + sh.x);
          e[1] = silu(e[1] * (1.f + sc.y) + sh.y);
        }
  }
  store_slice(y, m.big, m);
  push_slice(m.big, m);
  {
    float acc[kCMT][2][4];
    czero(acc);
    cgemm<kCMT>(acc, m.big, m.big, m.big, m.ld, nk, nk, lat, s, a, m);
    add_biased(r, acc, wp(23), c);
  }
}

// ---------------------------------------------------------------------------
// The one-token cross-attention segment: with one text token the
// softmax-linear cross-attention gives each row its sample's text value row
// times the row's mask m, and the segment is
//   r += W silu(LN(m v) * (1 + scale) + shift) + b
// with LN(m v) = m (v - mean) / sqrt(m^2 var + eps) * g + b_ln, exact for
// any mask value (mean, var: v's own).  md_value_stats, then (after a
// barrier) md_ca_rows, the exchange of big, and md_ca_project.

// The mean and variance of value rows 0..ns-1 (one a sample) into sstat.
__device__ __forceinline__ void md_value_stats(const MDCta& m,
                                               const bf16* value, int ns) {
  constexpr int kW = kCThreads / 32, kU = 3, kPer = 4 * kCMaxC / 2;
  const int D = m.D, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // up to kU samples a warp at once, their loads issued together
  for (int s0 = warp; s0 < ns; s0 += kU * kW) {
    float x[kU][kPer];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const bf16* v = value + (size_t)min(s0 + u * kW, ns - 1) * D;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        x[u][i] = lane + 32 * i < D ? ldgf(v + min(lane + 32 * i, D - 1))
                                    : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) sum += x[u][i];
      const float mean = warp_sum(sum) / D;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (lane + 32 * i < D) q += (x[u][i] - mean) * (x[u][i] - mean);
      q = warp_sum(q) / D;
      if (lane == 0 && s0 + u * kW < ns)
        m.sstat[s0 + u * kW] = make_float2(mean, q);
    }
  }
}

// The AdaLN -> SiLU rows of the CTA's 64 columns into big (row stride
// m.ld), for the next cluster exchange.  Row r of the group is row off + r
// of a stream of T-row samples: its sample s = (off + r) / T has value row
// value + s D, AdaLN row ss + s ss_stride (0: one row for all) and
// statistics sstat[s] (md_value_stats); its mask is kvs[r].  Padding rows
// are computed as the group's last row and stored as zeros.  K1 and kernel
// 11 pass off 0 (groups of whole samples), kernel 7 its first row's place
// in its sample.
__device__ __forceinline__ void md_ca_rows(const MDCta& m, const bf16* value,
                                           const bf16* ca_ss, int ca_stride,
                                           const bf16* g, const bf16* b,
                                           int T, int off) {
  const CLane t = clane();
  const int D = m.D;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = m.c * kCW + ccol(t, nt);
    const float2 gv = ldg2(g + col), bv = ldg2(b + col);
#pragma unroll
    for (int i = 0; i < kCMT; ++i)
      if (ctile(t, i) < m.ml)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = crow(t, i, hf);
          const int rr = min(row, m.nrow - 1), smp = (off + rr) / T;
          const float mk = m.kvs[rr];
          const float2 st = m.sstat[smp];
          const float k = mk * rsqrtf(mk * mk * st.y + kLnEps);
          const float2 v = ldg2(value + (size_t)smp * D + col);
          const bf16* ss = ca_ss + (size_t)smp * ca_stride;
          const float2 sc = ldg2(ss + col), sh = ldg2(ss + D + col);
          const float h0 =
              silu(((v.x - st.x) * k * gv.x + bv.x) * (1.f + sc.x) + sh.x);
          const float h1 =
              silu(((v.y - st.x) * k * gv.y + bv.y) * (1.f + sc.y) + sh.y);
          const bool in = row < m.nrow;
          st2(m.big + row * m.ld + col, in ? h0 : 0.f, in ? h1 : 0.f);
        }
  }
}

// r += the projection of big (every CTA, all D columns) + bias; its weight
// slices are the stream's next segment.
__device__ __forceinline__ void md_ca_project(float (&r)[kCMT][2][4],
                                              MDStream& s,
                                              const MDClusterArgs& a,
                                              const MDCta& m,
                                              const bf16* bias) {
  const int nk = m.D / kCKT;
  float acc[kCMT][2][4];
  czero(acc);
  cgemm<kCMT>(acc, m.big, m.big, m.big, m.ld, nk, nk, (1u << m.ml) - 1u, s,
              a, m);
  add_biased(r, acc, bias, m.c);
}

// ---------------------------------------------------------------------------
// One MD layer on the group's rows.  Pre: xa holds x (every CTA, all D
// columns), ext the extra rows, r the CTA's columns of x (f32).  value: the
// text value row of the group's first sample on; ca_ss / ffn_ss: the AdaLN
// (scale, shift) row of the group's first sample, `*_stride` elements
// between samples (0: one row shared by all).  Ends by calling epi(v) with
// v the CTA's columns of the layer's f32 output.
template <typename Epi>
__device__ __forceinline__ void md_layer_cl(float (&r)[kCMT][2][4],
                                            MDStream& s,
                                            const MDClusterArgs& a,
                                            const MDCta& m, int l,
                                            const bf16* value,
                                            const bf16* ca_ss, int ca_stride,
                                            const bf16* ffn_ss,
                                            int ffn_stride, Epi epi) {
  const int D = m.D, c = m.c, nk = D / kCKT;
  const unsigned lat = (1u << m.ml) - 1u;
  const unsigned kvm = lat | (((1u << m.me) - 1u) << kCLT);
  // layer l's tensor k of _PARAM_ORDER, at its use (not held in registers)
  const auto wp = [&](int k) {
    return a.w[k] + (size_t)l * md_param_numel(k, D, a.F1, a.F2);
  };
  bf16* qs = m.big;
  bf16* ks = qs + kCRows * kCLdQ;
  bf16* vs = ks + (kCRows + kCExtra) * kCLdQ;

  // the text value rows' statistics; read after later barriers
  md_value_stats(m, value, m.ns);

  // k, v of the latent and extra rows, q of the latent rows (CTA-local)
  for (int part = 1; part <= 2; ++part) {
    float acc[kCKVT][2][4];
    czero(acc);
    cgemm<kCKVT>(acc, m.xa, m.xa, m.ext, m.ld, nk, nk, kvm, s, a, m);
    store_biased_cl(acc, wp(1) + part * D + c * kCW, part == 1 ? ks : vs,
                    kvm);
  }
  {
    float acc[kCMT][2][4];
    czero(acc);
    cgemm<kCMT>(acc, m.xa, m.xa, m.xa, m.ld, nk, nk, lat, s, a, m);
    store_biased_cl(acc, wp(1) + c * kCW, qs, lat);
  }
  cluster_arrive();  // this CTA has read x in xa
  __syncthreads();   // q, k, v stored
  switch ((D / a.H) / 8) {
    case 8: md_attend<8>(m); break;
    case 4: md_attend<4>(m); break;
    case 2: md_attend<2>(m); break;
    default: md_attend<1>(m); break;
  }
  cluster_wait();  // every CTA has read its x: the context may overwrite it
  push_slice(m.xa, m);

  // out-projection + residual -> LN1
  {
    float acc[kCMT][2][4];
    czero(acc);
    cgemm<kCMT>(acc, m.xa, m.xa, m.xa, m.ld, nk, nk, lat, s, a, m);
    add_biased(r, acc, wp(3), c);
  }
  cluster_ln(r, m, wp(4), wp(5));
  store_slice(r, m.xa, m);
  push_slice(m.xa, m);

  // ReLU FFN + residual -> LN2; the cross-attention's AdaLN rows travel
  // with LN2's statistics
  float y[kCMT][2][4];
  md_ffn(y, wp(7), a.F1, 0, s, a, m);
  add_biased(r, y, wp(9), c);
  md_ca_rows(m, value, ca_ss, ca_stride, wp(12), wp(13), m.T, 0);
  copy_slice(m.big, m);
  stats_push(r, m);
  cluster_sync();
  stats_combine(m);
  ln_apply(r, m, wp(10), wp(11));

  // cross-attention projection + residual: x3
  md_ca_project(r, s, a, m, wp(15));
  store_slice(r, m.xa, m);
  push_slice(m.xa, m);

  // stylized GELU FFN -> LN -> AdaLN -> SiLU -> projection + residual
  md_stylized_ffn(r, s, a, m, l, ffn_ss, ffn_stride, 0, m.T);
  epi(r);
}

// The launch: one cluster of C CTAs per row group (K1, 11, 6 and 7).
// Internal linkage: each library keeps its own kernel and shared-memory
// grants (see attn_tile.cuh).
template <typename Kern>
static inline cudaError_t md_cluster_launch(Kern kernel,
                                            const MDClusterArgs& a,
                                            SmemGrant& grant,
                                            cudaStream_t stream) {
  if (!(a.ffn_only || a.ca_only ? seg_cluster_valid(a) : md_cluster_valid(a)))
    return cudaErrorInvalidValue;
  const size_t bytes = md_cluster_bytes(a);
  if (!allow_smem(kernel, bytes, grant)) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.groups * a.C);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Clusters of C CTAs that can be resident at once (0 when the query fails):
// the row-group count that fills the card once.  a: D, F1, F2 and ca_only
// (md_cluster_bytes).
template <typename Kern>
static inline int md_cluster_slots(Kern kernel, const MDClusterArgs& a,
                                   SmemGrant& grant) {
  const int D = a.D;
  if (D < kCW || D % kCW || D / kCW > kCMaxC) return 0;
  const size_t bytes = md_cluster_bytes(a);
  if (!allow_smem(kernel, bytes, grant)) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(D / kCW);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = D / kCW;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// K1, kernel 11 and kernel 6: the layer's layout at width D, FFN widths F1,
// F2.
template <typename Kern>
static inline int md_cluster_slots(Kern kernel, int D, int F1, int F2,
                                   SmemGrant& grant) {
  MDClusterArgs a = {};
  a.D = D;
  a.F1 = F1;
  a.F2 = F2;
  return md_cluster_slots(kernel, a, grant);
}

}  // namespace ladiff
