// Kernel K2: one whole post-norm transformer decoder layer (replaces
// ladiff_tpu/ops/pallas_decoder_layer.py fused_decoder_layer).  See
// ladiff_torch/ops/decoder_layer.py for the math, the bound and why it is a
// fixed sequence of four launches:
//   proj_kernel x2      q/k/v of the frame rows; k/v of the memory rows
//   attn_tile_kernel    register-resident 64-query flash tile, key tiles
//                       through a cp.async ring, online softmax in
//                       registers (attn_tile.cuh, shared with kernel 10)
//   tail_kernel         out-proj + LN1, cross-attention, out-proj + LN2,
//                       FFN, LN3, per 32-row block
#include "attn_tile.cuh"

using namespace ladiff;

namespace {

// out[M, N] = A[M, K] W^T + b (bf16 in, f32 accumulation, bf16 out); one
// block per 32 rows x 256 output columns.
__global__ void __launch_bounds__(kThreads)
proj_kernel(const bf16* A, int M, int K, const bf16* W, const bf16* bias,
            int N, bf16* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = K + 8, ldc = kChunk + 4;
  bf16* xb = reinterpret_cast<bf16*>(smem);
  float* cf = reinterpret_cast<float*>(smem + align128(kRows * ld * sizeof(bf16)));
  bf16* ws = reinterpret_cast<bf16*>(
      reinterpret_cast<unsigned char*>(cf) + kRows * ldc * sizeof(float));
  const size_t row0 = (size_t)blockIdx.x * kRows;
  const int nrow = min(kRows, (int)(M - row0));
  const int n0 = blockIdx.y * kChunk;
  const int nc = min(kChunk, N - n0);
  for (int i = threadIdx.x; i < kRows * K; i += blockDim.x) {
    const int row = i / K, c = i % K;
    xb[row * ld + c] = row < nrow ? ldg(A + (row0 + row) * K + c) : tob(0.f);
  }
  __syncthreads();
  block_gemm(xb, ld, W + (size_t)n0 * K, K, K, nc, cf, ldc, false, ws);
  for (int i = threadIdx.x; i < nrow * nc; i += blockDim.x) {
    const int row = i / nc, c = i % nc;
    out[(row0 + row) * N + n0 + c] =
        tob(cf[row * ldc + c] + ldgf(bias + n0 + c));
  }
}

struct TailArgs {
  const bf16* x;
  const bf16* ctx;
  const bf16* kv2;
  const float* mvalid;
  const bf16 *sa_out_w, *sa_out_b, *ln1_w, *ln1_b, *ca_in_w, *ca_in_b;
  const bf16 *ca_out_w, *ca_out_b, *ln2_w, *ln2_b, *w1, *b1, *w2, *b2;
  const bf16 *ln3_w, *ln3_b;
  bf16* out;
  int M, T, L, D, H, F, act;
};

struct TailLayout {
  size_t xb, qb, cf, r, hid, ws, total;
};

inline TailLayout tail_layout(int D, int F) {
  TailLayout L;
  const size_t ld = D + 8;
  L.xb = 0;
  L.qb = align128(L.xb + kRows * ld * sizeof(bf16));
  L.cf = align128(L.qb + kRows * ld * sizeof(bf16));
  L.r = align128(L.cf + kRows * (kChunk + 4) * sizeof(float));
  L.hid = align128(L.r + kRows * D * sizeof(float));
  L.ws = align128(L.hid + kRows * (F + 8) * sizeof(bf16));
  L.total = align128(L.ws + kWStageBytes);
  return L;
}

__global__ void __launch_bounds__(kThreads)
tail_kernel(TailArgs a, TailLayout Lt) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = a.D, H = a.H;
  const int ld = D + 8, ldc = kChunk + 4, ldh = a.F + 8;
  bf16* xb = reinterpret_cast<bf16*>(smem + Lt.xb);
  bf16* qb = reinterpret_cast<bf16*>(smem + Lt.qb);
  float* cf = reinterpret_cast<float*>(smem + Lt.cf);
  float* r = reinterpret_cast<float*>(smem + Lt.r);
  bf16* hid = reinterpret_cast<bf16*>(smem + Lt.hid);
  bf16* ws = reinterpret_cast<bf16*>(smem + Lt.ws);
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * kRows;
  const int nrow = min(kRows, (int)(a.M - row0));

  // 1. self-attention context in; out-projection + residual -> LN1
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    xb[row * ld + c] = row < nrow ? ldg(a.ctx + (row0 + row) * D + c) : tob(0.f);
  }
  __syncthreads();
  block_gemm(xb, ld, a.sa_out_w, D, D, D, cf, ldc, false, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    const float xv = row < nrow ? ldgf(a.x + (row0 + row) * D + c) : 0.f;
    r[i] = xv + cf[row * ldc + c] + ldgf(a.sa_out_b + c);
  }
  __syncthreads();
  block_layernorm_rows(r, D, r, D, xb, ld, D, a.ln1_w, a.ln1_b);
  __syncthreads();

  // 2. cross-attention of each row into its sample's <= L memory rows
  block_gemm(xb, ld, a.ca_in_w, D, D, D, cf, ldc, false, ws);
  store_biased(cf, ldc, a.ca_in_b, D, qb, ld);
  __syncthreads();
  cross_attend_rows<false>(qb, ld, a.kv2, a.mvalid, row0, nrow, a.T, a.L, D,
                           H, Dropout{}, 0u, xb);
  __syncthreads();
  block_gemm(xb, ld, a.ca_out_w, D, D, D, cf, ldc, false, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    r[i] += cf[row * ldc + c] + ldgf(a.ca_out_b + c);
  }
  __syncthreads();
  block_layernorm_rows(r, D, r, D, xb, ld, D, a.ln2_w, a.ln2_b);
  __syncthreads();

  // 3. FFN + residual -> LN3
  block_ffn(xb, ld, D, a.w1, a.b1, a.w2, a.F, a.act, hid, ldh, cf, ldc, ws);
  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int row = i / D, c = i % D;
    r[i] += cf[row * ldc + c] + ldgf(a.b2 + c);
  }
  __syncthreads();
  block_layernorm_rows(r, D, r, D, xb, ld, D, a.ln3_w, a.ln3_b);
  __syncthreads();
  for (int i = tid; i < nrow * D; i += blockDim.x)
    a.out[row0 * D + i] = tob(r[i]);
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x, kvalid, mem, mvalid, 18 weights (ops/decoder_layer.py
// _PARAM_ORDER), then the scratch qkv [B*T, 3D], kv2 [B*L, 2D], ctx
// [B*T, D] and the output [B*T, D].  ints: B, T, L, D, H, F, act.
extern "C" int decoder_layer_forward(const void** p, const int* n,
                                     const float*, void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  const int B = n[0], T = n[1], Lm = n[2], D = n[3], H = n[4], F = n[5];
  if (D % 32 || D > kChunk || D % H || (D / H) % 16 || D / H > 128 || F % kKT)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* x = w[0];
  const float* kvalid = reinterpret_cast<const float*>(p[1]);
  const bf16* mem = w[2];
  const float* mvalid = reinterpret_cast<const float*>(p[3]);
  const bf16** q = w + 4;
  bf16* qkv = const_cast<bf16*>(w[22]);
  bf16* kv2 = const_cast<bf16*>(w[23]);
  bf16* ctx = const_cast<bf16*>(w[24]);
  bf16* out = const_cast<bf16*>(w[25]);
  const int M = B * T, ML = B * Lm;

  const size_t proj_bytes = align128(kRows * (D + 8) * sizeof(bf16)) +
                            kRows * (kChunk + 4) * sizeof(float) + kWStageBytes;
  const TailLayout Lt = tail_layout(D, F);
  static SmemGrant g_proj, g_tail;
  if (!allow_smem(proj_kernel, proj_bytes, g_proj) ||
      !allow_smem(tail_kernel, Lt.total, g_tail))
    return cudaErrorInvalidValue;
  cudaError_t err;
  proj_kernel<<<dim3((M + kRows - 1) / kRows, (3 * D + kChunk - 1) / kChunk),
                kThreads, proj_bytes, stream>>>(x, M, D, q[0], q[1], 3 * D, qkv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // memory k/v: rows D..3D of the cross-attention in-projection
  proj_kernel<<<dim3((ML + kRows - 1) / kRows, (2 * D + kChunk - 1) / kChunk),
                kThreads, proj_bytes, stream>>>(mem, ML, D, q[6] + (size_t)D * D,
                                                q[7] + D, 2 * D, kv2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // q, k, v: the thirds of the packed projection, row stride 3D
  AttnArgs at;
  at.q = qkv; at.k = qkv + D; at.v = qkv + 2 * D;
  at.kvalid = kvalid; at.out = ctx;
  at.T = T; at.Dh = D / H; at.ld = 3 * D; at.ldo = D;
  if ((err = launch_attn_tiles(at, B, H, stream)) != cudaSuccess) return err;
  TailArgs a;
  a.x = x; a.ctx = ctx; a.kv2 = kv2; a.mvalid = mvalid;
  a.sa_out_w = q[2]; a.sa_out_b = q[3]; a.ln1_w = q[4]; a.ln1_b = q[5];
  a.ca_in_w = q[6]; a.ca_in_b = q[7]; a.ca_out_w = q[8]; a.ca_out_b = q[9];
  a.ln2_w = q[10]; a.ln2_b = q[11]; a.w1 = q[12]; a.b1 = q[13];
  a.w2 = q[14]; a.b2 = q[15]; a.ln3_w = q[16]; a.ln3_b = q[17];
  a.out = out;
  a.M = M; a.T = T; a.L = Lm; a.D = D; a.H = H; a.F = F; a.act = n[6];
  tail_kernel<<<(M + kRows - 1) / kRows, kThreads, Lt.total, stream>>>(a, Lt);
  return cudaGetLastError();
}
