// Kernel 8: the self-attention segment of a transformer layer in training,
// forward and backward (replaces ladiff_tpu/ops/pallas_train_attention.py
// train_self_attention).  See ladiff_torch/ops/train_attention.py for the
// math, the dropout contract, what is saved and the weight-gradient scheme.
//
// Forward, a fixed sequence of launches (the products on the sm90 GEMM
// block, train_gemm.cuh):
//   qkv product        qkv = x Wqkv^T + bqkv                    [M, 3D]
//   attn_fwd_kernel    64-query x 64-key tiles, online softmax, probability
//                      dropout; writes ctx [M, D] and the log-sum-exp [M, H]
//   out product        out = x + (ctx Wout^T + bout) * residual mask
// Backward:
//   dattn_kernel       dattn = dout * residual mask (rate 0: dout itself)
//   dctx product       dctx = dattn Wout; delta = dctx . ctx per row and
//                      head
//   attn_bwd_kernel x2 probabilities recomputed from q, k and the log-sum-exp;
//                      one launch owns query tiles (dq), one owns key tiles
//                      (dk, dv)
//   dx product         dx = dout + dqkv Wqkv
//   weight gradients   dWqkv = dqkv^T x, dWout = dattn^T ctx over K ranges
//                      with a fixed-order sum; dbqkv, dbout column sums
#include "train_attn.cuh"
#include "train_gemm.cuh"

namespace {

// dattn = bf16(dout * residual mask) (mask 1, element i of [M, D]), 8
// elements a thread: two Philox blocks.
__global__ void dattn_kernel(const bf16* dout, size_t n8, Dropout drop,
                             bf16* dattn) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(dout) + i);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  uint4 o;
  __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const uint64_t q = 2 * i + b;  // elements 4 q .. 4 q + 3
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32),
                   1u, 0u),
        drop.key0, drop.key1);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float2 f = __bfloat1622float2(h[2 * b + e]);
      oh[2 * b + e] = __floats2bfloat162_rn(
          f.x * (bits[2 * e] < drop.thresh ? drop.inv_keep : 0.f),
          f.y * (bits[2 * e + 1] < drop.thresh ? drop.inv_keep : 0.f));
    }
  }
  reinterpret_cast<uint4*>(dattn)[i] = o;
}

}  // namespace

LADIFF_ERROR_STRING_FN

// ptrs: x [M, D] bf16, kvalid [M] f32, in_w [3D, D], in_b, out_w [D, D],
// out_b (bf16), then what the backward reuses: qkv [M, 3D], ctx [M, D]
// (bf16), lse [M, H] (f32), and out [M, D] (bf16).  ints: B, S, D, H, seed
// lo, seed hi, then the geometry (BN, CTAs) of the qkv and out products.
// floats: rate.
extern "C" int train_attention_forward(const void** p, const int* n,
                                       const float* f, void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  const int B = n[0], S = n[1], D = n[2], H = n[3];
  if (!shape_ok(B, S, D, H)) return cudaErrorInvalidValue;
  const int M = B * S;
  const Dropout drop = make_dropout(n[4], n[5], f[0]);
  const bool on = f[0] > 0.f;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* x = w[0];
  const float* kvalid = reinterpret_cast<const float*>(p[1]);
  bf16* qkv = const_cast<bf16*>(w[6]);
  bf16* ctx = const_cast<bf16*>(w[7]);
  float* lse = reinterpret_cast<float*>(const_cast<void*>(p[8]));
  bf16* out = const_cast<bf16*>(w[9]);
  cudaError_t err;
  if ((err = qkv_product(gemm_geo(n + 6), x, w[2], w[3], qkv, M, D,
                         stream)) != cudaSuccess)
    return err;
  if ((err = launch_attn_fwd(qkv, kvalid, ctx, lse, B, S, D, H, drop, on,
                             stream)) != cudaSuccess)
    return err;
  sm90::GemmArgs g = gemm_args(M, D, D, w[5], out, x);
  if (!on)
    return gemm_at<sm90::kEpiAdd, false, false>(gemm_geo(n + 8), ctx, w[4], g,
                                                stream);
  g.drop = drop;
  g.mask_id = 1u;
  return gemm_at<sm90::kEpiAddDrop, false, false>(gemm_geo(n + 8), ctx, w[4],
                                                  g, stream);
}

// ptrs: x [M, D] bf16, kvalid [M] f32, dout [M, D] bf16; in_w, in_b, out_w,
// out_b (bf16); the forward's qkv, ctx (bf16), lse (f32); scratch dattn
// [M, D], dctx [M, D] (bf16), delta [M, H] (f32), dqkv [M, 3D] (bf16), wpart
// (f32: the weight gradients' partials, then the column sums'); dx [M, D]
// (bf16); d_in_w [3D, D], d_in_b, d_out_w [D, D], d_out_b (f32).  ints: B,
// S, D, H, seed lo, seed hi, the column sums' row ranges, then the geometry
// of the dctx and dx products (BN, CTAs) and of the dWqkv and dWout
// products (BN, CTAs, K ranges, rows a range).  floats: rate.
extern "C" int train_attention_backward(const void** p, const int* n,
                                        const float* f, void* stream_ptr) {
  const bf16** w = reinterpret_cast<const bf16**>(p);
  auto fptr = [&](int i) {
    return reinterpret_cast<float*>(const_cast<void*>(p[i]));
  };
  const int B = n[0], S = n[1], D = n[2], H = n[3], split = n[6];
  if (!shape_ok(B, S, D, H) || split < 1) return cudaErrorInvalidValue;
  const int M = B * S;
  const Dropout drop = make_dropout(n[4], n[5], f[0]);
  const bool on = f[0] > 0.f;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* x = w[0];
  const float* kvalid = fptr(1);
  const bf16* dout = w[2];
  const bf16 *in_w = w[3], *out_w = w[5];
  const bf16 *qkv = w[7], *ctx = w[8];
  const float* lse = fptr(9);
  bf16* dattn = const_cast<bf16*>(w[10]);
  bf16* dctx = const_cast<bf16*>(w[11]);
  float* delta = fptr(12);
  bf16* dqkv = const_cast<bf16*>(w[13]);
  float* wpart = fptr(14);
  bf16* dx = const_cast<bf16*>(w[15]);
  float *d_in_w = fptr(16), *d_in_b = fptr(17), *d_out_w = fptr(18),
        *d_out_b = fptr(19);
  cudaError_t err;
  if (on) {
    const size_t n8 = (size_t)M * D / 8;
    dattn_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, stream>>>(
        dout, n8, drop, dattn);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  } else {
    dattn = const_cast<bf16*>(dout);  // the mask is all ones
  }
  sm90::GemmArgs g = gemm_args(M, D, D, nullptr, dctx, ctx);
  g.delta = delta;
  g.H = H;
  g.dh = D / H;
  if ((err = gemm_at<sm90::kEpiDctx, false, true>(gemm_geo(n + 7), dattn,
                                                  out_w, g, stream)) !=
      cudaSuccess)
    return err;
  if ((err = launch_attn_bwd(qkv, dctx, kvalid, lse, delta, dqkv, B, S, D,
                             H, drop, on, stream)) != cudaSuccess)
    return err;
  if ((err = dx_product(gemm_geo(n + 9), dqkv, in_w, dout, dx, M, D,
                        stream)) != cudaSuccess)
    return err;
  if ((err = weight_grad_sm90(gemm_geo(n + 11, true), dqkv, 3 * D, x, D, M,
                              wpart, d_in_w, stream)) != cudaSuccess)
    return err;
  if ((err = bias_grad(dqkv, 3 * D, 3 * D, M, split, wpart, d_in_b,
                       stream)) != cudaSuccess)
    return err;
  if ((err = weight_grad_sm90(gemm_geo(n + 15, true), dattn, D, ctx, D, M,
                              wpart, d_out_w, stream)) != cudaSuccess)
    return err;
  return bias_grad(dattn, D, D, M, split, wpart, d_out_b, stream);
}

// ptrs: pm [B, H, S, S], rm [M, D] (f32): the keep-masks of a seed.  ints:
// B, S, D, H, seed lo, seed hi.  floats: rate.
extern "C" int train_attention_masks(const void** p, const int* n,
                                     const float* f, void* stream_ptr) {
  float* pm = reinterpret_cast<float*>(const_cast<void*>(p[0]));
  float* rm = reinterpret_cast<float*>(const_cast<void*>(p[1]));
  const unsigned long long B = n[0], S = n[1], D = n[2], H = n[3];
  const Dropout d = make_dropout(n[4], n[5], f[0]);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = fill_mask(pm, B * H * S * S, d, 0u, stream);
  if (err != cudaSuccess) return err;
  return fill_mask(rm, B * S * D, d, 1u, stream);
}

// One product alone, for holding each variant of the GEMM block to its
// float32 product: out = epilogue(A W^T [+ bias]) with A [M, K] (a_mn:
// stored [K, M]) and W [N, K] (b_mn: stored [K, N]).
// ptrs: A, W, bias (or null), out (bf16, or f32 [splits M, N] for the
// partial epilogue), resid (or null), delta (the dctx epilogue's, or null).
// ints: M, N, K, epilogue (sm90::Epilogue: bias, add, add_drop, dctx,
// part), a_mn, b_mn, BN, CTAs, splits, rows a split, H, seed lo, seed hi.
// floats: rate.  The combinations are those of kernels 8 and 12.
extern "C" int train_gemm(const void** p, const int* n, const float* f,
                          void* stream_ptr) {
  const bf16* A = static_cast<const bf16*>(p[0]);
  const bf16* W = static_cast<const bf16*>(p[1]);
  sm90::GemmArgs g =
      gemm_args(n[0], n[1], n[2], static_cast<const bf16*>(p[2]),
                const_cast<void*>(p[3]), p[4]);
  const int epi = n[3], a_mn = n[4], b_mn = n[5];
  const GemmGeo geo = {n[6], n[7], n[8], n[9]};
  g.H = n[10];
  g.dh = g.H > 0 ? g.N / g.H : 0;
  g.delta = reinterpret_cast<float*>(const_cast<void*>(p[5]));
  g.drop = make_dropout(n[11], n[12], f[0]);
  g.mask_id = 1u;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (!a_mn && !b_mn) {
    if (epi == sm90::kEpiBias)
      return gemm_at<sm90::kEpiBias, false, false>(geo, A, W, g, s);
    if (epi == sm90::kEpiAdd)
      return gemm_at<sm90::kEpiAdd, false, false>(geo, A, W, g, s);
    if (epi == sm90::kEpiAddDrop)
      return gemm_at<sm90::kEpiAddDrop, false, false>(geo, A, W, g, s);
  } else if (!a_mn && b_mn) {
    if (epi == sm90::kEpiDctx)
      return gemm_at<sm90::kEpiDctx, false, true>(geo, A, W, g, s);
    if (epi == sm90::kEpiAdd)
      return gemm_at<sm90::kEpiAdd, false, true>(geo, A, W, g, s);
  } else if (a_mn && b_mn && epi == sm90::kEpiPart) {
    return gemm_at<sm90::kEpiPart, true, true>(geo, A, W, g, s);
  }
  return cudaErrorInvalidValue;
}
