// Kernel 8: the self-attention segment of a transformer layer in training,
// forward and backward (replaces ladiff_tpu/ops/pallas_train_attention.py
// train_self_attention).  See ladiff_torch/ops/train_attention.py for the
// math, the dropout contract, what is saved and the weight-gradient scheme.
//
// Forward, a fixed sequence of launches:
//   linear_kernel      qkv = x Wqkv^T + bqkv                    [M, 3D]
//   attn_fwd_kernel    64-query x 64-key tiles, online softmax, probability
//                      dropout; writes ctx [M, D] and the log-sum-exp [M, H]
//   out_proj_kernel    out = x + (ctx Wout^T + bout) * residual mask
// Backward:
//   dctx_kernel        dattn = dout * residual mask; dctx = dattn Wout;
//                      delta = dctx . ctx per row and head
//   attn_bwd_kernel x2 probabilities recomputed from q, k and the log-sum-exp;
//                      one launch owns query tiles (dq), one owns key tiles
//                      (dk, dv)
//   linear_nn_kernel   dx = dout + dqkv Wqkv
//   wgrad / colsum + reduce   dWqkv = dqkv^T x, dbqkv, dWout = dattn^T ctx,
//                      dbout
#include "train_attn.cuh"

LADIFF_ERROR_STRING_FN

// ptrs: x [M, D] bf16, kvalid [M] f32, in_w [3D, D], in_b, out_w [D, D],
// out_b (bf16), then what the backward reuses: qkv [M, 3D], ctx [M, D]
// (bf16), lse [M, H] (f32), and out [M, D] (bf16).  ints: B, S, D, H, seed
// lo, seed hi.  floats: rate.
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

  const size_t rb = row_gemm_bytes(D);
  static SmemGrant g_lin, g_out0, g_out1;
  if (!allow_smem(linear_kernel, rb, g_lin) ||
      !allow_smem(out_proj_kernel<false>, rb, g_out0) ||
      !allow_smem(out_proj_kernel<true>, rb, g_out1))
    return cudaErrorInvalidValue;
  const int blocks = (M + kRows - 1) / kRows;
  cudaError_t err;
  linear_kernel<<<dim3(blocks, (3 * D + kChunk - 1) / kChunk), kThreads, rb,
                  stream>>>(x, M, D, w[2], w[3], 3 * D, qkv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_attn_fwd(qkv, kvalid, ctx, lse, B, S, D, H, drop, on,
                             stream)) != cudaSuccess)
    return err;
  if (on)
    out_proj_kernel<true><<<blocks, kThreads, rb, stream>>>(
        ctx, x, M, D, w[4], w[5], drop, out);
  else
    out_proj_kernel<false><<<blocks, kThreads, rb, stream>>>(
        ctx, x, M, D, w[4], w[5], drop, out);
  return cudaGetLastError();
}

// ptrs: x [M, D] bf16, kvalid [M] f32, dout [M, D] bf16; in_w, in_b, out_w,
// out_b (bf16); the forward's qkv, ctx (bf16), lse (f32); scratch dattn
// [M, D], dctx [M, D] (bf16), delta [M, H] (f32), dqkv [M, 3D] (bf16), wpart
// [split, 3 D D] (f32); dx [M, D] (bf16); d_in_w [3D, D], d_in_b, d_out_w
// [D, D], d_out_b (f32).  ints: B, S, D, H, seed lo, seed hi, split.
// floats: rate.
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

  const size_t rb = row_gemm_bytes(D), rb3 = row_gemm_bytes(3 * D);
  static SmemGrant g_dc0, g_dc1, g_dx;
  if (!allow_smem(dctx_kernel<false>, rb, g_dc0) ||
      !allow_smem(dctx_kernel<true>, rb, g_dc1) ||
      !allow_smem(linear_nn_kernel, rb3, g_dx))
    return cudaErrorInvalidValue;
  const int blocks = (M + kRows - 1) / kRows;
  cudaError_t err;
  if (on)
    dctx_kernel<true><<<blocks, kThreads, rb, stream>>>(
        dout, ctx, M, D, H, out_w, drop, dattn, dctx, delta);
  else
    dctx_kernel<false><<<blocks, kThreads, rb, stream>>>(
        dout, ctx, M, D, H, out_w, drop, dattn, dctx, delta);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_attn_bwd(qkv, dctx, kvalid, lse, delta, dqkv, B, S, D,
                             H, drop, on, stream)) != cudaSuccess)
    return err;
  linear_nn_kernel<<<blocks, kThreads, rb3, stream>>>(dqkv, M, 3 * D, in_w,
                                                   D, dout, dx);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = weight_grad(dqkv, 3 * D, 3 * D, x, D, D, M, split, wpart, d_in_w,
                         stream)) != cudaSuccess) return err;
  if ((err = bias_grad(dqkv, 3 * D, 3 * D, M, split, wpart, d_in_b,
                       stream)) != cudaSuccess) return err;
  if ((err = weight_grad(dattn, D, D, ctx, D, D, M, split, wpart, d_out_w,
                         stream)) != cudaSuccess) return err;
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
