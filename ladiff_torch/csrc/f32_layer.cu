// The float32 counterparts of K1 (fused_md_layer), K2 (fused_decoder_layer),
// kernel 5 (fused_postnorm_ffn) and kernel 10 (pallas_masked_attention):
// replaces the same four TPU kernels as their bf16 versions
// (ladiff_tpu/ops/pallas_md_layer.py:198, pallas_decoder_layer.py:234,
// pallas_postnorm_ffn.py:64, pallas_attention.py:52), at the type of every
// published configuration (TRAIN.MIXED_PRECISION false).  Each of the four
// is a short chain of three kernels of f32_tile.cuh behind its wrapper
// (ladiff_torch/ops/f32_layer.py):
//
//   f32_linear     C = act(A W^T + b) (+ R): gemm_f32_kernel with both
//                  operands K-contiguous (16-byte cp.async pieces), bias,
//                  ReLU or exact-erf GELU and a residual in the epilogue.
//   f32_rownorm    one warp a row: LayerNorm of an optionally row-scaled
//                  source row, then optionally AdaLN and SiLU: the MD
//                  layer's stylization.
//   f32_attention  masked softmax attention over one or two key sources
//                  (the MD layer's latent keys under their mask and its
//                  always-valid text and time keys), a masked key's logit
//                  -1e9 as the plain versions have it, so a sample without a
//                  valid key attends uniformly.
//
// What bounds them on the H100: at the shapes of the published paths every
// product is float32 at 4 bytes an element; the FFMA pipes' 67 TFLOP/s are
// the ceiling of this design.  No product uses bf16 operands, TF32 or a
// library call.
#include "f32_tile.cuh"

using namespace ladiff;
using namespace ladiff::f32;

LADIFF_ERROR_STRING_FN

// ptrs: A (row stride lda), W [N, K], bias [N] or null, R (row stride ldr)
// or null, C (row stride ldc); all float32.  ints: M, N, K, lda, ldr, ldc,
// act (0 none, 1 ReLU, 2 exact-erf GELU).
extern "C" int f32_linear(const void** p, const int* n, const float*,
                          void* stream_ptr) {
  GemmArgs g = {};
  g.A = static_cast<const float*>(p[0]);
  g.lda = n[3];
  g.B = static_cast<const float*>(p[1]);
  g.ldb = n[2];
  g.C = static_cast<float*>(const_cast<void*>(p[4]));
  g.ldc = n[5];
  g.M = n[0];
  g.N = n[1];
  g.K = n[2];
  g.ksplit = n[2];
  g.e.bias = static_cast<const float*>(p[2]);
  g.e.act = n[6];
  g.e.R = static_cast<const float*>(p[3]);
  g.e.ldr = n[4];
  return gemm_f32(g, false, false, static_cast<cudaStream_t>(stream_ptr));
}

// ptrs: src (row stride lds), row_scale [M] or null, w [D], b [D], ss
// [rows, 2D] or null, out (row stride ldo); all float32.  ints: M, D, lds,
// src_div, ss_div, ldo.
extern "C" int f32_rownorm(const void** p, const int* n, const float*,
                           void* stream_ptr) {
  return rownorm_f32(static_cast<const float*>(p[0]), n[2], n[3],
                     static_cast<const float*>(p[1]),
                     static_cast<const float*>(p[2]),
                     static_cast<const float*>(p[3]),
                     static_cast<const float*>(p[4]), n[4],
                     static_cast<float*>(const_cast<void*>(p[5])), n[5], n[0],
                     n[1], static_cast<cudaStream_t>(stream_ptr));
}

// ptrs: q (row stride ldq), k1, v1 (row stride ldk1), valid1 [B n1] or
// null, k2, v2 (row stride ldk2) or null, out (row stride ldo); all
// float32.  ints: B, Sq, n1, n2, H, Dh, ldq, ldk1, ldk2, ldo.  floats: the
// logit scale.
extern "C" int f32_attention(const void** p, const int* n, const float* f,
                             void* stream_ptr) {
  AttnF32 a = {};
  a.q = static_cast<const float*>(p[0]);
  a.k1 = static_cast<const float*>(p[1]);
  a.v1 = static_cast<const float*>(p[2]);
  a.valid1 = static_cast<const float*>(p[3]);
  a.k2 = static_cast<const float*>(p[4]);
  a.v2 = static_cast<const float*>(p[5]);
  a.out = static_cast<float*>(const_cast<void*>(p[6]));
  a.B = n[0]; a.Sq = n[1]; a.n1 = n[2]; a.n2 = n[3]; a.H = n[4];
  a.Dh = n[5]; a.ldq = n[6]; a.ldk1 = n[7]; a.ldk2 = n[8]; a.ldo = n[9];
  a.scale = f[0];
  return attention_f32(a, static_cast<cudaStream_t>(stream_ptr));
}
