// Masked multi-head self-attention, shared by kernel K2 (decoder_layer.cu: q,
// k, v are the thirds of one packed [B*T, 3D] projection) and kernel 10
// (masked_attention.cu: three separate [B, T, D] tensors).  The caller gives
// the three base pointers and their common row stride.  The tile is
// flash_tile.cuh's: one block of 4 warps per (sample, head, 64-query tile),
// q in registers, k and v through a two-stage cp.async ring, scores,
// probabilities and the output in registers, key tiles without a valid key
// skipped.
#pragma once

#include "flash_tile.cuh"

namespace ladiff {

// Row t of sample b, head h starts at ptr + (b * T + t) * ld + h * Dh, for
// q, k and v alike (ld, Dh multiples of 8 and 16-byte aligned pointers: rows
// move as 16-byte vectors); the context goes to out with row stride ldo.
// kvalid [B * T] f32 marks the keys that may be attended to (> 0.5); null
// means every key is valid.
struct AttnArgs {
  const bf16 *q, *k, *v;
  const float* kvalid;
  bf16* out;
  int T, Dh, ld, ldo;
};

// Self-attention of one (sample, head, 64-query tile) over the sample's T
// rows.  Grid: (query tiles, heads, samples).
template <int kD>
__global__ void __launch_bounds__(kFThreads)
attn_tile_kernel(AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t base = (size_t)blockIdx.z * a.T;
  const int hoff = blockIdx.y * kD;
  FlashFwd f;
  f.q = a.q + base * a.ld + hoff;
  f.k = a.k + base * a.ld + hoff;
  f.v = a.v + base * a.ld + hoff;
  f.kvalid = a.kvalid ? a.kvalid + base : nullptr;
  f.out = a.out + base * a.ldo + hoff;
  f.lse = nullptr;
  f.ld = a.ld; f.ldo = a.ldo; f.lds = 0; f.T = a.T;
  f.q0 = blockIdx.x * kFT;
  f.mbase = 0;
  flash_fwd_tile<kD, false>(f, Dropout{}, smem);
}

// Internal linkage: the shared-memory grant belongs to this library's copy
// of the kernel, and the local static of an extern inline function would be
// one object for every library of the process that includes this header.
template <int kD>
static inline cudaError_t launch_attn_tiles_d(const AttnArgs& a, int B, int H,
                                              cudaStream_t stream) {
  static SmemGrant grant;
  const size_t bytes = flash_smem_bytes<kD>(a.T);
  if (!allow_smem(attn_tile_kernel<kD>, bytes, grant))
    return cudaErrorInvalidValue;
  attn_tile_kernel<kD><<<dim3((a.T + kFT - 1) / kFT, H, B), kFThreads, bytes,
                         stream>>>(a);
  return cudaGetLastError();
}

// Launches the tiles for B samples and H heads on `stream`; head widths
// that are a multiple of 16 up to 128.
static inline cudaError_t launch_attn_tiles(const AttnArgs& a, int B, int H,
                                            cudaStream_t stream) {
  if (a.ld % 8 || a.ldo % 2 || a.T < 1) return cudaErrorInvalidValue;
  switch (a.Dh) {
    case 16: return launch_attn_tiles_d<16>(a, B, H, stream);
    case 32: return launch_attn_tiles_d<32>(a, B, H, stream);
    case 48: return launch_attn_tiles_d<48>(a, B, H, stream);
    case 64: return launch_attn_tiles_d<64>(a, B, H, stream);
    case 80: return launch_attn_tiles_d<80>(a, B, H, stream);
    case 96: return launch_attn_tiles_d<96>(a, B, H, stream);
    case 112: return launch_attn_tiles_d<112>(a, B, H, stream);
    case 128: return launch_attn_tiles_d<128>(a, B, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ladiff
