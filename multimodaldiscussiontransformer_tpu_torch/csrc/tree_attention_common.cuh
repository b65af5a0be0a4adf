// Shared pieces of the attention kernels: the CUDA-core tiling constants
// and type conversion (biased_attention_fwd.cu), the tree kernels' bias
// assembled on the fly, and the dropout bits that every kernel draws.
//
// Dropout bits: Philox4x32-10 (Salmon et al., "Parallel random numbers: as
// easy as 1, 2, 3", SC 2011), keyed by the 64-bit seed, with the counter
// (j / 4, i, h, b); word j % 4 is the bits of key j in row i of head h of
// graph b. The bits are a pure function of (seed, b, h, i, j), whatever
// the tiling, so the forward and both backward kernels see one mask, and
// the plain PyTorch version (ops/tree_attention.py) computes the same one.
// A key is kept where its bits are >= thr = min(floor(rate * 2^32), 2^32-1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace tree_attention {

constexpr int kTile = 64;                      // rows per block, keys per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kTile / kWarps;   // 8
constexpr int kStride = kTile + 1;             // padded row of a transposed tile
constexpr int kLutSize = 32;
constexpr float kMaskBias = -1e9f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// c * max(tpl, -1e9) + lut[id], where ids 0 and ids outside [0, 32) add
// nothing from the LUT (lut_s holds this head's column, lut_s[0] = 0)
__device__ __forceinline__ float bias_of(float tpl, int id, const float* lut_s, float tpl_coef) {
  const float spatial = (id > 0 && id < kLutSize) ? lut_s[id] : 0.f;
  return tpl_coef * fmaxf(tpl, kMaskBias) + spatial;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

}  // namespace tree_attention
