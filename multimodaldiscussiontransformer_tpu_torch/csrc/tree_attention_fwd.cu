// Compact-bias tree attention, forward, for Hopper (sm_90a).
//
// Replaces five Pallas kernels of the JAX package that compute the same
// function (multimodaldiscussiontransformer_tpu/ops/tree_attention.py):
//   _make_kernel_batched              (rate 0, padded S <= 128),
//   _make_kernel                      (rate 0, 128 < padded S < 513),
//   _make_kernel_flash                with rate 0 and no LSE page (padded S >= 513),
//   _make_dropout_fwd_kernel_batched  (dropout, padded S <= 128),
//   _make_dropout_fwd_kernel          (dropout, 128 < padded S < 513).
//
// Function, for each (b, h, i):
//   s_ij  = scale * q_i . k_j + c * max(tpl[b,i,j], -1e9) + lut[ids[b,i,j], h]
//           (c = 2 with the reference's double-added bias, else 1; ids 0 and
//            ids outside [0, 32) add nothing)
//   m_i   = max(-1e9, max_j s_ij),  e_ij = exp(s_ij - m_i)
//   l_i   = max(sum_j e_ij, 1e-30)                  (the UNDROPPED sum)
//   out_i = sum_j keep_ij e_ij v_j / ((1 - rate) l_i)
//   lse_i = m_i + log(l_i)                          (optional, for the backward)
// keep_ij comes from tree_attention_common.cuh (Philox; all true at rate 0).
// q/k/v are (B, H, S, DH) in bf16 or f32; tpl (B, S, S) f32; ids (B, S, S)
// int32; lut (32, H) f32; lse (B, H, S) f32 or null. All arithmetic is f32;
// out is stored in q's type.
//
// What bounds it: at the canonical shapes (S = 33 at B = 12..16, H = 12,
// DH = 64) the call moves ~3 MB (q, k, v, out and the head-shared tpl/ids)
// for ~50 MFLOP, i.e. about 1 us of HBM time against 0.05 us of tensor-core
// time: it is bound by memory and launch overhead, not arithmetic.
//
// Design: one block per (64-row q tile, head, graph), 8 warps of 8 rows each.
// The block loops over 64-key tiles of K and V staged in shared memory as
// f32 (K transposed with a padded row, so both the staging writes and the
// per-lane key reads are free of bank conflicts). Each lane scores 2 keys of
// the tile for one query row at a time, and the row keeps an online softmax
// (running max, running sum and the DH-wide accumulator) in registers, so the
// (S, S) score matrix never exists. Dropout multiplies only the p.v
// accumulation; the running sum takes the undropped terms, as the Pallas
// kernels do. tpl/ids rows are read straight from global memory, 64
// consecutive entries per row and tile (coalesced); the H blocks of a graph
// read the same rows, which L2 serves. The ragged edge is masked in the
// kernel (keys >= S score -inf, rows >= S are not stored), so nothing is
// padded. The kernel allocates nothing; the caller passes `out` and `lse`.
// Tensor cores, TMA and several heads per block are left for a later change.

#include "tree_attention_common.cuh"

namespace {

using namespace tree_attention;

__device__ __forceinline__ float biased(float qk, int key, int S, const float* tpl_row,
                                        const int* ids_row, const float* lut_s, float tpl_coef) {
  if (key >= S) return -INFINITY;
  return qk + bias_of(tpl_row[key], ids_row[key], lut_s, tpl_coef);
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kTile * DH + DH * kStride + kTile * DH);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
tree_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ tpl,
                          const int* __restrict__ ids, const float* __restrict__ lut,
                          T* __restrict__ out, float* __restrict__ lse, int H, int S,
                          float scale, float tpl_coef, uint2 seed, unsigned thr,
                          float keep_scale) {
  constexpr int kDimsPerLane = (DH + 31) / 32;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [kTile][DH], pre-scaled
  float* kt_s = q_s + kTile * DH;      // [DH][kStride]
  float* v_s = kt_s + DH * kStride;    // [kTile][DH]
  __shared__ float lut_s[kLutSize];

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long bh = (long long)b * H + h;
  const T* qb = q + bh * S * DH;
  const T* kb = k + bh * S * DH;
  const T* vb = v + bh * S * DH;
  T* ob = out + bh * S * DH;
  const float* tpl_b = tpl + (long long)b * S * S;
  const int* ids_b = ids + (long long)b * S * S;

  if (tid < kLutSize) lut_s[tid] = tid == 0 ? 0.f : lut[tid * H + h];
  for (int e = tid; e < kTile * DH; e += kThreads) {
    const int row = q0 + e / DH;
    q_s[e] = row < S ? to_f32(qb[(long long)row * DH + e % DH]) * scale : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMaskBias;
    l[r] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) acc[r][dd] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed; q_s/lut_s are written
    for (int e = tid; e < kTile * DH; e += kThreads) {
      const int j = e / DH;
      const int d = e % DH;
      const int key = k0 + j;
      const bool ok = key < S;
      kt_s[d * kStride + j] = ok ? to_f32(kb[(long long)key * DH + d]) : 0.f;
      v_s[e] = ok ? to_f32(vb[(long long)key * DH + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int lr = warp * kRowsPerWarp + r;
      const int row = q0 + lr;
      if (row >= S) continue;  // uniform across the warp
      const float* q_row = q_s + lr * DH;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) {
        const float qd = q_row[d];
        s0 = fmaf(qd, kt_s[d * kStride + lane], s0);
        s1 = fmaf(qd, kt_s[d * kStride + lane + 32], s1);
      }
      const float* tpl_row = tpl_b + (long long)row * S;
      const int* ids_row = ids_b + (long long)row * S;
      s0 = biased(s0, k0 + lane, S, tpl_row, ids_row, lut_s, tpl_coef);
      s1 = biased(s1, k0 + lane + 32, S, tpl_row, ids_row, lut_s, tpl_coef);

      float tile_max = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(kFull, tile_max, off));
      const float m_new = fmaxf(m[r], tile_max);
      const float alpha = expf(m[r] - m_new);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      float p_sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        p_sum += __shfl_xor_sync(kFull, p_sum, off);
      l[r] = l[r] * alpha + p_sum;
      m[r] = m_new;

      bool keep0, keep1;
      keep_pair(seed, thr, b, h, row, k0, lane, keep0, keep1);
      const float pk0 = keep0 ? p0 : 0.f;
      const float pk1 = keep1 ? p1 : 0.f;

#pragma unroll
      for (int dd = 0; dd < kDimsPerLane; ++dd) acc[r][dd] *= alpha;
#pragma unroll 8
      for (int jj = 0; jj < 32; ++jj) {
        const float pa = __shfl_sync(kFull, pk0, jj);
        const float pb = __shfl_sync(kFull, pk1, jj);
#pragma unroll
        for (int dd = 0; dd < kDimsPerLane; ++dd) {
          const int d = lane + 32 * dd;
          if (DH % 32 == 0 || d < DH) {
            acc[r][dd] = fmaf(pa, v_s[jj * DH + d], acc[r][dd]);
            acc[r][dd] = fmaf(pb, v_s[(jj + 32) * DH + d], acc[r][dd]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) {
      const int d = lane + 32 * dd;
      if (DH % 32 == 0 || d < DH)
        ob[(long long)row * DH + d] = from_f32<T>(acc[r][dd] / denom * keep_scale);
    }
    if (lse != nullptr && lane == 0) lse[bh * S + row] = m[r] + logf(denom);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* tpl,
                   const void* ids, const void* lut, void* out, void* lse, int B, int H, int S,
                   float scale, float tpl_coef, uint2 seed, unsigned thr, float keep_scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(tree_attention_fwd_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  tree_attention_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(tpl), static_cast<const int*>(ids),
      static_cast<const float*>(lut), static_cast<T*>(out), static_cast<float*>(lse), H, S,
      scale, tpl_coef, seed, thr, keep_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, const void* tpl,
                         const void* ids, const void* lut, void* out, void* lse, int B, int H,
                         int S, int DH, float scale, float tpl_coef, uint2 seed, unsigned thr,
                         float keep_scale, cudaStream_t stream) {
  switch (DH) {
    case 16: return launch<T, 16>(q, k, v, tpl, ids, lut, out, lse, B, H, S, scale, tpl_coef, seed, thr, keep_scale, stream);
    case 32: return launch<T, 32>(q, k, v, tpl, ids, lut, out, lse, B, H, S, scale, tpl_coef, seed, thr, keep_scale, stream);
    case 64: return launch<T, 64>(q, k, v, tpl, ids, lut, out, lse, B, H, S, scale, tpl_coef, seed, thr, keep_scale, stream);
    case 128: return launch<T, 128>(q, k, v, tpl, ids, lut, out, lse, B, H, S, scale, tpl_coef, seed, thr, keep_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse may be null. The dropout mask is
// keyed by (seed_hi << 32 | seed_lo); thr = 0 keeps every key, and
// keep_scale is 1 / (1 - rate). Returns a cudaError_t (0 on success).
extern "C" int tree_attention_fwd(const void* q, const void* k, const void* v,
                                  const void* tpl, const void* ids, const void* lut,
                                  void* out, void* lse, int B, int H, int S, int DH,
                                  float scale, float tpl_coef, unsigned seed_lo,
                                  unsigned seed_hi, unsigned thr, float keep_scale, int dtype,
                                  void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint2 seed = make_uint2(seed_lo, seed_hi);
  if (dtype == 0)
    return dispatch_dim<float>(q, k, v, tpl, ids, lut, out, lse, B, H, S, DH, scale, tpl_coef,
                               seed, thr, keep_scale, st);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(q, k, v, tpl, ids, lut, out, lse, B, H, S, DH, scale,
                                       tpl_coef, seed, thr, keep_scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* tree_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
