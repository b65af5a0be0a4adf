// Tower attention with a per-key bias, forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_make_fwd_kernel` of the JAX package
// (multimodaldiscussiontransformer_tpu/ops/masked_attention.py), the fused
// self-attention of the BERT and ViT tower layers.
//
// Function, for each (b, h, i):
//   s_ij  = scale * q_i . k_j + max(kb[b, j], -1e9)     (kb = 0 when null)
//   m_i   = max(-1e9, max_j s_ij),  e_ij = exp(s_ij - m_i)
//   l_i   = max(sum_j e_ij, 1e-30)                       (the UNDROPPED sum)
//   out_i = sum_j keep_ij e_ij v_j / ((1 - rate) l_i)
//   stats[0, i] = m_i, stats[1, i] = log(l_i)            (optional, for the backward)
// keep_ij is the Philox mask of tree_attention_common.cuh, counter
// (j / 4, i, h, b): the same bits as the tree-attention kernels, so one
// plain mask serves both. q/k/v are (B, H, S, DH) in bf16 or f32; kb is
// (B, S) f32 or null; stats (2, B, H, S) f32 or null. All arithmetic is f32
// (q is scaled in f32, as the Pallas kernel does); out is stored in q's type.
//
// A row whose every key carries -1e9 (a capacity-padding text row) gets
// equal weights over its S keys; the Pallas kernel pads S to a multiple of 8
// with -1e9 keys and spreads such a row over those too. No loss reads these
// rows. The backward recomputes p_ij = exp((s_ij - m_i) - log l_i), so the
// row max and the log of the sum are stored apart: their sum, the
// log-sum-exp, would be about -1e9 for such a row, where float32 steps by 64
// and log(l_i) (at most log S) is lost.
//
// What bounds it: at the text-fusion shape (B = 256 rows, S = 104, H = 12,
// DH = 64, bf16) the call reads q, k, v and writes out, ~164 MB, for ~8.5
// GFLOP: about 49 us of HBM time against 9 us of tensor-core time, so bytes
// bound it; on CUDA cores (this design, ~127 us at the f32 peak) arithmetic
// does.
//
// Design: the tree-attention forward (tree_attention_fwd.cu) with the
// (B, S, S) template and ids replaced by the key bias. One block per
// (64-row q tile, head, batch row), 8 warps of 8 rows each; the block loops
// over 64-key tiles of K and V staged in shared memory as f32 (K transposed
// with a padded row) with the tile's 64 clamped key biases beside them;
// each lane scores 2 keys per row and the row keeps an online softmax in
// registers, so the (S, S) probabilities never exist. Keys past S score
// -inf and rows past S are not stored, so nothing is padded. Shared memory
// does not grow with S. Tensor cores and several heads per block are left
// for a later change.

#include "tree_attention_common.cuh"

namespace {

using namespace tree_attention;

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kTile * DH + DH * kStride + kTile * DH + kTile);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
masked_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const float* __restrict__ key_bias,
                            T* __restrict__ out, float* __restrict__ stats, int H, int S,
                            float scale, uint2 seed, unsigned thr, float keep_scale) {
  constexpr int kDimsPerLane = (DH + 31) / 32;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [kTile][DH], pre-scaled
  float* kt_s = q_s + kTile * DH;      // [DH][kStride]
  float* v_s = kt_s + DH * kStride;    // [kTile][DH]
  float* kb_s = v_s + kTile * DH;      // [kTile]: clamped bias, -inf past S

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
  const float* bias_b = key_bias == nullptr ? nullptr : key_bias + (long long)b * S;

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
    __syncthreads();  // the previous tile is consumed; q_s is written
    for (int e = tid; e < kTile * DH; e += kThreads) {
      const int j = e / DH;
      const int d = e % DH;
      const int key = k0 + j;
      const bool ok = key < S;
      kt_s[d * kStride + j] = ok ? to_f32(kb[(long long)key * DH + d]) : 0.f;
      v_s[e] = ok ? to_f32(vb[(long long)key * DH + d]) : 0.f;
    }
    if (tid < kTile) {
      const int key = k0 + tid;
      kb_s[tid] = key >= S ? -INFINITY : bias_b == nullptr ? 0.f : fmaxf(bias_b[key], kMaskBias);
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
      s0 += kb_s[lane];
      s1 += kb_s[lane + 32];

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
    if (stats != nullptr && lane == 0) {
      stats[bh * S + row] = m[r];
      stats[(long long)gridDim.z * H * S + bh * S + row] = logf(denom);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_bias, void* out,
                   void* stats, int B, int H, int S, float scale, uint2 seed, unsigned thr,
                   float keep_scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(masked_attention_fwd_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  masked_attention_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<T*>(out), static_cast<float*>(stats), H,
      S, scale, seed, thr, keep_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, const void* key_bias,
                         void* out, void* stats, int B, int H, int S, int DH, float scale,
                         uint2 seed, unsigned thr, float keep_scale, cudaStream_t stream) {
  switch (DH) {
    case 16: return launch<T, 16>(q, k, v, key_bias, out, stats, B, H, S, scale, seed, thr, keep_scale, stream);
    case 32: return launch<T, 32>(q, k, v, key_bias, out, stats, B, H, S, scale, seed, thr, keep_scale, stream);
    case 64: return launch<T, 64>(q, k, v, key_bias, out, stats, B, H, S, scale, seed, thr, keep_scale, stream);
    case 128: return launch<T, 128>(q, k, v, key_bias, out, stats, B, H, S, scale, seed, thr, keep_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. key_bias and stats may be null. The
// dropout mask is keyed by (seed_hi << 32 | seed_lo); thr = 0 keeps every
// key, and keep_scale is 1 / (1 - rate). Returns a cudaError_t (0 on
// success).
extern "C" int masked_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* key_bias, void* out, void* stats, int B, int H,
                                    int S, int DH, float scale, unsigned seed_lo,
                                    unsigned seed_hi, unsigned thr, float keep_scale, int dtype,
                                    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint2 seed = make_uint2(seed_lo, seed_hi);
  if (dtype == 0)
    return dispatch_dim<float>(q, k, v, key_bias, out, stats, B, H, S, DH, scale, seed, thr,
                               keep_scale, st);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(q, k, v, key_bias, out, stats, B, H, S, DH, scale, seed,
                                       thr, keep_scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* masked_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
