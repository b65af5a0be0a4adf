// Attention with a dense additive bias, forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_fused_kernel` of the JAX package
// (multimodaldiscussiontransformer_tpu/ops/biased_attention.py, dispatched by
// `_fused_forward`), the graph layer's dense-bias fused attention.
//
// Function, for each (b, h, i):
//   c_ij  = max(f32(bias[b, hb, i, j]) + (pad[b, j] ? -1e9 : 0), -1e9)
//           (bias = 0 when null; hb = h, or 0 for a head-shared bias)
//   s_ij  = scale * q_i . k_j + c_ij                     (q scaled in f32)
//   m_i   = max(-1e9, max_j s_ij),  e_ij = exp(s_ij - m_i)
//   out_i = sum_j e_ij v_j / max(sum_j e_ij, 1e-30)
// q/k/v/out are (B, H, S, DH) in bf16 or f32; bias is (B, H, S, S) or
// (B, 1, S, S) in bf16 or f32, or null, and may hold -inf; pad is (B, S)
// bytes (a torch.bool tensor), nonzero = padded key, or null. All arithmetic
// is f32; out is stored in q's type. The JAX wrapper first writes an f32
// (B, H|1, S, S) copy of bias + pad; this kernel reads the bias in its own
// type (head stride 0 when shared) and the pad mask, and folds the two in
// registers in the same f32 order, so the combined bias never exists.
//
// A row whose every key is masked gets equal weights over its S keys (the
// Pallas kernel pads S to a multiple of 8 and spreads such a row over the
// zero-padded keys too). The collator never makes one: column 0 is open.
//
// What bounds it: at the serving shape (B = 16, H = 12, S = 33, DH = 64,
// bf16) the call reads q, k, v and the bf16 bias and writes out, ~3.7 MB,
// for 54 MFLOP: ~1.1 us of HBM time, 0.05 us of tensor-core time; at S =
// 1025 (B = 1) ~31 MB (the bias is 25 MB of it) for 3.2 GFLOP: ~9.4 us of
// HBM time against 3.3 us. Bytes bound it on the card; on CUDA cores (this
// design, 67 TFLOP/s at most: 48 us at S = 1025) arithmetic does.
//
// Design: the first port's CUDA-core tower forward (retired since) with its
// 64-key bias vector replaced by the (S, S) bias plane. One block per (64-row q tile,
// head, batch row), 8 warps of 8 rows each; the block loops over 64-key
// tiles of K and V staged in shared memory as f32 (K transposed with a
// padded row) with the tile's 64 pad terms beside them. Each lane scores 2
// keys per row; it loads its two bias entries of the row from device memory
// (32 neighbouring keys per warp, so each load is coalesced, and each entry
// is read by one block only, or once per head when shared) before the dot
// product, so their latency hides behind it. The row keeps an online
// softmax in registers, so the (S, S) probabilities never exist and any S
// runs with the same shared memory. Keys past S score -inf and rows past S
// are not stored, so nothing is padded. Tensor cores and several heads per
// block are left for a later change.

#include "tree_attention_common.cuh"

namespace {

using namespace tree_attention;

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kTile * DH + DH * kStride + kTile * DH + kTile);
}

template <typename T, typename TB, int DH>
__global__ void __launch_bounds__(kThreads)
biased_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const TB* __restrict__ bias,
                            const unsigned char* __restrict__ pad, T* __restrict__ out, int H,
                            int S, int bias_heads, float scale) {
  constexpr int kDimsPerLane = (DH + 31) / 32;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [kTile][DH], pre-scaled
  float* kt_s = q_s + kTile * DH;      // [DH][kStride]
  float* v_s = kt_s + DH * kStride;    // [kTile][DH]
  float* pad_s = v_s + kTile * DH;     // [kTile]: -1e9 on a padded key, else 0

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
  const TB* bias_bh =
      bias == nullptr
          ? nullptr
          : bias + ((long long)b * bias_heads + (bias_heads == 1 ? 0 : h)) * S * (long long)S;
  const unsigned char* pad_b = pad == nullptr ? nullptr : pad + (long long)b * S;

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
      pad_s[tid] = (pad_b != nullptr && key < S && pad_b[key]) ? kMaskBias : 0.f;
    }
    __syncthreads();

    const bool ok0 = k0 + lane < S;
    const bool ok1 = k0 + lane + 32 < S;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int lr = warp * kRowsPerWarp + r;
      const int row = q0 + lr;
      if (row >= S) continue;  // uniform across the warp
      float b0 = 0.f, b1 = 0.f;
      if (bias_bh != nullptr) {
        const TB* brow = bias_bh + (long long)row * S + k0;
        if (ok0) b0 = to_f32(brow[lane]);
        if (ok1) b1 = to_f32(brow[lane + 32]);
      }
      const float* q_row = q_s + lr * DH;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) {
        const float qd = q_row[d];
        s0 = fmaf(qd, kt_s[d * kStride + lane], s0);
        s1 = fmaf(qd, kt_s[d * kStride + lane + 32], s1);
      }
      s0 += ok0 ? fmaxf(b0 + pad_s[lane], kMaskBias) : -INFINITY;
      s1 += ok1 ? fmaxf(b1 + pad_s[lane + 32], kMaskBias) : -INFINITY;

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

#pragma unroll
      for (int dd = 0; dd < kDimsPerLane; ++dd) acc[r][dd] *= alpha;
#pragma unroll 8
      for (int jj = 0; jj < 32; ++jj) {
        const float pa = __shfl_sync(kFull, p0, jj);
        const float pb = __shfl_sync(kFull, p1, jj);
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
      if (DH % 32 == 0 || d < DH) ob[(long long)row * DH + d] = from_f32<T>(acc[r][dd] / denom);
    }
  }
}

template <typename T, typename TB, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, const void* pad,
                   void* out, int B, int H, int S, int bias_heads, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(biased_attention_fwd_kernel<T, TB, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  biased_attention_fwd_kernel<T, TB, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TB*>(bias), static_cast<const unsigned char*>(pad), static_cast<T*>(out),
      H, S, bias_heads, scale);
  return cudaGetLastError();
}

template <typename T, typename TB>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, const void* bias,
                         const void* pad, void* out, int B, int H, int S, int DH, int bias_heads,
                         float scale, cudaStream_t stream) {
  switch (DH) {
    case 16: return launch<T, TB, 16>(q, k, v, bias, pad, out, B, H, S, bias_heads, scale, stream);
    case 32: return launch<T, TB, 32>(q, k, v, bias, pad, out, B, H, S, bias_heads, scale, stream);
    case 64: return launch<T, TB, 64>(q, k, v, bias, pad, out, B, H, S, bias_heads, scale, stream);
    case 128: return launch<T, TB, 128>(q, k, v, bias, pad, out, B, H, S, bias_heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_bias(const void* q, const void* k, const void* v, const void* bias,
                          const void* pad, void* out, int B, int H, int S, int DH, int bias_heads,
                          float scale, int bias_dtype, cudaStream_t stream) {
  if (bias_dtype == 0)
    return dispatch_dim<T, float>(q, k, v, bias, pad, out, B, H, S, DH, bias_heads, scale, stream);
  if (bias_dtype == 1)
    return dispatch_dim<T, __nv_bfloat16>(q, k, v, bias, pad, out, B, H, S, DH, bias_heads, scale,
                                          stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype, bias_dtype: 0 = float32, 1 = bfloat16. bias and pad may be null;
// bias_heads is 1 (a head-shared bias) or H, and is ignored without a bias.
// Returns a cudaError_t (0 on success).
extern "C" int biased_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                                    const void* pad, void* out, int B, int H, int S, int DH,
                                    int bias_heads, float scale, int dtype, int bias_dtype,
                                    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  if (bias != nullptr && bias_heads != 1 && bias_heads != H) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bias<float>(q, k, v, bias, pad, out, B, H, S, DH, bias_heads, scale,
                                bias_dtype, st);
  if (dtype == 1)
    return dispatch_bias<__nv_bfloat16>(q, k, v, bias, pad, out, B, H, S, DH, bias_heads, scale,
                                        bias_dtype, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* biased_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
