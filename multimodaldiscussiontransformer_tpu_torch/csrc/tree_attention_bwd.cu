// Compact-bias tree attention, backward, for Hopper (sm_90a): two kernels
// on CUDA cores, K2 and K3. The route (ops/tree_attention.py::kernel_route)
// sends them bf16 at DH 16, 32 and 128; bf16 at DH 64 takes the tensor-core
// pair of tree_attention_bwd_mma.cu and float32 the 3xTF32 pair of
// tree_attention_bwd_tf32.cu. They take float32 and every DH still.
//
// Replaces the Pallas backward kernels of the JAX package
// (multimodaldiscussiontransformer_tpu/ops/tree_attention.py)
//   _make_dropout_bwd_kernel_batched  (padded S <= 128),
//   _make_dropout_bwd_kernel          (128 < padded S < 513),
// and, at rate 0, the XLA backward `_bwd` of the same file for S < 513.
//
// With p_ij = exp(s_ij - lse_i) (s and lse as in tree_attention_fwd.cu),
// D_i = sum_d g_id out_id and the keep mask of the forward:
//   pd_ij = keep_ij p_ij / (1 - rate)
//   ds_ij = p_ij (keep_ij (g_i . v_j) / (1 - rate) - D_i)
//   dv_j  = sum_i pd_ij g_i
//   dq_i  = scale sum_j ds_ij k_j,   dk_j = scale sum_i ds_ij q_i
//   dlut[id, h] = sum_{b,i,j : ids[b,i,j] = id} ds_ij  for 1 <= id < 32
// (the template factor c does not enter dlut; lut row 0 gets nothing).
//
// tree_attention_bwd_dq_kernel (q-major): one block per (64-row q tile,
// head, graph). It forms D_i from g and out (and stores it for the second
// kernel), loops over 64-key tiles with K and V staged transposed in shared
// memory, recomputes p from the saved lse, regenerates keep, and writes dq.
// Each warp sums ds into its own 32-bin shared histogram by id; the block
// adds its bins to the (32, H) f32 dlut with atomicAdd. The TPU carried this
// sum across sequential grid steps; Hopper blocks run in parallel and in no
// fixed order, so the float sum's order (and its last bits) changes between
// runs.
//
// tree_attention_bwd_dkv_kernel (k-major): one block per (64-key tile, head,
// graph), looping over 64-row q tiles with q and g staged transposed and the
// (q tile x key tile) block of tpl/ids staged in shared memory; each warp
// owns 8 keys and accumulates their dk and dv rows in registers. Writing dk
// and dv from the q-major kernel instead would need atomics on (B, H, S, DH).
//
// What bounds them: at S = 33, B = 12, H = 12, DH = 64 the pair reads q, k,
// v, g, out (bf16) and the head-shared tpl/ids and writes dq, dk, dv (~3.5
// MB, ~1 us of HBM time) for ~10 B H S^2 DH = 100 MFLOP; bound by memory and
// launch overhead. In float32 at S = 1025, B = 1, H = 12 the pair does 14 B
// H S^2 DH = 11.3 GFLOP, 169 us at the 67 TFLOP/s of float32 on CUDA cores:
// bound by FFMA issue. Like the forward they run on CUDA cores with f32
// accumulation; the
// tensor-core pairs are tree_attention_bwd_mma.cu (bf16) and
// tree_attention_bwd_tf32.cu (float32 in 3xTF32).

#include "tree_attention_common.cuh"

namespace {

using namespace tree_attention;

template <int DH>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(2 * kTile * DH + 2 * DH * kStride);
}

template <int DH>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(2 * kTile * DH + 2 * DH * kStride + 2 * kTile * kStride +
                                  2 * kTile);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
tree_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ out,
                             const T* __restrict__ g, const float* __restrict__ tpl,
                             const int* __restrict__ ids, const float* __restrict__ lut,
                             const float* __restrict__ lse, T* __restrict__ dq,
                             float* __restrict__ dlut, float* __restrict__ delta, int H, int S,
                             float scale, float tpl_coef, uint2 seed, unsigned thr,
                             float keep_scale) {
  constexpr int kDimsPerLane = (DH + 31) / 32;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [kTile][DH], pre-scaled
  float* g_s = q_s + kTile * DH;       // [kTile][DH]
  float* kt_s = g_s + kTile * DH;      // [DH][kStride]
  float* vt_s = kt_s + DH * kStride;   // [DH][kStride]
  __shared__ float lut_s[kLutSize];
  __shared__ float hist[kWarps][kLutSize];

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
  const T* ob = out + bh * S * DH;
  const T* gb = g + bh * S * DH;
  T* dqb = dq + bh * S * DH;
  const float* tpl_b = tpl + (long long)b * S * S;
  const int* ids_b = ids + (long long)b * S * S;

  if (tid < kLutSize) lut_s[tid] = tid == 0 ? 0.f : lut[tid * H + h];
  hist[warp][lane] = 0.f;
  for (int e = tid; e < kTile * DH; e += kThreads) {
    const int row = q0 + e / DH;
    const bool ok = row < S;
    q_s[e] = ok ? to_f32(qb[(long long)row * DH + e % DH]) * scale : 0.f;
    g_s[e] = ok ? to_f32(gb[(long long)row * DH + e % DH]) : 0.f;
  }
  __syncthreads();

  float D[kRowsPerWarp], L[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int lr = warp * kRowsPerWarp + r;
    const int row = q0 + lr;
    float dsum = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) {
      acc[r][dd] = 0.f;
      const int d = lane + 32 * dd;
      if (row < S && (DH % 32 == 0 || d < DH))
        dsum = fmaf(g_s[lr * DH + d], to_f32(ob[(long long)row * DH + d]), dsum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dsum += __shfl_xor_sync(kFull, dsum, off);
    D[r] = dsum;
    L[r] = row < S ? lse[bh * S + row] : 0.f;
    if (row < S && lane == 0) delta[bh * S + row] = dsum;
  }

  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kTile * DH; e += kThreads) {
      const int j = e / DH;
      const int d = e % DH;
      const int key = k0 + j;
      const bool ok = key < S;
      kt_s[d * kStride + j] = ok ? to_f32(kb[(long long)key * DH + d]) : 0.f;
      vt_s[d * kStride + j] = ok ? to_f32(vb[(long long)key * DH + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int lr = warp * kRowsPerWarp + r;
      const int row = q0 + lr;
      if (row >= S) continue;  // uniform across the warp
      const float* q_row = q_s + lr * DH;
      const float* g_row = g_s + lr * DH;
      float s0 = 0.f, s1 = 0.f, dp0 = 0.f, dp1 = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) {
        const float qd = q_row[d];
        const float gd = g_row[d];
        s0 = fmaf(qd, kt_s[d * kStride + lane], s0);
        s1 = fmaf(qd, kt_s[d * kStride + lane + 32], s1);
        dp0 = fmaf(gd, vt_s[d * kStride + lane], dp0);
        dp1 = fmaf(gd, vt_s[d * kStride + lane + 32], dp1);
      }
      const int key0 = k0 + lane;
      const int key1 = key0 + 32;
      const float* tpl_row = tpl_b + (long long)row * S;
      const int* ids_row = ids_b + (long long)row * S;
      const int id0 = key0 < S ? ids_row[key0] : 0;
      const int id1 = key1 < S ? ids_row[key1] : 0;
      const float p0 = key0 < S ? expf(s0 + bias_of(tpl_row[key0], id0, lut_s, tpl_coef) - L[r]) : 0.f;
      const float p1 = key1 < S ? expf(s1 + bias_of(tpl_row[key1], id1, lut_s, tpl_coef) - L[r]) : 0.f;
      bool keep0, keep1;
      keep_pair(seed, thr, b, h, row, k0, lane, keep0, keep1);
      const float ds0 = p0 * ((keep0 ? dp0 * keep_scale : 0.f) - D[r]);
      const float ds1 = p1 * ((keep1 ? dp1 * keep_scale : 0.f) - D[r]);
      if (id0 > 0 && id0 < kLutSize) atomicAdd(&hist[warp][id0], ds0);
      if (id1 > 0 && id1 < kLutSize) atomicAdd(&hist[warp][id1], ds1);

#pragma unroll 8
      for (int jj = 0; jj < 32; ++jj) {
        const float da = __shfl_sync(kFull, ds0, jj);
        const float db = __shfl_sync(kFull, ds1, jj);
#pragma unroll
        for (int dd = 0; dd < kDimsPerLane; ++dd) {
          const int d = lane + 32 * dd;
          if (DH % 32 == 0 || d < DH) {
            acc[r][dd] = fmaf(da, kt_s[d * kStride + jj], acc[r][dd]);
            acc[r][dd] = fmaf(db, kt_s[d * kStride + jj + 32], acc[r][dd]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= S) continue;
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) {
      const int d = lane + 32 * dd;
      if (DH % 32 == 0 || d < DH) dqb[(long long)row * DH + d] = from_f32<T>(acc[r][dd] * scale);
    }
  }

  __syncthreads();
  if (tid > 0 && tid < kLutSize) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += hist[w][tid];
    if (sum != 0.f) atomicAdd(&dlut[tid * H + h], sum);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
tree_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ g,
                              const float* __restrict__ tpl, const int* __restrict__ ids,
                              const float* __restrict__ lut, const float* __restrict__ lse,
                              const float* __restrict__ delta, T* __restrict__ dk,
                              T* __restrict__ dv, int H, int S, float scale, float tpl_coef,
                              uint2 seed, unsigned thr, float keep_scale) {
  constexpr int kDimsPerLane = (DH + 31) / 32;
  extern __shared__ float smem[];
  float* k_s = smem;                        // [kTile keys][DH]
  float* v_s = k_s + kTile * DH;            // [kTile keys][DH]
  float* qt_s = v_s + kTile * DH;           // [DH][kStride], pre-scaled
  float* gt_s = qt_s + DH * kStride;        // [DH][kStride]
  float* tpl_s = gt_s + DH * kStride;       // [kTile rows][kStride keys]
  int* ids_s = reinterpret_cast<int*>(tpl_s + kTile * kStride);  // same
  float* lse_s = reinterpret_cast<float*>(ids_s + kTile * kStride);  // [kTile]
  float* d_s = lse_s + kTile;               // [kTile]
  __shared__ float lut_s[kLutSize];

  const int kt0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long bh = (long long)b * H + h;
  const T* qb = q + bh * S * DH;
  const T* kb = k + bh * S * DH;
  const T* vb = v + bh * S * DH;
  const T* gb = g + bh * S * DH;
  T* dkb = dk + bh * S * DH;
  T* dvb = dv + bh * S * DH;
  const float* tpl_b = tpl + (long long)b * S * S;
  const int* ids_b = ids + (long long)b * S * S;

  if (tid < kLutSize) lut_s[tid] = tid == 0 ? 0.f : lut[tid * H + h];
  for (int e = tid; e < kTile * DH; e += kThreads) {
    const int key = kt0 + e / DH;
    const bool ok = key < S;
    k_s[e] = ok ? to_f32(kb[(long long)key * DH + e % DH]) : 0.f;
    v_s[e] = ok ? to_f32(vb[(long long)key * DH + e % DH]) : 0.f;
  }

  float adk[kRowsPerWarp][kDimsPerLane], adv[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) adk[r][dd] = adv[r][dd] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();  // the previous q tile is consumed; k_s/v_s/lut_s are written
    for (int e = tid; e < kTile * DH; e += kThreads) {
      const int i = e / DH;
      const int d = e % DH;
      const int row = q0 + i;
      const bool ok = row < S;
      qt_s[d * kStride + i] = ok ? to_f32(qb[(long long)row * DH + d]) * scale : 0.f;
      gt_s[d * kStride + i] = ok ? to_f32(gb[(long long)row * DH + d]) : 0.f;
    }
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int i = e / kTile;
      const int j = e % kTile;
      const int row = q0 + i;
      const int key = kt0 + j;
      const bool ok = row < S && key < S;
      tpl_s[i * kStride + j] = ok ? tpl_b[(long long)row * S + key] : 0.f;
      ids_s[i * kStride + j] = ok ? ids_b[(long long)row * S + key] : 0;
    }
    if (tid < kTile) {
      const int row = q0 + tid;
      // rows past S get p = exp(s - inf) = 0
      lse_s[tid] = row < S ? lse[bh * S + row] : INFINITY;
      d_s[tid] = row < S ? delta[bh * S + row] : 0.f;
    }
    __syncthreads();

    const int i0 = q0 + lane;
    const int i1 = i0 + 32;
    uint4 wa = make_uint4(0u, 0u, 0u, 0u), wb = wa;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int jl = warp * kRowsPerWarp + r;
      const int key = kt0 + jl;
      if (key >= S) continue;  // uniform across the warp; so are the later r
      if ((r & 3) == 0 && thr != 0u) {
        // keys key..key+3 share a Philox counter; one draw per 4 keys
        const unsigned c0 = (unsigned)(key >> 2);
        wa = philox4x32_10(make_uint4(c0, (unsigned)i0, (unsigned)h, (unsigned)b), seed);
        wb = philox4x32_10(make_uint4(c0, (unsigned)i1, (unsigned)h, (unsigned)b), seed);
      }
      const float* k_row = k_s + jl * DH;
      const float* v_row = v_s + jl * DH;
      float s0 = 0.f, s1 = 0.f, dp0 = 0.f, dp1 = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) {
        const float kd = k_row[d];
        const float vd = v_row[d];
        s0 = fmaf(qt_s[d * kStride + lane], kd, s0);
        s1 = fmaf(qt_s[d * kStride + lane + 32], kd, s1);
        dp0 = fmaf(gt_s[d * kStride + lane], vd, dp0);
        dp1 = fmaf(gt_s[d * kStride + lane + 32], vd, dp1);
      }
      const float p0 = i0 < S ? expf(s0 + bias_of(tpl_s[lane * kStride + jl], ids_s[lane * kStride + jl], lut_s, tpl_coef) - lse_s[lane]) : 0.f;
      const float p1 = i1 < S ? expf(s1 + bias_of(tpl_s[(lane + 32) * kStride + jl], ids_s[(lane + 32) * kStride + jl], lut_s, tpl_coef) - lse_s[lane + 32]) : 0.f;
      const bool keep0 = thr == 0u || word_of(wa, r & 3) >= thr;
      const bool keep1 = thr == 0u || word_of(wb, r & 3) >= thr;
      const float pd0 = keep0 ? p0 * keep_scale : 0.f;
      const float pd1 = keep1 ? p1 * keep_scale : 0.f;
      const float ds0 = p0 * ((keep0 ? dp0 * keep_scale : 0.f) - d_s[lane]);
      const float ds1 = p1 * ((keep1 ? dp1 * keep_scale : 0.f) - d_s[lane + 32]);

#pragma unroll 4
      for (int ii = 0; ii < 32; ++ii) {
        const float pa = __shfl_sync(kFull, pd0, ii);
        const float pb = __shfl_sync(kFull, pd1, ii);
        const float da = __shfl_sync(kFull, ds0, ii);
        const float db = __shfl_sync(kFull, ds1, ii);
#pragma unroll
        for (int dd = 0; dd < kDimsPerLane; ++dd) {
          const int d = lane + 32 * dd;
          if (DH % 32 == 0 || d < DH) {
            adv[r][dd] = fmaf(pa, gt_s[d * kStride + ii], adv[r][dd]);
            adv[r][dd] = fmaf(pb, gt_s[d * kStride + ii + 32], adv[r][dd]);
            adk[r][dd] = fmaf(da, qt_s[d * kStride + ii], adk[r][dd]);
            adk[r][dd] = fmaf(db, qt_s[d * kStride + ii + 32], adk[r][dd]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = kt0 + warp * kRowsPerWarp + r;
    if (key >= S) continue;
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) {
      const int d = lane + 32 * dd;
      if (DH % 32 == 0 || d < DH) {
        // q_s was pre-scaled, so dk already carries the scale
        dkb[(long long)key * DH + d] = from_f32<T>(adk[r][dd]);
        dvb[(long long)key * DH + d] = from_f32<T>(adv[r][dd]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *out, *g, *tpl, *ids, *lut, *lse;
  void *dq, *dk, *dv, *dlut, *delta;
  int B, H, S;
  float scale, tpl_coef;
  uint2 seed;
  unsigned thr;
  float keep_scale;
  cudaStream_t stream;
};

template <typename T, int DH>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(tree_attention_bwd_dq_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kTile - 1) / kTile, a.H, a.B);
  tree_attention_bwd_dq_kernel<T, DH><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.out), static_cast<const T*>(a.g), static_cast<const float*>(a.tpl),
      static_cast<const int*>(a.ids), static_cast<const float*>(a.lut),
      static_cast<const float*>(a.lse), static_cast<T*>(a.dq), static_cast<float*>(a.dlut),
      static_cast<float*>(a.delta), a.H, a.S, a.scale, a.tpl_coef, a.seed, a.thr, a.keep_scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(tree_attention_bwd_dkv_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kTile - 1) / kTile, a.H, a.B);
  tree_attention_bwd_dkv_kernel<T, DH><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), static_cast<const float*>(a.tpl),
      static_cast<const int*>(a.ids), static_cast<const float*>(a.lut),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.S, a.scale, a.tpl_coef, a.seed,
      a.thr, a.keep_scale);
  return cudaGetLastError();
}

template <bool kDq, typename T>
cudaError_t dispatch_dim(const Args& a, int DH) {
  switch (DH) {
    case 16: return kDq ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return kDq ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return kDq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int dispatch(const Args& a, int DH, int dtype) {
  if (a.B <= 0 || a.H <= 0 || a.S <= 0 || a.B > 65535 || a.H > 65535) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_dim<kDq, float>(a, DH);
  if (dtype == 1) return dispatch_dim<kDq, __nv_bfloat16>(a, DH);
  return cudaErrorInvalidValue;
}

}  // namespace

// dq (and the per-row D_i in `delta`, f32 (B, H, S)) and the dlut sum, which
// is ADDED to `dlut` (f32 (32, H), zeroed by the caller). dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int tree_attention_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* out, const void* g, const void* tpl,
                                     const void* ids, const void* lut, const void* lse, void* dq,
                                     void* dlut, void* delta, int B, int H, int S, int DH,
                                     float scale, float tpl_coef, unsigned seed_lo,
                                     unsigned seed_hi, unsigned thr, float keep_scale, int dtype,
                                     void* stream) {
  Args a{q, k, v, out, g, tpl, ids, lut, lse, dq, nullptr, nullptr, dlut, delta,
         B, H, S, scale, tpl_coef, make_uint2(seed_lo, seed_hi), thr, keep_scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, DH, dtype);
}

// dk and dv, from the `delta` that tree_attention_bwd_dq wrote.
extern "C" int tree_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* g, const void* tpl, const void* ids,
                                      const void* lut, const void* lse, const void* delta,
                                      void* dk, void* dv, int B, int H, int S, int DH,
                                      float scale, float tpl_coef, unsigned seed_lo,
                                      unsigned seed_hi, unsigned thr, float keep_scale,
                                      int dtype, void* stream) {
  Args a{q, k, v, nullptr, g, tpl, ids, lut, lse, nullptr, dk, dv, nullptr,
         const_cast<void*>(delta), B, H, S, scale, tpl_coef, make_uint2(seed_lo, seed_hi), thr,
         keep_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, DH, dtype);
}

extern "C" const char* tree_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
