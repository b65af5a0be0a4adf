// Attention with a dense additive bias, forward, for Hopper (sm_90a): one
// pass on tensor cores for float32 q, k, v at DH = 16, 32, 64 and 128, any
// S >= 1, every product in 3xTF32, K, V and the bias streamed in tiles.
//
// Replaces the Pallas kernel `_fused_kernel` of the JAX package
// (multimodaldiscussiontransformer_tpu/ops/biased_attention.py:61, launched
// at :118), the graph layer's dense-bias fused attention, on the float32
// route, as biased_attention_fwd_mma.cu does on the bf16 one. It takes the
// float32 forward over from the CUDA-core kernel biased_attention_fwd.cu,
// which now serves bf16 at DH 16, 32 and 128 only.
//
// Function, that of biased_attention_fwd.cu, for each (b, h, i):
//   c_ij  = max(f32(bias[b, hb, i, j]) + (pad[b, j] ? -1e9 : 0), -1e9)
//           (bias = 0 when null; hb = h, or 0 for a head-shared bias)
//   s_ij  = (scale q_i) . k_j + c_ij       (q scaled in f32; keys >= S: -inf)
//   m_i   = max(-1e9, max_j s_ij),  e_ij = exp(s_ij - m_i)
//   out_i = sum_j e_ij v_j / max(sum_j e_ij, 1e-30)
// bias is (B, H, S, S) or (B, 1, S, S) in float32 or bfloat16, or null, and
// may hold -inf (-inf + pad gives -inf, clamped to -1e9: never NaN); pad is
// (B, S) bytes (a torch.bool tensor), nonzero = padded key, or null. The two
// are folded in registers: the combined bias never exists. A row whose every
// key is masked gets s = -1e9 exactly (|q . k| scale is far below the
// float32 step of 64 there), m = -1e9 and equal weights over its S keys,
// as from the CUDA-core kernel.
//
// Precision, 3xTF32 (tf32_common.cuh): S = Q K^T and O += P V run on
// mma.sync.m16n8k8 with each float32 operand split into two TF32 parts and
// the three larger cross products summed in f32; P stays f32 in registers.
//
// What bounds it: at S = 1025, B = 1, H = 12, DH = 64 the call reads q, k,
// v and the f32 per-head bias (50 MB of the 56 MB) and writes out: ~17 us
// at 3.35 TB/s, against 4 B H S^2 DH = 3.2 GFLOP, 48 us at the 67 TFLOP/s
// of float32 on CUDA cores and, as three TF32 products each, 20 us at the
// 495 TFLOP/s of dense TF32. At S = 33 .. 601 the bias bytes bound it.
//
// Design, the float32 tree forward's (tree_attention_fwd_tf32.cu) with a
// (rows x keys) tile of the dense bias in place of the compact one: one
// block per (head, 32-row q tile, batch row), 4 warps: two 16-row tiles x
// two key groups. The head is blockIdx.x, so the H blocks that read one
// head-shared bias plane run together and L2 serves the H - 1 re-reads.
// - Q's tile is staged once (16-byte cp.async, rows past S zero-filled),
//   row-major with DH + 4 floats a row, and scaled in place in f32.
// - K, V, the (32 rows x keys) bias tile and the keys' pad terms stream
//   through a double-buffered ring: K and V by 16-byte cp.async (keys past S
//   zero-filled), an f32 bias by 4-byte cp.async (its rows start at 4 S
//   bytes, not 16-byte aligned for odd S), a bf16 bias by plain loads
//   converted to f32 (its rows start at 2 S bytes, below cp.async's 4-byte
//   minimum for odd S; written to the stage, which the previous tile
//   consumed), and the pad bytes as -1e9 or 0 by plain loads. 64-key tiles
//   at DH <= 32, 32-key tiles at DH >= 64: 53 KB of shared memory at DH 64.
// - Per key tile and warp: S = Q K^T with each 3xTF32 term in an
//   accumulator of its own (three independent mma chains over DH); the
//   score formed in f32 on the accumulator as acc + max(bias + pad, -1e9),
//   each lane reading its bias entries in the C-fragment layout (rows grp,
//   grp + 8; keys 2 tq, 2 tq + 1 of each n-tile); an online softmax on the
//   C fragments; O += P V with P taken from the registers as the A operand
//   (acc_as_a).
// - The key groups merge through the consumed ring; the output is written
//   once from the fragments (8-byte stores). The kernel allocates nothing;
//   the caller passes out.
// The operands are split where they are read, each time. The exponentials
// are expf.

#include "mma_common.cuh"
#include "tf32_common.cuh"
#include "tree_attention_common.cuh"

namespace {

using namespace tree_attention;
using namespace tf32_mma;
using tower_mma::cp_async16;
using tower_mma::cp_async4;
using tower_mma::cp_async_commit;
using tower_mma::cp_async_wait;

constexpr int kStages = 2;                       // the ring's depth
constexpr int kRowWarps = 2;                     // 16-row tiles per block
constexpr int kKeyGroups = 2;                    // warps that split each key tile
constexpr int kFwdWarps = kRowWarps * kKeyGroups;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kRows = 16 * kRowWarps;            // q rows per block

template <int DH>
struct FwdShape {
  static constexpr int kLd = DH + 4;                       // floats per staged row
  static constexpr int kKeys = DH <= 32 ? 64 : 32;         // keys per streamed tile
  static constexpr int kGroupKeys = kKeys / kKeyGroups;    // keys per warp and tile
  static constexpr int kGroupNt = kGroupKeys / 8;          // 8-key n-tiles per warp and tile
  static constexpr int kBiasLd = kKeys + 4;                // floats per staged bias row
  static constexpr int kPartial = 4 * (DH / 8) + 4;        // a lane's o, m and l
  // Q, the K and V rings, the bias and pad rings (DH 64: 53 KB)
  static constexpr size_t kSmem =
      sizeof(float) * (size_t)(kRows * kLd + 2 * kStages * kKeys * kLd + kStages * kRows * kBiasLd + kStages * kKeys);
  static_assert(sizeof(float) * (kKeyGroups - 1) * kRowWarps * kPartial * 32 <=
                    sizeof(float) * 2 * kStages * kKeys * kLd,
                "the key groups' partial rows meet in the K and V rings");
};

__device__ __forceinline__ void stage_bias(float* dst, const float* src, bool ok) { cp_async4(dst, src, ok); }

__device__ __forceinline__ void stage_bias(float* dst, const __nv_bfloat16* src, bool ok) {
  *dst = ok ? __bfloat162float(*src) : 0.f;
}

template <int DH, typename TB>
__global__ void __launch_bounds__(kFwdThreads)
biased_attention_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const TB* __restrict__ bias,
                                 const unsigned char* __restrict__ pad, float* __restrict__ out, int H,
                                 int S, int bias_heads, float scale) {
  using Shape = FwdShape<DH>;
  constexpr int LD = Shape::kLd;
  constexpr int KT = Shape::kKeys;
  constexpr int GK = Shape::kGroupKeys;
  constexpr int NT = Shape::kGroupNt;
  constexpr int BLD = Shape::kBiasLd;
  constexpr int DT = DH / 8;  // 8-dim steps: the k steps of S, the n-tiles of O
  constexpr int C4 = DH / 4;  // 16-byte chunks per row
  extern __shared__ __align__(128) float smem[];
  float* q_s = smem;                         // [kRows][LD], scaled at tile 0
  float* k_s = q_s + kRows * LD;             // [kStages][KT][LD]
  float* v_s = k_s + kStages * KT * LD;      // [kStages][KT][LD]
  float* bias_s = v_s + kStages * KT * LD;   // [kStages][kRows][BLD]: f32(bias)
  float* pad_s = bias_s + kStages * kRows * BLD;  // [kStages][KT]: -1e9 on a padded key, else 0

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;  // the fragment row group
  const int tq = lane & 3;    // the fragment column pair
  const int rw = warp % kRowWarps;  // this warp's 16-row tile
  const int kg = warp / kRowWarps;  // and its key group: keys GK kg .. of every tile
  const long long bh = (long long)b * H + h;
  const long long base = bh * S * DH;
  const int n_tiles = (S + KT - 1) / KT;
  const int r0 = q0 + 16 * rw;  // this warp's first row
  const bool active = r0 < S;   // warp-uniform: a warp past S only copies
  const int rows = min(kRows, S - q0);  // the block's rows below S
  const TB* bias_bh =
      bias == nullptr ? nullptr
                      : bias + ((long long)b * bias_heads + (bias_heads == 1 ? 0 : h)) * S * (long long)S;
  const unsigned char* pad_b = pad == nullptr ? nullptr : pad + (long long)b * S;

  // tile t of K, V (keys past S zero-filled), the bias (the block's rows
  // below S; keys past S zero-filled) and the pad terms into stage t %
  // kStages
  auto load_tile = [&](int t) {
    const int k0 = t * KT;
    const int st = t % kStages;
    float* kd = k_s + st * KT * LD;
    float* vd = v_s + st * KT * LD;
    for (int c = tid; c < KT * C4; c += kFwdThreads) {
      const int row = c / C4;
      const int col = (c % C4) * 4;
      const bool ok = k0 + row < S;
      const long long src = base + (long long)(ok ? k0 + row : 0) * DH + col;
      cp_async16(kd + row * LD + col, k + src, ok);
      cp_async16(vd + row * LD + col, v + src, ok);
    }
    const int j = tid % KT;
    const bool key_ok = k0 + j < S;
    if (bias_bh != nullptr) {
      float* bd = bias_s + st * kRows * BLD;
      for (int r = tid / KT; r < rows; r += kFwdThreads / KT)
        stage_bias(bd + r * BLD + j, bias_bh + (key_ok ? (long long)(q0 + r) * S + k0 + j : 0), key_ok);
    }
    if (pad_b != nullptr && tid < KT) pad_s[st * KT + j] = key_ok && pad_b[k0 + j] ? kMaskBias : 0.f;
  };

  for (int c = tid; c < kRows * C4; c += kFwdThreads) {
    const int row = c / C4;
    const int col = (c % C4) * 4;
    const bool ok = q0 + row < S;
    cp_async16(q_s + row * LD + col, q + base + (long long)(ok ? q0 + row : 0) * DH + col, ok);
  }
  load_tile(0);
  cp_async_commit();

  // this lane's rows grp (a) and grp + 8 (b): below S, and their offsets in
  // a staged bias tile at the warp's keys
  const int row_a = r0 + grp;
  const bool ok_a = row_a < S;
  const bool ok_b = row_a + 8 < S;
  const int off_a = (16 * rw + grp) * BLD + GK * kg + 2 * tq;
  const int off_b = off_a + 8 * BLD;

  // m and l of rows a and b over the warp's keys; l is this lane's share of
  // the row sum until the end
  float m[2] = {kMaskBias, kMaskBias};
  float l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kw = t * KT + GK * kg;  // the warp's first key of the tile
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {  // q in f32 times scale, as the CUDA-core kernel forms it
      for (int e = tid; e < kRows * DH; e += kFwdThreads) q_s[(e / DH) * LD + e % DH] *= scale;
      __syncthreads();
    }

    // 8-key n-tiles of the warp's keys with a key below S, warp-uniform
    const int nts = active ? max(0, min(NT, (S - kw + 7) >> 3)) : 0;
    if (nts > 0) {
      const int st = t % kStages;
      const float* kt = k_s + (st * KT + GK * kg) * LD;  // the warp's keys
      const float* vt = v_s + (st * KT + GK * kg) * LD;
      const float* bt = bias_s + st * kRows * BLD;
      const float* pt = pad_s + st * KT + GK * kg;

      // S = Q K^T: 16 rows x the warp's keys, k = DH dims, each 3xTF32
      // term in its own accumulator
      float sc[NT][3][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int t3 = 0; t3 < 3; ++t3)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[n][t3][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DT; ++ks) {
        const Frag<4> aq = load_a<LD>(q_s, 16 * rw, 8 * ks, lane);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          if (n < nts) mma_3xtf32_terms(sc[n], aq, load_b_cols<LD>(kt, 8 * n, 8 * ks, lane));
      }

      // the scores with max(bias + pad, -1e9) (kept in sc[n][0]), the row
      // max and the rescaling of what came before
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < nts) {
          float2 pd = make_float2(0.f, 0.f);  // keys 2 tq, 2 tq + 1 of the n-tile
          if (pad_b != nullptr) pd = *reinterpret_cast<const float2*>(pt + 8 * n + 2 * tq);
          float bs[4] = {0.f, 0.f, 0.f, 0.f};  // C elements: rows a, a, b, b
          if (bias_bh != nullptr) {
            if (ok_a) {
              const float2 b2 = *reinterpret_cast<const float2*>(bt + off_a + 8 * n);
              bs[0] = b2.x;
              bs[1] = b2.y;
            }
            if (ok_b) {
              const float2 b2 = *reinterpret_cast<const float2*>(bt + off_b + 8 * n);
              bs[2] = b2.x;
              bs[3] = b2.y;
            }
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float comb = fmaxf(bs[c] + ((c & 1) ? pd.y : pd.x), kMaskBias);
            const float s = kw + 8 * n + 2 * tq + (c & 1) < S ? terms_sum(sc[n], c) + comb : -INFINITY;
            sc[n][0][c] = s;
            mx[c >> 1] = fmaxf(mx[c >> 1], s);
          }
        }
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(kFull, mx[hi], 1));
        mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(kFull, mx[hi], 2));
        const float m_new = fmaxf(m[hi], mx[hi]);
        const float alpha = expf(m[hi] - m_new);
        m[hi] = m_new;
        l[hi] *= alpha;
#pragma unroll
        for (int n = 0; n < DT; ++n) {
          o[n][2 * hi] *= alpha;
          o[n][2 * hi + 1] *= alpha;
        }
      }

      // p, summed, and O += P V per n-tile: k = the n-tile's 8 keys, n = DH
      // dims
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < nts) {
          float p[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) p[c] = expf(sc[n][0][c] - m[c >> 1]);
          l[0] += p[0] + p[1];
          l[1] += p[2] + p[3];
          const Frag<4> ap = acc_as_a(p);
#pragma unroll
          for (int dn = 0; dn < DT; ++dn) mma_3xtf32(o[dn], ap, load_b_rows<LD>(vt, 8 * n, 8 * dn, lane));
        }
      }
    }
    __syncthreads();  // the tile's buffers are consumed before tile t + 2 lands in them
  }

  // the key groups meet: groups 1.. leave each lane's o, m and l in the
  // consumed K and V rings ([group][row tile][value][lane], conflict-free),
  // and group 0 merges them into its own as blocks of an online softmax
  constexpr int kPartial = Shape::kPartial;
  float* const partials = k_s;
  if (kg > 0 && active) {
    float* partial = partials + ((kg - 1) * kRowWarps + rw) * kPartial * 32 + lane;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) partial[(4 * n + c) * 32] = o[n][c];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      partial[(4 * DT + hi) * 32] = m[hi];
      partial[(4 * DT + 2 + hi) * 32] = l[hi];
    }
  }
  __syncthreads();
  if (kg > 0 || !active) return;
  for (int g = 1; g < kKeyGroups; ++g) {
    const float* partial = partials + ((g - 1) * kRowWarps + rw) * kPartial * 32 + lane;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float m1 = partial[(4 * DT + hi) * 32];
      const float m_new = fmaxf(m[hi], m1);
      const float a0 = expf(m[hi] - m_new);
      const float a1 = expf(m1 - m_new);
      m[hi] = m_new;
      l[hi] = l[hi] * a0 + partial[(4 * DT + 2 + hi) * 32] * a1;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        o[n][2 * hi] = o[n][2 * hi] * a0 + partial[(4 * n + 2 * hi) * 32] * a1;
        o[n][2 * hi + 1] = o[n][2 * hi + 1] * a0 + partial[(4 * n + 2 * hi + 1) * 32] * a1;
      }
    }
  }

  // the row sums over the 4 lanes of each row; out = o / l, rows a and b,
  // two neighbouring dims a lane
  float f[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(kFull, l[hi], 1);
    l[hi] += __shfl_xor_sync(kFull, l[hi], 2);
    f[hi] = 1.f / fmaxf(l[hi], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int col = 8 * n + 2 * tq;
    if (ok_a)
      *reinterpret_cast<float2*>(out + base + (long long)row_a * DH + col) =
          make_float2(o[n][0] * f[0], o[n][1] * f[0]);
    if (ok_b)
      *reinterpret_cast<float2*>(out + base + (long long)(row_a + 8) * DH + col) =
          make_float2(o[n][2] * f[1], o[n][3] * f[1]);
  }
}

template <int DH, typename TB>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, const void* pad, void* out,
                   int B, int H, int S, int bias_heads, float scale, cudaStream_t stream) {
  constexpr size_t smem = FwdShape<DH>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(biased_attention_fwd_tf32_kernel<DH, TB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (S + kRows - 1) / kRows, B);
  biased_attention_fwd_tf32_kernel<DH, TB><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const TB*>(bias), static_cast<const unsigned char*>(pad), static_cast<float*>(out), H, S,
      bias_heads, scale);
  return cudaGetLastError();
}

template <typename TB>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, const void* bias, const void* pad, void* out,
                         int B, int H, int S, int DH, int bias_heads, float scale, cudaStream_t stream) {
  switch (DH) {
    case 16: return launch<16, TB>(q, k, v, bias, pad, out, B, H, S, bias_heads, scale, stream);
    case 32: return launch<32, TB>(q, k, v, bias, pad, out, B, H, S, bias_heads, scale, stream);
    case 64: return launch<64, TB>(q, k, v, bias, pad, out, B, H, S, bias_heads, scale, stream);
    case 128: return launch<128, TB>(q, k, v, bias, pad, out, B, H, S, bias_heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// float32 q, k, v (dtype 0) at DH = 16, 32, 64 or 128; bias_dtype 0 =
// float32, 1 = bfloat16; anything else returns cudaErrorInvalidValue. q, k,
// v and out must be 16-byte aligned (the wrapper checks q, k and v and
// allocates out). bias and pad may be null; bias_heads is 1 (a head-shared
// bias) or H, and is ignored without a bias. Returns a cudaError_t (0 on
// success).
extern "C" int biased_attention_fwd_tf32(const void* q, const void* k, const void* v, const void* bias,
                                         const void* pad, void* out, int B, int H, int S, int DH,
                                         int bias_heads, float scale, int dtype, int bias_dtype,
                                         void* stream) {
  // the grid's y dimension counts 32-row q tiles
  if (dtype != 0 || B <= 0 || H <= 0 || S <= 0 || B > 65535 || (S + kRows - 1) / kRows > 65535)
    return cudaErrorInvalidValue;
  if (bias != nullptr && bias_heads != 1 && bias_heads != H) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bias_dtype == 0) return dispatch_dim<float>(q, k, v, bias, pad, out, B, H, S, DH, bias_heads, scale, st);
  if (bias_dtype == 1)
    return dispatch_dim<__nv_bfloat16>(q, k, v, bias, pad, out, B, H, S, DH, bias_heads, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* biased_attention_fwd_tf32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
