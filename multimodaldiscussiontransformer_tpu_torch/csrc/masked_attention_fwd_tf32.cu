// Tower attention with a per-key bias, forward, for Hopper (sm_90a): one
// pass on tensor cores for float32 at DH = 16, 32, 64 and 128, any S >= 1,
// every product in 3xTF32, K and V streamed in tiles.
//
// Replaces the Pallas kernel `_make_fwd_kernel` of the JAX package
// (multimodaldiscussiontransformer_tpu/ops/masked_attention.py:86), the
// fused self-attention of the BERT and ViT tower layers, on the float32
// route, as masked_attention_fwd_mma.cu and masked_attention_fwd_tiled.cu
// do on the bf16 one. Its statistics feed the 3xTF32 backward pair
// masked_attention_bwd_tf32.cu.
//
// Function, that of masked_attention_fwd_mma.cu, for each (b, h, i):
//   s_ij  = (scale q_i) . k_j + max(kb[b, j], -1e9)     (q scaled in f32;
//                                                         kb = 0 when null;
//                                                         keys >= S: -inf)
//   m_i   = max(-1e9, max_j s_ij),  e_ij = exp(s_ij - m_i)
//   l_i   = max(sum_j e_ij, 1e-30)                       (the UNDROPPED sum)
//   out_i = sum_j keep_ij e_ij v_j / ((1 - rate) l_i)
//   stats[0, i] = m_i, stats[1, i] = log(l_i)            (optional, stored apart)
// keep_ij is the Philox mask of tree_attention_common.cuh, counter
// (j / 4, i, h, b). A capacity-padding row (every key at -1e9) has s =
// -1e9 exactly (|q . k| scale is far below the float32 step of 64 there),
// m = -1e9 and e = 1: equal weights 1/S over its S keys, as from the
// CUDA-core kernel. The row max and the log of the sum are stored apart:
// their sum would be about -1e9 for such a row, where log(l_i) is lost.
//
// Precision, 3xTF32 (tf32_common.cuh): S = Q K^T and O += P V run on
// mma.sync.m16n8k8 with each float32 operand split into two TF32 parts and
// the three larger cross products summed in f32; P stays f32 in registers.
//
// What bounds it: at the text-fusion shape (B = 256 rows, S = 104, H = 12,
// DH = 64) the call reads q, k, v, the key bias and writes out and the two
// statistics planes, ~330 MB or ~98 us at 3.35 TB/s, against 4 B H S^2 DH
// = 8.5 GFLOP: 127 us at the 67 TFLOP/s of float32 on CUDA cores, 52 us
// as three TF32 products each at the 495 TFLOP/s of dense TF32. On tensor
// cores bytes bound it.
//
// Design, the tree forward's (tree_attention_fwd_tf32.cu) with the (B, S)
// key bias in place of tpl/ids/LUT: one block per (64-row q tile, head,
// batch row), 8 warps, four 16-row tiles x two key groups; the q tile is
// blockIdx.x, so the blocks that read one (b, h)'s K and V run together and
// L2 serves the re-reads.
// - Q's tile is staged once (16-byte cp.async, rows past S zero-filled),
//   row-major with DH + 4 floats a row, and scaled in place in f32.
// - K, V and the tile's key biases stream through a double-buffered
//   cp.async ring: K and V by 16-byte copies (keys past S zero-filled), the
//   KT raw biases by 4-byte copies (clamped at -1e9 where they are read).
//   64-key tiles at DH <= 64 (88 KB of shared memory at DH 64, two blocks
//   an SM), 32-key tiles at DH 128. Shared memory does not grow with S.
// - Per key tile and warp: the keep bits (chunk_keep_bits), S = Q K^T with
//   each 3xTF32 term in an accumulator of its own, the scores on the
//   accumulator, an online softmax on the C fragments, and O += P V with P
//   taken from the registers as the A operand (acc_as_a).
// - The key groups merge through the consumed ring; the output is written
//   once from the fragments (8-byte stores), the statistics when asked.
// The operands are split where they are read, each time. The exponentials
// are expf, as in the backward, so that the statistics match its
// recomputed p.

#include "mma_common.cuh"
#include "tf32_common.cuh"
#include "tree_attention_common.cuh"

namespace {

using namespace tree_attention;
using namespace tf32_mma;
using tower_mma::chunk_keep_bits;
using tower_mma::cp_async16;
using tower_mma::cp_async4;
using tower_mma::cp_async_commit;
using tower_mma::cp_async_wait;

constexpr int kStages = 2;                       // the ring's depth
constexpr int kRowWarps = 4;                     // 16-row tiles per block
constexpr int kKeyGroups = 2;                    // warps that split each key tile
constexpr int kFwdWarps = kRowWarps * kKeyGroups;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kRows = 16 * kRowWarps;            // q rows per block

template <int DH>
struct FwdShape {
  static constexpr int kLd = DH + 4;                       // floats per staged row
  static constexpr int kKeys = DH <= 64 ? 64 : 32;         // keys per streamed tile
  static constexpr int kGroupKeys = kKeys / kKeyGroups;    // keys per warp and tile
  static constexpr int kGroupNt = kGroupKeys / 8;          // 8-key n-tiles per warp and tile
  static constexpr int kPartial = 4 * (DH / 8) + 4;        // a lane's o, m and l
  static constexpr int kMinBlocks = DH <= 64 ? 2 : 1;      // blocks an SM the registers leave room for
  // Q, the K and V rings, the key-bias ring (DH 64: 88 KB)
  static constexpr size_t kSmem =
      sizeof(float) * (size_t)(kRows * kLd + 2 * kStages * kKeys * kLd + kStages * kKeys);
  static_assert(sizeof(float) * (kKeyGroups - 1) * kRowWarps * kPartial * 32 <=
                    sizeof(float) * 2 * kStages * kKeys * kLd,
                "the key groups' partial rows meet in the K and V rings");
};

template <int DH>
__global__ void __launch_bounds__(kFwdThreads, FwdShape<DH>::kMinBlocks)
masked_attention_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ key_bias,
                                 float* __restrict__ out, float* __restrict__ stats, int B, int H,
                                 int S, float scale, uint2 seed, unsigned thr, float keep_scale) {
  using Shape = FwdShape<DH>;
  constexpr int LD = Shape::kLd;
  constexpr int KT = Shape::kKeys;
  constexpr int GK = Shape::kGroupKeys;
  constexpr int NT = Shape::kGroupNt;
  constexpr int DT = DH / 8;  // 8-dim steps: the k steps of S, the n-tiles of O
  constexpr int C4 = DH / 4;  // 16-byte chunks per row
  extern __shared__ __align__(128) float smem[];
  float* q_s = smem;                      // [kRows][LD], scaled at tile 0
  float* k_s = q_s + kRows * LD;          // [kStages][KT][LD]
  float* v_s = k_s + kStages * KT * LD;   // [kStages][KT][LD]
  float* kb_s = v_s + kStages * KT * LD;  // [kStages][KT]: the raw key biases

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
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
  const float* bias_b = key_bias == nullptr ? nullptr : key_bias + (long long)b * S;

  // tile t of K, V (keys past S zero-filled) and the key biases (those
  // past S are never read) into stage t % kStages
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
    if (bias_b != nullptr && tid < KT) {
      const bool ok = k0 + tid < S;
      cp_async4(kb_s + st * KT + tid, bias_b + (ok ? k0 + tid : 0), ok);
    }
  };

  for (int c = tid; c < kRows * C4; c += kFwdThreads) {
    const int row = c / C4;
    const int col = (c % C4) * 4;
    const bool ok = q0 + row < S;
    cp_async16(q_s + row * LD + col, q + base + (long long)(ok ? q0 + row : 0) * DH + col, ok);
  }
  load_tile(0);
  cp_async_commit();

  const int row_a = r0 + grp;  // this lane's rows grp (a) and grp + 8 (b)
  const bool ok_a = row_a < S;
  const bool ok_b = row_a + 8 < S;

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
    // the warp's keep bits of the tile while its copies land (all set at rate 0)
    const unsigned keep = thr != 0u && active ? chunk_keep_bits<NT>(r0, kw, h, b, seed, thr, lane) : ~0u;
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
      const float* kbt = kb_s + st * KT + GK * kg;

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

      // the scores with the clamped key bias (kept in sc[n][0]), the row
      // max and the rescaling of what came before
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < nts) {
          float kb[2] = {0.f, 0.f};  // keys 2 tq, 2 tq + 1 of the n-tile
          if (bias_b != nullptr) {
            const float2 k2 = *reinterpret_cast<const float2*>(kbt + 8 * n + 2 * tq);
            kb[0] = fmaxf(k2.x, kMaskBias);
            kb[1] = fmaxf(k2.y, kMaskBias);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float s = kw + 8 * n + 2 * tq + (c & 1) < S ? terms_sum(sc[n], c) + kb[c & 1] : -INFINITY;
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

      // p (summed undropped), the keep bits, and O += P V per n-tile:
      // k = the n-tile's 8 keys, n = DH dims
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < nts) {
          float p[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) p[c] = expf(sc[n][0][c] - m[c >> 1]);
          l[0] += p[0] + p[1];
          l[1] += p[2] + p[3];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (!((keep >> (4 * n + c)) & 1u)) p[c] = 0.f;
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

  // the row sums over the 4 lanes of each row; out = o / ((1 - rate) l),
  // rows a and b, two neighbouring dims a lane
  float denom[2], f[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(kFull, l[hi], 1);
    l[hi] += __shfl_xor_sync(kFull, l[hi], 2);
    denom[hi] = fmaxf(l[hi], 1e-30f);
    f[hi] = keep_scale / denom[hi];
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
  if (stats != nullptr && tq == 0) {
    const long long plane = (long long)B * H * S;
    if (ok_a) {
      stats[bh * S + row_a] = m[0];
      stats[plane + bh * S + row_a] = logf(denom[0]);
    }
    if (ok_b) {
      stats[bh * S + row_a + 8] = m[1];
      stats[plane + bh * S + row_a + 8] = logf(denom[1]);
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_bias, void* out,
                   void* stats, int B, int H, int S, float scale, uint2 seed, unsigned thr,
                   float keep_scale, cudaStream_t stream) {
  constexpr size_t smem = FwdShape<DH>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(masked_attention_fwd_tf32_kernel<DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  masked_attention_fwd_tf32_kernel<DH><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(key_bias), static_cast<float*>(out), static_cast<float*>(stats), B, H, S,
      scale, seed, thr, keep_scale);
  return cudaGetLastError();
}

}  // namespace

// float32 (dtype 0) at DH = 16, 32, 64 or 128; anything else returns
// cudaErrorInvalidValue. q, k, v and out must be 16-byte aligned (the
// wrapper checks q, k and v and allocates out). key_bias and stats may be
// null. The dropout mask is keyed by (seed_hi << 32 | seed_lo); thr = 0
// keeps every key, and keep_scale is 1 / (1 - rate). Returns a cudaError_t
// (0 on success).
extern "C" int masked_attention_fwd_tf32(const void* q, const void* k, const void* v,
                                         const void* key_bias, void* out, void* stats, int B, int H,
                                         int S, int DH, float scale, unsigned seed_lo,
                                         unsigned seed_hi, unsigned thr, float keep_scale, int dtype,
                                         void* stream) {
  if (dtype != 0 || B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint2 seed = make_uint2(seed_lo, seed_hi);
  switch (DH) {
    case 16: return launch<16>(q, k, v, key_bias, out, stats, B, H, S, scale, seed, thr, keep_scale, st);
    case 32: return launch<32>(q, k, v, key_bias, out, stats, B, H, S, scale, seed, thr, keep_scale, st);
    case 64: return launch<64>(q, k, v, key_bias, out, stats, B, H, S, scale, seed, thr, keep_scale, st);
    case 128: return launch<128>(q, k, v, key_bias, out, stats, B, H, S, scale, seed, thr, keep_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* masked_attention_fwd_tf32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
