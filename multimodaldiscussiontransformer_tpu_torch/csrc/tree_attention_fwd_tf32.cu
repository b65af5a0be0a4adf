// Compact-bias tree attention, forward, for Hopper (sm_90a): one pass on
// tensor cores for float32 at DH = 16, 32, 64 and 128, any S >= 1, every
// product in 3xTF32, K and V streamed in tiles.
//
// Replaces the forward Pallas kernels of the JAX package
// (multimodaldiscussiontransformer_tpu/ops/tree_attention.py) on the float32
// route, as tree_attention_fwd_mma.cu does on the bf16 one:
//   _make_kernel_batched              (:103, rate 0, padded S <= 128),
//   _make_kernel                      (:66, rate 0, 128 < padded S < 513),
//   _make_kernel_flash                (:228, padded S >= 513, with the
//                                      dropout of :218 and the LSE page of
//                                      :370),
//   _make_kernel_flash_lse            (:418, the LSE for the backward),
//   _make_dropout_fwd_kernel_batched  (:1096, dropout, padded S <= 128),
//   _make_dropout_fwd_kernel          (:973, dropout, 128 < padded S < 513).
//
// Function, that of tree_attention_fwd_mma.cu, for each (b, h, i):
//   s_ij  = (scale q_i) . k_j + c max(tpl[b,i,j], -1e9) + lut[ids[b,i,j], h]
//           (q scaled in f32; c = 2 with the reference's double-added bias,
//            else 1; ids 0 and ids outside [0, 32) add nothing; keys >= S
//            score -inf)
//   m_i   = max(-1e9, max_j s_ij),  e_ij = exp(s_ij - m_i)
//   l_i   = max(sum_j e_ij, 1e-30)                  (the UNDROPPED sum)
//   out_i = sum_j keep_ij e_ij v_j / ((1 - rate) l_i)
//   lse_i = m_i + log(l_i)                          (optional, f32 (B, H, S))
// keep_ij is the Philox mask of tree_attention_common.cuh, counter (j / 4,
// i, h, b), so every backward pair regenerates it bit for bit and reads this
// kernel's LSE. A row whose every key the template masks (c = 2: s = -2e9)
// gets e = 0, l = 1e-30, zeros and the LSE -1e9 + log(1e-30).
//
// Precision, 3xTF32 (tf32_common.cuh): S = Q K^T and O += P V run on
// mma.sync.m16n8k8 with each float32 operand split into two TF32 parts and
// the three larger cross products summed in f32 (~2^-22 of each product
// dropped), where one TF32 product (~2^-11) would break the float32 route's
// 1e-4 tolerances. P stays f32 in registers and is split like any operand.
//
// What bounds it: at S = 1025, B = 1, H = 12, DH = 64 the call reads q, k,
// v and the head-shared tpl/ids (8.4 MB, read by every head) and writes out
// and the LSE, ~21 MB or ~6 us at 3.35 TB/s, against 4 B H S^2 DH = 3.2
// GFLOP, 48 us at the 67 TFLOP/s of float32 on CUDA cores and, as three
// TF32 products each, 20 us at the 495 TFLOP/s of dense TF32: bound by
// operations. At the canonical S = 33 bytes and launch latency bound it.
//
// Design, one block per (head, 32-row q tile, graph), 4 warps: two 16-row
// tiles x two key groups, the layout of tree_attention_fwd_mma.cu. The
// head is blockIdx.x, so the H blocks that read the same (graph, q tile)
// rows of tpl and ids run together and L2 serves the H - 1 re-reads.
// - Q's tile is staged once (16-byte cp.async, rows past S zero-filled),
//   row-major with DH + 4 floats a row, and scaled in place in f32.
// - K, V and the (32 rows x keys) tpl/ids tile stream through a
//   double-buffered cp.async ring: K and V by 16-byte copies (keys past S
//   zero-filled), tpl and ids by 4-byte copies (their rows start at 4 S
//   bytes, not 16-byte aligned for odd S). 64-key tiles at DH <= 32,
//   32-key tiles at DH >= 64: 62 KB of shared memory at DH 64, three blocks
//   an SM (two at DH 128).
// - Key group g of a row tile scores keys KT/2 g .. of every tile and keeps
//   its own online softmax; at the end group 1 leaves its row max, sum and
//   output in the consumed ring and group 0 merges them.
// - Per key tile and warp: the keep bits (chunk_keep_bits of
//   mma_common.cuh: the m16n8k8 C layout is that of m16n8k16) are drawn
//   before the copies are waited for; S = Q K^T with each 3xTF32 term in an
//   accumulator of its own (three independent mma chains over DH); the
//   score is formed in f32 on the accumulator as acc + c max(tpl, -1e9) +
//   lut_s[id], each lane reading its tpl/ids entries in the C-fragment
//   layout (rows grp, grp + 8; keys 2 tq, 2 tq + 1 of each n-tile); then an
//   online softmax on the C fragments (row max over the 4 lanes of a row,
//   rescaled f32 sum and output), and O += P V with P kept f32 in the
//   registers where Q K^T left it and taken as the A operand through the
//   permuted k index (acc_as_a), V's B fragments read as (row 2 tq, column
//   grp): no shuffle and no trip through shared memory.
// - The output is written once from the fragments (8-byte stores), the LSE
//   when asked. The kernel allocates nothing; the caller passes out and lse.
// The operands are split where they are read, each time: two cvt and one
// subtraction per element and use. The exponentials are expf.

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
  static constexpr int kBiasLd = kKeys + 4;                // entries per staged tpl/ids row
  static constexpr int kPartial = 4 * (DH / 8) + 4;        // a lane's o, m and l
  // Q, the K and V rings, the tpl and ids rings (DH 64: 62 KB)
  static constexpr size_t kSmem =
      sizeof(float) * (size_t)(kRows * kLd + 2 * kStages * kKeys * kLd + 2 * kStages * kRows * kBiasLd);
  static_assert(sizeof(float) * (kKeyGroups - 1) * kRowWarps * kPartial * 32 <=
                    sizeof(float) * 2 * kStages * kKeys * kLd,
                "the key groups' partial rows meet in the K and V rings");
};

template <int DH>
__global__ void __launch_bounds__(kFwdThreads)
tree_attention_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ tpl,
                               const int* __restrict__ ids, const float* __restrict__ lut,
                               float* __restrict__ out, float* __restrict__ lse, int H, int S,
                               float scale, float tpl_coef, uint2 seed, unsigned thr,
                               float keep_scale) {
  using Shape = FwdShape<DH>;
  constexpr int LD = Shape::kLd;
  constexpr int KT = Shape::kKeys;
  constexpr int GK = Shape::kGroupKeys;
  constexpr int NT = Shape::kGroupNt;
  constexpr int BLD = Shape::kBiasLd;
  constexpr int DT = DH / 8;  // 8-dim steps: the k steps of S, the n-tiles of O
  constexpr int C4 = DH / 4;  // 16-byte chunks per row
  extern __shared__ __align__(128) float smem[];
  float* q_s = smem;                       // [kRows][LD], scaled at tile 0
  float* k_s = q_s + kRows * LD;           // [kStages][KT][LD]
  float* v_s = k_s + kStages * KT * LD;    // [kStages][KT][LD]
  float* tpl_s = v_s + kStages * KT * LD;  // [kStages][kRows][BLD]
  int* ids_s = reinterpret_cast<int*>(tpl_s + kStages * kRows * BLD);
  __shared__ float lut_s[kLutSize];

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
  const long long graph = (long long)b * S * S;

  // tile t of K, V (keys past S zero-filled), tpl and ids (the block's rows
  // below S; keys past S zero-filled) into stage t % kStages
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
    float* td = tpl_s + st * kRows * BLD;
    int* idd = ids_s + st * kRows * BLD;
    const int j = tid % KT;
    const bool key_ok = k0 + j < S;
    for (int r = tid / KT; r < rows; r += kFwdThreads / KT) {
      const long long src = key_ok ? graph + (long long)(q0 + r) * S + k0 + j : 0;
      cp_async4(td + r * BLD + j, tpl + src, key_ok);
      cp_async4(idd + r * BLD + j, ids + src, key_ok);
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
  if (tid < kLutSize) lut_s[tid] = tid == 0 ? 0.f : lut[tid * H + h];

  // this lane's rows grp (a) and grp + 8 (b): below S, and their offsets
  // in a staged tpl/ids tile at the warp's keys
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
    // the warp's keep bits of the tile while its copies land (all set at rate 0)
    const unsigned keep = thr != 0u && active ? chunk_keep_bits<NT>(r0, kw, h, b, seed, thr, lane) : ~0u;
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {  // q in f32 times scale, as the plain version forms it
      for (int e = tid; e < kRows * DH; e += kFwdThreads) q_s[(e / DH) * LD + e % DH] *= scale;
      __syncthreads();
    }

    // 8-key n-tiles of the warp's keys with a key below S, warp-uniform
    const int nts = active ? max(0, min(NT, (S - kw + 7) >> 3)) : 0;
    if (nts > 0) {
      const int st = t % kStages;
      const float* kt = k_s + (st * KT + GK * kg) * LD;  // the warp's keys
      const float* vt = v_s + (st * KT + GK * kg) * LD;
      const float* tt = tpl_s + st * kRows * BLD;
      const int* it = ids_s + st * kRows * BLD;

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

      // the scores with the compact bias (kept in sc[n][0]), the row max
      // and the rescaling of what came before
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < nts) {
          float bias[4] = {0.f, 0.f, 0.f, 0.f};  // C elements: rows a, a, b, b
          if (ok_a) {
            const float2 t2 = *reinterpret_cast<const float2*>(tt + off_a + 8 * n);
            const int2 i2 = *reinterpret_cast<const int2*>(it + off_a + 8 * n);
            bias[0] = bias_of(t2.x, i2.x, lut_s, tpl_coef);
            bias[1] = bias_of(t2.y, i2.y, lut_s, tpl_coef);
          }
          if (ok_b) {
            const float2 t2 = *reinterpret_cast<const float2*>(tt + off_b + 8 * n);
            const int2 i2 = *reinterpret_cast<const int2*>(it + off_b + 8 * n);
            bias[2] = bias_of(t2.x, i2.x, lut_s, tpl_coef);
            bias[3] = bias_of(t2.y, i2.y, lut_s, tpl_coef);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float s = kw + 8 * n + 2 * tq + (c & 1) < S ? terms_sum(sc[n], c) + bias[c] : -INFINITY;
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
  if (lse != nullptr && tq == 0) {
    if (ok_a) lse[bh * S + row_a] = m[0] + logf(denom[0]);
    if (ok_b) lse[bh * S + row_a + 8] = m[1] + logf(denom[1]);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* tpl, const void* ids,
                   const void* lut, void* out, void* lse, int B, int H, int S, float scale,
                   float tpl_coef, uint2 seed, unsigned thr, float keep_scale, cudaStream_t stream) {
  constexpr size_t smem = FwdShape<DH>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(tree_attention_fwd_tf32_kernel<DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (S + kRows - 1) / kRows, B);
  tree_attention_fwd_tf32_kernel<DH><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(tpl), static_cast<const int*>(ids), static_cast<const float*>(lut),
      static_cast<float*>(out), static_cast<float*>(lse), H, S, scale, tpl_coef, seed, thr, keep_scale);
  return cudaGetLastError();
}

}  // namespace

// float32 (dtype 0) at DH = 16, 32, 64 or 128; anything else returns
// cudaErrorInvalidValue. q, k, v and out must be 16-byte aligned (the
// wrapper checks q, k and v and allocates out). lse may be null. The
// dropout mask is keyed by (seed_hi << 32 | seed_lo); thr = 0 keeps every
// key, and keep_scale is 1 / (1 - rate). Returns a cudaError_t (0 on
// success).
extern "C" int tree_attention_fwd_tf32(const void* q, const void* k, const void* v,
                                       const void* tpl, const void* ids, const void* lut,
                                       void* out, void* lse, int B, int H, int S, int DH,
                                       float scale, float tpl_coef, unsigned seed_lo,
                                       unsigned seed_hi, unsigned thr, float keep_scale, int dtype,
                                       void* stream) {
  // the grid's y dimension counts 32-row q tiles
  if (dtype != 0 || B <= 0 || H <= 0 || S <= 0 || B > 65535 || (S + kRows - 1) / kRows > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint2 seed = make_uint2(seed_lo, seed_hi);
  switch (DH) {
    case 16: return launch<16>(q, k, v, tpl, ids, lut, out, lse, B, H, S, scale, tpl_coef, seed, thr, keep_scale, st);
    case 32: return launch<32>(q, k, v, tpl, ids, lut, out, lse, B, H, S, scale, tpl_coef, seed, thr, keep_scale, st);
    case 64: return launch<64>(q, k, v, tpl, ids, lut, out, lse, B, H, S, scale, tpl_coef, seed, thr, keep_scale, st);
    case 128: return launch<128>(q, k, v, tpl, ids, lut, out, lse, B, H, S, scale, tpl_coef, seed, thr, keep_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* tree_attention_fwd_tf32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
