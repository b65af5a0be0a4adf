// Tower attention with a per-key bias, backward, for Hopper (sm_90a): two
// kernels on tensor cores for bf16 at DH = 16, 32, 64 and 128, any S >= 1,
// streaming over S.
//
// Replaces the Pallas kernel `_make_bwd_kernel` of the JAX package
// (multimodaldiscussiontransformer_tpu/ops/masked_attention.py:134) on the
// bf16 shapes that the one-pass kernel masked_attention_bwd_mma.cu does not
// take: S > 256 and DH 16, 32 and 128. The Pallas kernel and the one-pass
// kernel hold every key of S in fast memory; past a few hundred keys that
// does not fit 227 KB of shared memory, so K and V (or Q and G) stream here.
//
// Function, that of masked_attention_bwd_mma.cu: with the row statistics m_i
// and log l_i that the tiled forward (masked_attention_fwd_tiled.cu) stores,
// D_i = g_i . out_i and the forwards' Philox keep mask (counter (j / 4, i,
// h, b) of tree_attention_common.cuh, regenerated bit for bit),
//   s_ij  = (q_i . k_j) * scale + max(kb[b, j], -1e9)  (kb = 0 when null;
//                                                       keys >= S: -inf)
//   p_ij  = exp((s_ij - m_i) - log l_i)
//   pd_ij = keep_ij p_ij / (1 - rate)
//   ds_ij = p_ij (keep_ij (g_i . v_j) / (1 - rate) - D_i)
//   dv_j  = sum_i pd_ij g_i,  dk_j = scale sum_i ds_ij q_i,
//   dq_i  = scale sum_j ds_ij k_j.
// The score is formed as the tiled forward forms it, acc * scale + kb in f32
// on the f32 accumulator, so that a capacity-padding row (every key at
// -1e9) gets s = -1e9, m = -1e9 and p = 1 / S again. The key bias gets no
// gradient, as in the JAX custom VJP.
//
// What bounds them: at S = 512, B = 64, H = 12, DH = 64 the pair reads q,
// k, v, g, out, the statistics and the key bias and writes dq, dk, dv and
// D, ~410 MB counted once, ~122 us at 3.35 TB/s, against 14 B H S^2 DH
// (S, dP and dQ in the first kernel; S^T, dP^T, dV and dK in the second) =
// 180 GFLOP, ~182 us at the bf16 tensor-core peak: the products bound it.
// A pair rather than one pass: one pass over key tiles would have to sum
// dq across blocks with f32 atomics, in no fixed order.
//
// masked_attention_bwd_dq_tiled_kernel (q-major), one block per (32-row q
// tile, head, batch row), 4 warps: two 16-row tiles x two key groups, the
// layout of tree_attention_bwd_mma.cu's dq kernel.
// - Q and G are staged once in bf16 (16-byte cp.async, rows past S
//   zero-filled) and each warp keeps its 16 rows of both as A fragments.
//   D_i is formed from g and out and written to `delta`.
// - K, V and the tile's key biases stream through a double-buffered
//   cp.async ring of 64-key tiles (the biases by 4-byte copies, clamped
//   where read).
// - Per tile each warp forms S = Q K^T and dP = G V^T over its 32 keys on
//   mma.sync.m16n8k16, then p, keep (chunk_keep_bits, as in the forward)
//   and ds in f32 on the C fragments, and dQ += dS K with dS rounded to
//   bf16 and taken from the accumulator fragments as the A operand (K by
//   ldmatrix.trans). dQ stays in registers for the whole key walk; the key
//   groups add theirs through the consumed ring, and dq is scaled and
//   written once, no atomics.
//
// masked_attention_bwd_dkv_tiled_kernel (k-major), one block per (32-key
// tile, head, batch row), 4 warps: two 16-key slices x two row groups.
// - The K and V tile is staged once; at DH <= 64 each warp keeps its 16 keys
//   of both as A fragments in registers, at DH 128 it reloads them by
//   ldmatrix each step (registers hold dK and dV, 128 f32 a lane). Each
//   lane keeps the clamped biases of its two keys in registers.
// - Q, G and the tile's row max, log-sum and delta stream through a
//   double-buffered ring of 64-row tiles; rows past S get m = +inf (p = 0)
//   and delta = 0.
// - Per 16-row step: S^T = K Q^T and dP^T = V G^T, p, keep
//   (key_major_keep_bits of mma_common.cuh), pd and ds in f32, then dV +=
//   Pd^T G and dK += dS^T Q with the accumulator fragments as A operands
//   (bf16) and G, Q by ldmatrix.trans. dK and dV stay in registers for the
//   whole q walk; the row groups add theirs through the consumed ring, and
//   the tile is written once in bf16 through the staged K and V tiles.
//
// Staged bf16 rows hold DH + 8 values, as in the tiled forward: ldmatrix
// and the fragment stores are free of bank conflicts at every DH.
//
// Precision: P and dS are rounded to bf16 before the second products, as in
// masked_attention_bwd_mma.cu and the tensor-core tree pair; row sums and
// D stay f32. The exponentials are expf, as in the forwards.

#include "mma_common.cuh"
#include "tree_attention_common.cuh"

namespace {

using tree_attention::kFull;
using tree_attention::kMaskBias;
using tower_mma::bf16;
using tower_mma::chunk_keep_bits;
using tower_mma::cp_async16;
using tower_mma::cp_async4;
using tower_mma::cp_async_commit;
using tower_mma::cp_async_wait;
using tower_mma::key_major_keep_bits;
using tower_mma::ldsm_x4;
using tower_mma::ldsm_x4_t;
using tower_mma::mma;
using tower_mma::pack_bf16;

constexpr int kStages = 2;  // the rings' depth

// the dq kernel
constexpr int kDqRowWarps = 2;                          // 16-row tiles per block
constexpr int kDqKeyGroups = 2;                         // warps that split each key tile
constexpr int kDqWarps = kDqRowWarps * kDqKeyGroups;
constexpr int kDqThreads = kDqWarps * 32;
constexpr int kDqRows = 16 * kDqRowWarps;               // q rows per block
constexpr int kDqKeys = 64;                             // keys per streamed tile
constexpr int kDqGroupKeys = kDqKeys / kDqKeyGroups;    // keys per warp and tile
constexpr int kDqGroupNt = kDqGroupKeys / 8;            // 8-key n-tiles per warp and tile
static_assert(kDqThreads == 4 * kDqRows, "four threads form each row's D");

// the dk/dv kernel
constexpr int kKvKeyWarps = 2;                          // 16-key slices per block
constexpr int kKvRowGroups = 2;                         // warps that split each q tile
constexpr int kKvWarps = kKvKeyWarps * kKvRowGroups;
constexpr int kKvThreads = kKvWarps * 32;
constexpr int kKvKeys = 16 * kKvKeyWarps;               // keys per block
constexpr int kKvRows = 64;                             // q rows per streamed tile
constexpr int kKvGroupRows = kKvRows / kKvRowGroups;    // rows per warp and tile

template <int DH>
struct Shape {
  static constexpr int kLd = DH + 8;      // bf16 values per staged row
  static constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  // Q and G, the K and V rings, the key-bias ring (DH 64: 46 KB)
  static constexpr size_t kDqSmem = sizeof(bf16) * (size_t)(2 * kDqRows * kLd + 2 * kStages * kDqKeys * kLd) +
                                    sizeof(float) * (size_t)(kStages * kDqKeys);
  static_assert(sizeof(float) * (kDqKeyGroups - 1) * kDqRowWarps * (DH / 2) * 32 <=
                    sizeof(bf16) * kStages * kDqKeys * kLd,
                "the key groups' dQ partials fit the K ring");
  // K and V, the Q and G rings, the row max, log-sum and delta rings (DH
  // 64: 47 KB)
  static constexpr size_t kKvSmem = sizeof(bf16) * (size_t)(2 * kKvKeys * kLd + 2 * kStages * kKvRows * kLd) +
                                    sizeof(float) * (size_t)(3 * kStages * kKvRows);
  static_assert(sizeof(float) * (kKvRowGroups - 1) * kKvKeyWarps * DH * 32 <=
                    sizeof(bf16) * 2 * kStages * kKvRows * kLd,
                "the row groups' dK and dV partials fit the Q and G rings");
  static constexpr bool kKeepKv = DH <= 64;  // K and V fragments held in registers
  // dk/dv blocks an SM the registers are capped for: at DH 64 three (167
  // registers, no spill) ran its kernel 8-15% faster on an H100 than two
  // (198 registers); at DH 128 three spill, at DH 16 and 32 it changed
  // nothing
  static constexpr int kKvMinBlocks = DH == 64 ? 3 : 2;
};

template <int DH>
__global__ void __launch_bounds__(kDqThreads, 2)
masked_attention_bwd_dq_tiled_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                     const bf16* __restrict__ v, const bf16* __restrict__ out,
                                     const bf16* __restrict__ g, const float* __restrict__ key_bias,
                                     const float* __restrict__ stats, bf16* __restrict__ dq,
                                     float* __restrict__ delta, int B, int H, int S, float scale, uint2 seed,
                                     unsigned thr, float keep_scale) {
  constexpr int LD = Shape<DH>::kLd;
  constexpr int CH = Shape<DH>::kChunks;
  constexpr int KS = DH / 16;  // 16-dim steps
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kDqRows][LD]; then the dq tile
  bf16* g_s = q_s + kDqRows * LD;                 // [kDqRows][LD]
  bf16* k_s = g_s + kDqRows * LD;                 // [kStages][kDqKeys][LD]
  bf16* v_s = k_s + kStages * kDqKeys * LD;       // [kStages][kDqKeys][LD]
  float* kb_s = reinterpret_cast<float*>(v_s + kStages * kDqKeys * LD);  // [kStages][kDqKeys]
  __shared__ float d_s[kDqRows];

  const int q0 = blockIdx.x * kDqRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;  // the fragment row group
  const int tq = lane & 3;    // the fragment column pair
  const int rw = warp % kDqRowWarps;  // this warp's 16-row tile
  const int kg = warp / kDqRowWarps;  // and its key group: keys kDqGroupKeys kg .. of every tile
  const long long bh = (long long)b * H + h;
  const long long base = bh * S * DH;
  const long long plane = (long long)B * H * S;  // stats[1] = log l
  const int kp = (S + 15) & ~15;  // keys padded to 16
  const int n_tiles = (S + kDqKeys - 1) / kDqKeys;
  const int r0 = q0 + 16 * rw;    // this warp's first row
  const bool active = r0 < S;     // warp-uniform: a warp past S only copies
  const float* bias_b = key_bias == nullptr ? nullptr : key_bias + (long long)b * S;

  // tile t of K, V (keys past S zero-filled) and the key biases (those
  // past S are never read) into stage t % kStages
  auto load_tile = [&](int t) {
    const int k0 = t * kDqKeys;
    const int st = t % kStages;
    bf16* kd = k_s + st * kDqKeys * LD;
    bf16* vd = v_s + st * kDqKeys * LD;
    for (int c = tid; c < kDqKeys * CH; c += kDqThreads) {
      const int row = c / CH;
      const int col = (c % CH) * 8;
      const bool ok = k0 + row < S;
      const long long src = base + (long long)(ok ? k0 + row : 0) * DH + col;
      cp_async16(kd + row * LD + col, k + src, ok);
      cp_async16(vd + row * LD + col, v + src, ok);
    }
    if (bias_b != nullptr && tid < kDqKeys) {
      const bool ok = k0 + tid < S;
      cp_async4(kb_s + st * kDqKeys + tid, bias_b + (ok ? k0 + tid : 0), ok);
    }
  };

  for (int c = tid; c < kDqRows * CH; c += kDqThreads) {
    const int row = c / CH;
    const int col = (c % CH) * 8;
    const bool ok = q0 + row < S;
    const long long src = base + (long long)(ok ? q0 + row : 0) * DH + col;
    cp_async16(q_s + row * LD + col, q + src, ok);
    cp_async16(g_s + row * LD + col, g + src, ok);
  }
  load_tile(0);
  cp_async_commit();
  {  // D_i = g_i . out_i: four threads a row, DH / 4 dims each, while the copies land
    const int row = tid >> 2;
    float dsum = 0.f;
    if (q0 + row < S) {
      const long long off = base + (long long)(q0 + row) * DH + (DH / 4) * (tid & 3);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(g + off);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(out + off);
#pragma unroll
      for (int e = 0; e < DH / 8; ++e) {
        const float2 fg = __bfloat1622float2(g2[e]);
        const float2 fo = __bfloat1622float2(o2[e]);
        dsum = fmaf(fg.x, fo.x, dsum);
        dsum = fmaf(fg.y, fo.y, dsum);
      }
    }
    dsum += __shfl_xor_sync(kFull, dsum, 1);
    dsum += __shfl_xor_sync(kFull, dsum, 2);
    if ((tid & 3) == 0) {
      d_s[row] = dsum;
      if (q0 + row < S) delta[bh * S + q0 + row] = dsum;
    }
  }

  // this lane's rows grp (a) and grp + 8 (b) and their statistics (m =
  // +inf past S: p = 0)
  const int row_a = r0 + grp;
  const bool ok_a = row_a < S;
  const bool ok_b = row_a + 8 < S;
  const float m_r[2] = {ok_a ? stats[bh * S + row_a] : INFINITY, ok_b ? stats[bh * S + row_a + 8] : INFINITY};
  const float ll_r[2] = {ok_a ? stats[plane + bh * S + row_a] : 0.f,
                         ok_b ? stats[plane + bh * S + row_a + 8] : 0.f};

  unsigned qa[KS][4], ga[KS][4];  // A fragments of the warp's Q and G rows, k = DH dims
  float d_r[2] = {0.f, 0.f};      // D of rows a and b
  float acc[2 * KS][4];           // dQ / scale of rows a and b over the warp's keys
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kw = t * kDqKeys + kDqGroupKeys * kg;  // the warp's first key of the tile
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    // the warp's keep bits of the tile while its copies land (all set at rate 0)
    const unsigned keep =
        thr != 0u && active ? chunk_keep_bits<kDqGroupNt>(r0, kw, h, b, seed, thr, lane) : ~0u;
    cp_async_wait<1>();
    __syncthreads();

    if (t == 0 && active) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int off = (16 * rw + (lane & 15)) * LD + 16 * ks + ((lane >> 4) << 3);
        ldsm_x4(q_s + off, qa[ks]);
        ldsm_x4(g_s + off, ga[ks]);
      }
      d_r[0] = d_s[16 * rw + grp];
      d_r[1] = d_s[16 * rw + grp + 8];
    }
    // 16-key pairs of the warp's keys below S rounded up to 16, warp-uniform
    const int pairs = active ? max(0, min(kDqGroupKeys, kp - kw)) >> 4 : 0;
    if (pairs > 0) {
      const int st = t % kStages;
      const bf16* kt = k_s + (st * kDqKeys + kDqGroupKeys * kg) * LD;  // the warp's keys
      const bf16* vt = v_s + (st * kDqKeys + kDqGroupKeys * kg) * LD;
      const float* kbt = kb_s + st * kDqKeys + kDqGroupKeys * kg;

      // S = Q K^T and dP = G V^T: 16 rows x the warp's 32 keys, k = DH dims
      float sc[kDqGroupNt][4], dp[kDqGroupNt][4];
#pragma unroll
      for (int n = 0; n < kDqGroupNt; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[n][c] = dp[n][c] = 0.f;
#pragma unroll
      for (int np = 0; np < kDqGroupNt / 2; ++np) {
        if (np < pairs) {
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const int off = (16 * np + (lane & 7) + ((lane >> 4) << 3)) * LD + 16 * ks + (((lane >> 3) & 1) << 3);
            unsigned bk[4], bv[4];
            ldsm_x4(kt + off, bk);
            ldsm_x4(vt + off, bv);
            mma(sc[2 * np], qa[ks], bk[0], bk[1]);
            mma(sc[2 * np + 1], qa[ks], bk[2], bk[3]);
            mma(dp[2 * np], ga[ks], bv[0], bv[1]);
            mma(dp[2 * np + 1], ga[ks], bv[2], bv[3]);
          }
        }
      }

      // p, keep and ds in f32 per 16-key pair; ds as bf16 into the A
      // fragment of dQ += dS K
#pragma unroll
      for (int np = 0; np < kDqGroupNt / 2; ++np) {
        if (np < pairs) {
          unsigned ads[4];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int nt = 2 * np + jj;
            float kb[2] = {0.f, 0.f};  // keys 2 tq, 2 tq + 1 of the n-tile
            if (bias_b != nullptr) {
              const float2 k2 = *reinterpret_cast<const float2*>(kbt + 8 * nt + 2 * tq);
              kb[0] = fmaxf(k2.x, kMaskBias);
              kb[1] = fmaxf(k2.y, kMaskBias);
            }
            float ds[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const bool key_ok = kw + 8 * nt + 2 * tq + (c & 1) < S;
              const float s = key_ok ? sc[nt][c] * scale + kb[c & 1] : -INFINITY;
              const float p = expf((s - m_r[c >> 1]) - ll_r[c >> 1]);
              const bool kept = ((keep >> (4 * nt + c)) & 1u) != 0u;
              ds[c] = p * ((kept ? dp[nt][c] * keep_scale : 0.f) - d_r[c >> 1]);
            }
            ads[2 * jj] = pack_bf16(ds[0], ds[1]);
            ads[2 * jj + 1] = pack_bf16(ds[2], ds[3]);
          }
          // k = the pair's 16 keys, n = DH dims
#pragma unroll
          for (int dn = 0; dn < KS; ++dn) {
            unsigned bk[4];
            ldsm_x4_t(kt + (16 * np + (lane & 15)) * LD + 16 * dn + ((lane >> 4) << 3), bk);
            mma(acc[2 * dn], ads, bk[0], bk[1]);
            mma(acc[2 * dn + 1], ads, bk[2], bk[3]);
          }
        }
      }
    }
    __syncthreads();  // the tile's buffers are consumed before tile t + 2 lands in them
  }

  // the key groups meet: groups 1.. leave each lane's dQ in the consumed K
  // ring ([group][row tile][value][lane], conflict-free), group 0 adds them
  float* const partials = reinterpret_cast<float*>(k_s);
  if (kg > 0 && active) {
    float* partial = partials + ((kg - 1) * kDqRowWarps + rw) * (8 * KS) * 32 + lane;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) partial[(4 * n + c) * 32] = acc[n][c];
  }
  __syncthreads();
  if (kg > 0 || !active) return;
  for (int gi = 1; gi < kDqKeyGroups; ++gi) {
    const float* partial = partials + ((gi - 1) * kDqRowWarps + rw) * (8 * KS) * 32 + lane;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] += partial[(4 * n + c) * 32];
  }

  // dq = scale dS K, written once in bf16: staged through the warp's own
  // (no longer needed) Q rows, then stored with 16-byte writes
  bf16* const o_s = q_s + 16 * rw * LD;
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    *reinterpret_cast<unsigned*>(o_s + grp * LD + 8 * n + 2 * tq) = pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<unsigned*>(o_s + (grp + 8) * LD + 8 * n + 2 * tq) =
        pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int row = c / CH;
    const int col = (c % CH) * 8;
    if (r0 + row < S)
      *reinterpret_cast<uint4*>(dq + base + (long long)(r0 + row) * DH + col) =
          *reinterpret_cast<const uint4*>(o_s + row * LD + col);
  }
}

template <int DH>
__global__ void __launch_bounds__(kKvThreads, Shape<DH>::kKvMinBlocks)
masked_attention_bwd_dkv_tiled_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                      const bf16* __restrict__ v, const bf16* __restrict__ g,
                                      const float* __restrict__ key_bias, const float* __restrict__ stats,
                                      const float* __restrict__ delta, bf16* __restrict__ dk,
                                      bf16* __restrict__ dv, int B, int H, int S, float scale, uint2 seed,
                                      unsigned thr, float keep_scale) {
  constexpr int LD = Shape<DH>::kLd;
  constexpr int CH = Shape<DH>::kChunks;
  constexpr int KS = DH / 16;
  constexpr bool kKeepKv = Shape<DH>::kKeepKv;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kKvKeys][LD]; then the dk tile
  bf16* v_s = k_s + kKvKeys * LD;                 // [kKvKeys][LD]; then the dv tile
  bf16* q_s = v_s + kKvKeys * LD;                 // [kStages][kKvRows][LD]
  bf16* g_s = q_s + kStages * kKvRows * LD;       // [kStages][kKvRows][LD]
  float* row_s = reinterpret_cast<float*>(g_s + kStages * kKvRows * LD);  // [kStages][m, log l, D][kKvRows]

  const int kt0 = blockIdx.x * kKvKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int tq = lane & 3;
  const int kw = warp % kKvKeyWarps;  // this warp's 16 keys
  const int rg = warp / kKvKeyWarps;  // and its row group: rows kKvGroupRows rg .. of every tile
  const long long bh = (long long)b * H + h;
  const long long base = bh * S * DH;
  const long long plane = (long long)B * H * S;  // stats[1] = log l
  const int n_tiles = (S + kKvRows - 1) / kKvRows;
  const int key0 = kt0 + 16 * kw;  // this warp's first key
  const bool active = key0 < S;    // warp-uniform: a warp past S only copies

  // q tile t: Q and G (rows past S zero-filled), m (+inf past S), log l and
  // delta (0 past S) into stage t % kStages
  auto load_tile = [&](int t) {
    const int q0 = t * kKvRows;
    const int st = t % kStages;
    bf16* qd = q_s + st * kKvRows * LD;
    bf16* gd = g_s + st * kKvRows * LD;
    for (int c = tid; c < kKvRows * CH; c += kKvThreads) {
      const int row = c / CH;
      const int col = (c % CH) * 8;
      const bool ok = q0 + row < S;
      const long long src = base + (long long)(ok ? q0 + row : 0) * DH + col;
      cp_async16(qd + row * LD + col, q + src, ok);
      cp_async16(gd + row * LD + col, g + src, ok);
    }
    for (int i = tid; i < 3 * kKvRows; i += kKvThreads) {
      const int which = i / kKvRows;  // 0: m, 1: log l, 2: D
      const int row = i % kKvRows;
      float* dst = row_s + (st * 3 + which) * kKvRows + row;
      if (q0 + row < S) {
        const float* src = which == 2 ? delta : stats + which * plane;
        cp_async4(dst, src + bh * S + q0 + row, true);
      } else {
        *dst = which == 0 ? INFINITY : 0.f;  // the stage was consumed at tile t - 1
      }
    }
  };

  for (int c = tid; c < kKvKeys * CH; c += kKvThreads) {
    const int row = c / CH;
    const int col = (c % CH) * 8;
    const bool ok = kt0 + row < S;
    const long long src = base + (long long)(ok ? kt0 + row : 0) * DH + col;
    cp_async16(k_s + row * LD + col, k + src, ok);
    cp_async16(v_s + row * LD + col, v + src, ok);
  }
  load_tile(0);
  cp_async_commit();

  // this lane's keys grp and grp + 8 of the warp's 16: below S, and their
  // clamped biases
  const bool key_ok[2] = {key0 + grp < S, key0 + grp + 8 < S};
  float kb[2] = {0.f, 0.f};
  if (key_bias != nullptr) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      if (key_ok[hi]) kb[hi] = fmaxf(key_bias[(long long)b * S + key0 + grp + 8 * hi], kMaskBias);
  }

  unsigned ak[kKeepKv ? KS : 1][4], av[kKeepKv ? KS : 1][4];  // A fragments of the warp's K and V rows
  float acc_dk[2 * KS][4], acc_dv[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_dk[n][c] = acc_dv[n][c] = 0.f;
  const int kv_off = (16 * kw + (lane & 15)) * LD + ((lane >> 4) << 3);  // + 16 ks: this lane's ldmatrix row

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kKvRows;
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if constexpr (kKeepKv) {
      if (t == 0 && active) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          ldsm_x4(k_s + kv_off + 16 * ks, ak[ks]);
          ldsm_x4(v_s + kv_off + 16 * ks, av[ks]);
        }
      }
    }
    if (active) {
      const int st = t % kStages;
      const bf16* qs = q_s + st * kKvRows * LD;
      const bf16* gs = g_s + st * kKvRows * LD;
      const float* ms = row_s + st * 3 * kKvRows;
      const float* lls = ms + kKvRows;
      const float* dls = lls + kKvRows;
#pragma unroll
      for (int sub = 0; sub < kKvGroupRows / 16; ++sub) {
        const int r0 = kKvGroupRows * rg + 16 * sub;  // the step's first row in the tile
        if (q0 + r0 >= S) break;                      // warp-uniform
        // S^T = K_w Q^T and dP^T = V_w G^T: 16 keys x 16 rows, k = DH dims
        float sacc[2][4], pacc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) sacc[j][c] = pacc[j][c] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int off = (r0 + (lane & 7) + ((lane >> 4) << 3)) * LD + 16 * ks + (((lane >> 3) & 1) << 3);
          unsigned bq[4], bg[4];
          ldsm_x4(qs + off, bq);
          ldsm_x4(gs + off, bg);
          if constexpr (kKeepKv) {
            mma(sacc[0], ak[ks], bq[0], bq[1]);
            mma(sacc[1], ak[ks], bq[2], bq[3]);
            mma(pacc[0], av[ks], bg[0], bg[1]);
            mma(pacc[1], av[ks], bg[2], bg[3]);
          } else {
            unsigned a4[4];
            ldsm_x4(k_s + kv_off + 16 * ks, a4);
            mma(sacc[0], a4, bq[0], bq[1]);
            mma(sacc[1], a4, bq[2], bq[3]);
            ldsm_x4(v_s + kv_off + 16 * ks, a4);
            mma(pacc[0], a4, bg[0], bg[1]);
            mma(pacc[1], a4, bg[2], bg[3]);
          }
        }

        // keep bits: bit 2j + (row & 1) of keep[hi] for key grp + 8 hi and
        // row 8j + 2tq + (row & 1) of the step
        unsigned keep[2] = {0xFu, 0xFu};
        if (thr != 0u) key_major_keep_bits(key0, q0 + r0, h, b, seed, thr, lane, keep[0], keep[1]);

        // p, pd, ds in f32; their fragments become A operands in bf16
        unsigned apd[4], ads[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float pd[4], dsv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int hi = c >> 1;
            const int lr = r0 + 8 * j + 2 * tq + (c & 1);  // the row in the tile
            const float s = key_ok[hi] ? sacc[j][c] * scale + kb[hi] : -INFINITY;
            const float p = expf((s - ms[lr]) - lls[lr]);
            const bool kept = ((keep[hi] >> (2 * j + (c & 1))) & 1u) != 0u;
            pd[c] = kept ? p * keep_scale : 0.f;
            dsv[c] = p * ((kept ? pacc[j][c] * keep_scale : 0.f) - dls[lr]);
          }
          apd[2 * j] = pack_bf16(pd[0], pd[1]);
          apd[2 * j + 1] = pack_bf16(pd[2], pd[3]);
          ads[2 * j] = pack_bf16(dsv[0], dsv[1]);
          ads[2 * j + 1] = pack_bf16(dsv[2], dsv[3]);
        }

        // dV_w += Pd^T G and dK_w += dS^T Q: k = the step's 16 rows, n = DH dims
#pragma unroll
        for (int np = 0; np < KS; ++np) {
          const int off = (r0 + (lane & 15)) * LD + 16 * np + ((lane >> 4) << 3);
          unsigned bg[4], bq[4];
          ldsm_x4_t(gs + off, bg);
          ldsm_x4_t(qs + off, bq);
          mma(acc_dv[2 * np], apd, bg[0], bg[1]);
          mma(acc_dv[2 * np + 1], apd, bg[2], bg[3]);
          mma(acc_dk[2 * np], ads, bq[0], bq[1]);
          mma(acc_dk[2 * np + 1], ads, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // the tile's buffers are consumed before tile t + 2 lands in them
  }

  // the row groups meet: groups 1.. leave each lane's dK and dV in the
  // consumed Q and G rings ([group][key slice][value][lane]), group 0 adds
  // them and stages the tile in bf16 in the K and V tiles (no warp reads
  // them any more)
  float* const partials = reinterpret_cast<float*>(q_s);
  if (rg > 0 && active) {
    float* partial = partials + ((rg - 1) * kKvKeyWarps + kw) * (16 * KS) * 32 + lane;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        partial[(4 * n + c) * 32] = acc_dk[n][c];
        partial[(8 * KS + 4 * n + c) * 32] = acc_dv[n][c];
      }
  }
  __syncthreads();
  if (rg == 0 && active) {
    for (int gi = 1; gi < kKvRowGroups; ++gi) {
      const float* partial = partials + ((gi - 1) * kKvKeyWarps + kw) * (16 * KS) * 32 + lane;
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc_dk[n][c] += partial[(4 * n + c) * 32];
          acc_dv[n][c] += partial[(8 * KS + 4 * n + c) * 32];
        }
    }
    const int w0 = 16 * kw;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      const int col = 8 * n + 2 * tq;
      *reinterpret_cast<unsigned*>(k_s + (w0 + grp) * LD + col) = pack_bf16(acc_dk[n][0] * scale, acc_dk[n][1] * scale);
      *reinterpret_cast<unsigned*>(k_s + (w0 + grp + 8) * LD + col) =
          pack_bf16(acc_dk[n][2] * scale, acc_dk[n][3] * scale);
      *reinterpret_cast<unsigned*>(v_s + (w0 + grp) * LD + col) = pack_bf16(acc_dv[n][0], acc_dv[n][1]);
      *reinterpret_cast<unsigned*>(v_s + (w0 + grp + 8) * LD + col) = pack_bf16(acc_dv[n][2], acc_dv[n][3]);
    }
  }
  __syncthreads();
  for (int c = tid; c < kKvKeys * CH; c += kKvThreads) {
    const int row = c / CH;
    const int col = (c % CH) * 8;
    if (kt0 + row < S) {
      const long long dst = base + (long long)(kt0 + row) * DH + col;
      *reinterpret_cast<uint4*>(dk + dst) = *reinterpret_cast<const uint4*>(k_s + row * LD + col);
      *reinterpret_cast<uint4*>(dv + dst) = *reinterpret_cast<const uint4*>(v_s + row * LD + col);
    }
  }
}

bool shape_ok(int B, int H, int S, int dtype) {
  return dtype == 1 && B > 0 && H > 0 && S > 0 && B <= 65535 && H <= 65535;
}

template <int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* out, const void* g,
                      const void* key_bias, const void* stats, void* dq, void* delta, int B, int H, int S,
                      float scale, uint2 seed, unsigned thr, float keep_scale, cudaStream_t stream) {
  constexpr size_t smem = Shape<DH>::kDqSmem;
  const cudaError_t err = cudaFuncSetAttribute(masked_attention_bwd_dq_tiled_kernel<DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kDqRows - 1) / kDqRows, H, B);
  masked_attention_bwd_dq_tiled_kernel<DH><<<grid, kDqThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(out), static_cast<const bf16*>(g), static_cast<const float*>(key_bias),
      static_cast<const float*>(stats), static_cast<bf16*>(dq), static_cast<float*>(delta), B, H, S, scale, seed,
      thr, keep_scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* g, const void* key_bias,
                       const void* stats, const void* delta, void* dk, void* dv, int B, int H, int S, float scale,
                       uint2 seed, unsigned thr, float keep_scale, cudaStream_t stream) {
  constexpr size_t smem = Shape<DH>::kKvSmem;
  const cudaError_t err = cudaFuncSetAttribute(masked_attention_bwd_dkv_tiled_kernel<DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kKvKeys - 1) / kKvKeys, H, B);
  masked_attention_bwd_dkv_tiled_kernel<DH><<<grid, kKvThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<const float*>(key_bias), static_cast<const float*>(stats),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, H, S, scale, seed, thr,
      keep_scale);
  return cudaGetLastError();
}

}  // namespace

// dq and the per-row D_i in `delta` (f32 (B, H, S)), from the tiled
// forward's `stats` (f32 (2, B, H, S): row max, log of the row sum).
// bfloat16 (dtype 1) at DH = 16, 32, 64 or 128, any S >= 1; anything else
// returns cudaErrorInvalidValue. q, k, v, out, g and dq must be 16-byte
// aligned (the wrapper checks the inputs and allocates dq). key_bias may be
// null. The dropout mask is keyed by (seed_hi << 32 | seed_lo); thr = 0
// keeps every key, and keep_scale is 1 / (1 - rate). Returns a cudaError_t
// (0 on success).
extern "C" int masked_attention_bwd_dq_tiled(const void* q, const void* k, const void* v, const void* out,
                                             const void* g, const void* key_bias, const void* stats, void* dq,
                                             void* delta, int B, int H, int S, int DH, float scale,
                                             unsigned seed_lo, unsigned seed_hi, unsigned thr, float keep_scale,
                                             int dtype, void* stream) {
  if (!shape_ok(B, H, S, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint2 seed = make_uint2(seed_lo, seed_hi);
  switch (DH) {
    case 16: return launch_dq<16>(q, k, v, out, g, key_bias, stats, dq, delta, B, H, S, scale, seed, thr, keep_scale, st);
    case 32: return launch_dq<32>(q, k, v, out, g, key_bias, stats, dq, delta, B, H, S, scale, seed, thr, keep_scale, st);
    case 64: return launch_dq<64>(q, k, v, out, g, key_bias, stats, dq, delta, B, H, S, scale, seed, thr, keep_scale, st);
    case 128:
      return launch_dq<128>(q, k, v, out, g, key_bias, stats, dq, delta, B, H, S, scale, seed, thr, keep_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// dk and dv, from the `delta` that masked_attention_bwd_dq_tiled wrote. The
// same dtype, DH and alignment rules; q, k, v, g, dk and dv 16-byte aligned.
extern "C" int masked_attention_bwd_dkv_tiled(const void* q, const void* k, const void* v, const void* g,
                                              const void* key_bias, const void* stats, const void* delta, void* dk,
                                              void* dv, int B, int H, int S, int DH, float scale, unsigned seed_lo,
                                              unsigned seed_hi, unsigned thr, float keep_scale, int dtype,
                                              void* stream) {
  if (!shape_ok(B, H, S, dtype)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint2 seed = make_uint2(seed_lo, seed_hi);
  switch (DH) {
    case 16: return launch_dkv<16>(q, k, v, g, key_bias, stats, delta, dk, dv, B, H, S, scale, seed, thr, keep_scale, st);
    case 32: return launch_dkv<32>(q, k, v, g, key_bias, stats, delta, dk, dv, B, H, S, scale, seed, thr, keep_scale, st);
    case 64: return launch_dkv<64>(q, k, v, g, key_bias, stats, delta, dk, dv, B, H, S, scale, seed, thr, keep_scale, st);
    case 128:
      return launch_dkv<128>(q, k, v, g, key_bias, stats, delta, dk, dv, B, H, S, scale, seed, thr, keep_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* masked_attention_bwd_tiled_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
