// Compact-bias tree attention, backward, for Hopper (sm_90a): two kernels on
// tensor cores for bf16 at DH = 16, 32, 64 and 128, any S >= 1, streaming
// over S.
//
// Replaces the backward Pallas kernels of the JAX package
// (multimodaldiscussiontransformer_tpu/ops/tree_attention.py) for bf16:
//   _make_kernel_flash_dq             (:468, dq and the dLUT page),
//   _make_kernel_flash_dkv            (:558, dk and dv),
//   _make_dropout_bwd_kernel          (:1007, padded S < 513),
//   _make_dropout_bwd_kernel_batched  (:1148, padded S <= 128).
// (float32 takes the 3xTF32 pair, tree_attention_bwd_tf32.cu.)
//
// Function: with the LSE that the forward writes, D_i = g_i . out_i and
// the forward's Philox keep mask (counter (j / 4, i, h, b) of
// tree_attention_common.cuh, regenerated bit for bit),
//   s_ij  = scale q_i . k_j + c max(tpl[b,i,j], -1e9) + lut[ids[b,i,j], h]
//           (ids 0 and ids outside [0, 32) add nothing; keys >= S: -inf)
//   p_ij  = exp(s_ij - lse_i)
//   pd_ij = keep_ij p_ij / (1 - rate)
//   ds_ij = p_ij (keep_ij (g_i . v_j) / (1 - rate) - D_i)
//   dv_j  = sum_i pd_ij g_i,  dk_j = scale sum_i ds_ij q_i,
//   dq_i  = scale sum_j ds_ij k_j,
//   dlut[id, h] += sum_{i,j : ids[b,i,j] = id} ds_ij  for 1 <= id < 32
// (row 0 of dlut gets nothing). A row whose every key the template masks
// (c = 2: s = -2e9, lse = -1e9 + log 1e-30) gets p = 0 exactly, so it adds
// nothing to any output.
//
// What bounds them: at S = 1025, B = 1, H = 12, DH 64 the pair reads q, k,
// v, g, out and the LSE and the head-shared tpl/ids (8.4 MB, read by every
// head of both kernels) and writes dq, dk and dv: ~21 MB counted once, ~6.3
// us at 3.35 TB/s, against 14 B H S^2 DH (S, dP and dQ in the first kernel;
// S^T, dP^T, dV and dK in the second) = 11.3 GFLOP, ~11.4 us at the bf16
// tensor-core peak: the pair sits near the balance of the two. Two kernels
// rather than one pass: tree S has no cap, and one pass over key tiles
// would have to sum dq across blocks with f32 atomics (~13M at S = 1025,
// in no fixed order). At a fixed width H DH the bound does not depend on
// DH; the per-(row, key) work that does not shrink with DH (the tpl/ids
// tiles, the bias, the Philox draws, the dLUT histogram) grows with H.
//
// tree_attention_bwd_dq_mma_kernel (q-major), one block per (head, 32-row q
// tile, graph), 4 warps: two 16-row tiles x two key groups, the layout of
// tree_attention_fwd_mma.cu (head on blockIdx.x, so the H blocks that read
// the same (graph, q tile) rows of tpl and ids run together and L2 serves
// the re-reads).
// - Q and G are staged once in bf16 (16-byte cp.async, rows past S
//   zero-filled) and each warp keeps its 16 rows of both as A fragments.
//   D_i is formed from g and out and written to `delta`.
// - K, V and the (32 rows x 64 keys) tpl/ids tile stream through the
//   forward's double-buffered ring (tpl/ids by 4-byte cp.async: their rows
//   start at 4 S bytes, not 16-byte aligned for odd S; rows of 68 entries).
// - Per tile each warp forms S = Q K^T and dP = G V^T over its 32 keys on
//   mma.sync.m16n8k16, then p, keep and ds in f32 on the C fragments (the
//   keep bits from chunk_keep_bits, as in the forward), and dQ += dS K with
//   dS rounded to bf16 and taken from the accumulator fragments as the A
//   operand (K by ldmatrix.trans). dQ stays in registers for the whole key
//   walk; the key groups add theirs through the consumed ring at the end,
//   and dq is scaled and written once, with 16-byte stores, no atomics.
// - dLUT: each lane keeps a private 32-bin f32 histogram of the f32 ds in
//   shared memory, bin-major ([warp][bin][lane]), so every lane's slot of
//   every bin sits in its own bank: plain adds, no atomics, no bank
//   conflicts. At the end the block sums the bins and adds each to the
//   (32, H) dlut with one atomicAdd.
//
// tree_attention_bwd_dkv_mma_kernel (k-major), one block per (head, 32-key
// tile, graph), 4 warps: two 16-key slices x two row groups.
// - The K and V tile is staged once; at DH <= 64 each warp keeps its 16
//   keys of both as A fragments in registers, at DH 128 it reloads them by
//   ldmatrix each step (registers hold dK and dV, 128 f32 a lane there).
// - Q, G, the tile's lse and delta, and the (64 rows x 32 keys) tpl/ids tile
//   stream through a double-buffered ring; rows past S get lse = +inf (p =
//   0) and delta = 0. The tpl/ids rows hold 36 entries, so the key-major
//   reads of the C-fragment layout (8 keys x rows 2 tq apart) hit 32
//   distinct banks.
// - Per 64-row tile, each warp takes its row group's two 16-row steps: S^T =
//   K Q^T and dP^T = V G^T on mma.sync, p, keep (key_major_keep_bits of
//   mma_common.cuh: one Philox draw per (row, 4-key group), 4 shuffles), pd
//   and ds in f32, then dV += Pd^T G and dK += dS^T Q with the accumulator
//   fragments as A operands (bf16) and G, Q by ldmatrix.trans, as in
//   masked_attention_bwd_mma.cu. dK and dV stay in registers for the whole
//   q walk; the row groups add theirs through the consumed ring, and the
//   tile is written once in bf16 through the staged K and V tiles.
//
// Staged bf16 rows are the forward's (tile_at of mma_common.cuh): swizzled
// 64-wide rows at DH 64, rows of DH + 8 values at DH 16, 32 and 128, free
// of bank conflicts at every DH. The rings are double-buffered, but at DH
// 128 two stages take 135 KB (dq) and 122 KB (dk/dv), one block an SM: a
// grid of more blocks than the card has SMs (6 heads x 2 tiles x 12 graphs
// at S = 33 is 144 blocks for 132 SMs) then ran a second wave for a few
// blocks. There the launch takes one stage (86 and 71 KB, two blocks an
// SM), and keeps two where one wave holds the grid (S = 601, B = 1: 114).
//
// Precision: the products run on bf16 operands in f32 accumulators; P and
// dS are rounded to bf16 before the second products, as in
// masked_attention_bwd_mma.cu; dlut sums the f32 ds. The score is formed
// as the forward forms it, acc * scale + bias on the f32 accumulator.

#include "mma_common.cuh"
#include "tree_attention_common.cuh"

namespace {

using namespace tree_attention;
using namespace tower_mma;

// the dq kernel
constexpr int kDqRowWarps = 2;                          // 16-row tiles per block
constexpr int kDqKeyGroups = 2;                         // warps that split each key tile
constexpr int kDqWarps = kDqRowWarps * kDqKeyGroups;
constexpr int kDqThreads = kDqWarps * 32;
constexpr int kDqRows = 16 * kDqRowWarps;               // q rows per block
constexpr int kDqKeys = kKeyChunk;                      // keys per streamed tile
constexpr int kDqGroupKeys = kDqKeys / kDqKeyGroups;    // keys per warp and tile
constexpr int kDqGroupNt = kDqGroupKeys / 8;            // 8-key n-tiles per warp and tile
constexpr int kDqBiasStride = kDqKeys + 4;              // entries per staged tpl/ids row
static_assert(kDqThreads == 4 * kDqRows, "four threads form each row's D");

// the dk/dv kernel
constexpr int kKvKeyWarps = 2;                          // 16-key slices per block
constexpr int kKvRowGroups = 2;                         // warps that split each q tile
constexpr int kKvWarps = kKvKeyWarps * kKvRowGroups;
constexpr int kKvThreads = kKvWarps * 32;
constexpr int kKvKeys = 16 * kKvKeyWarps;               // keys per block
constexpr int kKvRows = 64;                             // q rows per streamed tile
constexpr int kKvGroupRows = kKvRows / kKvRowGroups;    // rows per warp and tile
constexpr int kKvBiasStride = kKvKeys + 4;              // entries per staged tpl/ids row
static_assert(kKvThreads == 2 * kKvRows, "one thread stages each row's lse or delta");

// ST: the rings' depth. Two stages let a tile land while the one before is
// worked on; at DH 128 one stage (86 KB for the dq kernel, 71 KB for dk/dv,
// against 135 and 122 KB with two) lets two blocks share an SM, which the
// launch takes where the grid holds more blocks than the card has SMs. Both
// sides were timed on the H100 (PERF.md, the DH-128 pair's row): one stage
// wins where the grid passes the SM count, two where it fits in one wave.
template <int DH, int ST>
struct Shape {
  static constexpr int kStages = ST;
  static constexpr int kLd = tile_ld<DH>();  // bf16 values per staged row
  static constexpr int kChunks = DH / 8;     // 16-byte chunks per row
  static constexpr int kChunkShift = DH == 16 ? 1 : DH == 32 ? 2 : DH == 64 ? 3 : 4;  // log2 kChunks
  static_assert(1 << kChunkShift == kChunks, "DH is 16, 32, 64 or 128");
  // Q and G, the K and V rings, the tpl and ids rings, the lanes'
  // histograms (DH 64: 90 KB)
  static constexpr size_t kDqSmem = sizeof(bf16) * (size_t)(2 * kDqRows * kLd + 2 * kStages * kDqKeys * kLd) +
                                    (sizeof(float) + sizeof(int)) * (size_t)(kStages * kDqRows * kDqBiasStride) +
                                    sizeof(float) * (size_t)(kDqWarps * kLutSize * 32);
  static_assert(sizeof(float) * (kDqKeyGroups - 1) * kDqRowWarps * (DH / 2) * 32 <=
                    sizeof(bf16) * kStages * kDqKeys * kLd,
                "the key groups' dQ partials fit the K ring");
  // K and V, the Q and G rings, the lse and delta rings, the tpl and ids
  // rings (DH 64: 77 KB)
  static constexpr size_t kKvSmem = sizeof(bf16) * (size_t)(2 * kKvKeys * kLd + 2 * kStages * kKvRows * kLd) +
                                    sizeof(float) * (size_t)(2 * kStages * kKvRows) +
                                    (sizeof(float) + sizeof(int)) * (size_t)(kStages * kKvRows * kKvBiasStride);
  static_assert(sizeof(float) * (kKvRowGroups - 1) * kKvKeyWarps * DH * 32 <=
                    sizeof(bf16) * 2 * kStages * kKvRows * kLd,
                "the row groups' dK and dV partials fit the Q and G rings");
  static constexpr bool kKeepKv = DH <= 64;  // K and V fragments held in registers
};

template <int DH, int ST>
__global__ void __launch_bounds__(kDqThreads, 2)
tree_attention_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const bf16* __restrict__ out,
                                 const bf16* __restrict__ g, const float* __restrict__ tpl,
                                 const int* __restrict__ ids, const float* __restrict__ lut,
                                 const float* __restrict__ lse, bf16* __restrict__ dq,
                                 float* __restrict__ dlut, float* __restrict__ delta, int H, int S,
                                 float scale, float tpl_coef, uint2 seed, unsigned thr,
                                 float keep_scale) {
  constexpr int LD = Shape<DH, ST>::kLd;
  constexpr int CH = Shape<DH, ST>::kChunks;
  constexpr int CSHIFT = Shape<DH, ST>::kChunkShift;
  constexpr int KS = DH / 16;  // 16-dim steps
  constexpr int kStages = ST;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);     // [kDqRows][LD]; then the dq tile
  bf16* g_s = q_s + kDqRows * LD;                    // [kDqRows][LD]
  bf16* k_s = g_s + kDqRows * LD;                    // [kStages][kDqKeys][LD]
  bf16* v_s = k_s + kStages * kDqKeys * LD;          // [kStages][kDqKeys][LD]
  float* tpl_s = reinterpret_cast<float*>(v_s + kStages * kDqKeys * LD);  // [kStages][kDqRows][kDqBiasStride]
  int* ids_s = reinterpret_cast<int*>(tpl_s + kStages * kDqRows * kDqBiasStride);
  float* hist = reinterpret_cast<float*>(ids_s + kStages * kDqRows * kDqBiasStride);  // [warp][bin][lane]
  __shared__ float lut_s[kLutSize];
  __shared__ float d_s[kDqRows];

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * kDqRows;
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
  const int kp = (S + 15) & ~15;  // keys padded to 16
  const int n_tiles = (S + kDqKeys - 1) / kDqKeys;
  const int r0 = q0 + 16 * rw;    // this warp's first row
  const bool active = r0 < S;     // warp-uniform: a warp past S only copies
  const int rows = min(kDqRows, S - q0);  // the block's rows below S
  const long long graph = (long long)b * S * S;

  // tile t of K, V (keys past S zero-filled), tpl and ids (the block's
  // rows below S; keys past S zero-filled) into stage t % kStages
  auto load_tile = [&](int t) {
    const int k0 = t * kDqKeys;
    const int st = t % kStages;
    bf16* kd = k_s + st * kDqKeys * LD;
    bf16* vd = v_s + st * kDqKeys * LD;
    for (int c = tid; c < kDqKeys * CH; c += kDqThreads) {
      const int row = c >> CSHIFT;
      const int col = (c & (CH - 1)) << 3;
      const bool ok = k0 + row < S;
      const long long src = base + (long long)(ok ? k0 + row : 0) * DH + col;
      cp_async16(kd + tile_at<DH>(row, col), k + src, ok);
      cp_async16(vd + tile_at<DH>(row, col), v + src, ok);
    }
    float* td = tpl_s + st * kDqRows * kDqBiasStride;
    int* idd = ids_s + st * kDqRows * kDqBiasStride;
    const int j = tid & (kDqKeys - 1);
    const bool key_ok = k0 + j < S;
    for (int r = tid / kDqKeys; r < rows; r += kDqThreads / kDqKeys) {
      const long long src = key_ok ? graph + (long long)(q0 + r) * S + k0 + j : 0;
      cp_async4(td + r * kDqBiasStride + j, tpl + src, key_ok);
      cp_async4(idd + r * kDqBiasStride + j, ids + src, key_ok);
    }
  };

  for (int c = tid; c < kDqRows * CH; c += kDqThreads) {
    const int row = c >> CSHIFT;
    const int col = (c & (CH - 1)) << 3;
    const bool ok = q0 + row < S;
    const long long src = base + (long long)(ok ? q0 + row : 0) * DH + col;
    cp_async16(q_s + tile_at<DH>(row, col), q + src, ok);
    cp_async16(g_s + tile_at<DH>(row, col), g + src, ok);
  }
  load_tile(0);
  cp_async_commit();
  if (tid < kLutSize) lut_s[tid] = tid == 0 ? 0.f : lut[tid * H + h];
  float* const my_hist = hist + warp * kLutSize * 32 + lane;  // bin i at my_hist[32 i]
#pragma unroll
  for (int i = 0; i < kLutSize; ++i) my_hist[32 * i] = 0.f;
  {  // D_i = g_i . out_i: four threads a row, DH / 4 dims each, while the copies land
    const int row = tid >> 2;
    float dsum = 0.f;
    if (q0 + row < S) {
      const long long off = base + (long long)(q0 + row) * DH + (DH / 4) * (tid & 3);
      if constexpr (DH >= 32) {
#pragma unroll
        for (int cc = 0; cc < DH / 32; ++cc)
          dsum += dot8(__ldg(reinterpret_cast<const uint4*>(g + off) + cc),
                       __ldg(reinterpret_cast<const uint4*>(out + off) + cc));
      } else {
        const uint2 g4 = __ldg(reinterpret_cast<const uint2*>(g + off));
        const uint2 o4 = __ldg(reinterpret_cast<const uint2*>(out + off));
        dsum = dot8(make_uint4(g4.x, g4.y, 0u, 0u), make_uint4(o4.x, o4.y, 0u, 0u));
      }
    }
    dsum += __shfl_xor_sync(kFull, dsum, 1);
    dsum += __shfl_xor_sync(kFull, dsum, 2);
    if ((tid & 3) == 0) {
      d_s[row] = dsum;
      if (q0 + row < S) delta[bh * S + q0 + row] = dsum;
    }
  }

  // this lane's rows grp (a) and grp + 8 (b): below S, their LSE (+inf past
  // S: p = 0), and their offsets in a staged tpl/ids tile at the warp's keys
  const int row_a = r0 + grp;
  const bool ok_a = row_a < S;
  const bool ok_b = row_a + 8 < S;
  const float lse_r[2] = {ok_a ? lse[bh * S + row_a] : INFINITY, ok_b ? lse[bh * S + row_a + 8] : INFINITY};
  const int off_a = (16 * rw + grp) * kDqBiasStride + kDqGroupKeys * kg + 2 * tq;
  const int off_b = off_a + 8 * kDqBiasStride;

  unsigned qa[KS][4], ga[KS][4];  // A fragments of the warp's Q and G rows, k = DH dims
  float d_r[2] = {0.f, 0.f};      // D of rows a and b
  float acc[2 * KS][4];           // dQ / scale of rows a and b over the warp's keys
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kw = t * kDqKeys + kDqGroupKeys * kg;  // the warp's first key of the tile
    if constexpr (kStages > 1) {
      if (t + 1 < n_tiles) load_tile(t + 1);
      cp_async_commit();
    }
    // the warp's keep bits of the tile while its copies land (all set at rate 0)
    const unsigned keep =
        thr != 0u && active ? chunk_keep_bits<kDqGroupNt>(r0, kw, h, b, seed, thr, lane) : ~0u;
    cp_async_wait<kStages - 1>();
    __syncthreads();

    // 16-key pairs of the warp's keys below S rounded up to 16, warp-uniform
    const int pairs = active ? max(0, min(kDqGroupKeys, kp - kw)) >> 4 : 0;
    if (t == 0 && active) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int off = tile_at<DH>(16 * rw + (lane & 15), 16 * ks + ((lane >> 4) << 3));
        ldsm_x4(q_s + off, qa[ks]);
        ldsm_x4(g_s + off, ga[ks]);
      }
      d_r[0] = d_s[16 * rw + grp];
      d_r[1] = d_s[16 * rw + grp + 8];
    }
    if (pairs > 0) {
      const int st = t % kStages;
      const bf16* kt = k_s + (st * kDqKeys + kDqGroupKeys * kg) * LD;  // the warp's keys
      const bf16* vt = v_s + (st * kDqKeys + kDqGroupKeys * kg) * LD;
      const float* tt = tpl_s + st * kDqRows * kDqBiasStride;
      const int* it = ids_s + st * kDqRows * kDqBiasStride;

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
            const int off =
                tile_at<DH>(16 * np + (lane & 7) + ((lane >> 4) << 3), 16 * ks + (((lane >> 3) & 1) << 3));
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

      // p, keep and ds in f32 per 16-key pair; ds into the lane's histogram
      // and, as bf16, into the A fragment of dQ += dS K
#pragma unroll
      for (int np = 0; np < kDqGroupNt / 2; ++np) {
        if (np < pairs) {
          unsigned ads[4];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int nt = 2 * np + jj;
            float bias[4] = {0.f, 0.f, 0.f, 0.f};  // C elements: rows a, a, b, b
            int id[4] = {0, 0, 0, 0};
            if (ok_a) {
              const float2 t2 = *reinterpret_cast<const float2*>(tt + off_a + 8 * nt);
              const int2 i2 = *reinterpret_cast<const int2*>(it + off_a + 8 * nt);
              id[0] = i2.x;
              id[1] = i2.y;
              bias[0] = bias_of(t2.x, i2.x, lut_s, tpl_coef);
              bias[1] = bias_of(t2.y, i2.y, lut_s, tpl_coef);
            }
            if (ok_b) {
              const float2 t2 = *reinterpret_cast<const float2*>(tt + off_b + 8 * nt);
              const int2 i2 = *reinterpret_cast<const int2*>(it + off_b + 8 * nt);
              id[2] = i2.x;
              id[3] = i2.y;
              bias[2] = bias_of(t2.x, i2.x, lut_s, tpl_coef);
              bias[3] = bias_of(t2.y, i2.y, lut_s, tpl_coef);
            }
            float ds[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const bool key_ok = kw + 8 * nt + 2 * tq + (c & 1) < S;
              const float s = key_ok ? sc[nt][c] * scale + bias[c] : -INFINITY;
              const float p = expf(s - lse_r[c >> 1]);
              const bool kept = ((keep >> (4 * nt + c)) & 1u) != 0u;
              ds[c] = p * ((kept ? dp[nt][c] * keep_scale : 0.f) - d_r[c >> 1]);
              if (id[c] > 0 && id[c] < kLutSize) my_hist[32 * id[c]] += ds[c];
            }
            ads[2 * jj] = pack_bf16(ds[0], ds[1]);
            ads[2 * jj + 1] = pack_bf16(ds[2], ds[3]);
          }
          // k = the pair's 16 keys, n = DH dims
#pragma unroll
          for (int dn = 0; dn < KS; ++dn) {
            unsigned bk[4];
            ldsm_x4_t(kt + tile_at<DH>(16 * np + (lane & 15), 16 * dn + ((lane >> 4) << 3)), bk);
            mma(acc[2 * dn], ads, bk[0], bk[1]);
            mma(acc[2 * dn + 1], ads, bk[2], bk[3]);
          }
        }
      }
    }
    __syncthreads();  // the tile's buffers are consumed before tile t + kStages lands in them
    if constexpr (kStages == 1) {
      if (t + 1 < n_tiles) load_tile(t + 1);
      cp_async_commit();
    }
  }

  // the key groups meet: groups 1.. leave each lane's dQ in the consumed K
  // ring ([group][row tile][value][lane], conflict-free), group 0 adds them
  float* const partials = reinterpret_cast<float*>(k_s);
  if (kg > 0 && active) {
    float* partial = partials + ((kg - 1) * kDqRowWarps + rw) * (DH / 2) * 32 + lane;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) partial[(4 * n + c) * 32] = acc[n][c];
  }
  __syncthreads();

  // dlut: warp w sums bins w, w + kDqWarps, ... over every lane's histogram
  // (bin 0 is the padding id and gets nothing)
  for (int bin = warp; bin < kLutSize; bin += kDqWarps) {
    if (bin == 0) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kDqWarps; ++w) sum += hist[(w * kLutSize + bin) * 32 + lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
    if (lane == 0 && sum != 0.f) atomicAdd(&dlut[bin * H + h], sum);
  }
  if (kg > 0 || !active) return;
  for (int gi = 1; gi < kDqKeyGroups; ++gi) {
    const float* partial = partials + ((gi - 1) * kDqRowWarps + rw) * (DH / 2) * 32 + lane;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] += partial[(4 * n + c) * 32];
  }

  // dq = scale dS K, written once in bf16: staged through the warp's own
  // (no longer needed) Q rows, then stored with 16-byte writes
  const int w0 = 16 * rw;
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    *reinterpret_cast<unsigned*>(q_s + tile_at<DH>(w0 + grp, 8 * n + 2 * tq)) =
        pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<unsigned*>(q_s + tile_at<DH>(w0 + grp + 8, 8 * n + 2 * tq)) =
        pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int c = lane + 32 * i;
    const int row = w0 + (c >> CSHIFT);
    const int col = (c & (CH - 1)) << 3;
    if (q0 + row < S)
      *reinterpret_cast<uint4*>(dq + base + (long long)(q0 + row) * DH + col) =
          *reinterpret_cast<const uint4*>(q_s + tile_at<DH>(row, col));
  }
}

template <int DH, int ST>
__global__ void __launch_bounds__(kKvThreads, 2)
tree_attention_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const bf16* __restrict__ g,
                                  const float* __restrict__ tpl, const int* __restrict__ ids,
                                  const float* __restrict__ lut, const float* __restrict__ lse,
                                  const float* __restrict__ delta, bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, int H, int S, float scale,
                                  float tpl_coef, uint2 seed, unsigned thr, float keep_scale) {
  constexpr int LD = Shape<DH, ST>::kLd;
  constexpr int CH = Shape<DH, ST>::kChunks;
  constexpr int CSHIFT = Shape<DH, ST>::kChunkShift;
  constexpr int KS = DH / 16;
  constexpr bool kKeepKv = Shape<DH, ST>::kKeepKv;
  constexpr int kStages = ST;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);   // [kKvKeys][LD]; then the dk tile
  bf16* v_s = k_s + kKvKeys * LD;                  // [kKvKeys][LD]; then the dv tile
  bf16* q_s = v_s + kKvKeys * LD;                  // [kStages][kKvRows][LD]
  bf16* g_s = q_s + kStages * kKvRows * LD;        // [kStages][kKvRows][LD]
  float* lse_s = reinterpret_cast<float*>(g_s + kStages * kKvRows * LD);  // [kStages][kKvRows]
  float* dl_s = lse_s + kStages * kKvRows;                                // [kStages][kKvRows]
  float* tpl_s = dl_s + kStages * kKvRows;  // [kStages][kKvRows][kKvBiasStride]
  int* ids_s = reinterpret_cast<int*>(tpl_s + kStages * kKvRows * kKvBiasStride);
  __shared__ float lut_s[kLutSize];

  const int h = blockIdx.x;
  const int kt0 = blockIdx.y * kKvKeys;
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
  const int n_tiles = (S + kKvRows - 1) / kKvRows;
  const int key0 = kt0 + 16 * kw;  // this warp's first key
  const bool active = key0 < S;    // warp-uniform: a warp past S only copies
  const long long graph = (long long)b * S * S;

  // q tile t: Q and G (rows past S zero-filled), lse (+inf past S) and
  // delta (0 past S), and the (rows x the block's keys) tpl and ids tile
  // (zero-filled past S) into stage t % kStages
  auto load_tile = [&](int t) {
    const int q0 = t * kKvRows;
    const int st = t % kStages;
    bf16* qd = q_s + st * kKvRows * LD;
    bf16* gd = g_s + st * kKvRows * LD;
    for (int c = tid; c < kKvRows * CH; c += kKvThreads) {
      const int row = c >> CSHIFT;
      const int col = (c & (CH - 1)) << 3;
      const bool ok = q0 + row < S;
      const long long src = base + (long long)(ok ? q0 + row : 0) * DH + col;
      cp_async16(qd + tile_at<DH>(row, col), q + src, ok);
      cp_async16(gd + tile_at<DH>(row, col), g + src, ok);
    }
    {
      const int row = tid % kKvRows;
      const bool is_lse = tid < kKvRows;
      float* dst = (is_lse ? lse_s : dl_s) + st * kKvRows + row;
      if (q0 + row < S)
        cp_async4(dst, (is_lse ? lse : delta) + bh * S + q0 + row, true);
      else
        *dst = is_lse ? INFINITY : 0.f;  // the stage was consumed at tile t - 1
    }
    float* td = tpl_s + st * kKvRows * kKvBiasStride;
    int* idd = ids_s + st * kKvRows * kKvBiasStride;
    const int j = tid % kKvKeys;
    const bool key_ok = kt0 + j < S;
    for (int r = tid / kKvKeys; r < kKvRows; r += kKvThreads / kKvKeys) {
      const bool ok = key_ok && q0 + r < S;
      const long long src = ok ? graph + (long long)(q0 + r) * S + kt0 + j : 0;
      cp_async4(td + r * kKvBiasStride + j, tpl + src, ok);
      cp_async4(idd + r * kKvBiasStride + j, ids + src, ok);
    }
  };

  for (int c = tid; c < kKvKeys * CH; c += kKvThreads) {
    const int row = c >> CSHIFT;
    const int col = (c & (CH - 1)) << 3;
    const bool ok = kt0 + row < S;
    const long long src = base + (long long)(ok ? kt0 + row : 0) * DH + col;
    cp_async16(k_s + tile_at<DH>(row, col), k + src, ok);
    cp_async16(v_s + tile_at<DH>(row, col), v + src, ok);
  }
  load_tile(0);
  cp_async_commit();
  if (tid < kLutSize) lut_s[tid] = tid == 0 ? 0.f : lut[tid * H + h];

  // this lane's keys grp and grp + 8 of the warp's 16: below S
  const bool key_ok[2] = {key0 + grp < S, key0 + grp + 8 < S};
  const int kl = 16 * kw + grp;  // the first one's column in a staged tpl/ids tile

  unsigned ak[kKeepKv ? KS : 1][4], av[kKeepKv ? KS : 1][4];  // A fragments of the warp's K and V rows
  float acc_dk[2 * KS][4], acc_dv[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_dk[n][c] = acc_dv[n][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kKvRows;
    if constexpr (kStages > 1) {
      if (t + 1 < n_tiles) load_tile(t + 1);
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();
    __syncthreads();

    if constexpr (kKeepKv) {
      if (t == 0 && active) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int off = tile_at<DH>(16 * kw + (lane & 15), 16 * ks + ((lane >> 4) << 3));
          ldsm_x4(k_s + off, ak[ks]);
          ldsm_x4(v_s + off, av[ks]);
        }
      }
    }
    if (active) {
      const int st = t % kStages;
      const bf16* qs = q_s + st * kKvRows * LD;
      const bf16* gs = g_s + st * kKvRows * LD;
      const float* ls = lse_s + st * kKvRows;
      const float* dls = dl_s + st * kKvRows;
      const float* tt = tpl_s + st * kKvRows * kKvBiasStride;
      const int* it = ids_s + st * kKvRows * kKvBiasStride;
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
          const int off = tile_at<DH>(r0 + (lane & 7) + ((lane >> 4) << 3), 16 * ks + (((lane >> 3) & 1) << 3));
          unsigned bq[4], bg[4];
          ldsm_x4(qs + off, bq);
          ldsm_x4(gs + off, bg);
          if constexpr (kKeepKv) {
            mma(sacc[0], ak[ks], bq[0], bq[1]);
            mma(sacc[1], ak[ks], bq[2], bq[3]);
            mma(pacc[0], av[ks], bg[0], bg[1]);
            mma(pacc[1], av[ks], bg[2], bg[3]);
          } else {
            const int kv_off = tile_at<DH>(16 * kw + (lane & 15), 16 * ks + ((lane >> 4) << 3));
            unsigned a4[4];
            ldsm_x4(k_s + kv_off, a4);
            mma(sacc[0], a4, bq[0], bq[1]);
            mma(sacc[1], a4, bq[2], bq[3]);
            ldsm_x4(v_s + kv_off, a4);
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
            const int e = lr * kKvBiasStride + kl + 8 * hi;
            const float s = key_ok[hi] ? sacc[j][c] * scale + bias_of(tt[e], it[e], lut_s, tpl_coef) : -INFINITY;
            const float p = expf(s - ls[lr]);
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
          const int off = tile_at<DH>(r0 + (lane & 15), 16 * np + ((lane >> 4) << 3));
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
    __syncthreads();  // the tile's buffers are consumed before tile t + kStages lands in them
    if constexpr (kStages == 1) {
      if (t + 1 < n_tiles) load_tile(t + 1);
      cp_async_commit();
    }
  }

  // the row groups meet: groups 1.. leave each lane's dK and dV in the
  // consumed Q and G rings ([group][key slice][value][lane]), group 0 adds
  // them and stages the tile in bf16 in the K and V tiles (no warp reads
  // them any more)
  float* const partials = reinterpret_cast<float*>(q_s);
  if (rg > 0 && active) {
    float* partial = partials + ((rg - 1) * kKvKeyWarps + kw) * DH * 32 + lane;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        partial[(4 * n + c) * 32] = acc_dk[n][c];
        partial[(DH / 2 + 4 * n + c) * 32] = acc_dv[n][c];
      }
  }
  __syncthreads();
  if (rg == 0 && active) {
    for (int gi = 1; gi < kKvRowGroups; ++gi) {
      const float* partial = partials + ((gi - 1) * kKvKeyWarps + kw) * DH * 32 + lane;
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc_dk[n][c] += partial[(4 * n + c) * 32];
          acc_dv[n][c] += partial[(DH / 2 + 4 * n + c) * 32];
        }
    }
    const int w0 = 16 * kw;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      const int col = 8 * n + 2 * tq;
      *reinterpret_cast<unsigned*>(k_s + tile_at<DH>(w0 + grp, col)) =
          pack_bf16(acc_dk[n][0] * scale, acc_dk[n][1] * scale);
      *reinterpret_cast<unsigned*>(k_s + tile_at<DH>(w0 + grp + 8, col)) =
          pack_bf16(acc_dk[n][2] * scale, acc_dk[n][3] * scale);
      *reinterpret_cast<unsigned*>(v_s + tile_at<DH>(w0 + grp, col)) = pack_bf16(acc_dv[n][0], acc_dv[n][1]);
      *reinterpret_cast<unsigned*>(v_s + tile_at<DH>(w0 + grp + 8, col)) = pack_bf16(acc_dv[n][2], acc_dv[n][3]);
    }
  }
  __syncthreads();
  for (int c = tid; c < kKvKeys * CH; c += kKvThreads) {
    const int row = c >> CSHIFT;
    const int col = (c & (CH - 1)) << 3;
    if (kt0 + row < S) {
      const long long dst = base + (long long)(kt0 + row) * DH + col;
      *reinterpret_cast<uint4*>(dk + dst) = *reinterpret_cast<const uint4*>(k_s + tile_at<DH>(row, col));
      *reinterpret_cast<uint4*>(dv + dst) = *reinterpret_cast<const uint4*>(v_s + tile_at<DH>(row, col));
    }
  }
}

bool shape_ok(int B, int H, int S, int dtype, int tile) {
  return dtype == 1 && B > 0 && H > 0 && S > 0 && B <= 65535 && (S + tile - 1) / tile <= 65535;
}

// whether a grid of (H, S / tile, B) blocks holds more blocks than the
// current device has SMs (DH 128 then takes one stage, two blocks an SM)
bool more_blocks_than_sms(int B, int H, int S, int tile) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return false;
  return (long long)H * ((S + tile - 1) / tile) * B > sms;
}

template <int DH, int ST>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* out, const void* g,
                      const void* tpl, const void* ids, const void* lut, const void* lse, void* dq,
                      void* dlut, void* delta, int B, int H, int S, float scale, float tpl_coef, uint2 seed,
                      unsigned thr, float keep_scale, cudaStream_t stream) {
  constexpr size_t smem = Shape<DH, ST>::kDqSmem;
  const cudaError_t err = cudaFuncSetAttribute(tree_attention_bwd_dq_mma_kernel<DH, ST>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (S + kDqRows - 1) / kDqRows, B);
  tree_attention_bwd_dq_mma_kernel<DH, ST><<<grid, kDqThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(out), static_cast<const bf16*>(g), static_cast<const float*>(tpl),
      static_cast<const int*>(ids), static_cast<const float*>(lut), static_cast<const float*>(lse),
      static_cast<bf16*>(dq), static_cast<float*>(dlut), static_cast<float*>(delta), H, S, scale, tpl_coef, seed,
      thr, keep_scale);
  return cudaGetLastError();
}

template <int DH, int ST>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* g, const void* tpl,
                       const void* ids, const void* lut, const void* lse, const void* delta, void* dk, void* dv,
                       int B, int H, int S, float scale, float tpl_coef, uint2 seed, unsigned thr,
                       float keep_scale, cudaStream_t stream) {
  constexpr size_t smem = Shape<DH, ST>::kKvSmem;
  const cudaError_t err = cudaFuncSetAttribute(tree_attention_bwd_dkv_mma_kernel<DH, ST>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (S + kKvKeys - 1) / kKvKeys, B);
  tree_attention_bwd_dkv_mma_kernel<DH, ST><<<grid, kKvThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<const float*>(tpl), static_cast<const int*>(ids),
      static_cast<const float*>(lut), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, S, scale, tpl_coef, seed, thr, keep_scale);
  return cudaGetLastError();
}

}  // namespace

// dq, the per-row D_i in `delta` (f32 (B, H, S)), and the dlut sum, which is
// ADDED to `dlut` (f32 (32, H), zeroed by the caller). bfloat16 (dtype 1) at
// DH = 16, 32, 64 or 128; anything else returns cudaErrorInvalidValue. q,
// k, v, out, g and dq must be 16-byte aligned (the wrapper checks the
// inputs and allocates dq). The dropout mask is keyed by (seed_hi << 32 |
// seed_lo); thr = 0 keeps every key, and keep_scale is 1 / (1 - rate).
// Returns a cudaError_t (0 on success).
extern "C" int tree_attention_bwd_dq_mma(const void* q, const void* k, const void* v,
                                         const void* out, const void* g, const void* tpl,
                                         const void* ids, const void* lut, const void* lse,
                                         void* dq, void* dlut, void* delta, int B, int H, int S,
                                         int DH, float scale, float tpl_coef, unsigned seed_lo,
                                         unsigned seed_hi, unsigned thr, float keep_scale,
                                         int dtype, void* stream) {
  if (!shape_ok(B, H, S, dtype, kDqRows)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint2 seed = make_uint2(seed_lo, seed_hi);
  switch (DH) {
    case 16:
      return launch_dq<16, 2>(q, k, v, out, g, tpl, ids, lut, lse, dq, dlut, delta, B, H, S, scale, tpl_coef, seed, thr,
                           keep_scale, st);
    case 32:
      return launch_dq<32, 2>(q, k, v, out, g, tpl, ids, lut, lse, dq, dlut, delta, B, H, S, scale, tpl_coef, seed, thr,
                           keep_scale, st);
    case 64:
      return launch_dq<64, 2>(q, k, v, out, g, tpl, ids, lut, lse, dq, dlut, delta, B, H, S, scale, tpl_coef, seed,
                              thr, keep_scale, st);
    case 128:
      if (more_blocks_than_sms(B, H, S, kDqRows))
        return launch_dq<128, 1>(q, k, v, out, g, tpl, ids, lut, lse, dq, dlut, delta, B, H, S, scale, tpl_coef, seed,
                                 thr, keep_scale, st);
      return launch_dq<128, 2>(q, k, v, out, g, tpl, ids, lut, lse, dq, dlut, delta, B, H, S, scale, tpl_coef, seed,
                               thr, keep_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// dk and dv, from the `delta` that tree_attention_bwd_dq_mma wrote. The
// same dtype, DH and alignment rules; q, k, v, g, dk and dv 16-byte
// aligned.
extern "C" int tree_attention_bwd_dkv_mma(const void* q, const void* k, const void* v,
                                          const void* g, const void* tpl, const void* ids,
                                          const void* lut, const void* lse, const void* delta,
                                          void* dk, void* dv, int B, int H, int S, int DH,
                                          float scale, float tpl_coef, unsigned seed_lo,
                                          unsigned seed_hi, unsigned thr, float keep_scale,
                                          int dtype, void* stream) {
  if (!shape_ok(B, H, S, dtype, kKvKeys)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint2 seed = make_uint2(seed_lo, seed_hi);
  switch (DH) {
    case 16:
      return launch_dkv<16, 2>(q, k, v, g, tpl, ids, lut, lse, delta, dk, dv, B, H, S, scale, tpl_coef, seed, thr,
                            keep_scale, st);
    case 32:
      return launch_dkv<32, 2>(q, k, v, g, tpl, ids, lut, lse, delta, dk, dv, B, H, S, scale, tpl_coef, seed, thr,
                            keep_scale, st);
    case 64:
      return launch_dkv<64, 2>(q, k, v, g, tpl, ids, lut, lse, delta, dk, dv, B, H, S, scale, tpl_coef, seed, thr,
                               keep_scale, st);
    case 128:
      if (more_blocks_than_sms(B, H, S, kKvKeys))
        return launch_dkv<128, 1>(q, k, v, g, tpl, ids, lut, lse, delta, dk, dv, B, H, S, scale, tpl_coef, seed, thr,
                                  keep_scale, st);
      return launch_dkv<128, 2>(q, k, v, g, tpl, ids, lut, lse, delta, dk, dv, B, H, S, scale, tpl_coef, seed, thr,
                                keep_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* tree_attention_bwd_mma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
