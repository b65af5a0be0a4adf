// Compact-bias tree attention, backward, for Hopper (sm_90a): two kernels on
// tensor cores for float32 at DH = 16, 32, 64 and 128, any S >= 1, every
// product in 3xTF32.
//
// Replaces the backward Pallas kernels of the JAX package
// (multimodaldiscussiontransformer_tpu/ops/tree_attention.py) on the float32
// route, as tree_attention_bwd_mma.cu does on the bf16 one:
//   _make_kernel_flash_dq             (:468, dq and the dLUT page),
//   _make_kernel_flash_dkv            (:558, dk and dv),
//   _make_dropout_bwd_kernel          (:1007, padded S < 513),
//   _make_dropout_bwd_kernel_batched  (:1148, padded S <= 128).
// It takes the float32 backward over from the CUDA-core pair K2/K3
// (tree_attention_bwd.cu), which now serves bf16 at DH 16, 32 and 128 only.
//
// Function, that of tree_attention_bwd.cu: with the LSE that either forward
// writes, D_i = g_i . out_i and the forwards' Philox keep mask (counter
// (j / 4, i, h, b) of tree_attention_common.cuh, regenerated bit for bit),
//   s_ij  = scale q_i . k_j + c max(tpl[b,i,j], -1e9) + lut[ids[b,i,j], h]
//           (ids 0 and ids outside [0, 32) add nothing; keys >= S: -inf)
//   p_ij  = exp(s_ij - lse_i)
//   pd_ij = keep_ij p_ij / (1 - rate)
//   ds_ij = p_ij (keep_ij (g_i . v_j) / (1 - rate) - D_i)
//   dv_j  = sum_i pd_ij g_i,  dk_j = scale sum_i ds_ij q_i,
//   dq_i  = scale sum_j ds_ij k_j,
//   dlut[id, h] += sum_{i,j : ids[b,i,j] = id} ds_ij  for 1 <= id < 32.
//
// Precision, 3xTF32: every product runs on
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 with each float32
// operand x split as big = cvt.rna.tf32(x), small = cvt.rna.tf32(x - big),
// and a b = big_a big_b + big_a small_b + small_a big_b (small_a small_b,
// ~2^-22 of the product, is dropped), all summed in f32 accumulators: the
// float32 route's 1e-4 tolerances hold, which one TF32 product (~2^-11)
// would break. p, pd and ds stay f32 in registers and are split like any
// operand. PyTorch's memory-efficient attention runs its float32 GEMMs the
// same way (OpMultiplyAddFastF32).
//
// What bounds them: at S = 1025, B = 1, H = 12, DH = 64 the pair reads q, k,
// v, g, out, the LSE and the head-shared tpl/ids (8.4 MB, read by every head
// of both kernels) and writes dq, dk, dv: ~33 MB counted once, ~10 us at
// 3.35 TB/s, against 14 B H S^2 DH = 11.3 GFLOP, 169 us at the 67 TFLOP/s of
// float32 on CUDA cores and, as three TF32 products each, 69 us at the 495
// TFLOP/s of dense TF32: bound by operations.
//
// Layout: a float32 tile is staged row-major with DH + 4 floats a row, so
// that the A fragment (row grp, column tq) and the B fragment (n grp, k tq)
// of a row-major tile touch 32 distinct banks, and so do the B fragments
// of a product over the tile's rows (k) read as (row 2 tq, column grp).
// The accumulator fragment of one 8-column n-tile holds (row grp, columns
// 2 tq, 2 tq + 1) where an A fragment wants (row grp, columns tq, tq + 4);
// a product sums over its k index in any order, so the second product
// takes the k index permuted (logical column tq = physical 2 tq, tq + 4 =
// 2 tq + 1): the accumulator registers become the A fragment as they are,
// and the B fragment reads rows 2 tq and 2 tq + 1. No shuffles, no trip
// through shared memory.
//
// tree_attention_bwd_dq_tf32_kernel (q-major), one block per (head, 32-row q
// tile, graph), 4 warps: two 16-row tiles x two key groups, the layout of
// tree_attention_bwd_mma.cu (head on blockIdx.x, so the H blocks that read
// the same (graph, q tile) rows of tpl and ids run together and L2 serves
// the re-reads).
// - Q and G are staged once (16-byte cp.async, rows past S zero-filled);
//   D_i is formed from g and out (16-byte loads) and written to `delta`.
// - K, V and the (32 rows x keys) tpl/ids tile stream through a
//   double-buffered cp.async ring (tpl/ids by 4-byte copies: their rows
//   start at 4 S bytes, not 16-byte aligned for odd S). 64-key tiles at DH
//   <= 32, 32-key tiles at DH >= 64, so that two blocks fit an SM up to DH
//   = 64.
// - Per tile each warp forms S = Q K^T and dP = G V^T over its keys (each
//   3xTF32 term in an accumulator of its own: three independent mma chains
//   over DH, where one accumulator would chain all three), then
//   p, keep (chunk_keep_bits of mma_common.cuh) and ds in f32 on the
//   accumulator fragments, and dQ += dS K. dQ stays in registers for the
//   whole key walk; the key groups add theirs through the consumed ring at
//   the end, and dq is scaled and written once, no atomics.
// - dLUT: each lane keeps a private 32-bin f32 histogram of ds in shared
//   memory, bin-major ([warp][bin][lane]): plain adds, no atomics, no bank
//   conflicts. At the end the block sums each bin and adds it to the (32,
//   H) dlut with one atomicAdd. (One histogram shared by the four warps
//   through shared-memory atomics fits three blocks an SM at DH 64; on an
//   H100 it was faster at S = 1025, H = 12 and slower at S = 129 to 601 and
//   at DH 16.)
//
// tree_attention_bwd_dkv_tf32_kernel (k-major), one block per (head, 32-key
// tile, graph), 4 warps: two 16-key slices x two row groups.
// - The K and V tile is staged once.
// - Q, G, the tile's lse and delta, and the (rows x 32 keys) tpl/ids tile
//   stream through a double-buffered ring (64-row tiles at DH <= 32, 32-row
//   at DH >= 64); rows past S get lse = +inf (p = 0) and delta = 0.
// - Per 16-row step: S^T = K Q^T and dP^T = V G^T, p, keep
//   (key_major_keep_bits), pd and ds in f32, then dV += Pd^T G and dK +=
//   dS^T Q. dK and dV stay in registers for the whole q walk; the row
//   groups add theirs through the consumed ring, and the tile is written
//   once.
//
// The operands are split where they are read, each time: two cvt and one
// subtraction per element and use.

#include "mma_common.cuh"
#include "tree_attention_common.cuh"

namespace {

using namespace tree_attention;
using tower_mma::chunk_keep_bits;
using tower_mma::cp_async16;
using tower_mma::cp_async4;
using tower_mma::cp_async_commit;
using tower_mma::cp_async_wait;
using tower_mma::key_major_keep_bits;

constexpr int kStages = 2;  // the rings' depth

// the dq kernel
constexpr int kDqRowWarps = 2;                         // 16-row tiles per block
constexpr int kDqKeyGroups = 2;                        // warps that split each key tile
constexpr int kDqWarps = kDqRowWarps * kDqKeyGroups;
constexpr int kDqThreads = kDqWarps * 32;
constexpr int kDqRows = 16 * kDqRowWarps;              // q rows per block
static_assert(kDqThreads == 4 * kDqRows, "four threads form each row's D");

// the dk/dv kernel
constexpr int kKvKeyWarps = 2;                         // 16-key slices per block
constexpr int kKvRowGroups = 2;                        // warps that split each q tile
constexpr int kKvWarps = kKvKeyWarps * kKvRowGroups;
constexpr int kKvThreads = kKvWarps * 32;
constexpr int kKvKeys = 16 * kKvKeyWarps;              // keys per block
constexpr int kKvBiasLd = kKvKeys + 4;                 // entries per staged tpl/ids row

template <int DH>
struct DqShape {
  static constexpr int kLd = DH + 4;                      // floats per staged row
  static constexpr int kKeys = DH <= 32 ? 64 : 32;        // keys per streamed tile
  static constexpr int kGroupKeys = kKeys / kDqKeyGroups;  // keys per warp and tile
  static constexpr int kGroupNt = kGroupKeys / 8;         // 8-key n-tiles per warp and tile
  static constexpr int kBiasLd = kKeys + 4;               // entries per staged tpl/ids row
  // Q and G, the K and V rings, the tpl and ids rings, the lanes' histograms
  // (DH 64: 85 KB)
  static constexpr size_t kSmem =
      sizeof(float) * (size_t)(2 * kDqRows * kLd + 2 * kStages * kKeys * kLd + 2 * kStages * kDqRows * kBiasLd +
                               kDqWarps * kLutSize * 32);
  static_assert(sizeof(float) * (kDqKeyGroups - 1) * kDqRowWarps * (DH / 2) * 32 <=
                    sizeof(float) * kStages * kKeys * kLd,
                "the key groups' dQ partials fit the K ring");
};

template <int DH>
struct KvShape {
  static constexpr int kLd = DH + 4;
  static constexpr int kRows = DH <= 32 ? 64 : 32;       // q rows per streamed tile
  static constexpr int kGroupRows = kRows / kKvRowGroups;  // rows per warp and tile
  // K and V, the Q and G rings, the lse and delta rings, the tpl and ids
  // rings (DH 64: 71 KB)
  static constexpr size_t kSmem =
      sizeof(float) * (size_t)(2 * kKvKeys * kLd + 2 * kStages * kRows * kLd + 2 * kStages * kRows +
                               2 * kStages * kRows * kKvBiasLd);
  static_assert(sizeof(float) * (kKvRowGroups - 1) * kKvKeyWarps * DH * 32 <=
                    sizeof(float) * 2 * kStages * kRows * kLd,
                "the row groups' dK and dV partials fit the Q and G rings");
};

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, each a tf32 (small carries the next 11 bits of x)
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += a b for one m16n8k8 tile: tf32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An operand of one m16n8k8 product, split: A (4 registers) or B (2)
template <int N>
struct Frag {
  unsigned big[N], small[N];
};

// c += a b in 3xTF32: the small cross terms first, then big x big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Frag<4>& a, const Frag<2>& b) {
  mma_tf32(c, a.small, b.big[0], b.big[1]);
  mma_tf32(c, a.big, b.small[0], b.small[1]);
  mma_tf32(c, a.big, b.big[0], b.big[1]);
}

// c[t] += term t of a b in 3xTF32 (small x big, big x small, big x big),
// each in an accumulator of its own: a long sum over k then keeps three
// independent mma chains in flight instead of one chain three times as long.
// The product is c[2] + (c[0] + c[1]) (``terms_sum``).
__device__ __forceinline__ void mma_3xtf32_terms(float (&c)[3][4], const Frag<4>& a, const Frag<2>& b) {
  mma_tf32(c[0], a.small, b.big[0], b.big[1]);
  mma_tf32(c[1], a.big, b.small[0], b.small[1]);
  mma_tf32(c[2], a.big, b.big[0], b.big[1]);
}

__device__ __forceinline__ float terms_sum(const float (&c)[3][4], int i) { return c[2][i] + (c[0][i] + c[1][i]); }

// The A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 7 of a row-major
// tile of LD floats a row (grp = lane / 4, tq = lane % 4):
// (grp, tq), (grp + 8, tq), (grp, tq + 4), (grp + 8, tq + 4)
template <int LD>
__device__ __forceinline__ Frag<4> load_a(const float* tile, int r0, int k0, int lane) {
  const float* p = tile + (r0 + (lane >> 2)) * LD + k0 + (lane & 3);
  Frag<4> f;
  split_tf32(p[0], f.big[0], f.small[0]);
  split_tf32(p[8 * LD], f.big[1], f.small[1]);
  split_tf32(p[4], f.big[2], f.small[2]);
  split_tf32(p[8 * LD + 4], f.big[3], f.small[3]);
  return f;
}

// The B fragment of a product over the tile's columns (B[k][n] = tile[n0 +
// n][k0 + k]): (n grp, k tq), (n grp, k tq + 4)
template <int LD>
__device__ __forceinline__ Frag<2> load_b_cols(const float* tile, int n0, int k0, int lane) {
  const float* p = tile + (n0 + (lane >> 2)) * LD + k0 + (lane & 3);
  Frag<2> f;
  split_tf32(p[0], f.big[0], f.small[0]);
  split_tf32(p[4], f.big[1], f.small[1]);
  return f;
}

// The B fragment of a product over the tile's rows (B[k][n] = tile[k0 +
// k][n0 + n]) with the permuted k of the accumulator-as-A operand: logical
// k tq is row k0 + 2 tq, logical k tq + 4 is row k0 + 2 tq + 1
template <int LD>
__device__ __forceinline__ Frag<2> load_b_rows(const float* tile, int k0, int n0, int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  Frag<2> f;
  split_tf32(p[0], f.big[0], f.small[0]);
  split_tf32(p[LD], f.big[1], f.small[1]);
  return f;
}

// The accumulator fragment c of one 16 x 8 tile as the A operand of a
// product over its 8 columns, k permuted as load_b_rows reads it
__device__ __forceinline__ Frag<4> acc_as_a(const float (&c)[4]) {
  Frag<4> f;
  split_tf32(c[0], f.big[0], f.small[0]);
  split_tf32(c[2], f.big[1], f.small[1]);
  split_tf32(c[1], f.big[2], f.small[2]);
  split_tf32(c[3], f.big[3], f.small[3]);
  return f;
}

template <int DH>
__global__ void __launch_bounds__(kDqThreads)
tree_attention_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ out,
                                  const float* __restrict__ g, const float* __restrict__ tpl,
                                  const int* __restrict__ ids, const float* __restrict__ lut,
                                  const float* __restrict__ lse, float* __restrict__ dq,
                                  float* __restrict__ dlut, float* __restrict__ delta, int H, int S,
                                  float scale, float tpl_coef, uint2 seed, unsigned thr,
                                  float keep_scale) {
  using Shape = DqShape<DH>;
  constexpr int LD = Shape::kLd;
  constexpr int KT = Shape::kKeys;
  constexpr int GK = Shape::kGroupKeys;
  constexpr int NT = Shape::kGroupNt;
  constexpr int BLD = Shape::kBiasLd;
  constexpr int DT = DH / 8;  // 8-dim steps: the k steps of S and dP, the n-tiles of dQ
  constexpr int C4 = DH / 4;  // 16-byte chunks per row
  extern __shared__ __align__(128) float smem[];
  float* q_s = smem;                       // [kDqRows][LD]
  float* g_s = q_s + kDqRows * LD;         // [kDqRows][LD]
  float* k_s = g_s + kDqRows * LD;         // [kStages][KT][LD]
  float* v_s = k_s + kStages * KT * LD;    // [kStages][KT][LD]
  float* tpl_s = v_s + kStages * KT * LD;  // [kStages][kDqRows][BLD]
  int* ids_s = reinterpret_cast<int*>(tpl_s + kStages * kDqRows * BLD);
  float* hist = reinterpret_cast<float*>(ids_s + kStages * kDqRows * BLD);  // [warp][bin][lane]
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
  const int kg = warp / kDqRowWarps;  // and its key group: keys GK kg .. of every tile
  const long long bh = (long long)b * H + h;
  const long long base = bh * S * DH;
  const int n_tiles = (S + KT - 1) / KT;
  const int r0 = q0 + 16 * rw;  // this warp's first row
  const bool active = r0 < S;   // warp-uniform: a warp past S only copies
  const int rows = min(kDqRows, S - q0);  // the block's rows below S
  const long long graph = (long long)b * S * S;

  // tile t of K, V (keys past S zero-filled), tpl and ids (the block's rows
  // below S; keys past S zero-filled) into stage t % kStages
  auto load_tile = [&](int t) {
    const int k0 = t * KT;
    const int st = t % kStages;
    float* kd = k_s + st * KT * LD;
    float* vd = v_s + st * KT * LD;
    for (int c = tid; c < KT * C4; c += kDqThreads) {
      const int row = c / C4;
      const int col = (c % C4) * 4;
      const bool ok = k0 + row < S;
      const long long src = base + (long long)(ok ? k0 + row : 0) * DH + col;
      cp_async16(kd + row * LD + col, k + src, ok);
      cp_async16(vd + row * LD + col, v + src, ok);
    }
    float* td = tpl_s + st * kDqRows * BLD;
    int* idd = ids_s + st * kDqRows * BLD;
    const int j = tid % KT;
    const bool key_ok = k0 + j < S;
    for (int r = tid / KT; r < rows; r += kDqThreads / KT) {
      const long long src = key_ok ? graph + (long long)(q0 + r) * S + k0 + j : 0;
      cp_async4(td + r * BLD + j, tpl + src, key_ok);
      cp_async4(idd + r * BLD + j, ids + src, key_ok);
    }
  };

  for (int c = tid; c < kDqRows * C4; c += kDqThreads) {
    const int row = c / C4;
    const int col = (c % C4) * 4;
    const bool ok = q0 + row < S;
    const long long src = base + (long long)(ok ? q0 + row : 0) * DH + col;
    cp_async16(q_s + row * LD + col, q + src, ok);
    cp_async16(g_s + row * LD + col, g + src, ok);
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
      const float4* gp = reinterpret_cast<const float4*>(g + off);
      const float4* op = reinterpret_cast<const float4*>(out + off);
#pragma unroll
      for (int cc = 0; cc < DH / 16; ++cc) {
        const float4 a = __ldg(gp + cc);
        const float4 o = __ldg(op + cc);
        dsum = fmaf(a.x, o.x, dsum);
        dsum = fmaf(a.y, o.y, dsum);
        dsum = fmaf(a.z, o.z, dsum);
        dsum = fmaf(a.w, o.w, dsum);
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
  const int off_a = (16 * rw + grp) * BLD + GK * kg + 2 * tq;
  const int off_b = off_a + 8 * BLD;

  float d_r[2] = {0.f, 0.f};  // D of rows a and b
  float acc[DT][4];           // dQ / scale of rows a and b over the warp's keys
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kw = t * KT + GK * kg;  // the warp's first key of the tile
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    // the warp's keep bits of the tile while its copies land (all set at rate 0)
    const unsigned keep = thr != 0u && active ? chunk_keep_bits<NT>(r0, kw, h, b, seed, thr, lane) : ~0u;
    cp_async_wait<1>();
    __syncthreads();

    if (t == 0 && active) {
      d_r[0] = d_s[16 * rw + grp];
      d_r[1] = d_s[16 * rw + grp + 8];
    }
    // 8-key n-tiles of the warp's keys with a key below S, warp-uniform
    const int nts = active ? max(0, min(NT, (S - kw + 7) >> 3)) : 0;
    if (nts > 0) {
      const int st = t % kStages;
      const float* kt = k_s + (st * KT + GK * kg) * LD;  // the warp's keys
      const float* vt = v_s + (st * KT + GK * kg) * LD;
      const float* tt = tpl_s + st * kDqRows * BLD;
      const int* it = ids_s + st * kDqRows * BLD;

      // S = Q K^T and dP = G V^T: 16 rows x the warp's keys, k = DH dims,
      // each 3xTF32 term in its own accumulator
      float sc[NT][3][4], dp[NT][3][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int t3 = 0; t3 < 3; ++t3)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[n][t3][c] = dp[n][t3][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DT; ++ks) {
        const Frag<4> aq = load_a<LD>(q_s, 16 * rw, 8 * ks, lane);
        const Frag<4> ag = load_a<LD>(g_s, 16 * rw, 8 * ks, lane);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n < nts) {
            mma_3xtf32_terms(sc[n], aq, load_b_cols<LD>(kt, 8 * n, 8 * ks, lane));
            mma_3xtf32_terms(dp[n], ag, load_b_cols<LD>(vt, 8 * n, 8 * ks, lane));
          }
        }
      }

      // p, keep and ds in f32 per 8-key n-tile; ds into the lane's
      // histogram and, split, into the A fragment of dQ += dS K
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < nts) {
          float bias[4] = {0.f, 0.f, 0.f, 0.f};  // C elements: rows a, a, b, b
          int id[4] = {0, 0, 0, 0};
          if (ok_a) {
            const float2 t2 = *reinterpret_cast<const float2*>(tt + off_a + 8 * n);
            const int2 i2 = *reinterpret_cast<const int2*>(it + off_a + 8 * n);
            id[0] = i2.x;
            id[1] = i2.y;
            bias[0] = bias_of(t2.x, i2.x, lut_s, tpl_coef);
            bias[1] = bias_of(t2.y, i2.y, lut_s, tpl_coef);
          }
          if (ok_b) {
            const float2 t2 = *reinterpret_cast<const float2*>(tt + off_b + 8 * n);
            const int2 i2 = *reinterpret_cast<const int2*>(it + off_b + 8 * n);
            id[2] = i2.x;
            id[3] = i2.y;
            bias[2] = bias_of(t2.x, i2.x, lut_s, tpl_coef);
            bias[3] = bias_of(t2.y, i2.y, lut_s, tpl_coef);
          }
          float ds[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const bool key_ok = kw + 8 * n + 2 * tq + (c & 1) < S;
            const float s = key_ok ? terms_sum(sc[n], c) * scale + bias[c] : -INFINITY;
            const float p = expf(s - lse_r[c >> 1]);
            const bool kept = ((keep >> (4 * n + c)) & 1u) != 0u;
            ds[c] = p * ((kept ? terms_sum(dp[n], c) * keep_scale : 0.f) - d_r[c >> 1]);
            if (id[c] > 0 && id[c] < kLutSize) my_hist[32 * id[c]] += ds[c];
          }
          // k = the n-tile's 8 keys, n = DH dims
          const Frag<4> ads = acc_as_a(ds);
#pragma unroll
          for (int dn = 0; dn < DT; ++dn) mma_3xtf32(acc[dn], ads, load_b_rows<LD>(kt, 8 * n, 8 * dn, lane));
        }
      }
    }
    __syncthreads();  // the tile's buffers are consumed before tile t + 2 lands in them
  }

  // the key groups meet: groups 1.. leave each lane's dQ in the consumed K
  // ring ([group][row tile][value][lane], conflict-free), group 0 adds them
  float* const partials = k_s;
  if (kg > 0 && active) {
    float* partial = partials + ((kg - 1) * kDqRowWarps + rw) * (4 * DT) * 32 + lane;
#pragma unroll
    for (int n = 0; n < DT; ++n)
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
    const float* partial = partials + ((gi - 1) * kDqRowWarps + rw) * (4 * DT) * 32 + lane;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] += partial[(4 * n + c) * 32];
  }

  // dq = scale dS K, written once: rows a and b, two neighbouring dims a lane
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int col = 8 * n + 2 * tq;
    if (ok_a)
      *reinterpret_cast<float2*>(dq + base + (long long)row_a * DH + col) =
          make_float2(acc[n][0] * scale, acc[n][1] * scale);
    if (ok_b)
      *reinterpret_cast<float2*>(dq + base + (long long)(row_a + 8) * DH + col) =
          make_float2(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int DH>
__global__ void __launch_bounds__(kKvThreads)
tree_attention_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v, const float* __restrict__ g,
                                   const float* __restrict__ tpl, const int* __restrict__ ids,
                                   const float* __restrict__ lut, const float* __restrict__ lse,
                                   const float* __restrict__ delta, float* __restrict__ dk,
                                   float* __restrict__ dv, int H, int S, float scale,
                                   float tpl_coef, uint2 seed, unsigned thr, float keep_scale) {
  using Shape = KvShape<DH>;
  constexpr int LD = Shape::kLd;
  constexpr int QT = Shape::kRows;
  constexpr int GR = Shape::kGroupRows;
  constexpr int BLD = kKvBiasLd;
  constexpr int DT = DH / 8;
  constexpr int C4 = DH / 4;
  extern __shared__ __align__(128) float smem[];
  float* k_s = smem;                       // [kKvKeys][LD]
  float* v_s = k_s + kKvKeys * LD;         // [kKvKeys][LD]
  float* q_s = v_s + kKvKeys * LD;         // [kStages][QT][LD]
  float* g_s = q_s + kStages * QT * LD;    // [kStages][QT][LD]
  float* lse_s = g_s + kStages * QT * LD;  // [kStages][QT]
  float* dl_s = lse_s + kStages * QT;      // [kStages][QT]
  float* tpl_s = dl_s + kStages * QT;      // [kStages][QT][BLD]
  int* ids_s = reinterpret_cast<int*>(tpl_s + kStages * QT * BLD);
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
  const int rg = warp / kKvKeyWarps;  // and its row group: rows GR rg .. of every tile
  const long long bh = (long long)b * H + h;
  const long long base = bh * S * DH;
  const int n_tiles = (S + QT - 1) / QT;
  const int key0 = kt0 + 16 * kw;  // this warp's first key
  const bool active = key0 < S;    // warp-uniform: a warp past S only copies
  const long long graph = (long long)b * S * S;

  // q tile t: Q and G (rows past S zero-filled), lse (+inf past S) and
  // delta (0 past S), and the (rows x the block's keys) tpl and ids tile
  // (zero-filled past S) into stage t % kStages
  auto load_tile = [&](int t) {
    const int q0 = t * QT;
    const int st = t % kStages;
    float* qd = q_s + st * QT * LD;
    float* gd = g_s + st * QT * LD;
    for (int c = tid; c < QT * C4; c += kKvThreads) {
      const int row = c / C4;
      const int col = (c % C4) * 4;
      const bool ok = q0 + row < S;
      const long long src = base + (long long)(ok ? q0 + row : 0) * DH + col;
      cp_async16(qd + row * LD + col, q + src, ok);
      cp_async16(gd + row * LD + col, g + src, ok);
    }
    for (int e = tid; e < 2 * QT; e += kKvThreads) {
      const int row = e % QT;
      const bool is_lse = e < QT;
      float* dst = (is_lse ? lse_s : dl_s) + st * QT + row;
      if (q0 + row < S)
        cp_async4(dst, (is_lse ? lse : delta) + bh * S + q0 + row, true);
      else
        *dst = is_lse ? INFINITY : 0.f;  // the stage was consumed at tile t - 1
    }
    float* td = tpl_s + st * QT * BLD;
    int* idd = ids_s + st * QT * BLD;
    const int j = tid % kKvKeys;
    const bool key_ok = kt0 + j < S;
    for (int r = tid / kKvKeys; r < QT; r += kKvThreads / kKvKeys) {
      const bool ok = key_ok && q0 + r < S;
      const long long src = ok ? graph + (long long)(q0 + r) * S + kt0 + j : 0;
      cp_async4(td + r * BLD + j, tpl + src, ok);
      cp_async4(idd + r * BLD + j, ids + src, ok);
    }
  };

  for (int c = tid; c < kKvKeys * C4; c += kKvThreads) {
    const int row = c / C4;
    const int col = (c % C4) * 4;
    const bool ok = kt0 + row < S;
    const long long src = base + (long long)(ok ? kt0 + row : 0) * DH + col;
    cp_async16(k_s + row * LD + col, k + src, ok);
    cp_async16(v_s + row * LD + col, v + src, ok);
  }
  load_tile(0);
  cp_async_commit();
  if (tid < kLutSize) lut_s[tid] = tid == 0 ? 0.f : lut[tid * H + h];

  // this lane's keys grp and grp + 8 of the warp's 16: below S
  const bool key_ok[2] = {key0 + grp < S, key0 + grp + 8 < S};
  const int kl = 16 * kw + grp;  // the first one's column in a staged tpl/ids tile

  float acc_dk[DT][4], acc_dv[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_dk[n][c] = acc_dv[n][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * QT;
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (active) {
      const int st = t % kStages;
      const float* qs = q_s + st * QT * LD;
      const float* gs = g_s + st * QT * LD;
      const float* ls = lse_s + st * QT;
      const float* dls = dl_s + st * QT;
      const float* tt = tpl_s + st * QT * BLD;
      const int* it = ids_s + st * QT * BLD;
#pragma unroll
      for (int sub = 0; sub < GR / 16; ++sub) {
        const int r0 = GR * rg + 16 * sub;  // the step's first row in the tile
        if (q0 + r0 >= S) break;            // warp-uniform
        // S^T = K_w Q^T and dP^T = V_w G^T: 16 keys x 16 rows, k = DH dims
        float sacc[2][4], pacc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) sacc[j][c] = pacc[j][c] = 0.f;
#pragma unroll
        for (int ks = 0; ks < DT; ++ks) {
          const Frag<4> ak = load_a<LD>(k_s, 16 * kw, 8 * ks, lane);
          const Frag<4> av = load_a<LD>(v_s, 16 * kw, 8 * ks, lane);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma_3xtf32(sacc[j], ak, load_b_cols<LD>(qs, r0 + 8 * j, 8 * ks, lane));
            mma_3xtf32(pacc[j], av, load_b_cols<LD>(gs, r0 + 8 * j, 8 * ks, lane));
          }
        }

        // keep bits: bit 2j + (row & 1) of keep[hi] for key grp + 8 hi and
        // row 8j + 2tq + (row & 1) of the step
        unsigned keep[2] = {0xFu, 0xFu};
        if (thr != 0u) key_major_keep_bits(key0, q0 + r0, h, b, seed, thr, lane, keep[0], keep[1]);

        // p, pd, ds in f32 per 8-row n-tile j; then dV += Pd^T G and dK +=
        // dS^T Q over those 8 rows (k), n = DH dims
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float pd[4], dsv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int hi = c >> 1;
            const int lr = r0 + 8 * j + 2 * tq + (c & 1);  // the row in the tile
            const int e = lr * BLD + kl + 8 * hi;
            const float s = key_ok[hi] ? sacc[j][c] * scale + bias_of(tt[e], it[e], lut_s, tpl_coef) : -INFINITY;
            const float p = expf(s - ls[lr]);
            const bool kept = ((keep[hi] >> (2 * j + (c & 1))) & 1u) != 0u;
            pd[c] = kept ? p * keep_scale : 0.f;
            dsv[c] = p * ((kept ? pacc[j][c] * keep_scale : 0.f) - dls[lr]);
          }
          const Frag<4> apd = acc_as_a(pd);
          const Frag<4> ads = acc_as_a(dsv);
#pragma unroll
          for (int dn = 0; dn < DT; ++dn) {
            mma_3xtf32(acc_dv[dn], apd, load_b_rows<LD>(gs, r0 + 8 * j, 8 * dn, lane));
            mma_3xtf32(acc_dk[dn], ads, load_b_rows<LD>(qs, r0 + 8 * j, 8 * dn, lane));
          }
        }
      }
    }
    __syncthreads();  // the tile's buffers are consumed before tile t + 2 lands in them
  }

  // the row groups meet: groups 1.. leave each lane's dK and dV in the
  // consumed Q and G rings ([group][key slice][value][lane]), group 0 adds
  // them and writes the tile
  float* const partials = q_s;
  if (rg > 0 && active) {
    float* partial = partials + ((rg - 1) * kKvKeyWarps + kw) * (8 * DT) * 32 + lane;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        partial[(4 * n + c) * 32] = acc_dk[n][c];
        partial[(4 * DT + 4 * n + c) * 32] = acc_dv[n][c];
      }
  }
  __syncthreads();
  if (rg > 0 || !active) return;
  for (int gi = 1; gi < kKvRowGroups; ++gi) {
    const float* partial = partials + ((gi - 1) * kKvKeyWarps + kw) * (8 * DT) * 32 + lane;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc_dk[n][c] += partial[(4 * n + c) * 32];
        acc_dv[n][c] += partial[(4 * DT + 4 * n + c) * 32];
      }
  }
  // keys grp and grp + 8, two neighbouring dims a lane
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int col = 8 * n + 2 * tq;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      if (!key_ok[hi]) continue;
      const long long dst = base + (long long)(key0 + grp + 8 * hi) * DH + col;
      *reinterpret_cast<float2*>(dk + dst) = make_float2(acc_dk[n][2 * hi] * scale, acc_dk[n][2 * hi + 1] * scale);
      *reinterpret_cast<float2*>(dv + dst) = make_float2(acc_dv[n][2 * hi], acc_dv[n][2 * hi + 1]);
    }
  }
}

struct Args {
  const float *q, *k, *v, *out, *g, *tpl, *lut, *lse, *delta;
  const int* ids;
  float *dq, *dk, *dv, *dlut, *delta_out;
  int B, H, S;
  float scale, tpl_coef;
  uint2 seed;
  unsigned thr;
  float keep_scale;
  cudaStream_t stream;
};

template <int DH>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = DqShape<DH>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(tree_attention_bwd_dq_tf32_kernel<DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, (a.S + kDqRows - 1) / kDqRows, a.B);
  tree_attention_bwd_dq_tf32_kernel<DH><<<grid, kDqThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.out, a.g, a.tpl, a.ids, a.lut, a.lse, a.dq, a.dlut, a.delta_out, a.H, a.S, a.scale,
      a.tpl_coef, a.seed, a.thr, a.keep_scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = KvShape<DH>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(tree_attention_bwd_dkv_tf32_kernel<DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, (a.S + kKvKeys - 1) / kKvKeys, a.B);
  tree_attention_bwd_dkv_tf32_kernel<DH><<<grid, kKvThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.g, a.tpl, a.ids, a.lut, a.lse, a.delta, a.dk, a.dv, a.H, a.S, a.scale, a.tpl_coef,
      a.seed, a.thr, a.keep_scale);
  return cudaGetLastError();
}

template <bool kDq>
int dispatch(const Args& a, int DH, int dtype) {
  // float32 only; the grid's y dimension counts 32-row (or 32-key) tiles
  if (dtype != 0 || a.B <= 0 || a.H <= 0 || a.S <= 0 || a.B > 65535 || (a.S + 31) / 32 > 65535)
    return cudaErrorInvalidValue;
  switch (DH) {
    case 16: return kDq ? launch_dq<16>(a) : launch_dkv<16>(a);
    case 32: return kDq ? launch_dq<32>(a) : launch_dkv<32>(a);
    case 64: return kDq ? launch_dq<64>(a) : launch_dkv<64>(a);
    case 128: return kDq ? launch_dq<128>(a) : launch_dkv<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dq, the per-row D_i in `delta` (f32 (B, H, S)), and the dlut sum, which is
// ADDED to `dlut` (f32 (32, H), zeroed by the caller). float32 (dtype 0) at
// DH = 16, 32, 64 or 128; anything else returns cudaErrorInvalidValue. q, k,
// v, out and g must be 16-byte aligned (the wrapper checks the inputs and
// allocates dq). The dropout mask is keyed by (seed_hi << 32 | seed_lo); thr
// = 0 keeps every key, and keep_scale is 1 / (1 - rate). Returns a
// cudaError_t (0 on success).
extern "C" int tree_attention_bwd_dq_tf32(const void* q, const void* k, const void* v,
                                          const void* out, const void* g, const void* tpl,
                                          const void* ids, const void* lut, const void* lse,
                                          void* dq, void* dlut, void* delta, int B, int H, int S,
                                          int DH, float scale, float tpl_coef, unsigned seed_lo,
                                          unsigned seed_hi, unsigned thr, float keep_scale,
                                          int dtype, void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<const float*>(out);
  a.g = static_cast<const float*>(g);
  a.tpl = static_cast<const float*>(tpl);
  a.ids = static_cast<const int*>(ids);
  a.lut = static_cast<const float*>(lut);
  a.lse = static_cast<const float*>(lse);
  a.dq = static_cast<float*>(dq);
  a.dlut = static_cast<float*>(dlut);
  a.delta_out = static_cast<float*>(delta);
  a.B = B;
  a.H = H;
  a.S = S;
  a.scale = scale;
  a.tpl_coef = tpl_coef;
  a.seed = make_uint2(seed_lo, seed_hi);
  a.thr = thr;
  a.keep_scale = keep_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<true>(a, DH, dtype);
}

// dk and dv, from the `delta` that tree_attention_bwd_dq_tf32 wrote. The
// same dtype, DH and alignment rules; q, k, v and g 16-byte aligned.
extern "C" int tree_attention_bwd_dkv_tf32(const void* q, const void* k, const void* v,
                                           const void* g, const void* tpl, const void* ids,
                                           const void* lut, const void* lse, const void* delta,
                                           void* dk, void* dv, int B, int H, int S, int DH,
                                           float scale, float tpl_coef, unsigned seed_lo,
                                           unsigned seed_hi, unsigned thr, float keep_scale,
                                           int dtype, void* stream) {
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.g = static_cast<const float*>(g);
  a.tpl = static_cast<const float*>(tpl);
  a.ids = static_cast<const int*>(ids);
  a.lut = static_cast<const float*>(lut);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.B = B;
  a.H = H;
  a.S = S;
  a.scale = scale;
  a.tpl_coef = tpl_coef;
  a.seed = make_uint2(seed_lo, seed_hi);
  a.thr = thr;
  a.keep_scale = keep_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<false>(a, DH, dtype);
}

extern "C" const char* tree_attention_bwd_tf32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
