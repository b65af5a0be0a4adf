// Compact-bias tree attention, forward, for Hopper (sm_90a): one pass on
// tensor cores for bf16 at DH = 16, 32, 64 and 128, any S >= 1, K and V
// streamed in 64-key tiles.
//
// Replaces the forward Pallas kernels of the JAX package
// (multimodaldiscussiontransformer_tpu/ops/tree_attention.py) for bf16:
//   _make_kernel_batched              (:103, rate 0, padded S <= 128),
//   _make_kernel                      (:66, rate 0, 128 < padded S < 513),
//   _make_kernel_flash                (:228, padded S >= 513, with the
//                                      dropout of :218 and the LSE page of
//                                      :370),
//   _make_kernel_flash_lse            (:418, the LSE for the backward),
//   _make_dropout_fwd_kernel_batched  (:1096, dropout, padded S <= 128),
//   _make_dropout_fwd_kernel          (:973, dropout, 128 < padded S < 513).
// (float32 takes the 3xTF32 forward, tree_attention_fwd_tf32.cu.)
//
// Function, for each (b, h, i):
//   s_ij  = scale * q_i . k_j + c * max(tpl[b,i,j], -1e9) + lut[ids[b,i,j], h]
//           (ids 0 and ids outside [0, 32) add nothing; keys >= S score -inf)
//   m_i   = max(-1e9, max_j s_ij),  e_ij = exp(s_ij - m_i)
//   l_i   = max(sum_j e_ij, 1e-30)                  (the UNDROPPED sum, f32)
//   out_i = sum_j keep_ij e_ij v_j / ((1 - rate) l_i)
//   lse_i = m_i + log(l_i)                          (optional, f32 (B, H, S))
// keep_ij is the Philox mask of tree_attention_common.cuh, counter (j / 4,
// i, h, b), so the backward pair of tree_attention_bwd_mma.cu regenerates
// it bit for bit and reads this kernel's LSE. A row whose every key is
// masked by the template (c = 2: s = -2e9) gets e = 0, l = 1e-30 and zeros.
//
// What bounds it: at S = 1025, B = 1, H = 12, DH 64 the call reads q, k, v
// and the head-shared tpl/ids (8.4 MB, read by every head) and writes out,
// ~14.7 MB or ~4.4 us at 3.35 TB/s, against 4 B H S^2 DH = 3.2 GFLOP of
// products, ~3.3 us at the bf16 tensor-core peak: bytes bound it, barely.
// At a fixed width H DH the bound does not depend on DH; the work per (row,
// key) that does not shrink with DH (the tpl/ids tile, the bias, the
// Philox draw) grows with H, 4x from 12 heads of 64 to 48 heads of 16.
//
// Design, one block per (head, 32-row q tile, graph): 4 warps, two 16-row
// tiles x two key groups. The head is blockIdx.x, so the H blocks that read
// the same (graph, q tile) rows of tpl and ids run together and L2 serves
// the H - 1 re-reads.
// - Q's tile is staged once in bf16 shared memory (16-byte cp.async, rows
//   past S zero-filled) and each warp keeps its 16 rows as A fragments in
//   registers (DH / 16 ldmatrix.x4).
// - K and V stream through a double-buffered ring of bf16 64-key tiles
//   (16-byte cp.async, keys past S zero-filled): tile t + 1 lands while
//   tile t is scored. Nothing is staged whole, so S has no cap.
// - Staged rows are XOR-swizzled 64-wide rows at DH 64 and rows of DH + 8
//   values at DH 16, 32 and 128 (tile_at of mma_common.cuh): ldmatrix is
//   free of bank conflicts at every DH, and DH 64 keeps 71 KB, three
//   blocks an SM (padded rows would take 78 KB, two).
// - The (32 rows x 64 keys) tile of tpl and of ids rides in the same ring,
//   copied by 4-byte cp.async (coalesced along a row): rows of tpl and ids
//   start at 4 S bytes, which is not 16-byte aligned for odd S (S = N + 1
//   is odd on every main path). Rows of 68 entries let each lane read its
//   two neighbouring keys as one 8-byte word, the 8 rows x 4 lanes of a
//   warp in the minimum two wavefronts.
// - Key group g of a row tile scores keys 32 g .. 32 g + 31 of every tile
//   and keeps its own online softmax; at the end group 1 leaves its row
//   max, sum and output in the consumed ring and group 0 merges them. The
//   two groups double the warps at work: a graph of 600 nodes gives 12 x
//   19 blocks at B = 1, and one warp per 16 rows left the schedulers
//   waiting on latency.
// - Per key tile and warp: the keep bits (chunk_keep_bits of
//   mma_common.cuh, one Philox draw per (row, 4-key group), two shuffles
//   per n-tile) are drawn before the copies are waited for; S = Q K^T on
//   mma.sync.m16n8k16 (K by ldmatrix), skipping 16-key pairs past S
//   rounded up to 16; the score is formed in f32 on the accumulator as
//   acc * scale + c * max(tpl, -1e9) + lut_s[id], each lane reading its
//   tpl/ids entries in the C-fragment layout (rows grp, grp + 8; keys 2tq,
//   2tq + 1 of each n-tile); then an online softmax (row max over the 4
//   lanes of a row, rescaled f32 sum and output), and O += P V with P
//   rounded to bf16 and taken from the accumulator fragments as the A
//   operand, V by ldmatrix.trans.
// - The LUT column of head h sits in shared memory with lut_s[0] = 0.
// - The output tile is written once in bf16: staged through the warp's own
//   (no longer needed) Q rows, then stored with 16-byte writes; the LSE
//   when asked.
// - Registers: the output accumulator holds DH / 2 f32 a lane and Q's
//   fragments DH / 8 registers; DH 128 is capped for two blocks an SM (its
//   113 KB of shared memory allow no more), the others for four.
// Slower on an H100 in a one-off comparison (chip_smoke.py times only this
// design): tpl/ids loaded straight from device memory in the fragment
// layout (L2 round trips on every tile's critical path), 64-row blocks of
// one key group, and 16-key groups (four a row tile).
//
// Precision: the products run on bf16 operands in f32 accumulators; P is
// rounded to bf16 before P V while l sums the f32 values, as in
// masked_attention_fwd_mma.cu. The backward pair forms the score the same
// way (acc * scale + bias on the f32 accumulator), so the LSE stays
// consistent with its recomputed p at every DH. The exponentials are expf.

#include "mma_common.cuh"
#include "tree_attention_common.cuh"

namespace {

using namespace tree_attention;
using namespace tower_mma;

constexpr int kRowWarps = 2;                    // 16-row tiles per block
constexpr int kKeyGroups = 2;                   // warps that split each key tile
constexpr int kMmaWarps = kRowWarps * kKeyGroups;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kRows = 16 * kRowWarps;           // q rows per block
constexpr int kKeys = kKeyChunk;                // keys per streamed tile
constexpr int kGroupKeys = kKeys / kKeyGroups;  // keys per warp and tile
constexpr int kGroupNt = kGroupKeys / 8;        // 8-key n-tiles per warp and tile
constexpr int kBiasStride = kKeys + 4;          // entries per staged tpl/ids row
constexpr int kStages = 2;                      // the ring's depth

template <int DH>
struct Shape {
  static constexpr int kLd = tile_ld<DH>();       // bf16 values per staged row
  static constexpr int kChunks = DH / 8;          // 16-byte chunks per row
  static constexpr int kChunkShift = DH == 16 ? 1 : DH == 32 ? 2 : DH == 64 ? 3 : 4;  // log2 kChunks
  static_assert(1 << kChunkShift == kChunks, "DH is 16, 32, 64 or 128");
  static constexpr int kPartial = DH / 2 + 4;     // a lane's o, m and l
  static constexpr int kMinBlocks = DH == 128 ? 2 : 4;
  // Q, the K and V rings, the tpl and ids rings (DH 64: 71 KB, three
  // blocks an SM; DH 128: 113 KB, two)
  static constexpr size_t kSmem = sizeof(bf16) * (size_t)(kRows * kLd + 2 * kStages * kKeys * kLd) +
                                  (sizeof(float) + sizeof(int)) * (size_t)(kStages * kRows * kBiasStride);
  static_assert(sizeof(float) * (kKeyGroups - 1) * kRowWarps * kPartial * 32 <= kSmem - sizeof(bf16) * kRows * kLd,
                "the key groups' partial rows meet in the rings");
};

template <int DH>
__global__ void __launch_bounds__(kMmaThreads, Shape<DH>::kMinBlocks)
tree_attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const float* __restrict__ tpl,
                              const int* __restrict__ ids, const float* __restrict__ lut,
                              bf16* __restrict__ out, float* __restrict__ lse, int H, int S,
                              float scale, float tpl_coef, uint2 seed, unsigned thr,
                              float keep_scale) {
  constexpr int LD = Shape<DH>::kLd;
  constexpr int CH = Shape<DH>::kChunks;
  constexpr int CSHIFT = Shape<DH>::kChunkShift;
  constexpr int KS = DH / 16;  // 16-dim k steps of S = Q K^T, 16-dim n pairs of O
  constexpr int kPartial = Shape<DH>::kPartial;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);                 // [kRows][LD]; then the output tile
  bf16* k_s = q_s + kRows * LD;                                  // [kStages][kKeys][LD]
  bf16* v_s = k_s + kStages * kKeys * LD;                        // [kStages][kKeys][LD]
  float* tpl_s = reinterpret_cast<float*>(v_s + kStages * kKeys * LD);  // [kStages][kRows][kBiasStride]
  int* ids_s = reinterpret_cast<int*>(tpl_s + kStages * kRows * kBiasStride);
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
  const int kg = warp / kRowWarps;  // and its key group: keys kGroupKeys kg .. of every tile
  const long long bh = (long long)b * H + h;
  const long long base = bh * S * DH;
  const int kp = (S + 15) & ~15;  // keys padded to 16
  const int n_tiles = (S + kKeys - 1) / kKeys;
  const int r0 = q0 + 16 * rw;    // this warp's first row
  const bool active = r0 < S;     // warp-uniform: a warp past S only copies
  const int rows = min(kRows, S - q0);  // the block's rows below S
  const long long graph = (long long)b * S * S;

  // tile t of K, V (keys past S zero-filled), tpl and ids (the block's
  // rows below S; keys past S zero-filled) into stage t % kStages
  auto load_tile = [&](int t) {
    const int k0 = t * kKeys;
    const int st = t % kStages;
    bf16* kd = k_s + st * kKeys * LD;
    bf16* vd = v_s + st * kKeys * LD;
    for (int c = tid; c < kKeys * CH; c += kMmaThreads) {
      const int row = c >> CSHIFT;
      const int col = (c & (CH - 1)) << 3;
      const bool ok = k0 + row < S;
      const long long src = base + (long long)(ok ? k0 + row : 0) * DH + col;
      cp_async16(kd + tile_at<DH>(row, col), k + src, ok);
      cp_async16(vd + tile_at<DH>(row, col), v + src, ok);
    }
    float* td = tpl_s + st * kRows * kBiasStride;
    int* idd = ids_s + st * kRows * kBiasStride;
    const int j = tid & (kKeys - 1);
    const bool key_ok = k0 + j < S;
    for (int r = tid / kKeys; r < rows; r += kMmaThreads / kKeys) {
      const long long src = key_ok ? graph + (long long)(q0 + r) * S + k0 + j : 0;
      cp_async4(td + r * kBiasStride + j, tpl + src, key_ok);
      cp_async4(idd + r * kBiasStride + j, ids + src, key_ok);
    }
  };

  for (int c = tid; c < kRows * CH; c += kMmaThreads) {
    const int row = c >> CSHIFT;
    const int col = (c & (CH - 1)) << 3;
    const bool ok = q0 + row < S;
    cp_async16(q_s + tile_at<DH>(row, col), q + base + (long long)(ok ? q0 + row : 0) * DH + col, ok);
  }
  load_tile(0);
  cp_async_commit();
  if (tid < kLutSize) lut_s[tid] = tid == 0 ? 0.f : lut[tid * H + h];

  // this lane's rows grp (a) and grp + 8 (b): below S, and their offsets
  // in a staged tpl/ids tile at the warp's keys
  const int row_a = r0 + grp;
  const bool ok_a = row_a < S;
  const bool ok_b = row_a + 8 < S;
  const int off_a = (16 * rw + grp) * kBiasStride + kGroupKeys * kg + 2 * tq;
  const int off_b = off_a + 8 * kBiasStride;

  unsigned qa[KS][4];  // A fragments of the warp's Q rows, k = DH dims
  // m and l of rows grp and grp + 8 over the warp's keys; l is this lane's
  // share of the row sum until the end
  float m[2] = {kMaskBias, kMaskBias};
  float l[2] = {0.f, 0.f};
  float o[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kw = t * kKeys + kGroupKeys * kg;  // the warp's first key of the tile
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    // the warp's keep bits of the tile while its copies land (all set at rate 0)
    const unsigned keep = thr != 0u && active ? chunk_keep_bits<kGroupNt>(r0, kw, h, b, seed, thr, lane) : ~0u;
    cp_async_wait<1>();
    __syncthreads();

    // 16-key pairs of the warp's keys below S rounded up to 16, warp-uniform
    const int pairs = active ? max(0, min(kGroupKeys, kp - kw)) >> 4 : 0;
    if (t == 0 && active) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(q_s + tile_at<DH>(16 * rw + (lane & 15), 16 * ks + ((lane >> 4) << 3)), qa[ks]);
    }
    if (pairs > 0) {
      const int st = t % kStages;
      const bf16* kt = k_s + (st * kKeys + kGroupKeys * kg) * LD;  // the warp's keys
      const bf16* vt = v_s + (st * kKeys + kGroupKeys * kg) * LD;
      const float* tt = tpl_s + st * kRows * kBiasStride;
      const int* it = ids_s + st * kRows * kBiasStride;

      // S = Q K^T: 16 rows x the warp's 32 keys, k = DH dims
      float sc[kGroupNt][4];
#pragma unroll
      for (int n = 0; n < kGroupNt; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[n][c] = 0.f;
#pragma unroll
      for (int np = 0; np < kGroupNt / 2; ++np) {
        if (np < pairs) {
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            unsigned bk[4];
            ldsm_x4(kt + tile_at<DH>(16 * np + (lane & 7) + ((lane >> 4) << 3), 16 * ks + (((lane >> 3) & 1) << 3)),
                    bk);
            mma(sc[2 * np], qa[ks], bk[0], bk[1]);
            mma(sc[2 * np + 1], qa[ks], bk[2], bk[3]);
          }
        }
      }

      // the scores with the compact bias, the row max and the rescaling of
      // what came before
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < kGroupNt; ++nt) {
        if (nt < 2 * pairs) {
          float bias[4] = {0.f, 0.f, 0.f, 0.f};  // C elements: rows a, a, b, b
          if (ok_a) {
            const float2 t2 = *reinterpret_cast<const float2*>(tt + off_a + 8 * nt);
            const int2 i2 = *reinterpret_cast<const int2*>(it + off_a + 8 * nt);
            bias[0] = bias_of(t2.x, i2.x, lut_s, tpl_coef);
            bias[1] = bias_of(t2.y, i2.y, lut_s, tpl_coef);
          }
          if (ok_b) {
            const float2 t2 = *reinterpret_cast<const float2*>(tt + off_b + 8 * nt);
            const int2 i2 = *reinterpret_cast<const int2*>(it + off_b + 8 * nt);
            bias[2] = bias_of(t2.x, i2.x, lut_s, tpl_coef);
            bias[3] = bias_of(t2.y, i2.y, lut_s, tpl_coef);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c)
            sc[nt][c] = kw + 8 * nt + 2 * tq + (c & 1) < S ? sc[nt][c] * scale + bias[c] : -INFINITY;
          mx[0] = fmaxf(mx[0], fmaxf(sc[nt][0], sc[nt][1]));
          mx[1] = fmaxf(mx[1], fmaxf(sc[nt][2], sc[nt][3]));
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
        for (int n = 0; n < 2 * KS; ++n) {
          o[n][2 * hi] *= alpha;
          o[n][2 * hi + 1] *= alpha;
        }
      }

      // p (summed undropped), the keep bits, and O += P V per 16-key pair
#pragma unroll
      for (int np = 0; np < kGroupNt / 2; ++np) {
        if (np < pairs) {
          unsigned pa[4];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int nt = 2 * np + jj;
            float p[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) p[c] = expf(sc[nt][c] - m[c >> 1]);
            l[0] += p[0] + p[1];
            l[1] += p[2] + p[3];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (!((keep >> (4 * nt + c)) & 1u)) p[c] = 0.f;
            pa[2 * jj] = pack_bf16(p[0], p[1]);
            pa[2 * jj + 1] = pack_bf16(p[2], p[3]);
          }
          // k = the pair's 16 keys, n = DH dims
#pragma unroll
          for (int dp = 0; dp < KS; ++dp) {
            unsigned bv[4];
            ldsm_x4_t(vt + tile_at<DH>(16 * np + (lane & 15), 16 * dp + ((lane >> 4) << 3)), bv);
            mma(o[2 * dp], pa, bv[0], bv[1]);
            mma(o[2 * dp + 1], pa, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // the tile's buffers are consumed before tile t + 2 lands in them
  }

  // the key groups meet: groups 1.. leave each lane's o, m and l in the
  // consumed rings ([group][row tile][value][lane], conflict-free), and
  // group 0 merges them into its own as blocks of an online softmax
  float* const partials = reinterpret_cast<float*>(k_s);
  if (kg > 0 && active) {
    float* partial = partials + ((kg - 1) * kRowWarps + rw) * kPartial * 32 + lane;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) partial[(4 * n + c) * 32] = o[n][c];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      partial[(DH / 2 + hi) * 32] = m[hi];
      partial[(DH / 2 + 2 + hi) * 32] = l[hi];
    }
  }
  __syncthreads();
  if (kg > 0 || !active) return;
  for (int g = 1; g < kKeyGroups; ++g) {
    const float* partial = partials + ((g - 1) * kRowWarps + rw) * kPartial * 32 + lane;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float m1 = partial[(DH / 2 + hi) * 32];
      const float m_new = fmaxf(m[hi], m1);
      const float a0 = expf(m[hi] - m_new);
      const float a1 = expf(m1 - m_new);
      m[hi] = m_new;
      l[hi] = l[hi] * a0 + partial[(DH / 2 + 2 + hi) * 32] * a1;
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n) {
        o[n][2 * hi] = o[n][2 * hi] * a0 + partial[(4 * n + 2 * hi) * 32] * a1;
        o[n][2 * hi + 1] = o[n][2 * hi + 1] * a0 + partial[(4 * n + 2 * hi + 1) * 32] * a1;
      }
    }
  }

  // the row sums over the 4 lanes of each row; out = o / ((1 - rate) l)
  float denom[2], f[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(kFull, l[hi], 1);
    l[hi] += __shfl_xor_sync(kFull, l[hi], 2);
    denom[hi] = fmaxf(l[hi], 1e-30f);
    f[hi] = keep_scale / denom[hi];
  }
  // the warp's Q rows are free: both key groups took their fragments at tile 0
  const int w0 = 16 * rw;
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    *reinterpret_cast<unsigned*>(q_s + tile_at<DH>(w0 + grp, 8 * n + 2 * tq)) =
        pack_bf16(o[n][0] * f[0], o[n][1] * f[0]);
    *reinterpret_cast<unsigned*>(q_s + tile_at<DH>(w0 + grp + 8, 8 * n + 2 * tq)) =
        pack_bf16(o[n][2] * f[1], o[n][3] * f[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int c = lane + 32 * i;
    const int row = w0 + (c >> CSHIFT);
    const int col = (c & (CH - 1)) << 3;
    if (q0 + row < S)
      *reinterpret_cast<uint4*>(out + base + (long long)(q0 + row) * DH + col) =
          *reinterpret_cast<const uint4*>(q_s + tile_at<DH>(row, col));
  }
  if (lse != nullptr && tq == 0) {
    if (ok_a) lse[bh * S + row_a] = m[0] + logf(denom[0]);
    if (ok_b) lse[bh * S + row_a + 8] = m[1] + logf(denom[1]);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* tpl, const void* ids,
                   const void* lut, void* out, void* lse, int B, int H, int S, float scale, float tpl_coef,
                   uint2 seed, unsigned thr, float keep_scale, cudaStream_t stream) {
  constexpr size_t smem = Shape<DH>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(tree_attention_fwd_mma_kernel<DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (S + kRows - 1) / kRows, B);
  tree_attention_fwd_mma_kernel<DH><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(tpl), static_cast<const int*>(ids), static_cast<const float*>(lut),
      static_cast<bf16*>(out), static_cast<float*>(lse), H, S, scale, tpl_coef, seed, thr, keep_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype 1 (bfloat16) at DH = 16, 32, 64 or 128; anything else returns
// cudaErrorInvalidValue. q, k, v and out must be 16-byte aligned (the
// wrapper checks q, k and v and allocates out). lse may be null. The
// dropout mask is keyed by (seed_hi << 32 | seed_lo); thr = 0 keeps every
// key, and keep_scale is 1 / (1 - rate). Returns a cudaError_t (0 on
// success).
extern "C" int tree_attention_fwd_mma(const void* q, const void* k, const void* v,
                                      const void* tpl, const void* ids, const void* lut,
                                      void* out, void* lse, int B, int H, int S, int DH,
                                      float scale, float tpl_coef, unsigned seed_lo,
                                      unsigned seed_hi, unsigned thr, float keep_scale, int dtype,
                                      void* stream) {
  if (dtype != 1 || B <= 0 || H <= 0 || S <= 0 || B > 65535 || (S + kRows - 1) / kRows > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint2 seed = make_uint2(seed_lo, seed_hi);
  switch (DH) {
    case 16: return launch<16>(q, k, v, tpl, ids, lut, out, lse, B, H, S, scale, tpl_coef, seed, thr, keep_scale, st);
    case 32: return launch<32>(q, k, v, tpl, ids, lut, out, lse, B, H, S, scale, tpl_coef, seed, thr, keep_scale, st);
    case 64: return launch<64>(q, k, v, tpl, ids, lut, out, lse, B, H, S, scale, tpl_coef, seed, thr, keep_scale, st);
    case 128:
      return launch<128>(q, k, v, tpl, ids, lut, out, lse, B, H, S, scale, tpl_coef, seed, thr, keep_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* tree_attention_fwd_mma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
