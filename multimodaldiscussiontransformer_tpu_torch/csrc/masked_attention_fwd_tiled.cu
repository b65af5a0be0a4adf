// Tower attention with a per-key bias, forward, for Hopper (sm_90a): on
// tensor cores for bf16 at DH = 16, 32, 64 and 128, any S >= 1, K and V
// streamed in 64-key tiles.
//
// Replaces the Pallas kernel `_make_fwd_kernel` of the JAX package
// (multimodaldiscussiontransformer_tpu/ops/masked_attention.py:86), the
// fused self-attention of the BERT and ViT tower layers, on the bf16 shapes
// that the one-pass kernel masked_attention_fwd_mma.cu does not take: S >
// 256 (a text tower at 512 positions, a ViT past 252 patches, where the
// Pallas kernel holds every key of S <= 1024 in VMEM) and DH 16, 32 and
// 128. Its statistics feed the tiled backward pair
// masked_attention_bwd_tiled.cu.
//
// Function, that of masked_attention_fwd_mma.cu, for each (b, h, i):
//   s_ij  = (q_i . k_j) * scale + max(kb[b, j], -1e9)    (kb = 0 when null;
//                                                          keys >= S: -inf)
//   m_i   = max(-1e9, max_j s_ij)
//   l_i   = max(sum_j exp(s_ij - m_i), 1e-30)            (the UNDROPPED sum, f32)
//   out_i = sum_j keep_ij exp(s_ij - m_i) v_j / ((1 - rate) l_i)
//   stats[0, i] = m_i, stats[1, i] = log(l_i)            (optional, stored apart)
// The score is formed as acc * scale + kb in f32 from the f32 accumulator,
// as masked_attention_bwd_tiled.cu re-forms it, so the backward's
// recomputed p = exp((s - m) - log l) matches this forward's m and l. A
// capacity-padding row (every key at -1e9) has s = -1e9, m = -1e9 and p =
// 1: equal weights 1/S over its S keys. Keys past S score -inf (p = 0),
// never -1e9, so such a row never spreads over them. keep_ij is the Philox
// mask of tree_attention_common.cuh, counter (j / 4, i, h, b).
//
// What bounds it: at S = 512, B = 64, H = 12, DH = 64 (a text tower at 512
// positions) the call reads q, k, v and the key bias and writes out and the
// statistics, ~203 MB or ~61 us at 3.35 TB/s, against 4 B H S^2 DH = 51.5
// GFLOP of products, ~52 us at the bf16 tensor-core peak: the two are close;
// below S ~ 600 at DH 64 bytes bound it, above it the products.
//
// Design, the grid and tile loop of masked_attention_fwd_tf32.cu with the
// arithmetic of masked_attention_fwd_mma.cu: one block per (64-row q tile,
// head, batch row), 4 warps, one 16-row tile each over every key of a
// tile; the q tile is blockIdx.x, so the blocks that read one (b, h)'s K
// and V run together and L2 serves the re-reads. Two key groups of 4 warps
// each (8 warps a block, the float32 kernel's layout, merged through shared
// memory at the end) were 0-20% slower on an H100 at S = 104 .. 1024 and
// DH 16 .. 128, and so were 128-key tiles.
// - Q's tile is staged once in bf16 (16-byte cp.async, rows past S
//   zero-filled) and each warp keeps its 16 rows as A fragments in
//   registers (DH / 16 ldmatrix.x4).
// - K, V and the tile's key biases stream through a double-buffered
//   cp.async ring: K and V by 16-byte copies (keys past S zero-filled), the
//   64 raw biases by 4-byte copies (clamped at -1e9 where they are read).
//   Shared memory does not grow with S: 46 KB at DH 64, 88 KB at DH 128;
//   three blocks an SM at DH <= 64.
// - Staged bf16 rows hold DH + 8 values (16 bytes of padding), so the 8
//   rows of an ldmatrix (and the 8 rows of a fragment store) start in 8
//   distinct 16-byte bank groups at every DH: no bank conflicts.
// - Per key tile and warp: the keep bits (chunk_keep_bits of
//   mma_common.cuh, one Philox draw per (row, 4-key group)) are drawn
//   while the copies land; S = Q K^T on mma.sync.m16n8k16 (bf16 operands
//   by ldmatrix, f32 accumulators), skipping 16-key pairs past S rounded
//   up to 16; the scores, an online softmax (row max over the 4 lanes of a
//   row, rescaled f32 sum and output); then O += P V with P rounded to
//   bf16 and taken from the accumulator fragments as the A operand, V by
//   ldmatrix.trans.
// - The output tile is written once in bf16: staged through the warp's own
//   (no longer needed) Q rows, then stored with 16-byte writes; the
//   statistics when asked.
//
// Precision: P is rounded to bf16 before P V while l sums the f32 values,
// as in masked_attention_fwd_mma.cu. The exponentials are expf, as in the
// backward, so that the statistics match its recomputed p.

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
using tower_mma::ldsm_x4;
using tower_mma::ldsm_x4_t;
using tower_mma::mma;
using tower_mma::pack_bf16;

constexpr int kStages = 2;             // the ring's depth
constexpr int kWarps = 4;              // 16-row tiles per block
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;     // q rows per block
constexpr int kKeys = 64;              // keys per streamed tile
constexpr int kNt = kKeys / 8;         // 8-key n-tiles per tile

template <int DH>
struct Shape {
  static constexpr int kLd = DH + 8;      // bf16 values per staged row
  static constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  static constexpr int kMinBlocks = DH <= 64 ? 3 : 1;
  // Q, the K and V rings, the key-bias ring (DH 64: 46 KB)
  static constexpr size_t kSmem = sizeof(bf16) * (size_t)(kRows * kLd + 2 * kStages * kKeys * kLd) +
                                  sizeof(float) * (size_t)(kStages * kKeys);
};

template <int DH>
__global__ void __launch_bounds__(kThreads, Shape<DH>::kMinBlocks)
masked_attention_fwd_tiled_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const float* __restrict__ key_bias,
                                  bf16* __restrict__ out, float* __restrict__ stats, int B, int H, int S,
                                  float scale, uint2 seed, unsigned thr, float keep_scale) {
  constexpr int LD = Shape<DH>::kLd;
  constexpr int CH = Shape<DH>::kChunks;
  constexpr int KS = DH / 16;  // 16-dim k steps of S = Q K^T, 16-dim n pairs of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kRows][LD]; then the output tile
  bf16* k_s = q_s + kRows * LD;                   // [kStages][kKeys][LD]
  bf16* v_s = k_s + kStages * kKeys * LD;         // [kStages][kKeys][LD]
  float* kb_s = reinterpret_cast<float*>(v_s + kStages * kKeys * LD);  // [kStages][kKeys]: raw key biases

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;  // the fragment row group
  const int tq = lane & 3;    // the fragment column pair
  const long long bh = (long long)b * H + h;
  const long long base = bh * S * DH;
  const int kp = (S + 15) & ~15;  // keys padded to 16
  const int n_tiles = (S + kKeys - 1) / kKeys;
  const int r0 = q0 + 16 * warp;  // this warp's first row
  const bool active = r0 < S;   // warp-uniform: a warp past S only copies
  const float* bias_b = key_bias == nullptr ? nullptr : key_bias + (long long)b * S;

  // tile t of K, V (keys past S zero-filled) and the key biases (those
  // past S are never read) into stage t % kStages
  auto load_tile = [&](int t) {
    const int k0 = t * kKeys;
    const int st = t % kStages;
    bf16* kd = k_s + st * kKeys * LD;
    bf16* vd = v_s + st * kKeys * LD;
    for (int c = tid; c < kKeys * CH; c += kThreads) {
      const int row = c / CH;
      const int col = (c % CH) * 8;
      const bool ok = k0 + row < S;
      const long long src = base + (long long)(ok ? k0 + row : 0) * DH + col;
      cp_async16(kd + row * LD + col, k + src, ok);
      cp_async16(vd + row * LD + col, v + src, ok);
    }
    if (bias_b != nullptr && tid < kKeys) {
      const bool ok = k0 + tid < S;
      cp_async4(kb_s + st * kKeys + tid, bias_b + (ok ? k0 + tid : 0), ok);
    }
  };

  for (int c = tid; c < kRows * CH; c += kThreads) {
    const int row = c / CH;
    const int col = (c % CH) * 8;
    const bool ok = q0 + row < S;
    cp_async16(q_s + row * LD + col, q + base + (long long)(ok ? q0 + row : 0) * DH + col, ok);
  }
  load_tile(0);
  cp_async_commit();

  const int row_a = r0 + grp;  // this lane's rows grp (a) and grp + 8 (b)
  const bool ok_a = row_a < S;
  const bool ok_b = row_a + 8 < S;

  unsigned qa[KS][4];  // A fragments of the warp's Q rows, k = DH dims
  // m and l of rows a and b over the keys so far; l is this lane's share of
  // the row sum until the end
  float m[2] = {kMaskBias, kMaskBias};
  float l[2] = {0.f, 0.f};
  float o[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kw = t * kKeys;  // the tile's first key
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    // the warp's keep bits of the tile while its copies land (all set at rate 0)
    const unsigned keep = thr != 0u && active ? chunk_keep_bits<kNt>(r0, kw, h, b, seed, thr, lane) : ~0u;
    cp_async_wait<1>();
    __syncthreads();

    if (t == 0 && active) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(q_s + (16 * warp + (lane & 15)) * LD + 16 * ks + ((lane >> 4) << 3), qa[ks]);
    }
    // 16-key pairs of the tile's keys below S rounded up to 16, warp-uniform
    const int pairs = active ? min(kKeys, kp - kw) >> 4 : 0;
    if (pairs > 0) {
      const int st = t % kStages;
      const bf16* kt = k_s + st * kKeys * LD;
      const bf16* vt = v_s + st * kKeys * LD;
      const float* kbt = kb_s + st * kKeys;

      // S = Q K^T: 16 rows x the tile's 64 keys, k = DH dims
      float sc[kNt][4];
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[n][c] = 0.f;
#pragma unroll
      for (int np = 0; np < kNt / 2; ++np) {
        if (np < pairs) {
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            unsigned bk[4];
            ldsm_x4(kt + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * LD + 16 * ks + (((lane >> 3) & 1) << 3), bk);
            mma(sc[2 * np], qa[ks], bk[0], bk[1]);
            mma(sc[2 * np + 1], qa[ks], bk[2], bk[3]);
          }
        }
      }

      // the scores with the clamped key bias, the row max and the
      // rescaling of what came before
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        if (nt < 2 * pairs) {
          float kb[2] = {0.f, 0.f};  // keys 2 tq, 2 tq + 1 of the n-tile
          if (bias_b != nullptr) {
            const float2 k2 = *reinterpret_cast<const float2*>(kbt + 8 * nt + 2 * tq);
            kb[0] = fmaxf(k2.x, kMaskBias);
            kb[1] = fmaxf(k2.y, kMaskBias);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c)
            sc[nt][c] = kw + 8 * nt + 2 * tq + (c & 1) < S ? sc[nt][c] * scale + kb[c & 1] : -INFINITY;
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
      for (int np = 0; np < kNt / 2; ++np) {
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
            ldsm_x4_t(vt + (16 * np + (lane & 15)) * LD + 16 * dp + ((lane >> 4) << 3), bv);
            mma(o[2 * dp], pa, bv[0], bv[1]);
            mma(o[2 * dp + 1], pa, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // the tile's buffers are consumed before tile t + 2 lands in them
  }

  if (!active) return;

  // the row sums over the 4 lanes of each row; out = o / ((1 - rate) l)
  float denom[2], f[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(kFull, l[hi], 1);
    l[hi] += __shfl_xor_sync(kFull, l[hi], 2);
    denom[hi] = fmaxf(l[hi], 1e-30f);
    f[hi] = keep_scale / denom[hi];
  }
  // the warp's Q rows are free: it took their fragments at tile 0
  bf16* const o_s = q_s + 16 * warp * LD;
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    *reinterpret_cast<unsigned*>(o_s + grp * LD + 8 * n + 2 * tq) = pack_bf16(o[n][0] * f[0], o[n][1] * f[0]);
    *reinterpret_cast<unsigned*>(o_s + (grp + 8) * LD + 8 * n + 2 * tq) = pack_bf16(o[n][2] * f[1], o[n][3] * f[1]);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int row = c / CH;
    const int col = (c % CH) * 8;
    if (r0 + row < S)
      *reinterpret_cast<uint4*>(out + base + (long long)(r0 + row) * DH + col) =
          *reinterpret_cast<const uint4*>(o_s + row * LD + col);
  }
  if (stats != nullptr && tq == 0) {
    const long long plane = (long long)B * H * S;  // stats[1] = log l
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
  constexpr size_t smem = Shape<DH>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(masked_attention_fwd_tiled_kernel<DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  masked_attention_fwd_tiled_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(key_bias), static_cast<bf16*>(out), static_cast<float*>(stats), B, H, S,
      scale, seed, thr, keep_scale);
  return cudaGetLastError();
}

}  // namespace

// out and, where `stats` is not null, the row statistics (f32 (2, B, H, S):
// row max, log of the row sum). bfloat16 (dtype 1) at DH = 16, 32, 64 or
// 128, any S >= 1; anything else returns cudaErrorInvalidValue. q, k, v and
// out must be 16-byte aligned (the wrapper checks q, k and v and allocates
// out). key_bias may be null. The dropout mask is keyed by (seed_hi << 32 |
// seed_lo); thr = 0 keeps every key, and keep_scale is 1 / (1 - rate).
// Returns a cudaError_t (0 on success).
extern "C" int masked_attention_fwd_tiled(const void* q, const void* k, const void* v,
                                          const void* key_bias, void* out, void* stats, int B, int H,
                                          int S, int DH, float scale, unsigned seed_lo,
                                          unsigned seed_hi, unsigned thr, float keep_scale, int dtype,
                                          void* stream) {
  if (dtype != 1 || B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
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

extern "C" const char* masked_attention_fwd_tiled_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
