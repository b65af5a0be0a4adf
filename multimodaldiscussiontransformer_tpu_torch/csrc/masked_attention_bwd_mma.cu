// Tower attention with a per-key bias, backward, for Hopper (sm_90a): dq, dk
// and dv in one pass on tensor cores, for bf16 at DH = 64 and S <= 256.
//
// Replaces the Pallas kernel `_make_bwd_kernel` of the JAX package
// (multimodaldiscussiontransformer_tpu/ops/masked_attention.py:134), which
// computes dq, dk and dv in one pass over whole-S blocks, at the tower
// shapes of the model; the pair of masked_attention_bwd_tiled.cu serves
// bf16 at other DH and longer S, that of masked_attention_bwd_tf32.cu
// float32. With the forward's row statistics m and
// log l, D_i = g_i . out_i and the forward's Philox keep mask,
//   p_ij  = exp(((s_ij + max(kb_j, -1e9)) - m_i) - log l_i),  s = scale q.k
//   pd_ij = keep_ij p_ij / (1 - rate)
//   ds_ij = p_ij (keep_ij (g_i . v_j) / (1 - rate) - D_i)
//   dv_j = sum_i pd_ij g_i,  dk_j = scale sum_i ds_ij q_i,  dq_i = scale sum_j ds_ij k_j
// in that order of operations, so a capacity-padding row (every key at
// -1e9, m = -1e9, log l = log S) keeps its equal weights 1/S.
//
// What bounds it: at the text-fusion shape (B = 256, S = 104, H = 12, bf16)
// one tensor is 40.9 MB; the pass reads q, k, v, g, out and the statistics
// and writes dq, dk and dv, ~330 MB or ~98 us at 3.35 TB/s, against ~26
// GFLOP of products (~27 us at the bf16 tensor-core peak): bytes bound it.
//
// Design, one block per (batch row, head), owning every key:
// - K and V (S padded to 16 rows, zero-filled) are staged once in shared
//   memory as bf16 with 16-byte cp.async copies; the q rows are walked in
//   64-row tiles of Q, G and out, double-buffered with cp.async, beside the
//   tile's statistics. Rows and keys past S are zero-filled in shared memory
//   and masked in the arithmetic (p = 0); S is padded to 16 in the loops,
//   never in memory.
// - Each warp owns 16 keys: S <= 128 takes 8 warps (two blocks per SM, ~91
//   KB of shared memory at S = 104), 128 < S <= 256 takes 16 warps (one
//   block per SM, ~145 KB). The 16-warp block was chosen over two key blocks
//   per (b, h) because those would write f32 dq partials and read them back
//   in a second kernel: ~80 MB more at the ViT-fusion shape, half again the
//   pass's own bytes.
// - Per 16-row step a warp forms S^T = K_w Q^T and dP^T = V_w G^T with
//   mma.sync.m16n8k16 (bf16 operands from ldmatrix, f32 accumulators),
//   forms p, keep, pd and ds in registers, and accumulates dV_w += Pd^T G and
//   dK_w += dS^T Q in registers across the whole q walk (64 f32 per thread);
//   the accumulator fragments of Pd^T and dS^T are the A operands of those
//   products without leaving registers. dS^T is also stored as bf16 to
//   shared memory; after the tile, every warp forms a slice of dQ = dS K from
//   it and writes it once, with no atomics. D_i is formed per tile from the
//   staged G and out, so nothing goes through device memory in between.
// - Shared tiles are 128-byte rows with the 16-byte chunk index XORed by
//   (row % 8), so ldmatrix and the dS stores are free of bank conflicts.
//
// What this does about each limit of the first port's CUDA-core pair
// (retired since): (1) every product runs on tensor cores; (2) an
// ldmatrix.x4 feeds 2-4 mma of 16x8x16 instead of one shared load per FMA,
// and no shuffles carry operands; (3) bf16 stays bf16 in shared memory
// (16-byte cp.async, no transposed scalar stores), ~91 KB a block; (4) the
// key and row loops step by 16 (112 of 104 keys, not 128); (5) the mask is
// drawn once per (row, 4-key group) per pass: each of 4 lanes draws one
// Philox block and the 4 share their bits with 4 shuffles; (6) q, k, v, g
// and out are read once and delta never reaches device memory.
//
// Precision: P and dS are rounded to bf16 before the second products (the
// pair keeps them in f32), as flash-attention designs do. What that costs
// against the plain f32 version, measured on an H100 by chip_smoke.py's
// masked_vs_plain (bf16 inputs and outputs, rate 0.3 and 0): at most one
// more bf16 step of the output. At text bottom (B = 256, S = 100) the
// largest dv error is 0.0625 against the pair's 0.0156 (max |dv| 12.7,
// 4.9e-3 of it); at text fusion dq / dk / dv 0.0156 / 0.031 / 0.031
// against 0.0156 / 0.031 / 0.0156; at ViT fusion dq 0.0156 against
// 0.0078 (max |dq| 2.34). The tolerance, 1e-2 of max |ref|, holds.

#include "mma_common.cuh"
#include "tree_attention_common.cuh"

namespace {

using namespace tree_attention;
using namespace tower_mma;

constexpr int kRows = 64;        // q rows per tile
constexpr int kTileElems = kRows * kDh;

__host__ __device__ constexpr size_t smem_bytes(int kp) {
  // K, V, dS^T (kp rows each), two buffers of Q, G, out, of m and log l, and D
  return sizeof(bf16) * (size_t)(3 * kp * kDh + 2 * 3 * kTileElems) +
         sizeof(float) * (size_t)(2 * 2 * kRows + kRows);
}

template <int NW>
__global__ void __launch_bounds__(NW * 32, 16 / NW)
masked_attention_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ out,
                                const bf16* __restrict__ g, const float* __restrict__ key_bias,
                                const float* __restrict__ stats, bf16* __restrict__ dq,
                                bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int S,
                                float scale, uint2 seed, unsigned thr, float keep_scale) {
  constexpr int kThreadsPerBlock = NW * 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int kp = (S + 15) & ~15;  // keys (and S) padded to 16
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kp][64]
  bf16* v_s = k_s + kp * kDh;                     // [kp][64]
  bf16* ds_s = v_s + kp * kDh;                    // [kp keys][64 rows]: dS^T of the tile
  bf16* tiles = ds_s + kp * kDh;                  // [2][Q, G, out][64][64]
  float* stat_s = reinterpret_cast<float*>(tiles + 2 * 3 * kTileElems);  // [2][m, log l][64]
  float* d_s = stat_s + 2 * 2 * kRows;                                   // [64]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;  // the fragment row group
  const int tq = lane & 3;    // the fragment column pair
  const long long base = (long long)bh * S * kDh;
  const long long plane = (long long)gridDim.x * S;  // stats[1] = log l

  // K and V, once
  for (int c = tid; c < kp * 8; c += kThreadsPerBlock) {
    const int row = c >> 3;
    const int col = (c & 7) << 3;
    const bool ok = row < S;
    const long long src = base + (long long)(ok ? row : 0) * kDh + col;
    cp_async16(k_s + swz(row, col), k + src, ok);
    cp_async16(v_s + swz(row, col), v + src, ok);
  }

  auto load_tile = [&](int t) {
    const int q0 = t * kRows;
    bf16* qs = tiles + (t & 1) * 3 * kTileElems;
    for (int c = tid; c < kRows * 8; c += kThreadsPerBlock) {
      const int row = c >> 3;
      const int col = (c & 7) << 3;
      const bool ok = q0 + row < S;
      const long long src = base + (long long)(ok ? q0 + row : 0) * kDh + col;
      cp_async16(qs + swz(row, col), q + src, ok);
      cp_async16(qs + kTileElems + swz(row, col), g + src, ok);
      cp_async16(qs + 2 * kTileElems + swz(row, col), out + src, ok);
    }
    if (tid < 2 * kRows) {
      const int which = tid / kRows;  // 0: row max, 1: log of the row sum
      const int row = tid % kRows;
      const bool ok = q0 + row < S;
      cp_async4(stat_s + ((t & 1) * 2 + which) * kRows + row,
                stats + which * plane + (long long)bh * S + (ok ? q0 + row : 0), ok);
    }
  };
  load_tile(0);
  cp_async_commit();

  // this warp's keys and their clamped biases (-inf past S: p = 0 there)
  const int key0 = warp * 16;
  const bool active = key0 < S;  // uniform across the warp
  float kb[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int key = key0 + grp + 8 * hi;
    kb[hi] = key >= S ? -INFINITY
                      : key_bias == nullptr ? 0.f : fmaxf(key_bias[(long long)b * S + key], kMaskBias);
  }

  float acc_dk[8][4], acc_dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_dk[n][c] = acc_dv[n][c] = 0.f;

  const int n_tiles = (S + kRows - 1) / kRows;
  for (int t = 0; t < n_tiles; ++t) {
    // the other buffer was last read in tile t-1's key phase, which every
    // warp finished before tile t-1's dQ phase
    if (t + 1 < n_tiles) {
      load_tile(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and K, V) visible; dS^T of tile t-1 consumed

    const int q0 = t * kRows;
    const int rows_t = min(kRows, S - q0);
    const bf16* qs = tiles + (t & 1) * 3 * kTileElems;
    const bf16* gs = qs + kTileElems;
    const bf16* os = gs + kTileElems;
    float* m_s = stat_s + (t & 1) * 2 * kRows;
    const float* ll_s = m_s + kRows;

    {  // D_i = g_i . out_i, NW / 2 threads per row
      constexpr int kPerRow = NW / 2;
      constexpr int kChunks = 8 / kPerRow;
      const int row = tid / kPerRow;
      const int part = tid % kPerRow;
      float dsum = 0.f;
#pragma unroll
      for (int cc = 0; cc < kChunks; ++cc) {
        const int col = (part * kChunks + cc) << 3;
        dsum += dot8(*reinterpret_cast<const uint4*>(gs + swz(row, col)),
                     *reinterpret_cast<const uint4*>(os + swz(row, col)));
      }
#pragma unroll
      for (int off = kPerRow / 2; off > 0; off >>= 1) dsum += __shfl_xor_sync(kFull, dsum, off);
      if (part == 0) {
        d_s[row] = dsum;
        if (row >= rows_t) m_s[row] = INFINITY;  // rows past S: p = 0
      }
    }
    __syncthreads();

    if (active) {
      const int steps = (rows_t + 15) >> 4;
      for (int st = 0; st < steps; ++st) {
        const int r0 = st * 16;
        // S^T = K_w Q^T and dP^T = V_w G^T: 16 keys x 16 rows, k = 64 dims
        float sacc[2][4], pacc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) sacc[j][c] = pacc[j][c] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          unsigned ak[4], av[4], bq[4], bg[4];
          const int a_off = swz(key0 + (lane & 15), 16 * ks + ((lane >> 4) << 3));
          const int b_off = swz(r0 + (lane & 7) + ((lane >> 4) << 3), 16 * ks + (((lane >> 3) & 1) << 3));
          ldsm_x4(k_s + a_off, ak);
          ldsm_x4(v_s + a_off, av);
          ldsm_x4(qs + b_off, bq);
          ldsm_x4(gs + b_off, bg);
          mma(sacc[0], ak, bq[0], bq[1]);
          mma(sacc[1], ak, bq[2], bq[3]);
          mma(pacc[0], av, bg[0], bg[1]);
          mma(pacc[1], av, bg[2], bg[3]);
        }

        // keep bits: this lane holds keys grp and grp + 8 of the warp in rows
        // 8j + 2tq + {0, 1}; bit rr = 2j + (row & 1)
        unsigned keep_lo = 0xFu, keep_hi = 0xFu;
        if (thr != 0u) key_major_keep_bits(key0, q0 + r0, h, b, seed, thr, lane, keep_lo, keep_hi);

        // p, pd, ds in registers; their fragments become A operands
        unsigned apd[4], ads[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float pd[4], dsv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int hi = c >> 1;
            const int rr = 2 * j + (c & 1);
            const int lr = r0 + 8 * j + 2 * tq + (c & 1);
            const float s = sacc[j][c] * scale + kb[hi];
            const float p = expf((s - m_s[lr]) - ll_s[lr]);
            const bool keep = (((hi ? keep_hi : keep_lo) >> rr) & 1u) != 0u;
            pd[c] = keep ? p * keep_scale : 0.f;
            dsv[c] = p * ((keep ? pacc[j][c] * keep_scale : 0.f) - d_s[lr]);
          }
          apd[2 * j] = pack_bf16(pd[0], pd[1]);
          apd[2 * j + 1] = pack_bf16(pd[2], pd[3]);
          ads[2 * j] = pack_bf16(dsv[0], dsv[1]);
          ads[2 * j + 1] = pack_bf16(dsv[2], dsv[3]);
          const int col = r0 + 8 * j + 2 * tq;
          *reinterpret_cast<unsigned*>(ds_s + swz(key0 + grp, col)) = ads[2 * j];
          *reinterpret_cast<unsigned*>(ds_s + swz(key0 + grp + 8, col)) = ads[2 * j + 1];
        }

        // dV_w += Pd^T G and dK_w += dS^T Q: k = the 16 rows, n = 64 dims
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned bg[4], bq[4];
          const int off = swz(r0 + (lane & 15), 16 * np + ((lane >> 4) << 3));
          ldsm_x4_t(gs + off, bg);
          ldsm_x4_t(qs + off, bq);
          mma(acc_dv[2 * np], apd, bg[0], bg[1]);
          mma(acc_dv[2 * np + 1], apd, bg[2], bg[3]);
          mma(acc_dk[2 * np], ads, bq[0], bq[1]);
          mma(acc_dk[2 * np + 1], ads, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // dS^T of the tile complete

    {  // dQ = scale dS K: warp -> 16 rows x (256 / NW) dims, k = kp keys
      constexpr int kNt = 32 / NW;  // n-tiles of 8 dims per warp
      constexpr int kWarpsPerRow = NW / 4;
      const int mt = warp / kWarpsPerRow;
      const int d0 = (warp % kWarpsPerRow) * kNt * 8;
      if (mt * 16 < rows_t) {
        float acc[kNt][4];
#pragma unroll
        for (int n = 0; n < kNt; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
        for (int k0 = 0; k0 < kp; k0 += 16) {
          unsigned a[4];
          ldsm_x4_t(ds_s + swz(k0 + (lane & 7) + ((lane >> 4) << 3), 16 * mt + (((lane >> 3) & 1) << 3)), a);
#pragma unroll
          for (int np = 0; np < kNt / 2; ++np) {
            unsigned bk[4];
            ldsm_x4_t(k_s + swz(k0 + (lane & 15), d0 + 16 * np + ((lane >> 4) << 3)), bk);
            mma(acc[2 * np], a, bk[0], bk[1]);
            mma(acc[2 * np + 1], a, bk[2], bk[3]);
          }
        }
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = q0 + 16 * mt + grp + 8 * hi;
          if (row < S) {
#pragma unroll
            for (int n = 0; n < kNt; ++n) {
              *reinterpret_cast<unsigned*>(dq + base + (long long)row * kDh + d0 + 8 * n + 2 * tq) =
                  pack_bf16(acc[n][2 * hi] * scale, acc[n][2 * hi + 1] * scale);
            }
          }
        }
      }
    }
  }

  if (active) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int key = key0 + grp + 8 * hi;
      if (key < S) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const long long off = base + (long long)key * kDh + 8 * n + 2 * tq;
          *reinterpret_cast<unsigned*>(dk + off) = pack_bf16(acc_dk[n][2 * hi] * scale, acc_dk[n][2 * hi + 1] * scale);
          *reinterpret_cast<unsigned*>(dv + off) = pack_bf16(acc_dv[n][2 * hi], acc_dv[n][2 * hi + 1]);
        }
      }
    }
  }
}

template <int NW>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out, const void* g,
                   const void* key_bias, const void* stats, void* dq, void* dk, void* dv, int B,
                   int H, int S, float scale, uint2 seed, unsigned thr, float keep_scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes((S + 15) & ~15);
  cudaError_t err = cudaFuncSetAttribute(masked_attention_bwd_mma_kernel<NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  masked_attention_bwd_mma_kernel<NW><<<B * H, NW * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(out), static_cast<const bf16*>(g),
      static_cast<const float*>(key_bias), static_cast<const float*>(stats), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, S, scale, seed, thr, keep_scale);
  return cudaGetLastError();
}

}  // namespace

// dq, dk and dv in one pass, from the forward's `stats` (f32 (2, B, H, S):
// row max, log of the row sum). Takes bf16 (dtype 1) at DH = 64 and
// 1 <= S <= 256 only; anything else returns cudaErrorInvalidValue. key_bias
// may be null. Returns a cudaError_t (0 on success).
extern "C" int masked_attention_bwd_mma(const void* q, const void* k, const void* v,
                                        const void* out, const void* g, const void* key_bias,
                                        const void* stats, void* dq, void* dk, void* dv, int B,
                                        int H, int S, int DH, float scale, unsigned seed_lo,
                                        unsigned seed_hi, unsigned thr, float keep_scale,
                                        int dtype, void* stream) {
  if (dtype != 1 || DH != kDh || B <= 0 || H <= 0 || S <= 0 || S > 256 ||
      (long long)B * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint2 seed = make_uint2(seed_lo, seed_hi);
  if (S <= 128)
    return launch<8>(q, k, v, out, g, key_bias, stats, dq, dk, dv, B, H, S, scale, seed, thr,
                     keep_scale, st);
  return launch<16>(q, k, v, out, g, key_bias, stats, dq, dk, dv, B, H, S, scale, seed, thr,
                    keep_scale, st);
}

extern "C" const char* masked_attention_bwd_mma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
