// Tower attention with a per-key bias, forward, for Hopper (sm_90a): one
// pass on tensor cores for bf16 at DH = 64 and S <= 256.
//
// Replaces the Pallas kernel `_make_fwd_kernel` of the JAX package
// (multimodaldiscussiontransformer_tpu/ops/masked_attention.py:86), the fused
// self-attention of the BERT and ViT tower layers, at the tower shapes of
// the model; masked_attention_fwd_tiled.cu serves bf16 at other DH and
// longer S, and masked_attention_fwd_tf32.cu float32. For each (b, h, i):
//   s_ij  = (q_i . k_j) * scale + max(kb[b, j], -1e9)    (kb = 0 when null)
//   m_i   = max(-1e9, max_j s_ij)
//   l_i   = max(sum_j exp(s_ij - m_i), 1e-30)            (the UNDROPPED sum, f32)
//   out_i = sum_j keep_ij exp(s_ij - m_i) v_j / ((1 - rate) l_i)
//   stats[0, i] = m_i, stats[1, i] = log(l_i)            (optional, stored apart)
// The score is formed as acc * scale + kb in f32 from the f32 accumulator,
// as masked_attention_bwd_mma.cu re-forms it, so the backward's recomputed
// p = exp((s - m) - log l) matches this forward's m and l. A capacity-padding
// row (every key at -1e9) has s = -1e9 exactly, m = -1e9 and p = 1: equal
// weights 1/S over its S real keys. Keys in the 16-padding past S score
// -inf (p = 0), never -1e9, so such a row never spreads over them.
// keep_ij is the Philox mask of tree_attention_common.cuh, counter
// (j / 4, i, h, b).
//
// What bounds it: at the text-fusion shape (B = 256 rows, S = 104, H = 12)
// the call reads q, k, v and writes out and the statistics, ~164 MB or
// ~49 us at 3.35 TB/s, against ~8.5 GFLOP of products, ~9 us at the bf16
// tensor-core peak: bytes bound it.
//
// Design, one block per (batch row, head), owning every key and row:
// - K, V and Q (S padded to 16 rows, the padding zero-filled) are staged
//   once in shared memory as bf16 with 16-byte cp.async copies into
//   XOR-swizzled 128-byte rows, beside the S clamped key biases (-inf past
//   S): ~43 KB at S = 104, ~97 KB at S = 256. Nothing is padded in memory.
// - Each warp owns 16-row q tiles (4 warps up to S = 64, else 8, each
//   walking the tiles warp, warp + 8, ...; two blocks of 8 warps an SM).
//   It keeps the tile's Q fragments in registers (4 ldmatrix.x4) and walks
//   the keys in chunks of 64: S = Q K^T on mma.sync.m16n8k16 (bf16
//   operands by ldmatrix, f32 accumulators), the scores, an online softmax
//   (row max over the 4 lanes of a row, rescaled sums and output), the
//   keep bits, then O += P V with P rounded to bf16 and taken from the
//   accumulator fragments as the A operand, V by ldmatrix.trans. The
//   (S, S) probabilities never leave registers.
// - Dropout (chunk_keep_bits of mma_common.cuh, shared with the tensor-core
//   tree forward): one Philox4x32-10 draw per (row, 4-key group). An 8-key
//   n-tile of 16 rows needs 32 draws, one per lane: lane 4g + u draws row
//   g + 8 (u & 1) of group u / 2, and the two lanes of each row group swap
//   them with two shuffles. A warp draws a whole tile's bits (one 32-bit
//   word a lane per 64-key chunk) before its scores, 8 independent draws
//   at a time, and the first tile's while the block's copies land. Rate 0
//   draws nothing.
// - The output tile is written once in bf16: staged through the warp's own
//   (no longer needed) Q rows, then stored with 16-byte coalesced writes.
//
// What this does about each limit of the first port's CUDA-core kernel
// (retired since): (1) K and V stay bf16 in shared memory, staged
// by 16-byte cp.async, with no transposed scalar stores (K^T comes from
// ldmatrix); (2) every product runs on tensor cores, an ldmatrix.x4 feeding
// two mma of 16x8x16 instead of one shared load per FMA; (3) no shuffle
// carries a probability into the value product: P stays in the registers
// where QK^T left it; (4) the key loop steps by 16 (112 of 104 keys, not
// 128); (5) the row statistics are formed in registers.
//
// Precision: P is rounded to bf16 before P V (the CUDA-core kernel keeps it
// in f32), as flash-attention designs do, while l sums the f32 values: each
// term carries a relative error of at most 2^-9, which averages out over
// the keys. Measured against the plain f32 version by chip_smoke.py's
// masked_vs_plain on an H100 (bf16 inputs, rates 0.3 and 0, S = 1 .. 256):
// at most 0.0156 off, 7e-3 of max |out|, where the CUDA-core kernel is at
// most 0.0078 off at the tower shapes; the tolerance is 1e-2 of max |ref|. The exponentials are expf, as in the backward, so that the
// row statistics match its recomputed p.

#include "mma_common.cuh"
#include "tree_attention_common.cuh"

namespace {

using namespace tree_attention;
using namespace tower_mma;

__host__ __device__ constexpr size_t smem_bytes(int kp) {
  // K, V, Q (kp rows each) and the clamped key biases
  return sizeof(bf16) * (size_t)(3 * kp * kDh) + sizeof(float) * (size_t)kp;
}

template <int NW>
__global__ void __launch_bounds__(NW * 32, 16 / NW)
masked_attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const float* __restrict__ key_bias,
                                bf16* __restrict__ out, float* __restrict__ stats, int H, int S,
                                float scale, uint2 seed, unsigned thr, float keep_scale) {
  constexpr int kThreadsPerBlock = NW * 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int kp = (S + 15) & ~15;  // keys and rows padded to 16
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);        // [kp][64]
  bf16* v_s = k_s + kp * kDh;                           // [kp][64]
  bf16* q_s = v_s + kp * kDh;                           // [kp][64]; then each tile's output
  float* kb_s = reinterpret_cast<float*>(q_s + kp * kDh);  // [kp]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;  // the fragment row group
  const int tq = lane & 3;    // the fragment column pair
  const long long base = (long long)bh * S * kDh;

  for (int c = tid; c < kp * 8; c += kThreadsPerBlock) {
    const int row = c >> 3;
    const int col = (c & 7) << 3;
    const bool ok = row < S;
    const long long src = base + (long long)(ok ? row : 0) * kDh + col;
    cp_async16(k_s + swz(row, col), k + src, ok);
    cp_async16(v_s + swz(row, col), v + src, ok);
    cp_async16(q_s + swz(row, col), q + src, ok);
  }
  cp_async_commit();
  for (int j = tid; j < kp; j += kThreadsPerBlock) {
    kb_s[j] = j >= S ? -INFINITY
                     : key_bias == nullptr ? 0.f : fmaxf(key_bias[(long long)b * S + j], kMaskBias);
  }
  // the first tile's keep bits, while the copies land
  const int n_tiles = kp >> 4;
  unsigned kf[4];
  if (warp < n_tiles) tile_keep_bits(kf, warp * 16, kp, h, b, seed, thr, lane);
  cp_async_wait<0>();
  __syncthreads();

  for (int t = warp; t < n_tiles; t += NW) {
    const int r0 = t * 16;
    if (t != warp) tile_keep_bits(kf, r0, kp, h, b, seed, thr, lane);
    unsigned qa[4][4];  // A fragments of the tile's Q, k = 64 dims
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldsm_x4(q_s + swz(r0 + (lane & 15), 16 * ks + ((lane >> 4) << 3)), qa[ks]);

    // rows grp (index 0) and grp + 8 (index 1) of the tile; l is this
    // lane's share of the row sum until the end
    float m[2] = {kMaskBias, kMaskBias};
    float l[2] = {0.f, 0.f};
    float o[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

    for (int k0 = 0; k0 < kp; k0 += kKeyChunk) {
      const int pairs = min(kKeyChunk, kp - k0) >> 4;  // 16-key pairs in the chunk, warp-uniform
      const int ch = k0 / kKeyChunk;
      const unsigned keep = ch == 0 ? kf[0] : ch == 1 ? kf[1] : ch == 2 ? kf[2] : kf[3];

      // S = Q K^T: 16 rows x 64 keys, k = 64 dims
      float sc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[n][c] = 0.f;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np < pairs) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            unsigned bk[4];
            ldsm_x4(k_s + swz(k0 + 16 * np + (lane & 7) + ((lane >> 4) << 3), 16 * ks + (((lane >> 3) & 1) << 3)),
                    bk);
            mma(sc[2 * np], qa[ks], bk[0], bk[1]);
            mma(sc[2 * np + 1], qa[ks], bk[2], bk[3]);
          }
        }
      }

      // the scores, the chunk's row max and the rescaling of what came before
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < 2 * pairs) {
          const float2 kb2 = *reinterpret_cast<const float2*>(kb_s + k0 + 8 * nt + 2 * tq);
          sc[nt][0] = sc[nt][0] * scale + kb2.x;
          sc[nt][1] = sc[nt][1] * scale + kb2.y;
          sc[nt][2] = sc[nt][2] * scale + kb2.x;
          sc[nt][3] = sc[nt][3] * scale + kb2.y;
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
        for (int n = 0; n < 8; ++n) {
          o[n][2 * hi] *= alpha;
          o[n][2 * hi + 1] *= alpha;
        }
      }

      // p (summed undropped), the keep bits, and O += P V per 16-key pair
#pragma unroll
      for (int np = 0; np < 4; ++np) {
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
          // k = the pair's 16 keys, n = 64 dims
#pragma unroll
          for (int dp = 0; dp < 4; ++dp) {
            unsigned bv[4];
            ldsm_x4_t(v_s + swz(k0 + 16 * np + (lane & 15), 16 * dp + ((lane >> 4) << 3)), bv);
            mma(o[2 * dp], pa, bv[0], bv[1]);
            mma(o[2 * dp + 1], pa, bv[2], bv[3]);
          }
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
    // the tile's Q rows are free: every lane took its fragments above
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<unsigned*>(q_s + swz(r0 + grp, 8 * n + 2 * tq)) = pack_bf16(o[n][0] * f[0], o[n][1] * f[0]);
      *reinterpret_cast<unsigned*>(q_s + swz(r0 + grp + 8, 8 * n + 2 * tq)) =
          pack_bf16(o[n][2] * f[1], o[n][3] * f[1]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      const int row = r0 + (c >> 3);
      const int col = (c & 7) << 3;
      if (row < S)
        *reinterpret_cast<uint4*>(out + base + (long long)row * kDh + col) =
            *reinterpret_cast<const uint4*>(q_s + swz(row, col));
    }
    if (stats != nullptr && tq == 0) {
      const long long plane = (long long)gridDim.x * S;  // stats[1] = log l
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = r0 + grp + 8 * hi;
        if (row < S) {
          stats[(long long)bh * S + row] = m[hi];
          stats[plane + (long long)bh * S + row] = logf(denom[hi]);
        }
      }
    }
  }
}

template <int NW>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_bias, void* out,
                   void* stats, int B, int H, int S, float scale, uint2 seed, unsigned thr,
                   float keep_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes((S + 15) & ~15);
  cudaError_t err = cudaFuncSetAttribute(masked_attention_fwd_mma_kernel<NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  masked_attention_fwd_mma_kernel<NW><<<B * H, NW * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(key_bias), static_cast<bf16*>(out), static_cast<float*>(stats), H, S,
      scale, seed, thr, keep_scale);
  return cudaGetLastError();
}

}  // namespace

// out and, where `stats` is not null, the row statistics (f32 (2, B, H, S):
// row max, log of the row sum). Takes bf16 (dtype 1) at DH = 64 and
// 1 <= S <= 256 only; anything else returns cudaErrorInvalidValue. key_bias
// may be null. The dropout mask is keyed by (seed_hi << 32 | seed_lo);
// thr = 0 keeps every key, and keep_scale is 1 / (1 - rate). Returns a
// cudaError_t (0 on success).
extern "C" int masked_attention_fwd_mma(const void* q, const void* k, const void* v,
                                        const void* key_bias, void* out, void* stats, int B,
                                        int H, int S, int DH, float scale, unsigned seed_lo,
                                        unsigned seed_hi, unsigned thr, float keep_scale,
                                        int dtype, void* stream) {
  if (dtype != 1 || DH != kDh || B <= 0 || H <= 0 || S <= 0 || S > 256 ||
      (long long)B * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint2 seed = make_uint2(seed_lo, seed_hi);
  if (S <= 64)
    return launch<4>(q, k, v, key_bias, out, stats, B, H, S, scale, seed, thr, keep_scale, st);
  return launch<8>(q, k, v, key_bias, out, stats, B, H, S, scale, seed, thr, keep_scale, st);
}

extern "C" const char* masked_attention_fwd_mma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
