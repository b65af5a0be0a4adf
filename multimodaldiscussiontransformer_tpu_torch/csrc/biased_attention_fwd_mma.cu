// Attention with a dense additive bias, forward, for Hopper (sm_90a): one
// pass on tensor cores for bf16 at DH = 64, any S >= 1, K, V and the (S, S)
// bias plane streamed in 64-key tiles.
//
// Replaces the Pallas kernel `_fused_kernel` of the JAX package
// (multimodaldiscussiontransformer_tpu/ops/biased_attention.py:61, dispatched
// by `_fused_forward`), as biased_attention_fwd.cu (the CUDA-core kernel that
// still serves float32 and DH 16, 32 and 128) does.
//
// Function, that of biased_attention_fwd.cu, for each (b, h, i):
//   c_ij  = max(f32(bias[b, hb, i, j]) + (pad[b, j] ? -1e9 : 0), -1e9)
//           (bias = 0 when null; hb = h, or 0 for a head-shared bias)
//   s_ij  = scale * q_i . k_j + c_ij                     (keys >= S score -inf)
//   m_i   = max(-1e9, max_j s_ij),  e_ij = exp(s_ij - m_i)
//   out_i = sum_j e_ij v_j / max(sum_j e_ij, 1e-30)      (stored in bf16)
// q/k/v/out are (B, H, S, 64) bf16; bias is (B, H, S, S) or (B, 1, S, S) in
// bf16 or f32, or null, and may hold -inf; pad is (B, S) bytes (a torch.bool
// tensor), nonzero = padded key, or null. A row whose every key is masked
// gets equal weights over its S keys (its scores are all -1e9 in f32), as
// from biased_attention_fwd.cu and the plain version.
//
// What bounds it: at S = 1025, B = 1, H = 12 with the per-head bf16 bias the
// graph layers give, the call reads q, k, v, the bias (25.2 MB) and the pad
// row and writes out, ~31.5 MB or ~9.4 us at 3.35 TB/s, against 4 B H S^2 DH
// = 3.2 GFLOP of products, ~3.3 us at the bf16 tensor-core peak: bytes bound
// it, and the bias is 80% of them. Each bias byte is read once (per-head), or
// once per block of the H that run together (head-shared, served by L2).
//
// Design: tree_attention_fwd_mma.cu with the compact bias (tpl, ids, LUT)
// replaced by the dense bias plane and the pad row, without dropout and LSE.
// One block per (head, 32-row q tile, batch row): 4 warps, two 16-row tiles
// x two key groups. The head is blockIdx.x, so the H blocks that read the
// same rows of a head-shared bias run together and L2 serves the re-reads.
// - Q's tile is staged once in XOR-swizzled bf16 shared memory (16-byte
//   cp.async, rows past S zero-filled) and each warp keeps its 16 rows as
//   A fragments in registers (4 ldmatrix.x4).
// - K and V stream through a double-buffered ring of swizzled bf16 64-key
//   tiles (16-byte cp.async, keys past S zero-filled).
// - The (32 rows x 64 keys) tile of the bias and the tile's 64 pad bytes
//   ride in the same ring, by 16-byte cp.async too. A bias row starts at
//   S x row elements, which for odd S (every main path) is not even 4-byte
//   aligned in bf16. So each staged row is the aligned window of 16-byte
//   chunks that holds the tile's 64 entries at any offset (9 chunks in bf16,
//   17 in f32) and a lane reads key j of row r at element off_r + j, off_r
//   being the row's start modulo a chunk: the same on every tile, since
//   tiles start at multiples of 64 keys. The pad row's window is 5 chunks.
//   Chunks whose first key is past S are not read (zero-filled), and the
//   chunk that holds the tensor's last entry is copied up to it and no
//   further, so nothing outside the tensors is read. The wrapper checks
//   that the bias and the pad mask start on 16-byte boundaries.
// - Key group g of a row tile scores keys 32 g .. 32 g + 31 of every tile
//   and keeps its own online softmax; at the end group 1 leaves its row
//   max, sum and output in the consumed ring and group 0 merges them.
// - Per key tile and warp: S = Q K^T on mma.sync.m16n8k16 (K by ldmatrix),
//   skipping 16-key pairs past S rounded up to 16; the score is formed in
//   f32 on the accumulator as acc * scale + max(f32(bias) + pad term,
//   -1e9), in the order of the plain version's combined bias, -inf for keys
//   >= S; then an online softmax (row max over the 4 lanes of a row,
//   rescaled f32 sum and output), and O += P V with P rounded to bf16 and
//   taken from the accumulator fragments as the A operand, V by
//   ldmatrix.trans.
// - The output tile is written once in bf16: staged through the warp's own
//   (no longer needed) Q rows, then stored with 16-byte writes; rows past S
//   are not stored.
//
// Precision: the products run on bf16 operands in f32 accumulators; the
// scale is applied to the f32 accumulator (q is not pre-scaled in bf16); P
// is rounded to bf16 before P V (biased_attention_fwd.cu keeps it in f32)
// while l sums the f32 values, as in tree_attention_fwd_mma.cu. The
// exponentials are expf.

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
constexpr int kStages = 2;                      // the ring's depth
constexpr int kPartial = 8 * 4 + 4;             // a lane's o, m and l
constexpr int kPadChunks = kKeys / 16 + 1;      // 16-byte chunks of a tile's pad bytes at any offset

// a staged bias row: the 16-byte chunks that hold a tile's 64 entries at
// any element offset
template <typename TB>
struct BiasRow {
  static constexpr int kPerChunk = 16 / sizeof(TB);      // entries per chunk: 8 bf16, 4 f32
  static constexpr int kChunks = kKeys / kPerChunk + 1;  // 9, 17
  static constexpr int kBytes = 16 * kChunks;            // 144, 272
};

// Q, the K and V rings, the bias and pad rings: 46 KB with a bf16 bias, 55
// KB with an f32 one; four blocks an SM
template <typename TB>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (size_t)(kRows * kDh + 2 * kStages * kKeys * kDh) +
         (size_t)kStages * (kRows * BiasRow<TB>::kBytes + 16 * kPadChunks);
}
static_assert(sizeof(float) * (kKeyGroups - 1) * kRowWarps * kPartial * 32 <= sizeof(bf16) * 2 * kStages * kKeys * kDh,
              "the key groups' partial rows meet in the K and V rings");

// `bytes` (0 .. 16) of src -> shared, the rest of the 16 zero-filled (src is
// not read when bytes is 0)
__device__ __forceinline__ void cp_async16_bytes(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

template <typename TB>
__global__ void __launch_bounds__(kMmaThreads, 4)
biased_attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const TB* __restrict__ bias,
                                const unsigned char* __restrict__ pad, bf16* __restrict__ out, int H,
                                int S, int bias_heads, float scale) {
  using Row = BiasRow<TB>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);                  // [kRows][64]; then the output tile
  bf16* k_s = q_s + kRows * kDh;                                  // [kStages][kKeys][64]
  bf16* v_s = k_s + kStages * kKeys * kDh;                        // [kStages][kKeys][64]
  unsigned char* bias_s = reinterpret_cast<unsigned char*>(v_s + kStages * kKeys * kDh);  // [kStages][kRows][Row::kBytes]
  unsigned char* pad_s = bias_s + kStages * kRows * Row::kBytes;  // [kStages][16 kPadChunks]

  const int h = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;  // the fragment row group
  const int tq = lane & 3;    // the fragment column pair
  const int rw = warp % kRowWarps;  // this warp's 16-row tile
  const int kg = warp / kRowWarps;  // and its key group: keys kGroupKeys kg .. of every tile
  const long long bh = (long long)b * H + h;
  const long long base = bh * S * kDh;
  const int kp = (S + 15) & ~15;  // keys padded to 16
  const int n_tiles = (S + kKeys - 1) / kKeys;
  const int r0 = q0 + 16 * rw;    // this warp's first row
  const bool active = r0 < S;     // warp-uniform: a warp past S only copies
  const int rows = min(kRows, S - q0);  // the block's rows below S
  // the bias plane of (b, h), and the entries of the whole tensor
  const long long plane = ((long long)b * bias_heads + (bias_heads == 1 ? 0 : h)) * S * (long long)S;
  const long long bias_end = (long long)B * bias_heads * S * (long long)S;
  const int pad_off = (int)(((long long)b * S) & 15);  // the pad row's start within its chunk

  // tile t of K, V (keys past S zero-filled), the bias (the block's rows
  // below S) and the pad row into stage t % kStages
  auto load_tile = [&](int t) {
    const int k0 = t * kKeys;
    const int st = t % kStages;
    bf16* kd = k_s + st * kKeys * kDh;
    bf16* vd = v_s + st * kKeys * kDh;
    for (int c = tid; c < kKeys * 8; c += kMmaThreads) {
      const int row = c >> 3;
      const int col = (c & 7) << 3;
      const bool ok = k0 + row < S;
      const long long src = base + (long long)(ok ? k0 + row : 0) * kDh + col;
      cp_async16(kd + swz(row, col), k + src, ok);
      cp_async16(vd + swz(row, col), v + src, ok);
    }
    if (bias != nullptr) {
      unsigned char* bd = bias_s + st * kRows * Row::kBytes;
      for (int c = tid; c < rows * Row::kChunks; c += kMmaThreads) {
        const int r = c / Row::kChunks;
        const int ch = c - r * Row::kChunks;
        const long long e0 = plane + (long long)(q0 + r) * S;  // key 0 of the row
        const int off = (int)(e0 & (Row::kPerChunk - 1));
        const int first_key = k0 + ch * Row::kPerChunk - off;
        const long long e = e0 + first_key;  // the chunk's first entry, 16-byte aligned
        const int bytes = first_key < S ? (int)min(bias_end - e, (long long)Row::kPerChunk) * (int)sizeof(TB) : 0;
        cp_async16_bytes(bd + r * Row::kBytes + 16 * ch, bytes ? bias + e : bias, bytes);
      }
    }
    if (pad != nullptr && tid < kPadChunks) {
      const int first_key = k0 + 16 * tid - pad_off;
      const long long e = (long long)b * S + first_key;
      const int bytes = first_key < S ? (int)min((long long)B * S - e, 16LL) : 0;
      cp_async16_bytes(pad_s + st * 16 * kPadChunks + 16 * tid, bytes ? pad + e : pad, bytes);
    }
  };

  for (int c = tid; c < kRows * 8; c += kMmaThreads) {
    const int row = c >> 3;
    const int col = (c & 7) << 3;
    const bool ok = q0 + row < S;
    cp_async16(q_s + swz(row, col), q + base + (long long)(ok ? q0 + row : 0) * kDh + col, ok);
  }
  load_tile(0);
  cp_async_commit();

  // this lane's rows grp (a) and grp + 8 (b): below S, and where their
  // entries of the warp's keys start in a staged bias tile (as TB) and in
  // the staged pad row
  const int row_a = r0 + grp;
  const bool ok_a = row_a < S;
  const bool ok_b = row_a + 8 < S;
  const int jw = kGroupKeys * kg + 2 * tq;  // the tile key of C element 0 of n-tile 0
  const int off_a = (16 * rw + grp) * Row::kChunks * Row::kPerChunk +
                    (int)((plane + (long long)row_a * S) & (Row::kPerChunk - 1)) + jw;
  const int off_b = (16 * rw + grp + 8) * Row::kChunks * Row::kPerChunk +
                    (int)((plane + (long long)(row_a + 8) * S) & (Row::kPerChunk - 1)) + jw;
  const int off_p = pad_off + jw;

  unsigned qa[4][4];  // A fragments of the warp's Q rows, k = 64 dims
  // m and l of rows grp and grp + 8 over the warp's keys; l is this lane's
  // share of the row sum until the end
  float m[2] = {kMaskBias, kMaskBias};
  float l[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kw = t * kKeys + kGroupKeys * kg;  // the warp's first key of the tile
    if (t + 1 < n_tiles) load_tile(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // 16-key pairs of the warp's keys below S rounded up to 16, warp-uniform
    const int pairs = active ? max(0, min(kGroupKeys, kp - kw)) >> 4 : 0;
    if (t == 0 && active) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        ldsm_x4(q_s + swz(16 * rw + (lane & 15), 16 * ks + ((lane >> 4) << 3)), qa[ks]);
    }
    if (pairs > 0) {
      const int st = t % kStages;
      const bf16* kt = k_s + st * kKeys * kDh + kGroupKeys * kg * kDh;  // the warp's keys
      const bf16* vt = v_s + st * kKeys * kDh + kGroupKeys * kg * kDh;
      const TB* bt = reinterpret_cast<const TB*>(bias_s + st * kRows * Row::kBytes);
      const unsigned char* pt = pad_s + st * 16 * kPadChunks;

      // S = Q K^T: 16 rows x the warp's 32 keys, k = 64 dims
      float sc[kGroupNt][4];
#pragma unroll
      for (int n = 0; n < kGroupNt; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[n][c] = 0.f;
#pragma unroll
      for (int np = 0; np < kGroupNt / 2; ++np) {
        if (np < pairs) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            unsigned bk[4];
            ldsm_x4(kt + swz(16 * np + (lane & 7) + ((lane >> 4) << 3), 16 * ks + (((lane >> 3) & 1) << 3)), bk);
            mma(sc[2 * np], qa[ks], bk[0], bk[1]);
            mma(sc[2 * np + 1], qa[ks], bk[2], bk[3]);
          }
        }
      }

      // the scores with the combined bias, the row max and the rescaling of
      // what came before
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < kGroupNt; ++nt) {
        if (nt < 2 * pairs) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};  // C elements: rows a, a, b, b; keys j, j + 1
          if (bias != nullptr) {
            if (ok_a) {
              c[0] = to_f32(bt[off_a + 8 * nt]);
              c[1] = to_f32(bt[off_a + 8 * nt + 1]);
            }
            if (ok_b) {
              c[2] = to_f32(bt[off_b + 8 * nt]);
              c[3] = to_f32(bt[off_b + 8 * nt + 1]);
            }
          }
          if (pad != nullptr) {
            const float p0 = pt[off_p + 8 * nt] ? kMaskBias : 0.f;
            const float p1 = pt[off_p + 8 * nt + 1] ? kMaskBias : 0.f;
            c[0] += p0;
            c[1] += p1;
            c[2] += p0;
            c[3] += p1;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[nt][e] = kw + 8 * nt + 2 * tq + (e & 1) < S ? sc[nt][e] * scale + fmaxf(c[e], kMaskBias) : -INFINITY;
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

      // p, and O += P V per 16-key pair
#pragma unroll
      for (int np = 0; np < kGroupNt / 2; ++np) {
        if (np < pairs) {
          unsigned pa[4];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int nt = 2 * np + jj;
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) p[e] = expf(sc[nt][e] - m[e >> 1]);
            l[0] += p[0] + p[1];
            l[1] += p[2] + p[3];
            pa[2 * jj] = pack_bf16(p[0], p[1]);
            pa[2 * jj + 1] = pack_bf16(p[2], p[3]);
          }
          // k = the pair's 16 keys, n = 64 dims
#pragma unroll
          for (int dp = 0; dp < 4; ++dp) {
            unsigned bv[4];
            ldsm_x4_t(vt + swz(16 * np + (lane & 15), 16 * dp + ((lane >> 4) << 3)), bv);
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
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) partial[(4 * n + c) * 32] = o[n][c];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      partial[(32 + hi) * 32] = m[hi];
      partial[(34 + hi) * 32] = l[hi];
    }
  }
  __syncthreads();
  if (kg > 0 || !active) return;
  for (int g = 1; g < kKeyGroups; ++g) {
    const float* partial = partials + ((g - 1) * kRowWarps + rw) * kPartial * 32 + lane;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float m1 = partial[(32 + hi) * 32];
      const float m_new = fmaxf(m[hi], m1);
      const float a0 = expf(m[hi] - m_new);
      const float a1 = expf(m1 - m_new);
      m[hi] = m_new;
      l[hi] = l[hi] * a0 + partial[(34 + hi) * 32] * a1;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[n][2 * hi] = o[n][2 * hi] * a0 + partial[(4 * n + 2 * hi) * 32] * a1;
        o[n][2 * hi + 1] = o[n][2 * hi + 1] * a0 + partial[(4 * n + 2 * hi + 1) * 32] * a1;
      }
    }
  }

  // the row sums over the 4 lanes of each row; out = o / max(l, 1e-30)
  float f[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(kFull, l[hi], 1);
    l[hi] += __shfl_xor_sync(kFull, l[hi], 2);
    f[hi] = 1.f / fmaxf(l[hi], 1e-30f);
  }
  // the warp's Q rows are free: both key groups took their fragments at tile 0
  const int w0 = 16 * rw;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<unsigned*>(q_s + swz(w0 + grp, 8 * n + 2 * tq)) = pack_bf16(o[n][0] * f[0], o[n][1] * f[0]);
    *reinterpret_cast<unsigned*>(q_s + swz(w0 + grp + 8, 8 * n + 2 * tq)) = pack_bf16(o[n][2] * f[1], o[n][3] * f[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i;
    const int row = w0 + (c >> 3);
    const int col = (c & 7) << 3;
    if (q0 + row < S)
      *reinterpret_cast<uint4*>(out + base + (long long)(q0 + row) * kDh + col) =
          *reinterpret_cast<const uint4*>(q_s + swz(row, col));
  }
}

template <typename TB>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, const void* pad, void* out,
                   int B, int H, int S, int bias_heads, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<TB>();
  const cudaError_t err = cudaFuncSetAttribute(biased_attention_fwd_mma_kernel<TB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (S + kRows - 1) / kRows, B);
  biased_attention_fwd_mma_kernel<TB><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const TB*>(bias), static_cast<const unsigned char*>(pad), static_cast<bf16*>(out), H, S,
      bias_heads, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; }

}  // namespace

// dtype 1 (bfloat16) at DH = 64 only; bias_dtype 0 (float32) or 1
// (bfloat16). bias and pad may be null; bias_heads is 1 (a head-shared
// bias) or H, and is ignored without a bias. q, k, v, out, bias and pad must
// be 16-byte aligned (the wrapper checks them and allocates out); anything
// else returns cudaErrorInvalidValue. Returns a cudaError_t (0 on success).
extern "C" int biased_attention_fwd_mma(const void* q, const void* k, const void* v, const void* bias,
                                        const void* pad, void* out, int B, int H, int S, int DH, int bias_heads,
                                        float scale, int dtype, int bias_dtype, void* stream) {
  if (dtype != 1 || DH != kDh || B <= 0 || H <= 0 || S <= 0 || B > 65535 || (S + kRows - 1) / kRows > 65535)
    return cudaErrorInvalidValue;
  if (bias != nullptr && bias_heads != 1 && bias_heads != H) return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) || !aligned16(bias) || !aligned16(pad))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bias == nullptr || bias_dtype == 1)
    return launch<bf16>(q, k, v, bias, pad, out, B, H, S, bias_heads, scale, st);
  if (bias_dtype == 0) return launch<float>(q, k, v, bias, pad, out, B, H, S, bias_heads, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* biased_attention_fwd_mma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
