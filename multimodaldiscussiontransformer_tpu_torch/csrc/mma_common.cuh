// PTX helpers shared by the tensor-core kernels (masked_attention_fwd_mma.cu,
// masked_attention_bwd_mma.cu, the tiled tower forward and pair,
// tree_attention_fwd_mma.cu, tree_attention_bwd_mma.cu,
// biased_attention_fwd_mma.cu): the swizzled shared-memory layout of a
// [rows][64] bf16 tile (and the tree kernels' layout at any DH), 16- and
// 4-byte cp.async copies, ldmatrix (plain and transposed),
// mma.sync.m16n8k16 with bf16 operands and f32 accumulators, a dot product
// of 8 bf16 pairs, and the dropout keep bits in the C-fragment
// layouts: row-major (S = Q K^T, one definition for the forwards and the
// tree's dq kernel) and key-major (S^T = K Q^T, for the backwards that
// accumulate dK and dV).
//
// Fragment layouts of mma.sync.m16n8k16 (grp = lane / 4, tq = lane % 4):
//   A (16 x 16, row):  a0 (grp, 2tq..+1), a1 (grp + 8, 2tq..+1),
//                      a2 (grp, 8 + 2tq..+1), a3 (grp + 8, 8 + 2tq..+1);
//   B (16 x 8, col):   b0 (k 2tq..+1, n grp), b1 (k 8 + 2tq..+1, n grp);
//   C (16 x 8, f32):   c0, c1 (grp, 2tq..+1), c2, c3 (grp + 8, 2tq..+1).
// So a C fragment of two neighbouring 8-column tiles, packed in pairs, is
// the A fragment of a product over those 16 columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tree_attention_common.cuh"

namespace tower_mma {

using bf16 = __nv_bfloat16;

constexpr int kDh = 64;        // head dim of the tensor-core kernels: 128-byte rows
constexpr int kKeyChunk = 64;  // keys per online-softmax step of the forwards

// element offset of (row, col) in a [rows][64] bf16 tile whose 16-byte
// chunks are XOR-swizzled by row % 8, so that ldmatrix and the fragment
// stores of 8 rows hit 8 distinct chunks (no bank conflicts)
__device__ __forceinline__ int swz(int row, int col) {
  return row * kDh + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

// bf16 values per staged row of a [rows][DH] tile of the tree kernels
// (tree_attention_fwd_mma.cu, tree_attention_bwd_mma.cu), and the element
// offset of (row, col) in it: the swizzled 64-wide rows of swz at DH 64,
// rows of DH + 8 values (16 bytes of padding) at DH 16, 32 and 128. Either
// way the 8 rows of an ldmatrix (and of a fragment store) start in 8
// distinct 16-byte bank groups.
template <int DH>
constexpr int tile_ld() {
  return DH == kDh ? kDh : DH + 8;
}

template <int DH>
__device__ __forceinline__ int tile_at(int row, int col) {
  if constexpr (DH == kDh) return swz(row, col);
  else return row * (DH + 8) + col;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(const bf16* p, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(const bf16* p, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b for one m16n8k16 tile: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// sum of the 8 products of two 16-byte chunks of bf16, in f32
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]);
    const float2 fy = __bfloat1622float2(y[i]);
    s = fmaf(fx.x, fy.x, s);
    s = fmaf(fx.y, fy.y, s);
  }
  return s;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const unsigned*>(&v);
}

// keep bits of the 4 keys of one Philox block: bit w is word w >= thr
__device__ __forceinline__ unsigned keep_nibble(const uint4& w, unsigned thr) {
  return (w.x >= thr ? 1u : 0u) | (w.y >= thr ? 2u : 0u) | (w.z >= thr ? 4u : 0u) |
         (w.w >= thr ? 8u : 0u);
}

// This lane's keep bits of the NT 8-key n-tiles at key k0 (64 keys by
// default) of the 16-row tile at r0 (global row and key indices): bit
// 4 nt + c is the flag of C element c of n-tile nt (rows grp, grp + 8; keys
// 2tq, 2tq + 1 of the n-tile). One Philox draw per (row, 4-key group): lane
// 4g + u draws row g + 8 (u & 1), group u / 2 of each n-tile; this lane's
// two keys are words 2 (tq & 1) and 2 (tq & 1) + 1 of group tq / 2, drawn
// by lane 4 grp + (tq & 2) for row grp and by the next lane for row grp +
// 8. The NT draws are independent, so they interleave. All 32 lanes must
// call it.
template <int NT = 8>
__device__ __forceinline__ unsigned chunk_keep_bits(int r0, int k0, int h, int b, uint2 seed,
                                                    unsigned thr, int lane) {
  using tree_attention::kFull;
  const int grp = lane >> 2;
  const int tq = lane & 3;
  const unsigned row_d = (unsigned)(r0 + grp + 8 * (tq & 1));
  unsigned nib[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const unsigned grp_d = (unsigned)((k0 + 8 * nt) >> 2) + (unsigned)(tq >> 1);
    nib[nt] = keep_nibble(
        tree_attention::philox4x32_10(make_uint4(grp_d, row_d, (unsigned)h, (unsigned)b), seed), thr);
  }
  const int src = (lane & ~3) | (tq & 2);
  const int sh = 2 * (tq & 1);
  unsigned bits = 0u;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const unsigned lo = (__shfl_sync(kFull, nib[nt], src) >> sh) & 3u;
    const unsigned hi = (__shfl_sync(kFull, nib[nt], src | 1) >> sh) & 3u;
    bits |= (lo | (hi << 2)) << (4 * nt);
  }
  return bits;
}

// This lane's keep bits of one 16-key x 16-row tile in the key-major
// C-fragment layout of S^T = K Q^T (keys key0 .. key0 + 15, key0 a multiple
// of 4; rows row0 .. row0 + 15; global indices): C element c of n-tile j
// sits at key key0 + grp + 8 (c >> 1) and row row0 + 8 j + 2 tq + (c & 1),
// and its flag is bit 2 j + (c & 1) of keep_lo (c < 2) or keep_hi. The
// lane holds keys of the 4-key groups a = grp / 4 and a + 2. The 4 lanes
// of one (a, tq) share those rows and groups: lane u = grp % 4 of them
// draws row u's two Philox blocks, and each takes its own bit from all
// four by 4 shuffles. All 32 lanes must call it.
__device__ __forceinline__ void key_major_keep_bits(int key0, int row0, int h, int b, uint2 seed,
                                                    unsigned thr, int lane, unsigned& keep_lo,
                                                    unsigned& keep_hi) {
  using tree_attention::kFull;
  const int grp = lane >> 2;
  const int tq = lane & 3;
  const int a = grp >> 2;
  const int u = grp & 3;
  const unsigned row_u = (unsigned)(row0 + ((u >> 1) << 3) + 2 * tq + (u & 1));
  const unsigned c0 = (unsigned)((key0 >> 2) + a);
  const uint4 wl = tree_attention::philox4x32_10(make_uint4(c0, row_u, (unsigned)h, (unsigned)b), seed);
  const uint4 wh = tree_attention::philox4x32_10(make_uint4(c0 + 2u, row_u, (unsigned)h, (unsigned)b), seed);
  const unsigned bits = keep_nibble(wl, thr) | (keep_nibble(wh, thr) << 4);
  keep_lo = keep_hi = 0u;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const unsigned w = __shfl_sync(kFull, bits, (a << 4) + (rr << 2) + tq);
    keep_lo |= ((w >> u) & 1u) << rr;
    keep_hi |= ((w >> (4 + u)) & 1u) << rr;
  }
}

// the keep bits of the first N chunks of the 16-row tile at r0, for keys
// below kp (all set at rate 0, and past kp)
template <int N>
__device__ __forceinline__ void tile_keep_bits(unsigned (&kf)[N], int r0, int kp, int h, int b,
                                               uint2 seed, unsigned thr, int lane) {
#pragma unroll
  for (int c = 0; c < N; ++c)
    kf[c] = thr != 0u && c * kKeyChunk < kp ? chunk_keep_bits(r0, c * kKeyChunk, h, b, seed, thr, lane)
                                            : ~0u;
}

}  // namespace tower_mma
