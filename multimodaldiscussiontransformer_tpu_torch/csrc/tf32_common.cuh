// 3xTF32 helpers shared by the float32 tensor-core kernels
// (tree_attention_bwd_tf32.cu, tree_attention_fwd_tf32.cu,
// masked_attention_fwd_tf32.cu): the TF32 split of a float32 operand,
// mma.sync.m16n8k8 on TF32 operands with f32 accumulators, the 3xTF32
// product, and the fragment loads of a row-major float32 tile staged with
// LD = DH + 4 floats a row.
//
// Precision, 3xTF32: each float32 operand x is split as big =
// cvt.rna.tf32(x), small = cvt.rna.tf32(x - big), and a b = big_a big_b +
// big_a small_b + small_a big_b (small_a small_b, ~2^-22 of the product, is
// dropped), all summed in f32 accumulators: the float32 route's tolerances
// hold, which one TF32 product (~2^-11) would break.
//
// Fragment layouts of mma.sync.m16n8k8 with TF32 operands (grp = lane / 4,
// tq = lane % 4):
//   A (16 x 8, row):  a0 (grp, tq), a1 (grp + 8, tq), a2 (grp, tq + 4),
//                     a3 (grp + 8, tq + 4);
//   B (8 x 8, col):   b0 (k tq, n grp), b1 (k tq + 4, n grp);
//   C (16 x 8, f32):  c0, c1 (grp, 2 tq..+1), c2, c3 (grp + 8, 2 tq..+1).
// The accumulator fragment of one 8-column n-tile holds (row grp, columns
// 2 tq, 2 tq + 1) where an A fragment wants (row grp, columns tq, tq + 4);
// a product sums over its k index in any order, so a second product takes
// the k index permuted (logical column tq = physical 2 tq, tq + 4 = 2 tq +
// 1): the accumulator registers become the A fragment as they are
// (acc_as_a), and the B fragment reads rows 2 tq and 2 tq + 1
// (load_b_rows). No shuffles, no trip through shared memory.
//
// With LD = DH + 4 floats a row, the A fragment (row grp, column tq) and
// the B fragment (n grp, k tq) of a row-major tile touch 32 distinct
// banks, and so do the B fragments of a product over the tile's rows read
// as (row 2 tq, column grp).

#pragma once

#include <cuda_runtime.h>

namespace tf32_mma {

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

}  // namespace tf32_mma
