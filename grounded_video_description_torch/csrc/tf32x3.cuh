// 3xTF32 on mma.sync.m16n8k8: f32-accurate products on the tensor cores,
// shared by the f32 attention (csrc/attention_tf32x3.cu), K1's f32 GEMM
// (csrc/encoder_layer.cu) and K6's f32 GEMM phases (csrc/decode_scan.cu).
//
// One TF32 product keeps ~11 bits of each operand, too few for the f32
// bars.  Each operand element is split on load as a = hi + lo (hi rounded
// to TF32 to nearest, ties away from zero; lo = a - hi, which the tensor
// core truncates to TF32), and a b = lo hi' + hi lo' + hi hi' with f32
// accumulation, the small terms first.  The dropped terms are ~2^-21 of
// a b, near f32's own 2^-24.
#pragma once

#include "gemm_sm90.cuh"

namespace gvd {

struct FragA {       // 16 x 8: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
  uint32_t hi[4];    // a3 (g + 8, t + 4); g = lane / 4, t = lane % 4
  uint32_t lo[4];
};
struct FragB {       // 8 x 8 (k, n): b0 (t, g), b1 (t + 4, g)
  uint32_t hi[2];
  uint32_t lo[2];
};

// x = hi + lo: hi is x rounded to TF32, to nearest with ties away from
// zero (cvt.rna.tf32.f32's rounding, done on the bit pattern: add half the
// range of the 13 dropped bits, then clear them: two integer operations,
// cheaper than cvt on the card); lo = x - hi is exact in f32, and
// the tensor core reads its top 19 bits (truncation).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// c (16 x 8, f32; c0, c1 at (g, 2t), (g, 2t + 1), c2, c3 at row g + 8)
// += a b, one TF32 product
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 4 f32 matrices (8 x 8 as b16) by ldmatrix; lane l gives the
// address of row l % 8 of matrix l / 8, and register i receives matrix i's
// element (row lane / 4, column lane % 4): the TF32 fragment layout.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A: rows r0.. r0 + 15, columns k0.. k0 + 7 of a row-major tile (rows ld
// floats apart; ld an odd multiple of 4 keeps the 8 rows of each matrix
// on distinct banks).
__device__ __forceinline__ FragA load_a(const float* s, int ld, int r0,
                                        int k0, int lane) {
  uint32_t r[4];
  ldsm_x4(r, s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + k0 +
                 (lane >> 4) * 4);
  return frag_a(__uint_as_float(r[0]), __uint_as_float(r[1]),
                __uint_as_float(r[2]), __uint_as_float(r[3]));
}

// B of two n-tiles, n0.. n0 + 7 and n0 + 8.., over k0.. k0 + 7, from a
// tile stored (n, k) row-major.
__device__ __forceinline__ void load_b_nk2(FragB b[2], const float* s,
                                           int ld, int n0, int k0,
                                           int lane) {
  uint32_t r[4];
  ldsm_x4(r, s + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                 ((lane >> 3) & 1) * 4);
  b[0] = frag_b(__uint_as_float(r[0]), __uint_as_float(r[1]));
  b[1] = frag_b(__uint_as_float(r[2]), __uint_as_float(r[3]));
}

// c = a b, one TF32 product, the accumulator not read (zero)
__device__ __forceinline__ void mma_tf32_set(float c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}

// c[n] += a b[n] in 3xTF32 for N n-tiles, the MMAs of different tiles
// interleaved so that each accumulator's three are not back to back.
template <int N>
__device__ __forceinline__ void mma3_n(float (*c)[4], const FragA& a,
                                       const FragB* b) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.lo, b[n].hi);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.hi, b[n].lo);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.hi, b[n].hi);
}

// The same with c[n] = a b[n], the accumulators not read.  The tensor
// cores' f32 additions truncate, so one accumulator summed over a long K
// drifts: K1's GEMM summing K = 1024 into its accumulators this way read
// 1.1e-4 off the f32 product on sums of up to ~16 on an H100, over K1's
// f32 bar of 1e-4.  That GEMM takes each 16-deep step into fresh
// accumulators and adds those to its running sums in f32 (round to
// nearest).
template <int N>
__device__ __forceinline__ void mma3_n_set(float (*c)[4], const FragA& a,
                                           const FragB* b) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32_set(c[n], a.lo, b[n].hi);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.hi, b[n].lo);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], a.hi, b[n].hi);
}

// acc[n] += c[n], elementwise in f32
template <int N>
__device__ __forceinline__ void add_n(float (*acc)[4], const float (*c)[4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += c[n][e];
}

}  // namespace gvd
