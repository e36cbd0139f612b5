// The pieces of the port's GEMMs on Hopper that more than one kernel uses:
// cp.async, ldmatrix and mma.sync (K1's bf16 GEMM, csrc/encoder_layer.cu),
// and for K5's GEMM (csrc/encoder_layer_train.cu) the mbarrier ring, TMA
// tile loads, wgmma with shared-memory descriptors, and the epilogue that
// both of K5's routes apply to each output element.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace gvd {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ cp.async --
// cp.async of 4 or 16 bytes; ok = false writes zeros and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------------ mma.sync --
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16, col).
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------ mbarrier --
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Arrive, and expect `bytes` more of asynchronous copies in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ----------------------------------------------------------------- TMA --
// The box at coordinates (c0 innermost, c1) of `map` into dst, completing
// on `bar`.  Elements outside the tensor arrive as zeros (and still count
// as bytes of the box).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// --------------------------------------------------------------- wgmma --
// A shared-memory matrix descriptor for a tile in the 128-byte swizzle
// (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B; the tile's 1024-byte
// swizzle atoms aligned to 1024).  K-major: rows of 128 bytes, `sbo` =
// 1024 between groups of 8 rows, `lbo` unused; MN-major: `lbo` between
// 64-element blocks along M or N, `sbo` = 1024 between groups of 8 k.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;  // 128-byte swizzle
  return d;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128, f32, the warpgroup's fragments) += A (64 x 16) B (16 x 128),
// bf16 from shared memory; TA / TB = 1 where that operand is MN-major.
// Fragment d[4 j + e] of thread t (warp w = t / 32 of the warpgroup, lane
// l): row 16 w + l / 4 + 8 (e / 2), column 8 j + 2 (l % 4) + e % 2.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// ------------------------------------------------------------ epilogue --
// What K5's GEMM does with each output element (m, n) of C (M, N), T the
// compute dtype.  With `partial`, split z writes its raw sum to
// partial[z] (summed later in a fixed order).  Otherwise: + bias[n], ReLU,
// zero where mask[m, n] <= 0, + resid[m, n] (which may be C itself: each
// element is read and written by one thread), stored as f32 or T, and
// also as bf16 into c2 when it is given.
template <typename T>
struct Epilogue {
  const float* bias;
  int relu;
  const T* mask;
  const float* resid;
  void* C;
  int c_f32;
  bf16* c2;
  float* partial;
  int M, N;

  __device__ __forceinline__ float finish(size_t at, int n, float v) const {
    if (bias != nullptr) v += bias[n];
    if (relu) v = fmaxf(v, 0.0f);
    if (mask != nullptr && !(to_f32(mask[at]) > 0.0f)) v = 0.0f;
    if (resid != nullptr) v += resid[at];
    return v;
  }

  __device__ __forceinline__ void store(int z, int m, int n, float v) const {
    const size_t at = (size_t)m * N + n;
    if (partial != nullptr) {
      partial[(size_t)z * M * N + at] = v;
      return;
    }
    v = finish(at, n, v);
    if (c_f32)
      static_cast<float*>(C)[at] = v;
    else
      static_cast<T*>(C)[at] = from_f32<T>(v);
    if (c2 != nullptr) c2[at] = __float2bfloat16(v);
  }

  // Elements (m, n) and (m, n + 1), n even: one 8-byte (f32) or 4-byte
  // (bf16) store each where N is even, else element by element.
  __device__ __forceinline__ void store2(int z, int m, int n, float v0,
                                         float v1) const {
    if (m >= M || n >= N) return;
    if (N % 2 != 0 || n + 1 >= N) {
      store(z, m, n, v0);
      if (n + 1 < N) store(z, m, n + 1, v1);
      return;
    }
    const size_t at = (size_t)m * N + n;
    if (partial != nullptr) {
      *reinterpret_cast<float2*>(partial + (size_t)z * M * N + at) =
          make_float2(v0, v1);
      return;
    }
    v0 = finish(at, n, v0);
    v1 = finish(at + 1, n + 1, v1);
    if (c_f32)
      *reinterpret_cast<float2*>(static_cast<float*>(C) + at) =
          make_float2(v0, v1);
    else if constexpr (sizeof(T) == 2)
      *reinterpret_cast<__nv_bfloat162*>(static_cast<T*>(C) + at) =
          __floats2bfloat162_rn(v0, v1);
    else
      *reinterpret_cast<float2*>(static_cast<T*>(C) + at) =
          make_float2(v0, v1);
    if (c2 != nullptr)
      *reinterpret_cast<__nv_bfloat162*>(c2 + at) =
          __floats2bfloat162_rn(v0, v1);
  }
};

}  // namespace gvd
