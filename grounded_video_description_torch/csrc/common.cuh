// Helpers shared by the port's kernels: dtype conversion, warp and block
// reductions, and the dtype dispatch of the C entry points.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gvd {

// Masked scores are SET to this value before the softmax, never to -inf:
// a fully masked row then gives a uniform softmax, not NaN.
constexpr float MIN_VALUE = -1e8f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive elements as f32.  p must be aligned to 4 elements.
__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Row stride, in floats, of a (rows, dh) f32 tile in shared memory: dh
// rounded up to a multiple of 4, plus 4 when that is a multiple of 8, so
// that the 16-byte reads of 8 consecutive rows hit distinct banks.
__host__ __device__ constexpr int tile_ld(int dh) {
  return ((dh + 3) / 4) % 2 ? (dh + 3) / 4 * 4 : (dh + 3) / 4 * 4 + 4;
}

// Rows [r0, r0 + n) of one head's dh columns into dst (n, ld) as f32; rows
// at or past R and the pad columns up to dh4 are zero.  One warp per row,
// lanes along the row.
template <typename T>
__device__ void load_tile_rows(float* dst, int ld, const T* src,
                               size_t row_stride, int r0, int n, int R,
                               int dh, int dh4) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < n; r += n_warps) {
    const bool ok = r0 + r < R;
    const T* row = src + (size_t)(r0 + r) * row_stride;
    for (int d = lane; d < dh4; d += 32)
      dst[r * ld + d] = ok && d < dh ? to_f32(row[d]) : 0.0f;
  }
}

// Sum (or max) over the whole block; every thread gets the result.
// `scratch` holds at least 32 floats.  blockDim.x is a multiple of 32.
template <bool IS_MAX>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = lane < n_warps ? scratch[lane] : (IS_MAX ? -INFINITY : 0.0f);
  r = IS_MAX ? warp_max(r) : warp_sum(r);
  return r;
}

// The JAX package's dropout hash (ops/pallas/encoder_layer_train.py::
// uniform_hash): u = (fmix32(ctr ^ mix) >> 8) * 2^-24 for a counter ctr,
// with mix = fmix32(seed + fmix32(salt)) per (seed, salt); uint32 wraps.
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// seed: one int64 on the device, of which the low 32 bits count.
__device__ __forceinline__ uint32_t salt_mix(const long long* seed,
                                             uint32_t salt) {
  return fmix32((uint32_t)(unsigned long long)seed[0] + fmix32(salt));
}

__device__ __forceinline__ float hash_uniform(uint32_t mix, uint32_t ctr) {
  return (float)(fmix32(ctr ^ mix) >> 8) * (1.0f / 16777216.0f);
}

// The per-(row, head) key of the attention's dropout hash: salt =
// salt_base + b * salt_mul + head (K4: 0x40000000, max(n_heads, 8); K5:
// 0x10000000, 8).
__device__ __forceinline__ uint32_t head_mix(const long long* seed, int b,
                                             int head, uint32_t salt_base,
                                             int salt_mul) {
  return salt_mix(seed, salt_base + (uint32_t)b * (uint32_t)salt_mul +
                            (uint32_t)head);
}

// 1 / (1 - rate) where prob (query i, key j) is kept, 0 where it is
// dropped; Rp is R rounded up to 128.
__device__ __forceinline__ float keep_scale(uint32_t mix, int i, int j,
                                            int Rp, float rate,
                                            float inv_keep) {
  const float u = hash_uniform(mix, (uint32_t)i * (uint32_t)Rp + (uint32_t)j);
  return u >= rate ? inv_keep : 0.0f;
}

// Let `kern` take `smem` bytes of dynamic shared memory (above 48 KB a
// kernel has to ask).
template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace gvd

// dtype codes of the C interface: 0 = float32, 1 = bfloat16
#define GVD_DISPATCH(code, T, ...)                     \
  do {                                                 \
    if ((code) == 0) {                                 \
      using T = float;                                 \
      __VA_ARGS__;                                     \
    } else if ((code) == 1) {                          \
      using T = __nv_bfloat16;                         \
      __VA_ARGS__;                                     \
    } else {                                           \
      return (int)cudaErrorInvalidValue;               \
    }                                                  \
  } while (0)
