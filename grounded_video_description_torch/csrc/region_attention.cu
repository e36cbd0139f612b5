// Per-token additive region attention (K3).
//
// Replaces grounded_video_description_tpu/ops/pallas/region_attention.py
// ::fused_region_attention.  For each batch row b:
//   s[r]   = sum_h tanh(p_pool[b,r,h] + att_h[b,h]) * alpha_w[h] + alpha_b
//   s[r]   = MIN_VALUE where att_mask[b,r]          (attention softmax)
//   grd[r] = MIN_VALUE where pnt_mask[b,r], else s[r] (grounding logits)
//   att_res[b,:] = softmax(s) @ pool[b]
//
// What bounds it on an H100: memory.  Each call reads the (B,R,H) and
// (B,R,D) banks once (at B=100, R=1000, H=512, D=1024 in f32: 600 MB) and
// does ~2 flops per byte, far below the card's ~300 flop/byte balance.
// Design: one block per batch row.  The (R,H) tanh intermediate lives only
// in registers (one warp per ROI reduces its H products), the row's R
// scores stay in shared memory (4 KB at R=1000), and the softmax is exact
// in two passes over shared memory, so each bank element is read from
// device memory exactly once.  Loads are four elements wide and unrolled so
// that enough bytes are in flight per SM; the weighted sum splits the ROIs
// over groups of threads and adds the groups' partial sums in shared
// memory.  H and D must be multiples of 4.  All arithmetic is f32; outputs
// are returned in the input dtype, as the TPU kernel does.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kThreads)
region_attention_kernel(const T* __restrict__ p_pool,
                        const T* __restrict__ att_h,
                        const T* __restrict__ pool,
                        const float* __restrict__ alpha_w,
                        const float* __restrict__ alpha_b,
                        const uint8_t* __restrict__ att_mask,
                        const uint8_t* __restrict__ pnt_mask,
                        T* __restrict__ att_res, T* __restrict__ grd, int R,
                        int H, int D) {
  extern __shared__ float smem[];
  // row groups of the weighted sum: blockDim.x / (D / 4) groups of
  // threads each sum every groups-th ROI over all D columns
  const int cols4 = D / 4;
  const int groups = max(1, (int)blockDim.x / cols4);
  float* s_ah = smem;               // (H) att_h row, f32
  float* s_w = smem + H;            // (H) alpha weights
  float* s_p = smem + 2 * H;        // (R) scores, then probabilities
  float* s_part = s_p + R;          // (groups, D) partial weighted sums
  __shared__ float scratch[32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int h = tid; h < H; h += blockDim.x) {
    s_ah[h] = gvd::to_f32(att_h[(size_t)b * H + h]);
    s_w[h] = alpha_w[h];
  }
  __syncthreads();

  // pass 1: one warp per ROI, four consecutive h per lane and load
  const float ab = alpha_b[0];
  const T* pp = p_pool + (size_t)b * R * H;
  for (int r = warp; r < R; r += n_warps) {
    const T* row = pp + (size_t)r * H;
    float acc = 0.0f;
#pragma unroll 4
    for (int h = 4 * lane; h < H; h += 128) {
      float v[4];
      gvd::load4(row + h, v);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc += tanhf(v[i] + s_ah[h + i]) * s_w[h + i];
    }
    acc = gvd::warp_sum(acc);
    if (lane == 0) {
      const size_t i = (size_t)b * R + r;
      const float s = att_mask[i] ? gvd::MIN_VALUE : acc + ab;
      s_p[r] = s;
      grd[i] = gvd::from_f32<T>(pnt_mask[i] ? gvd::MIN_VALUE : s);
    }
  }
  __syncthreads();

  // pass 2: exact softmax over the row in shared memory
  float m = -INFINITY;
  for (int r = tid; r < R; r += blockDim.x) m = fmaxf(m, s_p[r]);
  m = gvd::block_reduce<true>(m, scratch);
  float l = 0.0f;
  for (int r = tid; r < R; r += blockDim.x) {
    const float e = expf(s_p[r] - m);
    s_p[r] = e;
    l += e;
  }
  l = gvd::block_reduce<false>(l, scratch);  // also orders the s_p writes

  // pass 3: weighted sum of the pool rows, four columns per thread
  const T* pb = pool + (size_t)b * R * D;
  for (int w = tid; w < groups * cols4; w += blockDim.x) {
    const int c = 4 * (w % cols4), g = w / cols4;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int r = g; r < R; r += groups) {
      float v[4];
      gvd::load4(pb + (size_t)r * D + c, v);
      const float p = s_p[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += p * v[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) s_part[g * D + c + i] = acc[i];
  }
  __syncthreads();
  for (int d = tid; d < D; d += blockDim.x) {
    float acc = 0.0f;
    for (int g = 0; g < groups; ++g) acc += s_part[g * D + d];
    att_res[(size_t)b * D + d] = gvd::from_f32<T>(acc / l);
  }
}

}  // namespace

extern "C" int gvd_region_attention(int dtype, const void* p_pool,
                                    const void* att_h, const void* pool,
                                    const void* alpha_w, const void* alpha_b,
                                    const void* att_mask, const void* pnt_mask,
                                    void* att_res, void* grd, int B, int R,
                                    int H, int D, void* stream) {
  if (H % 4 != 0 || D % 4 != 0) return (int)cudaErrorInvalidValue;
  const int groups = D / 4 >= kThreads ? 1 : kThreads / (D / 4);
  const size_t smem = (size_t)(2 * H + R + groups * D) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  GVD_DISPATCH(dtype, T, {
    auto kern = region_attention_kernel<T>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kern<<<B, kThreads, smem, s>>>(
        (const T*)p_pool, (const T*)att_h, (const T*)pool,
        (const float*)alpha_w, (const float*)alpha_b,
        (const uint8_t*)att_mask, (const uint8_t*)pnt_mask, (T*)att_res,
        (T*)grd, R, H, D);
  });
  return (int)cudaGetLastError();
}
