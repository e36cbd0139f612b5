// Bidirectional GRU / LSTM recurrence over precomputed input projections (K2).
//
// Replaces grounded_video_description_tpu/ops/pallas/birnn.py
// ::birnn_recurrence.  Inputs: gi (T, 2, B, G) = x W_ih^T + b for both
// direction lanes (lane 1 already time-reversed by the caller), wh (2, H, G),
// bh (2, G) (GRU only; the LSTM bias is folded into gi).  Output: ys
// (T, 2, B, H), lane 1 still in reversed time.  G = 3H (GRU: r, z, n;
// n = tanh(i_n + r * (W_hn h + b_hn))) or 4H (LSTM: i, f, g, o).
//
// What bounds it on an H100: the T-step sequential chain.  Each step needs
// the whole W_hh of its direction (512 x 1536 at the flagship: 3 MB in f32,
// 1.5 MB in bf16), more than a block's 227 KB of shared memory, while the
// step's arithmetic is small.  Batch rows and directions are independent,
// so the design is one block per (direction, batch tile) that loops over
// all T steps inside the kernel, with no grid-wide synchronisation: h (and
// c) stay in shared memory in f32, W_hh is re-read every step from global
// memory where the 50 MB L2 holds it, and gi[t] is streamed in.  A wider
// batch tile (BT rows per block) reads W_hh fewer times per row; a narrower
// one puts more SMs to work.  Each thread owns hidden units j and computes
// all gates of j, so the gate math needs no exchange between threads.
//
// The tile is fixed at kBatchTile = 4.  A sweep of 1, 2, 4 and 8 at the
// flagship shapes on an H100 (PERF.md) found 4 the fastest for the LSTM,
// by 1.4x or more in both dtypes, and within 7% of the fastest for the GRU
// (tile 2 in f32, tile 8 in bf16).

#include "common.cuh"

namespace {

constexpr int kBatchTile = 4;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename T, int BT, bool GRU>
__global__ void birnn_kernel(const T* __restrict__ gi,
                             const T* __restrict__ wh,
                             const T* __restrict__ bh, T* __restrict__ out,
                             int n_steps, int B, int H) {
  constexpr int NG = GRU ? 3 : 4;
  extern __shared__ float smem[];
  float* h_buf = smem;                  // 2 x (BT, H): current / next h
  float* c_s = smem + 2 * BT * H;       // (BT, H), LSTM only

  const int k = blockIdx.x;             // direction lane
  const int b0 = blockIdx.y * BT;
  const int G = NG * H;
  const T* W = wh + (size_t)k * H * G;

  for (int i = threadIdx.x; i < (GRU ? 2 : 3) * BT * H; i += blockDim.x)
    smem[i] = 0.0f;
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < n_steps; ++t) {
    const float* hc = h_buf + cur * BT * H;
    float* hn = h_buf + (cur ^ 1) * BT * H;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float acc[NG][BT];
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) acc[g][bb] = 0.0f;

#pragma unroll 8
      for (int kk = 0; kk < H; ++kk) {
        float w[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g)
          w[g] = gvd::to_f32(W[(size_t)kk * G + g * H + j]);
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) {
          const float hv = hc[bb * H + kk];
#pragma unroll
          for (int g = 0; g < NG; ++g) acc[g][bb] += hv * w[g];
        }
      }

#pragma unroll
      for (int bb = 0; bb < BT; ++bb) {
        const int b = b0 + bb;
        if (b >= B) continue;
        const T* g_in = gi + (((size_t)t * 2 + k) * B + b) * G;
        const float h_old = hc[bb * H + j];
        float h_new;
        if constexpr (GRU) {
          const T* bk = bh + (size_t)k * G;
          const float hr = acc[0][bb] + gvd::to_f32(bk[j]);
          const float hz = acc[1][bb] + gvd::to_f32(bk[H + j]);
          const float hnn = acc[2][bb] + gvd::to_f32(bk[2 * H + j]);
          const float r = sigmoidf(gvd::to_f32(g_in[j]) + hr);
          const float z = sigmoidf(gvd::to_f32(g_in[H + j]) + hz);
          const float n = tanhf(gvd::to_f32(g_in[2 * H + j]) + r * hnn);
          h_new = (1.0f - z) * n + z * h_old;
        } else {
          const float ig = sigmoidf(gvd::to_f32(g_in[j]) + acc[0][bb]);
          const float fg = sigmoidf(gvd::to_f32(g_in[H + j]) + acc[1][bb]);
          const float gg = tanhf(gvd::to_f32(g_in[2 * H + j]) + acc[2][bb]);
          const float og = sigmoidf(gvd::to_f32(g_in[3 * H + j]) + acc[NG - 1][bb]);
          const float c_new = fg * c_s[bb * H + j] + ig * gg;
          c_s[bb * H + j] = c_new;
          h_new = og * tanhf(c_new);
        }
        hn[bb * H + j] = h_new;
        out[(((size_t)t * 2 + k) * B + b) * H + j] = gvd::from_f32<T>(h_new);
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

template <typename T, int BT, bool GRU>
int launch(const void* gi, const void* wh, const void* bh, void* out,
           int n_steps, int B, int H, cudaStream_t s) {
  const size_t smem = (size_t)(GRU ? 2 : 3) * BT * H * sizeof(float);
  auto kern = birnn_kernel<T, BT, GRU>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((H + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  dim3 grid(2, (B + BT - 1) / BT);
  kern<<<grid, threads, smem, s>>>((const T*)gi, (const T*)wh, (const T*)bh,
                                   (T*)out, n_steps, B, H);
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 = GRU, 1 = LSTM.
extern "C" int gvd_birnn_recurrence(int dtype, int mode, const void* gi,
                                    const void* wh, const void* bh, void* out,
                                    int n_steps, int B, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  GVD_DISPATCH(dtype, T, {
    return mode == 0
        ? launch<T, kBatchTile, true>(gi, wh, bh, out, n_steps, B, H, s)
        : launch<T, kBatchTile, false>(gi, wh, bh, out, n_steps, B, H, s);
  });
  return (int)cudaErrorInvalidValue;
}
