// One post-LN obj_interact encoder layer at inference (K1), as three kernels.
//
// Replaces grounded_video_description_tpu/ops/pallas/encoder_layer.py
// ::fused_encoder_layer (driven by encoder_apply_fused).  The layer is
//   qkv = x [Wq|Wk|Wv]^T
//   a   = concat_h softmax(q_h k_h^T / sqrt(D)) v_h  Wo^T
//   x1  = LN(x + a);  x2 = LN(x1 + relu(x1 W1^T + b1) W2^T + b2)
// with six uneven heads in torch.chunk boundaries (171 x 5 + 169 at D=1024),
// one shared scale sqrt(D), and LN dividing by (unbiased std + eps).
//
// What bounds it on an H100: arithmetic.  At B=100, R=1000, D=1024 a layer
// is ~1.1 TFLOP of projections and ~0.4 TFLOP of attention, against ~0.4 GB
// of activations; the (B, 6, R, R) scores would add 2.4 GB per layer of
// f32 traffic if they were written out.  Design:
//  * gvd_gemm: a tiled product C = A W^T (+bias, ReLU) with W in PyTorch's
//    (out, in) layout, 128 x 128 tiles staged through shared memory, an
//    8 x 8 block of outputs per thread, f32 accumulation; in bf16 (K a
//    multiple of 8) the tiles go through the tensor cores with wmma
//    (mma.sync), still accumulating in f32.  It serves the QKV (one product
//    with N = 3D), output and FFN projections.
//  * gvd_attention: one block per (query tile of 64, head, batch row),
//    flash-style: each 64-key tile's scores stay in shared memory and
//    registers, the softmax runs online over the tiles in f32, and P V is
//    summed in registers, so no score reaches device memory.  Each thread
//    computes a 4 x 4 block of scores and a 4 x 12 block of outputs from
//    16-byte shared-memory reads, so each read is reused in registers.  Heads are column
//    ranges of the qkv buffer, so the uneven heads need no packing.
//  * gvd_residual_layer_norm: x + y, then the unbiased-std LayerNorm, one
//    block per row, statistics in f32.
// These kernels are simple and right, not yet fast: no wgmma, TMA or
// pipelining, and the attention runs on the f32 SIMT units in both dtypes.

#include <mma.h>

#include "common.cuh"

namespace {

// ------------------------------------------------------------------ GEMM --
// C (M, N) = A (M, K) W (N, K)^T: 128 x 128 output tiles, 256 threads, each
// thread an 8 x 8 block (two 4-row by two 4-column quarters 64 apart, so a
// warp's shared-memory reads are conflict-free float4s), K in steps of 8.
constexpr int BM = 128, BN = 128, BK = 8, GEMM_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ W,
            const float* __restrict__ bias, T* __restrict__ C, int M, int N,
            int K, int relu) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // tile loads: thread t copies 4 consecutive k of row t / 2
  const int lr = tid / 2, lk = (tid % 2) * 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + lk + i;
      const int gm = m0 + lr, gn = n0 + lr;
      As[lk + i][lr] =
          (gm < M && gk < K) ? gvd::to_f32(A[(size_t)gm * K + gk]) : 0.0f;
      Ws[lk + i][lr] =
          (gn < N && gk < K) ? gvd::to_f32(W[(size_t)gn * K + gk]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], w[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 w0 = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float4 w1 = *reinterpret_cast<const float4*>(&Ws[kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      w[0] = w0.x; w[1] = w0.y; w[2] = w0.z; w[3] = w0.w;
      w[4] = w1.x; w[5] = w1.y; w[6] = w1.z; w[7] = w1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * w[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[n];
      if (relu) v = fmaxf(v, 0.0f);
      C[(size_t)m * N + n] = gvd::from_f32<T>(v);
    }
  }
}

// bf16 on the tensor cores (mma.sync through nvcuda::wmma), f32
// accumulation: 128 x 128 output tiles, 8 warps as 4 (rows) x 2 (columns),
// each warp 32 x 64 = 2 x 4 fragments of 16 x 16; K in steps of 32 staged in
// shared memory with 16-byte loads (needs K % 8 == 0).  The epilogue goes
// through a per-warp 16 x 16 f32 scratch to add the bias and the ReLU.
constexpr int WBM = 128, WBN = 128, WBK = 32, WLD = WBK + 8;

__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bf16_wmma_kernel(const __nv_bfloat16* __restrict__ A,
                      const __nv_bfloat16* __restrict__ W,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ C, int M, int N, int K,
                      int relu) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[WBM * WLD];
  __shared__ __align__(32) __nv_bfloat16 Ws[WBN * WLD];
  __shared__ __align__(32) float scratch[GEMM_THREADS / 32][16 * 16];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * WBM, n0 = blockIdx.x * WBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int k0 = 0; k0 < K; k0 += WBK) {
    // each tile is 128 rows x 32 k = 512 chunks of 8; two per thread
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int idx = tid + c * GEMM_THREADS;
      const int r = idx / 4, kc = (idx % 4) * 8, gk = k0 + kc;
      const int gm = m0 + r, gn = n0 + r;
      *reinterpret_cast<uint4*>(&As[r * WLD + kc]) =
          (gm < M && gk < K)
              ? *reinterpret_cast<const uint4*>(&A[(size_t)gm * K + gk]) : zero;
      *reinterpret_cast<uint4*>(&Ws[r * WLD + kc]) =
          (gn < N && gk < K)
              ? *reinterpret_cast<const uint4*>(&W[(size_t)gn * K + gk]) : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> w[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm * 32 + i * 16) * WLD + kk], WLD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(w[j], &Ws[(wn * 64 + j * 16) * WLD + kk], WLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* sc = scratch[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int mb = m0 + wm * 32 + i * 16, nb = n0 + wn * 64 + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int m = mb + e / 16, n = nb + e % 16;
        if (m < M && n < N) {
          float v = sc[e];
          if (bias != nullptr) v += bias[n];
          if (relu) v = fmaxf(v, 0.0f);
          C[(size_t)m * N + n] = __float2bfloat16(v);
        }
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------------------- attention --
// One block per (query tile of BQ = 64, head, batch row), 256 threads seen
// as a 16 x 16 grid (tq, tk).  Thread (tq, tk) owns queries 4 tq + i of the
// tile: for the scores, keys tk + 16 j of each 64-key tile (a 4 x 4 block);
// for P V, head dims 4 tk + 64 j + e (NV groups of 4).  Rows are stored
// with a stride of 4 (mod 8) floats, so the 16-byte reads of 8 consecutive
// threads hit distinct banks.  The softmax runs online over the key tiles
// (running max m, normaliser l, accumulator rescaled by exp(m_old - m_new)),
// so shared memory holds one score tile and two blocks fit on an SM.
constexpr int BQ = 64, QPT = BQ / 16, BKEY = 64, ATT_THREADS = 256;
constexpr int MAX_HEAD = 256;                     // widest head: NV = 4
constexpr int ST_LD = BKEY + 1;                   // score-tile row stride

__host__ __device__ constexpr size_t attention_smem(int ld) {
  return (size_t)(BQ * ld + BKEY * ld + BQ * ST_LD + 3 * BQ) * sizeof(float);
}

// qkv: (B, R, 3D) = [q | k | v]; head h spans columns [h*hs, min(h*hs+hs, D))
// of each.  out: (B, R, D).  NV: 4-wide head-dim groups per thread in P V,
// with dh <= 64 NV.
template <typename T, int NV>
__global__ void __launch_bounds__(ATT_THREADS, 2)   // two blocks per SM
attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int R, int D,
                 int hs, float inv_scale) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z;
  const int c0 = head * hs;
  const int dh = min(hs, D - c0);
  const int dh4 = (dh + 3) / 4 * 4;
  const int ld = gvd::tile_ld(dh);
  float* Qs = smem;                  // (BQ, ld)
  float* KVs = Qs + BQ * ld;         // (BKEY, ld): K tile, then V tile
  float* St = KVs + BKEY * ld;       // (BQ, ST_LD): scores, then probs
  float* m_s = St + BQ * ST_LD;      // (BQ) running max
  float* l_s = m_s + BQ;             // (BQ) running normaliser
  float* c_s = l_s + BQ;             // (BQ) this tile's rescale factor
  const int tid = threadIdx.x, tq = tid / 16, tk = tid % 16;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row_stride = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * R * row_stride + c0;

  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  gvd::load_tile_rows(Qs, ld, base, row_stride, q0, BQ, R, dh, dh4);

  float acc[QPT][NV][4];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int k0 = 0; k0 < R; k0 += BKEY) {
    __syncthreads();                 // KVs free (previous P V done)
    gvd::load_tile_rows(KVs, ld, base + D, row_stride, k0, BKEY, R, dh,
                         dh4);
    __syncthreads();
    float sc[QPT][4];
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int d = 0; d < dh4; d += 4) {
      float4 q[QPT], k[4];
#pragma unroll
      for (int i = 0; i < QPT; ++i)
        q[i] = *reinterpret_cast<const float4*>(&Qs[(tq * QPT + i) * ld + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        k[j] = *reinterpret_cast<const float4*>(&KVs[(tk + 16 * j) * ld + d]);
#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] += q[i].x * k[j].x;
          sc[i][j] += q[i].y * k[j].y;
          sc[i][j] += q[i].z * k[j].z;
          sc[i][j] += q[i].w * k[j].w;
        }
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        St[(tq * QPT + i) * ST_LD + tk + 16 * j] =
            k0 + tk + 16 * j < R ? sc[i][j] * inv_scale : -INFINITY;
    __syncthreads();

    // online softmax, one warp per query row: every tile holds at least
    // one real key, so the new max is finite
    for (int q = warp; q < BQ; q += ATT_THREADS / 32) {
      float* srow = St + q * ST_LD;
      const float s0 = srow[lane], s1 = srow[lane + 32];
      const float m_old = m_s[q];
      const float m_new = fmaxf(m_old, gvd::warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      srow[lane] = p0;
      srow[lane + 32] = p1;
      const float tile_sum = gvd::warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[q] = corr;
        l_s[q] = l_s[q] * corr + tile_sum;
        m_s[q] = m_new;
      }
    }
    gvd::load_tile_rows(KVs, ld, base + 2 * D, row_stride, k0, BKEY, R, dh,
                         dh4);
    __syncthreads();

    const int kn = min(BKEY, R - k0);
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const float corr = c_s[tq * QPT + i];
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= corr;
    }
    for (int kk = 0; kk < kn; ++kk) {
      float p[QPT];
#pragma unroll
      for (int i = 0; i < QPT; ++i) p[i] = St[(tq * QPT + i) * ST_LD + kk];
      const float* vrow = KVs + kk * ld;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int d = 4 * tk + 64 * j;
        if (d < dh4) {
          const float4 v = *reinterpret_cast<const float4*>(&vrow[d]);
#pragma unroll
          for (int i = 0; i < QPT; ++i) {
            acc[i][j][0] += p[i] * v.x;
            acc[i][j][1] += p[i] * v.y;
            acc[i][j][2] += p[i] * v.z;
            acc[i][j][3] += p[i] * v.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int q = tq * QPT + i;
    if (q0 + q >= R) continue;
    const float inv_l = 1.0f / l_s[q];
    T* orow = out + ((size_t)b * R + q0 + q) * D + c0;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tk + 64 * j + e;
        if (d < dh) orow[d] = gvd::from_f32<T>(acc[i][j][e] * inv_l);
      }
  }
}

template <typename T, int NV>
int launch_attention(const void* qkv, void* out, int B, int R, int D, int hs,
                     float inv_scale, cudaStream_t s) {
  const size_t smem = attention_smem(gvd::tile_ld(hs));
  cudaError_t e = gvd::allow_smem(attention_kernel<T, NV>, smem);
  if (e != cudaSuccess) return (int)e;
  // torch.chunk makes ceil(D / hs) heads, which can be fewer than n_heads
  const int heads = (D + hs - 1) / hs;
  dim3 grid((R + BQ - 1) / BQ, heads, B);
  attention_kernel<T, NV><<<grid, ATT_THREADS, smem, s>>>(
      (const T*)qkv, (T*)out, R, D, hs, inv_scale);
  return (int)cudaGetLastError();
}

// --------------------------------------------------- residual + LayerNorm --
constexpr int LN_THREADS = 256;

// out = gamma * (v - mean) / (std + eps) + beta, v = x + y, std unbiased
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
residual_ln_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ out, int D,
                   float eps) {
  extern __shared__ float v[];
  __shared__ float scratch[32];
  const size_t row = (size_t)blockIdx.x * D;
  float s = 0.0f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float a = gvd::to_f32(x[row + d]) + gvd::to_f32(y[row + d]);
    v[d] = a;
    s += a;
  }
  const float mean = gvd::block_reduce<false>(s, scratch) / D;
  float ss = 0.0f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float c = v[d] - mean;
    ss += c * c;
  }
  const float var = gvd::block_reduce<false>(ss, scratch) / max(D - 1, 1);
  const float inv = 1.0f / (sqrtf(var) + eps);
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    out[row + d] = gvd::from_f32<T>(gamma[d] * ((v[d] - mean) * inv) + beta[d]);
}

}  // namespace

extern "C" int gvd_gemm(int dtype, const void* A, const void* W,
                        const void* bias, void* C, int M, int N, int K,
                        int relu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1 && K % 8 == 0) {
    dim3 grid((N + WBN - 1) / WBN, (M + WBM - 1) / WBM);
    gemm_bf16_wmma_kernel<<<grid, GEMM_THREADS, 0, s>>>(
        (const __nv_bfloat16*)A, (const __nv_bfloat16*)W, (const float*)bias,
        (__nv_bfloat16*)C, M, N, K, relu);
    return (int)cudaGetLastError();
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  GVD_DISPATCH(dtype, T, {
    gemm_kernel<T><<<grid, GEMM_THREADS, 0, s>>>(
        (const T*)A, (const T*)W, (const float*)bias, (T*)C, M, N, K, relu);
  });
  return (int)cudaGetLastError();
}

extern "C" int gvd_attention(int dtype, const void* qkv, void* out, int B,
                             int R, int D, int n_heads, float inv_scale,
                             void* stream) {
  const int hs = (D + n_heads - 1) / n_heads;
  if (hs > MAX_HEAD) return (int)cudaErrorInvalidValue;
  const int nv = (hs + 63) / 64;
  cudaStream_t s = (cudaStream_t)stream;
  GVD_DISPATCH(dtype, T, {
    switch (nv) {
      case 1: return launch_attention<T, 1>(qkv, out, B, R, D, hs, inv_scale, s);
      case 2: return launch_attention<T, 2>(qkv, out, B, R, D, hs, inv_scale, s);
      case 3: return launch_attention<T, 3>(qkv, out, B, R, D, hs, inv_scale, s);
      default: return launch_attention<T, 4>(qkv, out, B, R, D, hs, inv_scale, s);
    }
  });
  return (int)cudaErrorInvalidValue;
}

extern "C" int gvd_residual_layer_norm(int dtype, const void* x,
                                       const void* y, const void* gamma,
                                       const void* beta, void* out, int rows,
                                       int D, float eps, void* stream) {
  const size_t smem = (size_t)D * sizeof(float);
  GVD_DISPATCH(dtype, T, {
    cudaError_t e = gvd::allow_smem(residual_ln_kernel<T>, smem);
    if (e != cudaSuccess) return (int)e;
    residual_ln_kernel<T><<<rows, LN_THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)y, (const float*)gamma, (const float*)beta,
        (T*)out, D, eps);
  });
  return (int)cudaGetLastError();
}
