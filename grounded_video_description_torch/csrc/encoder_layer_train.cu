// The whole obj_interact encoder layer in training, forward and backward,
// with dropout at three sites (K5): the pieces that K1 and K4 do not have.
//
// Replaces grounded_video_description_tpu/ops/pallas/encoder_layer_train.py
// ::fused_encoder_layer_train (_fwd_kernel, pl.pallas_call at :401;
// _bwd_kernel, :459).  Per batch row b of the call, in the compute dtype T
// with f32 accumulation:
//   q, k, v = x Wq^T, x Wk^T, x Wv^T
//   o       = concat_h drop_p(softmax(q_h k_h^T / sqrt(D))) v_h     (T)
//   x1      = LN1(x + drop_1(o Wo^T))                        (f32; x1c = T)
//   out     = LN2(x1 + drop_2(relu(x1c W1^T + b1) W2^T + b2))            (T)
// LN divides by (unbiased std + 1e-6).  Each dropout keeps where the JAX
// package's counter hash u >= rate and divides by (1 - rate): the prob site
// salted 0x10000000 + b * 8 + h over an (Rp, Rp) counter (Rp = R rounded up
// to 128), the two residual sites 0x20000000 + b and 0x30000000 + b over
// an (R, D) counter i * D + j.  Backward and forward regenerate the same
// masks; none is stored.
//
// The layer is a sequence of launches (ops/kernels/encoder_layer_train.py
// orders them), every product on the port's own kernels:
//  * forward: K1's gvd_gemm for Q, K, V and for W1 (+ b1, ReLU); K4's
//    flash forward (csrc/attention_train.cu) with K5's prob salts, which
//    keeps each (R, R) tile in shared memory and saves the row
//    log-sum-exp; gvd_k5_gemm for Wo and for W2 (+ b2) with f32 outputs;
//    gvd_k5_ln_fwd for dropout + residual + LayerNorm, which saves each
//    row's normalised values and sigma.
//  * backward: gvd_k5_ln_bwd (the LayerNorm backward of the TPU kernel's
//    _ln_bwd, max(sigma, 1e-30) included, and the residual site's mask);
//    gvd_k5_gemm in its other two layouts, dY W for the data gradients
//    (with the ReLU mask or a residual added in the epilogue) and A^T B
//    over the B * R rows for the weight gradients (split over the rows,
//    then summed in a fixed order); K4's FlashAttention-2 backward with
//    K5's salts; gvd_k5_colsum for db1, db2, dgamma and dbeta in two
//    passes.  No atomics anywhere, so a repeat call gives the same bits.
//
// Saved between the passes (beside x), at (B, R, D) = (30, 1000, 1024),
// FFN 512: q, k, v and o in T, x1c in T, the FFN activation in T, the two
// LayerNorms' normalised values in f32, sigma and the log-sum-exp in f32:
// 922 MB in f32, 584 MB in bf16.  No (B, heads, R, R) tensor is written.
//
// What bounds it on an H100: arithmetic.  The forward is 437 GFLOP per
// call at that shape (QKV 189, QK^T and PV 123, Wo 63, FFN 63), the
// backward 936 GFLOP (two products per forward product, and the
// attention's five: QK^T again, dV, dP, dQ, dK), against 0.25 GB of input
// and output.  This first version runs every product on the f32
// SIMT units (128 x 128 tiles, an 8 x 8 block of outputs per thread) in
// both dtypes, apart from K1's bf16 GEMM, which uses mma.sync; no wgmma,
// TMA or pipelining yet.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 8, THREADS = 256;
constexpr int LN_THREADS = 256;

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return gvd::to_f32(gvd::from_f32<T>(x));
}

// ---------------------------------------------------------------- GEMM --
// C (M, N) = sum_l Aop(i, l) Bop(l, j) over l in this block's K range:
//   A_T false: Aop(i, l) = A[i * K + l]   (A is (M, K))
//   A_T true:  Aop(i, l) = A[l * M + i]   (A is (K, M))
//   B_T true:  Bop(l, j) = B[j * K + l]   (B is (N, K), PyTorch's weights)
//   B_T false: Bop(l, j) = B[l * N + j]   (B is (K, N))
// A of type TA is rounded to T as it is loaded (an f32 gradient enters the
// product in the compute dtype, as the TPU kernel casts it).  With
// `partial`, block z writes its raw sums to partial[z]; otherwise the
// epilogue adds bias[j], applies ReLU, zeroes where mask[i, j] <= 0, adds
// resid[i, j] (which may be C itself) and stores C as f32 or T.
template <typename T, typename TA, bool A_T, bool B_T>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const TA* __restrict__ A, const T* __restrict__ B, int M, int N,
            int K, int k_chunk, const float* __restrict__ bias, int relu,
            const T* __restrict__ mask, const float* resid, void* C,
            int c_f32, float* __restrict__ partial) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_chunk, ke = min(K, kb + k_chunk);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = kb; k0 < ke; k0 += BK) {
    // each tile is 128 x 8 elements, 4 per thread; consecutive threads
    // take consecutive addresses in either layout
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int e = tid + c * THREADS;
      {
        const int r = A_T ? (e & 127) : (e >> 3);
        const int kk = A_T ? (e >> 7) : (e & 7);
        const int gm = m0 + r, gk = k0 + kk;
        float v = 0.0f;
        if (gm < M && gk < ke)
          v = round_to<T>(gvd::to_f32(A_T ? A[(size_t)gk * M + gm]
                                          : A[(size_t)gm * K + gk]));
        As[kk][r] = v;
      }
      {
        const int r = B_T ? (e >> 3) : (e & 127);
        const int kk = B_T ? (e & 7) : (e >> 7);
        const int gn = n0 + r, gk = k0 + kk;
        float v = 0.0f;
        if (gn < N && gk < ke)
          v = gvd::to_f32(B_T ? B[(size_t)gn * K + gk]
                              : B[(size_t)gk * N + gn]);
        Bs[kk][r] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], w[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 w0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 w1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
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
      const size_t at = (size_t)m * N + n;
      float v = acc[i][j];
      if (partial != nullptr) {
        partial[(size_t)blockIdx.z * M * N + at] = v;
        continue;
      }
      if (bias != nullptr) v += bias[n];
      if (relu) v = fmaxf(v, 0.0f);
      if (mask != nullptr && !(gvd::to_f32(mask[at]) > 0.0f)) v = 0.0f;
      if (resid != nullptr) v += resid[at];
      if (c_f32)
        static_cast<float*>(C)[at] = v;
      else
        static_cast<T*>(C)[at] = gvd::from_f32<T>(v);
    }
  }
}

// C[i] = sum over z of partial[z][i], z in order.
__global__ void __launch_bounds__(THREADS)
splitk_sum_kernel(const float* __restrict__ partial, float* __restrict__ C,
                  size_t n, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += partial[(size_t)z * n + i];
    C[i] = s;
  }
}

template <typename T, typename TA, bool A_T, bool B_T>
int launch_gemm(const void* A, const void* B, int M, int N, int K,
                int splits, const float* bias, int relu, const void* mask,
                const float* resid, void* C, int c_f32, float* partial,
                cudaStream_t s) {
  const int k_chunk = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  const int nz = (K + k_chunk - 1) / k_chunk;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, nz);
  float* part = nz > 1 ? partial : nullptr;
  if (nz > 1 && (partial == nullptr || !c_f32 || bias != nullptr || relu ||
                 mask != nullptr || resid != nullptr))
    return (int)cudaErrorInvalidValue;
  gemm_kernel<T, TA, A_T, B_T><<<grid, THREADS, 0, s>>>(
      (const TA*)A, (const T*)B, M, N, K, k_chunk, bias, relu,
      (const T*)mask, resid, C, c_f32, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nz == 1) return (int)e;
  const size_t n = (size_t)M * N;
  const int blocks = (int)std::min<size_t>((n + THREADS - 1) / THREADS, 4096);
  splitk_sum_kernel<<<blocks, THREADS, 0, s>>>(partial, (float*)C, n, nz);
  return (int)cudaGetLastError();
}

template <typename T, typename TA>
int gemm_layout(int layout, const void* A, const void* B, int M, int N,
                int K, int splits, const float* bias, int relu,
                const void* mask, const float* resid, void* C, int c_f32,
                float* partial, cudaStream_t s) {
  switch (layout) {
    case 0:   // A (M, K), B (N, K)
      return launch_gemm<T, TA, false, true>(A, B, M, N, K, splits, bias,
                                             relu, mask, resid, C, c_f32,
                                             partial, s);
    case 1:   // A (M, K), B (K, N)
      return launch_gemm<T, TA, false, false>(A, B, M, N, K, splits, bias,
                                              relu, mask, resid, C, c_f32,
                                              partial, s);
    case 2:   // A (K, M), B (K, N)
      return launch_gemm<T, TA, true, false>(A, B, M, N, K, splits, bias,
                                             relu, mask, resid, C, c_f32,
                                             partial, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------ dropout + residual + LN --
// One block per row r = b * R + i of (B * R, D):
//   y = x + drop(a)   (the mask of site salt_base + b, counter i * D + d)
//   normed = (y - mean) / (sigma + eps),  sigma the unbiased std
//   out = gamma * normed + beta, written as f32 (out_f32, optional) and T
// normed (f32) and sigma (per row) are saved for the backward.
template <typename TX, typename T>
__global__ void __launch_bounds__(LN_THREADS)
ln_fwd_kernel(const TX* __restrict__ x, const float* __restrict__ a,
              const long long* __restrict__ seed, uint32_t salt_base, int R,
              float rate, float keep, const float* __restrict__ gamma,
              const float* __restrict__ beta, float* __restrict__ out_f32,
              T* __restrict__ out_t, float* __restrict__ normed,
              float* __restrict__ sigma, int D, float eps) {
  extern __shared__ float v[];
  __shared__ float scratch[32];
  const int row = blockIdx.x;
  const size_t base = (size_t)row * D;
  const bool dropping = rate > 0.0f;
  const uint32_t mix =
      dropping ? gvd::salt_mix(seed, salt_base + (uint32_t)(row / R)) : 0u;
  const uint32_t ctr0 = (uint32_t)(row % R) * (uint32_t)D;
  float s = 0.0f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float ad = a[base + d];
    if (dropping)
      ad = gvd::hash_uniform(mix, ctr0 + (uint32_t)d) >= rate ? ad / keep
                                                               : 0.0f;
    const float y = gvd::to_f32(x[base + d]) + ad;
    v[d] = y;
    s += y;
  }
  const float mean = gvd::block_reduce<false>(s, scratch) / D;
  float ss = 0.0f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float c = v[d] - mean;
    ss += c * c;
  }
  const float sig = sqrtf(gvd::block_reduce<false>(ss, scratch) /
                          max(D - 1, 1));
  const float c = sig + eps;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float n = (v[d] - mean) / c;
    const float o = gamma[d] * n + beta[d];
    normed[base + d] = n;
    if (out_f32 != nullptr) out_f32[base + d] = o;
    out_t[base + d] = gvd::from_f32<T>(o);
  }
  if (threadIdx.x == 0) sigma[row] = sig;
}

// The backward of ln_fwd_kernel's LayerNorm for the gradient g of its
// output (the TPU kernel's _ln_bwd): with dn = g gamma,
//   dy = (dn - mean(dn)) / (sigma + eps)
//        - normed * sum(dn normed) / ((D - 1) max(sigma, 1e-30)),
// written in f32, and drop(dy) with the forward's mask (the gradient of the
// residual branch), also in f32.
template <typename TG>
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_kernel(const TG* __restrict__ g, const float* __restrict__ normed,
              const float* __restrict__ sigma,
              const float* __restrict__ gamma,
              const long long* __restrict__ seed, uint32_t salt_base, int R,
              float rate, float keep, float* __restrict__ dy,
              float* __restrict__ dyd, int D, float eps) {
  extern __shared__ float dn_s[];
  __shared__ float scratch[32];
  const int row = blockIdx.x;
  const size_t base = (size_t)row * D;
  float s1 = 0.0f, s2 = 0.0f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float dn = gvd::to_f32(g[base + d]) * gamma[d];
    dn_s[d] = dn;
    s1 += dn;
    s2 += dn * normed[base + d];
  }
  s1 = gvd::block_reduce<false>(s1, scratch);
  s2 = gvd::block_reduce<false>(s2, scratch);
  const float sig = sigma[row];
  const float c = sig + eps;
  const float t = s2 / ((float)(D - 1) * fmaxf(sig, 1e-30f));
  const float mean_dn = s1 / D;
  const bool dropping = rate > 0.0f;
  const uint32_t mix =
      dropping ? gvd::salt_mix(seed, salt_base + (uint32_t)(row / R)) : 0u;
  const uint32_t ctr0 = (uint32_t)(row % R) * (uint32_t)D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float y = (dn_s[d] - mean_dn) / c - normed[base + d] * t;
    dy[base + d] = y;
    dyd[base + d] =
        !dropping ? y
                  : (gvd::hash_uniform(mix, ctr0 + (uint32_t)d) >= rate
                         ? y / keep : 0.0f);
  }
}

// ---------------------------------------------------------- column sums --
// Pass 1: block (column tile, row chunk) sums its rows of a (and of a * b)
// per column; pass 2 sums the chunks in order.
template <typename TA>
__global__ void __launch_bounds__(THREADS)
colsum_partial_kernel(const TA* __restrict__ a, const float* __restrict__ b,
                      int M, int N, int rows_per, float* __restrict__ p1,
                      float* __restrict__ p2) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= N) return;
  const int r0 = blockIdx.y * rows_per, r1 = min(M, r0 + rows_per);
  float s1 = 0.0f, s2 = 0.0f;
  for (int r = r0; r < r1; ++r) {
    const size_t at = (size_t)r * N + col;
    const float av = gvd::to_f32(a[at]);
    s1 += av;
    if (b != nullptr) s2 += av * b[at];
  }
  p1[(size_t)blockIdx.y * N + col] = s1;
  if (b != nullptr) p2[(size_t)blockIdx.y * N + col] = s2;
}

__global__ void __launch_bounds__(THREADS)
colsum_final_kernel(const float* __restrict__ p1,
                    const float* __restrict__ p2, int chunks, int N,
                    float* __restrict__ out1, float* __restrict__ out2) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= N) return;
  float s1 = 0.0f, s2 = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    s1 += p1[(size_t)c * N + col];
    if (out2 != nullptr) s2 += p2[(size_t)c * N + col];
  }
  out1[col] = s1;
  if (out2 != nullptr) out2[col] = s2;
}

}  // namespace

// C = A op B in one of three layouts (0: A (M,K) B (N,K); 1: A (M,K)
// B (K,N); 2: A (K,M) B (K,N)); dtype is T (B's type, and C's unless
// c_f32), a_f32 says A is f32 (rounded to T as it loads).  splits > 1
// splits K over blocks into `partial` ((splits, M, N) f32 scratch) and
// sums into C (f32, no epilogue).  bias (N,) f32, mask (M, N) T and
// resid (M, N) f32 are optional.
extern "C" int gvd_k5_gemm(int dtype, int a_f32, int layout, const void* A,
                           const void* B, int M, int N, int K, int splits,
                           const void* bias, int relu, const void* mask,
                           const void* resid, void* C, int c_f32,
                           void* partial, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* bi = (const float*)bias;
  const float* re = (const float*)resid;
  float* pa = (float*)partial;
  if (splits < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return gemm_layout<float, float>(layout, A, B, M, N, K, splits, bi, relu,
                                     mask, re, C, c_f32, pa, s);
  if (dtype == 1 && a_f32)
    return gemm_layout<__nv_bfloat16, float>(layout, A, B, M, N, K, splits,
                                             bi, relu, mask, re, C, c_f32,
                                             pa, s);
  if (dtype == 1)
    return gemm_layout<__nv_bfloat16, __nv_bfloat16>(
        layout, A, B, M, N, K, splits, bi, relu, mask, re, C, c_f32, pa, s);
  return (int)cudaErrorInvalidValue;
}

// x (rows, D): T, or f32 when x_f32; a (rows, D) f32; rows = B * R.
// Writes out_t (T), out_f32 (f32, optional), normed (rows, D) and sigma
// (rows,) in f32.
extern "C" int gvd_k5_ln_fwd(int dtype, int x_f32, const void* x,
                             const void* a, const void* seed, int salt_base,
                             int R, float rate, float keep, const void* gamma,
                             const void* beta, void* out_f32, void* out_t,
                             void* normed, void* sigma, int rows, int D,
                             float eps, void* stream) {
  const size_t smem = (size_t)D * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  const long long* sd = (const long long*)seed;
  GVD_DISPATCH(dtype, T, {
    if (x_f32) {
      cudaError_t e = gvd::allow_smem(ln_fwd_kernel<float, T>, smem);
      if (e != cudaSuccess) return (int)e;
      ln_fwd_kernel<float, T><<<rows, LN_THREADS, smem, s>>>(
          (const float*)x, (const float*)a, sd, (uint32_t)salt_base, R, rate,
          keep, (const float*)gamma, (const float*)beta, (float*)out_f32,
          (T*)out_t, (float*)normed, (float*)sigma, D, eps);
    } else {
      cudaError_t e = gvd::allow_smem(ln_fwd_kernel<T, T>, smem);
      if (e != cudaSuccess) return (int)e;
      ln_fwd_kernel<T, T><<<rows, LN_THREADS, smem, s>>>(
          (const T*)x, (const float*)a, sd, (uint32_t)salt_base, R, rate,
          keep, (const float*)gamma, (const float*)beta, (float*)out_f32,
          (T*)out_t, (float*)normed, (float*)sigma, D, eps);
    }
  });
  return (int)cudaGetLastError();
}

// g (rows, D): T, or f32 when g_f32.  Writes dy and dyd (rows, D) f32.
extern "C" int gvd_k5_ln_bwd(int dtype, int g_f32, const void* g,
                             const void* normed, const void* sigma,
                             const void* gamma, const void* seed,
                             int salt_base, int R, float rate, float keep,
                             void* dy, void* dyd, int rows, int D, float eps,
                             void* stream) {
  const size_t smem = (size_t)D * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  const long long* sd = (const long long*)seed;
  GVD_DISPATCH(dtype, T, {
    if (g_f32) {
      cudaError_t e = gvd::allow_smem(ln_bwd_kernel<float>, smem);
      if (e != cudaSuccess) return (int)e;
      ln_bwd_kernel<float><<<rows, LN_THREADS, smem, s>>>(
          (const float*)g, (const float*)normed, (const float*)sigma,
          (const float*)gamma, sd, (uint32_t)salt_base, R, rate, keep,
          (float*)dy, (float*)dyd, D, eps);
    } else {
      cudaError_t e = gvd::allow_smem(ln_bwd_kernel<T>, smem);
      if (e != cudaSuccess) return (int)e;
      ln_bwd_kernel<T><<<rows, LN_THREADS, smem, s>>>(
          (const T*)g, (const float*)normed, (const float*)sigma,
          (const float*)gamma, sd, (uint32_t)salt_base, R, rate, keep,
          (float*)dy, (float*)dyd, D, eps);
    }
  });
  return (int)cudaGetLastError();
}

// out1[j] = sum_i a[i, j]; out2[j] = sum_i a[i, j] b[i, j] when b (f32) is
// given.  a (M, N): T (dtype), or f32 when a_f32.  partial: 2 * chunks * N
// f32 scratch.
extern "C" int gvd_k5_colsum(int dtype, int a_f32, const void* a,
                             const void* b, int M, int N, int chunks,
                             void* partial, void* out1, void* out2,
                             void* stream) {
  if (chunks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows_per = (M + chunks - 1) / chunks;
  float* p1 = (float*)partial;
  float* p2 = p1 + (size_t)chunks * N;
  dim3 grid((N + THREADS - 1) / THREADS, chunks);
  GVD_DISPATCH(dtype, T, {
    if (a_f32)
      colsum_partial_kernel<float><<<grid, THREADS, 0, s>>>(
          (const float*)a, (const float*)b, M, N, rows_per, p1, p2);
    else
      colsum_partial_kernel<T><<<grid, THREADS, 0, s>>>(
          (const T*)a, (const float*)b, M, N, rows_per, p1, p2);
  });
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  colsum_final_kernel<<<(N + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      p1, p2, chunks, N, (float*)out1, b != nullptr ? (float*)out2 : nullptr);
  return (int)cudaGetLastError();
}
