// The whole obj_interact encoder layer in training, forward and backward,
// with dropout at three sites (K5): its GEMM, LayerNorm passes and column
// sums (the attention is K4's).
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
// orders them and plans each GEMM: k5_gemm_plan):
//  * forward: gvd_k5_gemm for Q, K, V, Wo, W1 (+ b1, ReLU) and W2 (+ b2);
//    K4's flash forward (csrc/attention_mma.cu in bf16,
//    csrc/attention_tf32x3.cu in f32) with K5's prob salts, which keeps
//    each (R, R) tile on chip and saves the row log-sum-exp; gvd_k5_ln_fwd
//    for dropout + residual + LayerNorm, which saves each row's normalised
//    values and sigma.
//  * backward: gvd_k5_ln_bwd (the LayerNorm backward of the TPU kernel's
//    _ln_bwd, max(sigma, 1e-30) included, and the residual site's mask);
//    gvd_k5_gemm in its other two layouts, dY W for the data gradients
//    (with the ReLU mask or a residual added in the epilogue) and A^T B
//    over the B * R rows for the weight gradients (split over the rows
//    into f32 partials, then summed in a fixed order); K4's backward with
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
// and output.  So every product runs on one GEMM with three layouts:
//  * bf16, on the tensor cores: wgmma fed by TMA through an mbarrier ring
//    of three 128 x 64 (A) + 128 x 64 (B) stages in the 128-byte swizzle;
//    one producer warp (one thread starts the loads) and two consumer
//    warpgroups of 64 x 128 outputs each, two blocks an SM, so that one
//    block's epilogue overlaps the other's products.  wgmma reads a
//    K-major or an MN-major tile as it lies, so A^T B and dY W need no
//    transposing copy: TMA loads each tile in its own layout and the
//    descriptor says which way round it is.  Rows past M, N or K arrive as zeros from the
//    tensor map's bounds.  A bf16 operand's rows must be 16 bytes apart
//    (the wrapper pads them where they are not); an f32 gradient enters a
//    product as the bf16 copy that its producer wrote beside it (the
//    LayerNorm backward, or the dz1 product's epilogue), the same
//    rounding at the same point as the TPU kernel's cast.
//  * f32, on the SIMT units: K1's f32 structure (128 x 128 tiles, an 8 x 8
//    block of outputs per thread, K in steps of 16 through two
//    shared-memory buffers that cp.async fills, the next step loading
//    during the current step's products), its loads along whichever
//    dimension of each operand is contiguous.  TF32 would miss the f32
//    bars.
// Both routes end in the same epilogue (gvd::Epilogue), from the
// accumulators: bias, ReLU, the hid > 0 mask, a residual that may alias C,
// f32 or T out, and an optional bf16 copy.

#include <algorithm>

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

using gvd::bf16;
using gvd::cp_async4;
using gvd::cp_async_commit;
using gvd::cp_async_wait;

constexpr int THREADS = 256;
constexpr int LN_THREADS = 256;

// ------------------------------------------------------- f32 SIMT GEMM --
// C (M, N) = sum over l in block z's K range of Aop(i, l) Bop(l, j):
//   A_MN false: Aop(i, l) = A[i * lda + l]   (A is (M, K))
//   A_MN true:  Aop(i, l) = A[l * lda + i]   (A is (K, M))
//   B_MN false: Bop(l, j) = B[j * ldb + l]   (B is (N, K), PyTorch's weights)
//   B_MN true:  Bop(l, j) = B[l * ldb + j]   (B is (K, N))
// Tiles are stored k-major (As[k][m]) so the products read float4s; each
// 4-byte cp.async writes one element to its place, lanes running along
// the operand's contiguous dimension.
constexpr int SBM = 128, SBN = 128, SBK = 16, SLD = SBM + 4;

template <bool A_MN, bool B_MN>
__global__ void __launch_bounds__(THREADS)
gemm_f32_kernel(const float* __restrict__ A, int lda,
                const float* __restrict__ B, int ldb, int K, int k_split,
                gvd::Epilogue<float> ep) {
  __shared__ __align__(16) float As[2][SBK][SLD];
  __shared__ __align__(16) float Bs[2][SBK][SLD];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int M = ep.M, N = ep.N;
  const int m0 = blockIdx.y * SBM, n0 = blockIdx.x * SBN;
  const int kb = blockIdx.z * k_split, ke = min(K, kb + k_split);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  auto load = [&](int st, int k0) {
#pragma unroll
    for (int i = 0; i < SBM * SBK / THREADS; ++i) {
      const int e = tid + i * THREADS;
      {
        const int r = A_MN ? e % SBM : e / SBK;
        const int kk = A_MN ? e / SBM : e % SBK;
        const int gm = m0 + r, gk = k0 + kk;
        const bool ok = gm < M && gk < ke;
        const float* src = A_MN ? A + (size_t)gk * lda + gm
                                : A + (size_t)gm * lda + gk;
        cp_async4(&As[st][kk][r], ok ? src : A, ok);
      }
      {
        const int r = B_MN ? e % SBN : e / SBK;
        const int kk = B_MN ? e / SBN : e % SBK;
        const int gn = n0 + r, gk = k0 + kk;
        const bool ok = gn < N && gk < ke;
        const float* src = B_MN ? B + (size_t)gk * ldb + gn
                                : B + (size_t)gn * ldb + gk;
        cp_async4(&Bs[st][kk][r], ok ? src : B, ok);
      }
    }
  };

  const int nk = ke > kb ? (ke - kb + SBK - 1) / SBK : 0;
  if (nk > 0) load(0, kb);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) & 1, kb + (kt + 1) * SBK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float a[8], w[8];
      gvd::load4(&As[st][kk][ty * 4], a);
      gvd::load4(&As[st][kk][64 + ty * 4], a + 4);
      gvd::load4(&Bs[st][kk][tx * 4], w);
      gvd::load4(&Bs[st][kk][64 + tx * 4], w + 4);
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
      if (n < N) ep.store(blockIdx.z, m, n, acc[i][j]);
    }
  }
}

// ---------------------------------------------- bf16 tensor-core GEMM --
// The same C, with Aop and Bop as above, from 128 x 128 output tiles.
// Stage s of the ring holds A's tile (128 rows of M by 64 of K) and then
// B's (128 of N by 64 of K), each in the 128-byte swizzle:
//  * K-major (A (M, K), B (N, K)): one TMA box of 128 rows x 64 k, rows
//    128 bytes apart; consumer c's 64 rows start 8192 bytes in.
//  * MN-major (A (K, M), B (K, N)): two boxes of 64 k-rows x 64 elements
//    along M or N, the second 8192 bytes after the first.
// Warpgroups 0 and 1 each multiply 64 rows of the tile by its 128
// columns with m64n128k16 wgmma, keep one stage's products in flight, and
// release a stage (empty[s], one arrival per consumer) once its products
// have completed; warp 8 loads (one thread starts every TMA copy; full[s]
// counts the bytes in).  Two blocks an SM, so that one block's epilogue
// and first loads overlap the other's products.
constexpr int TBM = 128, TBN = 128, TBK = 64, STAGES = 3;
constexpr int TC_THREADS = 288, TC_BLOCKS = 2;
constexpr int A_BYTES = TBM * TBK * 2, B_BYTES = TBN * TBK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int BOX64 = 64 * TBK * 2;         // 64 rows (or columns) of a tile
constexpr size_t TC_SMEM = (size_t)STAGES * STAGE_BYTES + 1024;

template <bool A_MN, bool B_MN>
__global__ void __launch_bounds__(TC_THREADS, TC_BLOCKS)
gemm_tc_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b, int K, int k_split,
               gvd::Epilogue<bf16> ep) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // the swizzle atoms must start on 1024-byte boundaries
  uint8_t* tiles =
      smem_raw + ((1024 - (gvd::smem_addr(smem_raw) & 1023)) & 1023);
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int kb = blockIdx.z * k_split, ke = min(K, kb + k_split);
  const int nk = ke > kb ? (ke - kb + TBK - 1) / TBK : 0;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      gvd::mbar_init(&full[s], 1);
      gvd::mbar_init(&empty[s], 2);
    }
    gvd::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {                                   // the producer warp
    if (threadIdx.x == 256) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) gvd::mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        uint8_t* a = tiles + s * STAGE_BYTES;
        uint8_t* b = a + A_BYTES;
        const int k = kb + i * TBK;
        gvd::mbar_expect_tx(&full[s], STAGE_BYTES);
        if (A_MN) {
          gvd::tma_load_2d(a, &map_a, m0, k, &full[s]);
          gvd::tma_load_2d(a + BOX64, &map_a, m0 + 64, k, &full[s]);
        } else {
          gvd::tma_load_2d(a, &map_a, k, m0, &full[s]);
        }
        if (B_MN) {
          gvd::tma_load_2d(b, &map_b, n0, k, &full[s]);
          gvd::tma_load_2d(b + BOX64, &map_b, n0 + 64, k, &full[s]);
        } else {
          gvd::tma_load_2d(b, &map_b, k, n0, &full[s]);
        }
      }
    }
    return;
  }

  const int c = wg;                                // a consumer
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    gvd::mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* a = tiles + s * STAGE_BYTES + c * BOX64;
    const uint8_t* b = tiles + s * STAGE_BYTES + A_BYTES;
    gvd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk) {
      // 16 k: 32 bytes along a K-major row, 16 rows of an MN-major tile
      const uint64_t da = A_MN ? gvd::wgmma_desc(a + kk * 2048, BOX64, 1024)
                               : gvd::wgmma_desc(a + kk * 32, 16, 1024);
      const uint64_t db = B_MN ? gvd::wgmma_desc(b + kk * 2048, BOX64, 1024)
                               : gvd::wgmma_desc(b + kk * 32, 16, 1024);
      gvd::wgmma_m64n128k16<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db);
    }
    gvd::wgmma_commit();
    gvd::wgmma_wait<1>();              // the previous stage's products
    if (i > 0 && threadIdx.x % 128 == 0)
      gvd::mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  gvd::wgmma_wait<0>();

  const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
  const int row = m0 + c * 64 + w * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + j * 8 + (lane % 4) * 2;
    ep.store2(blockIdx.z, row, n, acc[4 * j], acc[4 * j + 1]);
    ep.store2(blockIdx.z, row + 8, n, acc[4 * j + 2], acc[4 * j + 3]);
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

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 matrix of `outer` rows of `inner` elements, rows `ld` elements
// apart, read in boxes of box_outer rows by 64 elements (128 bytes) in
// the 128-byte swizzle; outside the matrix a box reads zeros.
bool tile_map(CUtensorMap* map, const void* p, int inner, int outer, int ld,
              int box_outer) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool A_MN, bool B_MN>
int launch_tc(const void* A, int lda, const void* B, int ldb, int M, int N,
              int K, int splits, int k_split, const gvd::Epilogue<bf16>& ep,
              cudaStream_t s) {
  CUtensorMap map_a, map_b;
  if (!tile_map(&map_a, A, A_MN ? M : K, A_MN ? K : M, lda,
                A_MN ? TBK : TBM) ||
      !tile_map(&map_b, B, B_MN ? N : K, B_MN ? K : N, ldb,
                B_MN ? TBK : TBN))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = gvd::allow_smem(gemm_tc_kernel<A_MN, B_MN>, TC_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM, splits);
  gemm_tc_kernel<A_MN, B_MN><<<grid, TC_THREADS, TC_SMEM, s>>>(
      map_a, map_b, K, k_split, ep);
  return (int)cudaGetLastError();
}

template <bool A_MN, bool B_MN>
int launch_f32(const void* A, int lda, const void* B, int ldb, int M, int N,
               int K, int splits, int k_split,
               const gvd::Epilogue<float>& ep, cudaStream_t s) {
  dim3 grid((N + SBN - 1) / SBN, (M + SBM - 1) / SBM, splits);
  gemm_f32_kernel<A_MN, B_MN><<<grid, THREADS, 0, s>>>(
      (const float*)A, lda, (const float*)B, ldb, K, k_split, ep);
  return (int)cudaGetLastError();
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
// residual branch), also in f32 and, when dyd_t is given, as bf16 (the
// operand of its products).
template <typename TG>
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_kernel(const TG* __restrict__ g, const float* __restrict__ normed,
              const float* __restrict__ sigma,
              const float* __restrict__ gamma,
              const long long* __restrict__ seed, uint32_t salt_base, int R,
              float rate, float keep, float* __restrict__ dy,
              float* __restrict__ dyd, bf16* __restrict__ dyd_t, int D,
              float eps) {
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
    const float yd =
        !dropping ? y
                  : (gvd::hash_uniform(mix, ctr0 + (uint32_t)d) >= rate
                         ? y / keep : 0.0f);
    dy[base + d] = y;
    dyd[base + d] = yd;
    if (dyd_t != nullptr) dyd_t[base + d] = __float2bfloat16(yd);
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

// C (M, N) = A op B in one of three layouts: 0 (NT): A (M, K), B (N, K);
// 1 (NN): A (M, K), B (K, N); 2 (TN): A (K, M), B (K, N); rows of A and B
// lda and ldb elements apart.  dtype 1: A, B bf16 on the tensor cores
// (lda, ldb multiples of 8, A and B 16-byte aligned, k_split a multiple
// of 64); dtype 0: f32 on the SIMT units (k_split a multiple of 16).  Block
// z of `splits` sums K rows [z k_split, (z + 1) k_split); with splits > 1
// they go to `partial` ((splits, M, N) f32 scratch) and are summed into C
// (f32, no epilogue).  bias (N,) f32, mask (M, N) in the compute dtype,
// resid (M, N) f32 (may be C) and c2 (M, N) bf16 (a copy of the output;
// bf16 only) are optional; C is f32 when c_f32, else the compute dtype.
extern "C" int gvd_k5_gemm(int dtype, int layout, const void* A, int lda,
                           const void* B, int ldb, int M, int N, int K,
                           int splits, int k_split, const void* bias,
                           int relu, const void* mask, const void* resid,
                           void* C, int c_f32, void* c2, void* partial,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M < 1 || N < 1 || K < 1 || splits < 1 || k_split < 1 ||
      (long long)splits * k_split < K || layout < 0 || layout > 2)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (partial == nullptr || !c_f32 || bias != nullptr ||
                     relu || mask != nullptr || resid != nullptr ||
                     c2 != nullptr))
    return (int)cudaErrorInvalidValue;
  float* part = splits > 1 ? (float*)partial : nullptr;
  const float* bi = (const float*)bias;
  const float* re = (const float*)resid;
  int e;
  if (dtype == 1) {
    if (k_split % TBK != 0 || lda % 8 != 0 || ldb % 8 != 0 ||
        (uintptr_t)A % 16 != 0 || (uintptr_t)B % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const gvd::Epilogue<bf16> ep{bi, relu, (const bf16*)mask, re, C,
                                 c_f32, (bf16*)c2, part, M, N};
    e = layout == 0 ? launch_tc<false, false>(A, lda, B, ldb, M, N, K,
                                              splits, k_split, ep, s)
      : layout == 1 ? launch_tc<false, true>(A, lda, B, ldb, M, N, K,
                                             splits, k_split, ep, s)
                    : launch_tc<true, true>(A, lda, B, ldb, M, N, K, splits,
                                            k_split, ep, s);
  } else if (dtype == 0) {
    if (k_split % SBK != 0 || c2 != nullptr)
      return (int)cudaErrorInvalidValue;
    const gvd::Epilogue<float> ep{bi, relu, (const float*)mask, re, C,
                                  c_f32, nullptr, part, M, N};
    e = layout == 0 ? launch_f32<false, false>(A, lda, B, ldb, M, N, K,
                                               splits, k_split, ep, s)
      : layout == 1 ? launch_f32<false, true>(A, lda, B, ldb, M, N, K,
                                              splits, k_split, ep, s)
                    : launch_f32<true, true>(A, lda, B, ldb, M, N, K,
                                             splits, k_split, ep, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != 0 || splits == 1) return e;
  const size_t n = (size_t)M * N;
  const int blocks = (int)std::min<size_t>((n + THREADS - 1) / THREADS, 4096);
  splitk_sum_kernel<<<blocks, THREADS, 0, s>>>(part, (float*)C, n, splits);
  return (int)cudaGetLastError();
}

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

// g (rows, D): T, or f32 when g_f32.  Writes dy and dyd (rows, D) f32,
// and dyd_t (rows, D) bf16 when it is given.
extern "C" int gvd_k5_ln_bwd(int dtype, int g_f32, const void* g,
                             const void* normed, const void* sigma,
                             const void* gamma, const void* seed,
                             int salt_base, int R, float rate, float keep,
                             void* dy, void* dyd, void* dyd_t, int rows,
                             int D, float eps, void* stream) {
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
          (float*)dy, (float*)dyd, (bf16*)dyd_t, D, eps);
    } else {
      cudaError_t e = gvd::allow_smem(ln_bwd_kernel<T>, smem);
      if (e != cudaSuccess) return (int)e;
      ln_bwd_kernel<T><<<rows, LN_THREADS, smem, s>>>(
          (const T*)g, (const float*)normed, (const float*)sigma,
          (const float*)gamma, sd, (uint32_t)salt_base, R, rate, keep,
          (float*)dy, (float*)dyd, (bf16*)dyd_t, D, eps);
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
