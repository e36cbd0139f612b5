// K4's training attention in bf16 on Hopper's tensor cores, forward and
// backward; K5's attention and K7's bf16 launch run the same kernels.
//
// Replaces, for bf16 inputs, grounded_video_description_tpu/ops/pallas/
// attention_train.py::mha_probs_dropout (_fwd_kernel, _bwd_kernel) and
// mha.py::flash_self_attention.  The function is csrc/attention_train.cu's
// (see its note): per (batch row b, head h) P = softmax(q_h k_h^T *
// inv_scale), P~ = P * keep / (1 - rate) with the JAX counter hash bit for
// bit, o_h = P~ v_h, the row log-sum-exp in f32, and the FlashAttention-2
// backward.  f32 inputs run csrc/attention_tf32x3.cu: the same skeleton
// with each product split into three TF32 products (3xTF32), since one
// plain TF32 product keeps ~11 bits and would miss the f32 bars.  The
// repack below serves both dtypes.
//
// What bounds it on an H100: the tensor cores.  At the flagship microbatch
// (B = 30, R = 1000, six heads of 171) the forward is 2 and the backward 7
// products of R x R x 176 per (row, head): ~127 and ~440 GFLOP, 0.13 and
// 0.45 ms at the 989 TFLOP/s bf16 peak, against ~60 MB per (B, R, D)
// tensor.  Then the f32 work per score (exp, the dropout hash: one fmix32
// per element), which runs on the SIMT units beside the products.
// What the design does about it:
//  * Head-major padded operands.  A head starts at column 171 h, only
//    2-byte aligned for odd h, so a repack kernel first copies q, k, v (and
//    dO) into (B, H, Rt, dp) bf16: rows padded to 64 (Rt), the width to dp
//    (176 at flagship), the pads zero, which changes no product.  Every
//    row is then 16-byte aligned, and tiles come in by 16-byte cp.async.
//    The repack moves ~0.4 GB in the forward and ~0.5 GB in the backward.
//    The backward repacks q, k and v again instead of keeping the
//    forward's packed copies (~0.2 GB a call at flagship) alive until it
//    runs: memory traded for ~0.2 ms a call.
//    The epilogues write o, dq, dk, dv straight into the (B, R, D) columns.
//  * Products on mma.sync.m16n8k16 (bf16 in, f32 accumulate), operands
//    from shared memory by ldmatrix (ldmatrix.trans where the contraction
//    runs along the rows: V in P~ V, dO and Q in dV and dK, K in dQ).
//    Tile rows are dp + 8 elements apart (an odd number of 16-byte units),
//    so the eight rows an ldmatrix reads hit distinct banks.
//  * Forward (FlashAttention-2): 4 warps, each owning 16 query rows of a
//    64-query tile, Q held in registers as A fragments; 64-key tiles, the
//    next K tile loaded while P~ V runs and the V tile while Q K^T runs.
//    The online softmax runs in f32 on the accumulator fragments (row max
//    and sum by quad shuffles), the hash on each fragment element's own
//    (query, key); P~ goes to bf16 A fragments in registers.
//  * Backward: delta = rowsum(dO * o) (csrc/attention_train.cu), then one
//    kernel per 64-key tile (K, V resident, Q and dO streamed through a
//    two-stage ring) for dK and dV, and one per 64-query tile (Q and dO
//    held in registers, K and V streamed) for dQ.  8 warps: each computes
//    a 16 x 32 block of the scores and of dP, writes P~ and dS in bf16 to
//    shared memory, then accumulates 16 rows x half the head dims of its
//    outputs, so the dK and dV accumulators of a 176-wide head take 88
//    registers a thread.  No atomics: a second call gives the same bits.
// Rounding: scores, the softmax statistics, lse, delta and every
// elementwise step are f32; P~ and dS enter the tensor cores in bf16, where
// the JAX TPU kernel rounds them too (p and ds cast to the compute dtype).

#include "attention_mma.cuh"
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int TILE = gvd::ATTN_TILE;  // query and key rows per tile
constexpr int FWD_THREADS = 128;   // 4 warps x 16 query rows
constexpr int BWD_THREADS = 256;   // 8 warps
constexpr int ST_LD = TILE + 8;    // row stride of a 64 x 64 bf16 P~ or dS tile
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and register i receives matrix i (row lane / 4, elements
// 2 (lane % 4) + {0, 1}; transposed with _t).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t r[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16).
// Fragments, g = lane / 4, t = lane % 4: a[0] row g, cols 2t + {0, 1};
// a[1] row g + 8; a[2], a[3] the same 8 columns on; b0 rows (k) 2t + {0,
// 1} of column (n) g, b1 rows 2t + 8 + {0, 1}; c[0], c[1] row g, cols
// 2t + {0, 1}; c[2], c[3] row g + 8.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as one register of two bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// A 64-row packed tile (rows dp apart) into shared memory (rows dp + 8
// apart), 16 bytes per copy.
template <int DP, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src) {
  constexpr int CH = DP / 8, LDS = DP + 8;
  for (int c = threadIdx.x; c < TILE * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    cp_async16(dst + r * LDS + col, src + (size_t)r * DP + col);
  }
}

// A fragments of rows r0.. r0 + 15, columns c0.. c0 + 15 of a row-major
// tile with row stride ld.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* tile,
                                       int ld, int r0, int c0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two n-tiles, n0.. n0 + 15, over k0.. k0 + 15, from a tile
// stored (n, k) row-major (K in Q K^T): b[0], b[1] for n0, b[2], b[3] for
// n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t b[4], const bf16* tile,
                                          int ld, int n0, int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}

// The same from a tile stored (k, n) row-major (V in P~ V).
__device__ __forceinline__ void load_b_kn(uint32_t b[4], const bf16* tile,
                                          int ld, int k0, int n0, int lane) {
  ldsm_x4_t(b, tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0 +
                   (lane >> 4) * 8);
}

// One n-tile, n0.. n0 + 7, from a (k, n) tile.
__device__ __forceinline__ void load_b_kn8(uint32_t b[2], const bf16* tile,
                                           int ld, int k0, int n0, int lane) {
  ldsm_x2_t(b, tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------------------------ pack --
template <typename T>
struct PackArgs {
  const T* src[4];
  T* dst[4];
};

// dst (B, H, Rt, dp) from src (B, R, D) whose rows are ld elements apart
// (ld = D, or 3D for K1's (B, R, 3D) QKV buffer, src then pointing at the
// q, k or v columns): head h is columns [h hs, h hs + dh); rows at or past
// R and columns at or past dh are zero.  One thread per 16 packed bytes
// (8 bf16 or 4 f32 elements, one 16-byte store); blockIdx.y picks the
// tensor.
template <typename T>
__global__ void __launch_bounds__(256)
pack_kernel(PackArgs<T> a, int B, int R, int Rt, int D, int hs, int H,
            int dp, int ld) {
  constexpr int VEC = 16 / sizeof(T);
  const int CH = dp / VEC;
  const size_t n = (size_t)B * H * Rt * CH;
  const T* src = a.src[blockIdx.y];
  T* dst = a.dst[blockIdx.y];
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % CH);
    const size_t row = i / CH;
    const int r = (int)(row % Rt), bh = (int)(row / Rt);
    const int b = bh / H, h = bh % H;
    const int c0 = h * hs, dh = min(hs, D - c0);
    __align__(16) T v[VEC];
    const T* s = src + ((size_t)b * R + r) * ld + c0;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int d = c * VEC + e;
      v[e] = r < R && d < dh ? s[d] : gvd::from_f32<T>(0.0f);
    }
    *reinterpret_cast<uint4*>(dst + row * dp + c * VEC) =
        *reinterpret_cast<const uint4*>(v);
  }
}

template <typename T>
int pack_heads_as(int n, const void* const* src, void* dst, int B, int R,
                  int D, int hs, int ld, cudaStream_t s) {
  const int dp = gvd::packed_width(hs);
  if (n < 1 || n > 4 || dp == 0) return (int)cudaErrorInvalidValue;
  const int H = (D + hs - 1) / hs, Rt = gvd::rows_padded(R);
  const size_t per = (size_t)B * H * Rt * dp;
  PackArgs<T> a{};
  for (int i = 0; i < n; ++i) {
    a.src[i] = (const T*)src[i];
    a.dst[i] = (T*)dst + i * per;
  }
  const size_t want = (per / (16 / sizeof(T)) + 255) / 256;
  const int blocks = want < 132 * 16 ? (int)want : 132 * 16;
  pack_kernel<T><<<dim3(blocks, n), 256, 0, s>>>(a, B, R, Rt, D, hs, H, dp,
                                                  ld);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- forward --
// One block per (64-query tile, head, row): warp w owns queries 16 w.. of
// the tile.
template <int DP, bool DROP>
__global__ void __launch_bounds__(FWD_THREADS, 2)
fwd_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ kp,
           const bf16* __restrict__ vp, bf16* __restrict__ out,
           float* __restrict__ lse, const long long* __restrict__ seed, int R,
           int Rt, int D, int hs, uint32_t salt_base, int salt_mul,
           float inv_scale, float rate) {
  constexpr int LDS = DP + 8, KS = DP / 16, NT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TILE * LDS;
  bf16* Vs = Ks + TILE * LDS;
  const int q0 = blockIdx.x * TILE, head = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t hb = ((size_t)b * gridDim.y + head) * Rt * DP;
  const bf16* kh = kp + hb;
  const bf16* vh = vp + hb;
  const int c0 = head * hs, dh = min(hs, D - c0);
  const int Rp = (R + 127) / 128 * 128;
  const bool dropping = DROP && rate > 0.0f;
  const float inv_keep = 1.0f / (1.0f - rate);
  const uint32_t mix =
      dropping ? gvd::head_mix(seed, b, head, salt_base, salt_mul) : 0u;
  const float sl2 = inv_scale * LOG2E;      // scores in log2 units
  const int row0 = q0 + warp * 16 + g;      // this thread's rows: +0, +8

  load_tile<DP, FWD_THREADS>(Qs, qp + hb + (size_t)q0 * DP);
  load_tile<DP, FWD_THREADS>(Ks, kh);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    load_a(qf[kk], Qs, LDS, warp * 16, kk * 16, lane);

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.0f, 0.0f};

  const int nkt = Rt / TILE;
  for (int j = 0; j < nkt; ++j) {
    const int k0 = j * TILE;
    load_tile<DP, FWD_THREADS>(Vs, vh + (size_t)k0 * DP);
    cp_async_commit();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        load_b_nk(bk, Ks, LDS, np * 16, kk * 16, lane);
        mma(s[2 * np], qf[kk], bk[0], bk[1]);
        mma(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }

    // online softmax over this key tile (every tile holds a key < R, so
    // the new max is finite); the sum takes the undropped probs
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        s[n][e] = key < R ? s[n][e] * sl2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      corr[i] = exp2f(m_r[i] - mx[i]);
      m_r[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[n][e] - m_r[e >> 1]);
        sum[e >> 1] += p;
        if (dropping)
          p *= gvd::keep_scale(mix, row0 + 8 * (e >> 1),
                          k0 + n * 8 + 2 * t + (e & 1), Rp, rate, inv_keep);
        s[n][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + quad_sum(sum[i]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pf[kk][0] = pack2(s[2 * kk][0], s[2 * kk][1]);
      pf[kk][1] = pack2(s[2 * kk][2], s[2 * kk][3]);
      pf[kk][2] = pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[kk][3] = pack2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    cp_async_wait_all();
    __syncthreads();                  // V tile in; every warp done with K
    if (j + 1 < nkt) {
      load_tile<DP, FWD_THREADS>(Ks, kh + (size_t)(k0 + TILE) * DP);
      cp_async_commit();
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bv[4];
        load_b_kn(bv, Vs, LDS, kk * 16, np * 16, lane);
        mma(o[2 * np], pf[kk], bv[0], bv[1]);
        mma(o[2 * np + 1], pf[kk], bv[2], bv[3]);
      }
    cp_async_wait_all();
    __syncthreads();                  // next K tile in; every warp done with V
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= R) continue;
    const float inv_l = 1.0f / l_r[i];
    bf16* orow = out + ((size_t)b * R + r) * D + c0;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * t + e;
        if (d < dh) orow[d] = __float2bfloat16(o[n][2 * i + e] * inv_l);
      }
    if (lse != nullptr && t == 0)
      lse[((size_t)b * gridDim.y + head) * R + r] =
          (m_r[i] + log2f(l_r[i])) * (1.0f / LOG2E);
  }
}

// -------------------------------------------------------------- backward --
// One block per (64-key tile, head, row), walking every query tile.  Warp
// w: keys 16 (w % 4).. of the tile; queries 32 (w / 4).. of each query tile
// for S^T and dP^T; head dims (w / 4) dp / 2.. for dK and dV.
template <int DP>
__global__ void __launch_bounds__(BWD_THREADS, 1)
bwd_kv_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ kp,
              const bf16* __restrict__ vp, const bf16* __restrict__ dop,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const long long* __restrict__ seed, bf16* __restrict__ dk,
              bf16* __restrict__ dv, int R, int Rt, int D, int hs,
              uint32_t salt_base, int salt_mul, float inv_scale, float rate) {
  constexpr int LDS = DP + 8, KS = DP / 16, HN = DP / 16, HALF = DP / 2;
  constexpr int TS = TILE * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TS;
  bf16* Qs = Vs + TS;                 // two stages
  bf16* dOs = Qs + 2 * TS;            // two stages
  bf16* Pt = dOs + 2 * TS;            // (key, query): P~
  bf16* dSt = Pt + TILE * ST_LD;      // (key, query): dS
  const int k0 = blockIdx.x * TILE, head = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wk = warp & 3, wh = warp >> 2;
  const size_t hb = ((size_t)b * gridDim.y + head) * Rt * DP;
  const size_t hrow = ((size_t)b * gridDim.y + head) * R;
  const int c0 = head * hs, dh = min(hs, D - c0);
  const int Rp = (R + 127) / 128 * 128;
  const bool dropping = rate > 0.0f;
  const float inv_keep = 1.0f / (1.0f - rate);
  const uint32_t mix =
      dropping ? gvd::head_mix(seed, b, head, salt_base, salt_mul) : 0u;
  const float sl2 = inv_scale * LOG2E;
  const int key0 = k0 + wk * 16 + g;  // this thread's keys: +0, +8

  load_tile<DP, BWD_THREADS>(Ks, kp + hb + (size_t)k0 * DP);
  load_tile<DP, BWD_THREADS>(Vs, vp + hb + (size_t)k0 * DP);
  load_tile<DP, BWD_THREADS>(Qs, qp + hb);
  load_tile<DP, BWD_THREADS>(dOs, dop + hb);
  cp_async_commit();

  float adk[HN][4], adv[HN][4];
#pragma unroll
  for (int n = 0; n < HN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.0f;

  const int nqt = Rt / TILE;
  for (int i = 0; i < nqt; ++i) {
    const int q0 = i * TILE;
    const bf16* Qb = Qs + (i & 1) * TS;
    const bf16* dOb = dOs + (i & 1) * TS;
    cp_async_wait_all();
    __syncthreads();          // tile i in; every warp done with tile i - 1
    if (i + 1 < nqt) {
      const size_t at = hb + (size_t)(q0 + TILE) * DP;
      load_tile<DP, BWD_THREADS>(Qs + ((i + 1) & 1) * TS, qp + at);
      load_tile<DP, BWD_THREADS>(dOs + ((i + 1) & 1) * TS, dop + at);
      cp_async_commit();
    }

    float st[4][4], dpt[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, Ks, LDS, wk * 16, kk * 16, lane);
      load_a(va, Vs, LDS, wk * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bq[4], bo[4];
        load_b_nk(bq, Qb, LDS, wh * 32 + np * 16, kk * 16, lane);
        load_b_nk(bo, dOb, LDS, wh * 32 + np * 16, kk * 16, lane);
        mma(st[2 * np], ka, bq[0], bq[1]);
        mma(st[2 * np + 1], ka, bq[2], bq[3]);
        mma(dpt[2 * np], va, bo[0], bo[1]);
        mma(dpt[2 * np + 1], va, bo[2], bo[3]);
      }
    }

    // P = exp(s - lse) and the mask on each element (key, query); P~ and
    // dS = P (keep dP~ - delta) inv_scale to shared memory in bf16
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int qc = wh * 32 + n * 8 + 2 * t;     // query within the tile
      float l2[2], dl[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qq = q0 + qc + e;
        l2[e] = qq < R ? lse[hrow + qq] * LOG2E : 0.0f;
        dl[e] = qq < R ? delta[hrow + qq] : 0.0f;
      }
      float pd[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * (e >> 1), qq = q0 + qc + (e & 1);
        const bool ok = key < R && qq < R;
        const float p = ok ? exp2f(st[n][e] * sl2 - l2[e & 1]) : 0.0f;
        const float mk =
            dropping ? gvd::keep_scale(mix, qq, key, Rp, rate, inv_keep)
                     : 1.0f;
        pd[e] = p * mk;
        ds[e] = p * (mk * dpt[n][e] - dl[e & 1]) * inv_scale;
      }
      const int r = wk * 16 + g;
      *reinterpret_cast<uint32_t*>(Pt + r * ST_LD + qc) = pack2(pd[0], pd[1]);
      *reinterpret_cast<uint32_t*>(Pt + (r + 8) * ST_LD + qc) =
          pack2(pd[2], pd[3]);
      *reinterpret_cast<uint32_t*>(dSt + r * ST_LD + qc) = pack2(ds[0], ds[1]);
      *reinterpret_cast<uint32_t*>(dSt + (r + 8) * ST_LD + qc) =
          pack2(ds[2], ds[3]);
    }
    __syncthreads();

    // dV += P~^T dO, dK += dS^T Q over this warp's half of the head dims
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4], da[4];
      load_a(pa, Pt, ST_LD, wk * 16, kk * 16, lane);
      load_a(da, dSt, ST_LD, wk * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < HN / 2; ++np) {
        uint32_t bo[4], bq[4];
        load_b_kn(bo, dOb, LDS, kk * 16, wh * HALF + np * 16, lane);
        load_b_kn(bq, Qb, LDS, kk * 16, wh * HALF + np * 16, lane);
        mma(adv[2 * np], pa, bo[0], bo[1]);
        mma(adv[2 * np + 1], pa, bo[2], bo[3]);
        mma(adk[2 * np], da, bq[0], bq[1]);
        mma(adk[2 * np + 1], da, bq[2], bq[3]);
      }
      if constexpr (HN % 2 == 1) {
        uint32_t bo[2], bq[2];
        load_b_kn8(bo, dOb, LDS, kk * 16, wh * HALF + (HN - 1) * 8, lane);
        load_b_kn8(bq, Qb, LDS, kk * 16, wh * HALF + (HN - 1) * 8, lane);
        mma(adv[HN - 1], pa, bo[0], bo[1]);
        mma(adk[HN - 1], da, bq[0], bq[1]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= R) continue;
    const size_t at = ((size_t)b * R + key) * D + c0;
#pragma unroll
    for (int n = 0; n < HN; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = wh * HALF + n * 8 + 2 * t + e;
        if (d < dh) {
          dk[at + d] = __float2bfloat16(adk[n][2 * i + e]);
          dv[at + d] = __float2bfloat16(adv[n][2 * i + e]);
        }
      }
  }
}

// One block per (64-query tile, head, row), walking every key tile.  Warp
// w: queries 16 (w % 4).. of the tile; keys 32 (w / 4).. of each key tile
// for S and dP; head dims (w / 4) dp / 2.. for dQ.
template <int DP>
__global__ void __launch_bounds__(BWD_THREADS, 1)
bwd_q_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ kp,
             const bf16* __restrict__ vp, const bf16* __restrict__ dop,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const long long* __restrict__ seed, bf16* __restrict__ dq, int R,
             int Rt, int D, int hs, uint32_t salt_base, int salt_mul,
             float inv_scale, float rate) {
  constexpr int LDS = DP + 8, KS = DP / 16, HN = DP / 16, HALF = DP / 2;
  constexpr int TS = TILE * LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + TS;
  bf16* Ks = dOs + TS;                // two stages
  bf16* Vs = Ks + 2 * TS;             // two stages
  bf16* dSs = Vs + 2 * TS;            // (query, key): dS
  const int q0 = blockIdx.x * TILE, head = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wq = warp & 3, wh = warp >> 2;
  const size_t hb = ((size_t)b * gridDim.y + head) * Rt * DP;
  const size_t hrow = ((size_t)b * gridDim.y + head) * R;
  const int c0 = head * hs, dh = min(hs, D - c0);
  const int Rp = (R + 127) / 128 * 128;
  const bool dropping = rate > 0.0f;
  const float inv_keep = 1.0f / (1.0f - rate);
  const uint32_t mix =
      dropping ? gvd::head_mix(seed, b, head, salt_base, salt_mul) : 0u;
  const float sl2 = inv_scale * LOG2E;
  const int row0 = q0 + wq * 16 + g;  // this thread's queries: +0, +8

  load_tile<DP, BWD_THREADS>(Qs, qp + hb + (size_t)q0 * DP);
  load_tile<DP, BWD_THREADS>(dOs, dop + hb + (size_t)q0 * DP);
  load_tile<DP, BWD_THREADS>(Ks, kp + hb);
  load_tile<DP, BWD_THREADS>(Vs, vp + hb);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[KS][4], of[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    load_a(qf[kk], Qs, LDS, wq * 16, kk * 16, lane);
    load_a(of[kk], dOs, LDS, wq * 16, kk * 16, lane);
  }
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    l2[i] = r < R ? lse[hrow + r] * LOG2E : 0.0f;
    dl[i] = r < R ? delta[hrow + r] : 0.0f;
  }
  float adq[HN][4];
#pragma unroll
  for (int n = 0; n < HN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.0f;

  const int nkt = Rt / TILE;
  for (int j = 0; j < nkt; ++j) {
    const int k0 = j * TILE;
    const bf16* Kb = Ks + (j & 1) * TS;
    const bf16* Vb = Vs + (j & 1) * TS;
    cp_async_wait_all();
    __syncthreads();          // tile j in; every warp done with tile j - 1
    if (j + 1 < nkt) {
      const size_t at = hb + (size_t)(k0 + TILE) * DP;
      load_tile<DP, BWD_THREADS>(Ks + ((j + 1) & 1) * TS, kp + at);
      load_tile<DP, BWD_THREADS>(Vs + ((j + 1) & 1) * TS, vp + at);
      cp_async_commit();
    }

    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bk[4], bv[4];
        load_b_nk(bk, Kb, LDS, wh * 32 + np * 16, kk * 16, lane);
        load_b_nk(bv, Vb, LDS, wh * 32 + np * 16, kk * 16, lane);
        mma(s[2 * np], qf[kk], bk[0], bk[1]);
        mma(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        mma(dp[2 * np], of[kk], bv[0], bv[1]);
        mma(dp[2 * np + 1], of[kk], bv[2], bv[3]);
      }

#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int kc = wh * 32 + n * 8 + 2 * t;     // key within the tile
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qq = row0 + 8 * (e >> 1), key = k0 + kc + (e & 1);
        const bool ok = key < R && qq < R;
        const float p = ok ? exp2f(s[n][e] * sl2 - l2[e >> 1]) : 0.0f;
        const float mk =
            dropping ? gvd::keep_scale(mix, qq, key, Rp, rate, inv_keep)
                     : 1.0f;
        ds[e] = p * (mk * dp[n][e] - dl[e >> 1]) * inv_scale;
      }
      const int r = wq * 16 + g;
      *reinterpret_cast<uint32_t*>(dSs + r * ST_LD + kc) = pack2(ds[0], ds[1]);
      *reinterpret_cast<uint32_t*>(dSs + (r + 8) * ST_LD + kc) =
          pack2(ds[2], ds[3]);
    }
    __syncthreads();

    // dQ += dS K over this warp's half of the head dims
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t da[4];
      load_a(da, dSs, ST_LD, wq * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < HN / 2; ++np) {
        uint32_t bk[4];
        load_b_kn(bk, Kb, LDS, kk * 16, wh * HALF + np * 16, lane);
        mma(adq[2 * np], da, bk[0], bk[1]);
        mma(adq[2 * np + 1], da, bk[2], bk[3]);
      }
      if constexpr (HN % 2 == 1) {
        uint32_t bk[2];
        load_b_kn8(bk, Kb, LDS, kk * 16, wh * HALF + (HN - 1) * 8, lane);
        mma(adq[HN - 1], da, bk[0], bk[1]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= R) continue;
    const size_t at = ((size_t)b * R + r) * D + c0;
#pragma unroll
    for (int n = 0; n < HN; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = wh * HALF + n * 8 + 2 * t + e;
        if (d < dh) dq[at + d] = __float2bfloat16(adq[n][2 * i + e]);
      }
  }
}

// ------------------------------------------------------------- launchers --
constexpr size_t fwd_smem(int dp) {
  return (size_t)3 * TILE * (dp + 8) * sizeof(bf16);
}
constexpr size_t bwd_kv_smem(int dp) {
  return ((size_t)6 * TILE * (dp + 8) + 2 * TILE * ST_LD) * sizeof(bf16);
}
constexpr size_t bwd_q_smem(int dp) {
  return ((size_t)6 * TILE * (dp + 8) + TILE * ST_LD) * sizeof(bf16);
}

using gvd::rows_padded;

template <int DP, bool DROP>
int launch_fwd(const bf16* qp, const bf16* kp, const bf16* vp, void* out,
               float* lse, const long long* seed, int B, int R, int D, int hs,
               uint32_t salt_base, int salt_mul, float inv_scale, float rate,
               cudaStream_t s) {
  const size_t smem = fwd_smem(DP);
  cudaError_t e = gvd::allow_smem(fwd_kernel<DP, DROP>, smem);
  if (e != cudaSuccess) return (int)e;
  const int Rt = rows_padded(R);
  dim3 grid(Rt / TILE, (D + hs - 1) / hs, B);
  fwd_kernel<DP, DROP><<<grid, FWD_THREADS, smem, s>>>(
      qp, kp, vp, (bf16*)out, lse, seed, R, Rt, D, hs, salt_base, salt_mul,
      inv_scale, rate);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd(const bf16* qp, const bf16* kp, const bf16* vp,
               const bf16* dop, const float* lse, const float* delta,
               const long long* seed, void* dq, void* dk, void* dv, int B,
               int R, int D, int hs, uint32_t salt_base, int salt_mul,
               float inv_scale, float rate, cudaStream_t s) {
  cudaError_t e;
  if ((e = gvd::allow_smem(bwd_kv_kernel<DP>, bwd_kv_smem(DP))) !=
      cudaSuccess)
    return (int)e;
  if ((e = gvd::allow_smem(bwd_q_kernel<DP>, bwd_q_smem(DP))) != cudaSuccess)
    return (int)e;
  const int Rt = rows_padded(R);
  dim3 grid(Rt / TILE, (D + hs - 1) / hs, B);
  bwd_kv_kernel<DP><<<grid, BWD_THREADS, bwd_kv_smem(DP), s>>>(
      qp, kp, vp, dop, lse, delta, seed, (bf16*)dk, (bf16*)dv, R, Rt, D, hs,
      salt_base, salt_mul, inv_scale, rate);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  bwd_q_kernel<DP><<<grid, BWD_THREADS, bwd_q_smem(DP), s>>>(
      qp, kp, vp, dop, lse, delta, seed, (bf16*)dq, R, Rt, D, hs, salt_base,
      salt_mul, inv_scale, rate);
  return (int)cudaGetLastError();
}

}  // namespace

namespace gvd {

// The instantiated packed head widths: the head width rounded up to 64,
// 128, 176 or 192 (0 above 192).  Both dtypes' kernels take these.
int packed_width(int hs) {
  return hs <= 64 ? 64 : hs <= 128 ? 128 : hs <= 176 ? 176 : hs <= 192 ? 192
                                                                         : 0;
}

int pack_heads(int dtype, int n, const void* const* src, void* dst, int B,
               int R, int D, int hs, int ld, cudaStream_t s) {
  if (dtype == 0)
    return pack_heads_as<float>(n, src, dst, B, R, D, hs, ld, s);
  if (dtype == 1)
    return pack_heads_as<bf16>(n, src, dst, B, R, D, hs, ld, s);
  return (int)cudaErrorInvalidValue;
}

int attention_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                       float* lse, const long long* seed, void* scratch,
                       int B, int R, int D, int hs, int ld,
                       uint32_t salt_base, int salt_mul, float inv_scale,
                       float rate, bool drop, cudaStream_t s) {
  const void* src[3] = {q, k, v};
  int e = pack_heads(1, 3, src, scratch, B, R, D, hs, ld, s);
  if (e != 0) return e;
  const int dp = packed_width(hs);
  const size_t per = (size_t)B * ((D + hs - 1) / hs) * rows_padded(R) * dp;
  const bf16* qp = (const bf16*)scratch;
  const bf16* kp = qp + per;
  const bf16* vp = kp + per;
#define GVD_FWD(W)                                                          \
  case W:                                                                   \
    return drop ? launch_fwd<W, true>(qp, kp, vp, out, lse, seed, B, R, D,  \
                                      hs, salt_base, salt_mul, inv_scale,   \
                                      rate, s)                              \
                : launch_fwd<W, false>(qp, kp, vp, out, lse, seed, B, R, D, \
                                       hs, salt_base, salt_mul, inv_scale,  \
                                       rate, s);
  switch (dp) {
    GVD_FWD(64)
    GVD_FWD(128)
    GVD_FWD(176)
    GVD_FWD(192)
  }
#undef GVD_FWD
  return (int)cudaErrorInvalidValue;
}

int attention_bwd_bf16(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const long long* seed, void* scratch, void* dq,
                       void* dk, void* dv, int B, int R, int D, int hs,
                       uint32_t salt_base, int salt_mul, float inv_scale,
                       float rate, cudaStream_t s) {
  const void* src[4] = {q, k, v, dout};
  int e = pack_heads(1, 4, src, scratch, B, R, D, hs, D, s);
  if (e != 0) return e;
  const int dp = packed_width(hs);
  const size_t per = (size_t)B * ((D + hs - 1) / hs) * rows_padded(R) * dp;
  const bf16* qp = (const bf16*)scratch;
#define GVD_BWD(W)                                                            \
  case W:                                                                     \
    return launch_bwd<W>(qp, qp + per, qp + 2 * per, qp + 3 * per, lse,       \
                         delta, seed, dq, dk, dv, B, R, D, hs, salt_base,     \
                         salt_mul, inv_scale, rate, s);
  switch (dp) {
    GVD_BWD(64)
    GVD_BWD(128)
    GVD_BWD(176)
    GVD_BWD(192)
  }
#undef GVD_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace gvd

// The rows of a query or key tile of the kernels above, which the packed
// rows are padded to a multiple of; the K5 twin's flash_rounding walks the
// keys in tiles of this size (ops/kernels/attention_train.py MMA_TILE).
extern "C" int gvd_attention_tile() { return TILE; }

// The packed width of a head hs wide, 0 past the widest; the wrappers size
// the kernels' scratch by it.
extern "C" int gvd_packed_width(int hs) { return gvd::packed_width(hs); }

// n (1 to 4) tensors (B, R, D) of one dtype (0 f32, 1 bf16), rows ld
// elements apart, heads of width ceil(D / n_heads) as column ranges, into
// dst: n packed (B, H, Rt, dp) tensors one after another (Rt = R rounded up
// to TILE, dp = gvd_packed_width of a head).  The attention of either
// dtype runs this first; the entry of its own serves the tests and the
// timing of the repack alone.
extern "C" int gvd_pack_heads(int dtype, int n, const void* s0,
                              const void* s1, const void* s2, const void* s3,
                              void* dst, int B, int R, int D, int n_heads,
                              int ld, void* stream) {
  const void* src[4] = {s0, s1, s2, s3};
  return gvd::pack_heads(dtype, n, src, dst, B, R, D,
                         (D + n_heads - 1) / n_heads, ld,
                         (cudaStream_t)stream);
}
