// K4's training attention in f32 on Hopper's tensor cores, forward and
// backward, each product in 3xTF32; K5's f32 attention and K7's f32 launch
// run the same kernels.
//
// Replaces, for f32 inputs, grounded_video_description_tpu/ops/pallas/
// attention_train.py::mha_probs_dropout (_fwd_kernel, _bwd_kernel) and
// mha.py::flash_self_attention.  The function is csrc/attention_train.cu's
// (see its note): per (batch row b, head h) P = softmax(q_h k_h^T *
// inv_scale), P~ = P * keep / (1 - rate) with the JAX counter hash bit for
// bit, o_h = P~ v_h, the row log-sum-exp, and the FlashAttention-2
// backward.
//
// Every product in 3xTF32 (csrc/tf32x3.cuh: each operand element split
// on load into a TF32 hi and lo, three TF32 products on mma.sync.m16n8k8,
// f32 accumulation), which meets the f32 bars (1e-4 against the twin).
// Scores, the softmax statistics, lse, delta, the hash and every
// elementwise step are f32 on the accumulator fragments, as in
// csrc/attention_mma.cu.
//
// What bounds it on an H100: the tensor cores.  Three TF32 products per
// f32 product: 494.7 / 3 = 164.9 TFLOP/s of f32-accurate products, 2.5x
// the SIMT f32 peak.  At the flagship microbatch (B = 30, R = 1000, six
// heads of 171) the forward is 2 and the backward 5 products of R x R x
// 171 per (row, head), 0.123 and 0.307 TFLOP: 0.745 and 1.863 ms at that
// rate; K7 (600 x 1000 x 171) 0.410 TFLOP, 2.489 ms.  mma.sync does not
// reach the dense TF32 peak, which is wgmma's.  Beside the products, the
// split (two integer operations and a subtract per operand element
// loaded) and the f32 work per score run on the SIMT units.
// What the design does about it:
//  * Operands from the repack of csrc/attention_mma.cu, here in f32:
//    (B, H, Rt, dp), rows padded to 64, width to dp (176 at flagship),
//    pads zero, every row 16-byte aligned, tiles in by 16-byte cp.async.
//    At flagship this is 130 MB per tensor for K4 (432 MB for K7), in
//    scratch that the wrapper allocates; three tensors in the forward,
//    four (q, k, v, dO) in the backward.
//  * mma.sync, not wgmma: wgmma takes TF32 operands from shared memory
//    only K-major (its transpose bit is for 16-bit types), so P~ V, dV =
//    P~^T dO, dK = dS^T Q and dQ = dS K would each need a transposed copy;
//    mma.sync fragments come from shared loads in any layout.  Fragments
//    read along the rows (Q, K in Q K^T; K, V, Q, dO in S^T and dP^T) come
//    by ldmatrix: an 8 x 8 b16 matrix is an 8 x 4 f32 one, in exactly the
//    TF32 fragment layout.
//  * Bank layout: operand rows dp + 4 words apart (4 mod 16).  Where the
//    contraction runs down the rows (V, dO, Q, K as (k, n) operands) the k
//    order is permuted: k slot t is row 2t, slot t + 4 row 2t + 1, which
//    is also the column order of an accumulator's (2t, 2t + 1) pair.  So
//    P~ goes from the score accumulators to A fragments in registers
//    without a shuffle, and the (k, n) loads hit distinct banks (2 (dp +
//    4) = 8 mod 32).  P~ and dS tiles in shared memory are rows 8 mod 32
//    words apart and are read in the same order, 8 bytes at a time.
//  * Forward (FlashAttention-2): 8 warps, each owning 16 query rows of a
//    128-query tile; Q stays in shared memory and is split at each load
//    (as raw fragments it would take 88 registers beside the 88 of the
//    output accumulator at dp = 176); 64-key tiles, the V tile loaded
//    while Q K^T runs and the next K tile while P~ V runs.  Budget at dp =
//    176: 184,320 bytes of shared memory, one block (8 warps) an SM, ~213
//    registers a thread.  (Four warps on 64 queries and 32-key tiles, two
//    blocks an SM, ran slower.)
//  * Backward: delta = rowsum(dO * o) (csrc/attention_train.cu), then one
//    kernel per 64-key tile for dK and dV (K, V resident; Q and dO tiles
//    of 64 queries, 32 at dp = 192; 8 warps, each a
//    16 x 32 block of S^T and dP^T, then 16 keys x half the head dims of
//    dK and dV, 88 registers at dp = 176; P~ and dS through shared memory
//    in f32).  It also writes each dS^T tile to device memory, (B, H, Rt,
//    Rt) f32 in the scratch (755 MB at flagship), and dQ = dS K is one
//    product in a second kernel over 32-key tiles in a two-stage ring,
//    where recomputing S and dP for it would cost two products more of
//    the seven.  Budget at dp = 176: 221,184 (dK, dV; one block an SM)
//    and 63,488 (dQ; two blocks) bytes of shared memory.  No atomics: a
//    second call gives the same bits.

#include "attention_mma.cuh"
#include "tf32x3.cuh"

namespace {

using gvd::cp_async16;
using gvd::cp_async_commit;
using gvd::cp_async_wait;
using gvd::FragA;
using gvd::FragB;
using gvd::frag_a;
using gvd::frag_b;
using gvd::load_a;
using gvd::load_b_nk2;
using gvd::mma3_n;

constexpr int TILE = gvd::ATTN_TILE;   // query and key rows per tile
constexpr int FWD_KEYS = 64;           // key rows per forward tile
constexpr int FWD_WARPS = 8;
constexpr int FWD_ROWS = 16 * FWD_WARPS;     // query rows per forward tile
constexpr int FWD_THREADS = 32 * FWD_WARPS;  // a warp per 16 query rows
constexpr int BWD_THREADS = 256;       // 8 warps
constexpr float LOG2E = 1.4426950408889634f;
constexpr int KS_UNROLL = 2;           // unroll of the k-step loops

// The same with the k order permuted (slot t is column 2t, slot t + 4
// column 2t + 1): two 8-byte loads.  Pairs with load_b_kn.
__device__ __forceinline__ FragA load_a_perm(const float* s, int ld, int r0,
                                             int k0, int g, int t) {
  const float2 x =
      *reinterpret_cast<const float2*>(s + (r0 + g) * ld + k0 + 2 * t);
  const float2 y =
      *reinterpret_cast<const float2*>(s + (r0 + g + 8) * ld + k0 + 2 * t);
  return frag_a(x.x, y.x, x.y, y.y);
}

// An accumulator (16 rows x 8 columns) as the A operand over its columns,
// in the permuted k order: no data moves between lanes.
__device__ __forceinline__ FragA acc_as_a(const float c[4]) {
  return frag_a(c[0], c[2], c[1], c[3]);
}

// The same from a tile stored (k, n) row-major, k order permuted.
__device__ __forceinline__ FragB load_b_kn(const float* s, int ld, int k0,
                                           int n0, int g, int t) {
  const float* p = s + (k0 + 2 * t) * ld + n0 + g;
  return frag_b(p[0], p[ld]);
}

// ROWS packed rows (dp floats apart) into shared memory (dp + 4 apart).
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int valid = ROWS) {
  constexpr int CH = DP / 4, LDS = DP + 4;
  for (int c = threadIdx.x; c < ROWS * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 4;
    cp_async16(dst + r * LDS + col, src + (size_t)r * DP + col, r < valid);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// --------------------------------------------------------------- forward --
// One block per (128-query tile, head, row): warp w owns queries 16 w..
// of the tile; query rows past Rt load as zeros.
template <int DP, bool DROP>
__global__ void __launch_bounds__(FWD_THREADS, 1)
fwd_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
           const float* __restrict__ vp, float* __restrict__ out,
           float* __restrict__ lse, const long long* __restrict__ seed, int R,
           int Rt, int D, int hs, uint32_t salt_base, int salt_mul,
           float inv_scale, float rate) {
  constexpr int LDS = DP + 4, KS = DP / 8, NT = DP / 8;
  constexpr int KN = FWD_KEYS / 8;          // n-tiles of a key tile
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // (TILE, LDS)
  float* Ks = Qs + FWD_ROWS * LDS;           // (FWD_KEYS, LDS)
  float* Vs = Ks + FWD_KEYS * LDS;           // (FWD_KEYS, LDS)
  const int q0 = blockIdx.x * FWD_ROWS, head = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t hb = ((size_t)b * gridDim.y + head) * Rt * DP;
  const float* kh = kp + hb;
  const float* vh = vp + hb;
  const int c0 = head * hs, dh = min(hs, D - c0);
  const int Rp = (R + 127) / 128 * 128;
  const bool dropping = DROP && rate > 0.0f;
  const float inv_keep = 1.0f / (1.0f - rate);
  const uint32_t mix =
      dropping ? gvd::head_mix(seed, b, head, salt_base, salt_mul) : 0u;
  const float sl2 = inv_scale * LOG2E;      // scores in log2 units
  const int row0 = q0 + warp * 16 + g;      // this thread's rows: +0, +8

  load_tile<DP, FWD_ROWS, FWD_THREADS>(Qs, qp + hb + (size_t)q0 * DP,
                                       Rt - q0);
  load_tile<DP, FWD_KEYS, FWD_THREADS>(Ks, kh);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.0f, 0.0f};

  const int nkt = (R + FWD_KEYS - 1) / FWD_KEYS;
  for (int j = 0; j < nkt; ++j) {
    const int k0 = j * FWD_KEYS;
    load_tile<DP, FWD_KEYS, FWD_THREADS>(Vs, vh + (size_t)k0 * DP);
    cp_async_commit();

    float s[KN][4];
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll KS_UNROLL
    for (int kk = 0; kk < KS; ++kk) {
      const FragA qa = load_a(Qs, LDS, warp * 16, kk * 8, lane);
      FragB kb[KN];
#pragma unroll
      for (int n = 0; n < KN; n += 2)
        load_b_nk2(kb + n, Ks, LDS, n * 8, kk * 8, lane);
      mma3_n<KN>(s, qa, kb);
    }

    // online softmax over this key tile (its first key is < R, so the new
    // max is finite); the sum takes the undropped probs
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < KN; ++n)
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
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[n][e] - m_r[e >> 1]);
        sum[e >> 1] += p;
        if (dropping)
          p *= gvd::keep_scale(mix, row0 + 8 * (e >> 1),
                               k0 + n * 8 + 2 * t + (e & 1), Rp, rate,
                               inv_keep);
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

    cp_async_wait<0>();
    __syncthreads();                  // V tile in; every warp done with K
    if (j + 1 < nkt) {
      load_tile<DP, FWD_KEYS, FWD_THREADS>(Ks,
                                           kh + (size_t)(k0 + FWD_KEYS) * DP);
      cp_async_commit();
    }
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      const FragA pa = acc_as_a(s[kk]);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        const FragB vb[2] = {load_b_kn(Vs, LDS, kk * 8, n * 8, g, t),
                             load_b_kn(Vs, LDS, kk * 8, n * 8 + 8, g, t)};
        mma3_n<2>(o + n, pa, vb);
      }
    }
    cp_async_wait<0>();
    __syncthreads();                  // next K tile in; every warp done with V
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= R) continue;
    const float inv_l = 1.0f / l_r[i];
    float* orow = out + ((size_t)b * R + r) * D + c0;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * t + e;
        if (d < dh) orow[d] = o[n][2 * i + e] * inv_l;
      }
    if (lse != nullptr && t == 0)
      lse[((size_t)b * gridDim.y + head) * R + r] =
          (m_r[i] + log2f(l_r[i])) * (1.0f / LOG2E);
  }
}

// -------------------------------------------------------------- backward --
// P = exp(s - lse) and the keep scale of (query qq, key), and
// dS = P (keep dP~ - delta) inv_scale; P~ = P keep.  0 outside R.
struct ProbGrad {
  float pd, ds;
};
__device__ __forceinline__ ProbGrad prob_grad(float s, float dp, float l2,
                                              float dl, int qq, int key,
                                              int R, float sl2, bool dropping,
                                              uint32_t mix, int Rp, float rate,
                                              float inv_keep,
                                              float inv_scale) {
  const bool ok = key < R && qq < R;
  const float p = ok ? exp2f(s * sl2 - l2) : 0.0f;
  const float mk =
      dropping ? gvd::keep_scale(mix, qq, key, Rp, rate, inv_keep) : 1.0f;
  return {p * mk, p * (mk * dp - dl) * inv_scale};
}

// One block per (64-key tile, head, row), walking every query tile of QT
// rows.  Warp w: keys 16 (w % 4).. of the tile; queries (w / 4) QT / 2..
// of each query tile for S^T and dP^T; head dims (w / 4) dp / 2.. for dK
// and dV.
template <int DP, int QT>
__global__ void __launch_bounds__(BWD_THREADS, 1)
bwd_kv_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
              const float* __restrict__ vp, const float* __restrict__ dop,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const long long* __restrict__ seed, float* __restrict__ dk,
              float* __restrict__ dv, float* __restrict__ dst_g, int R,
              int Rt, int D, int hs, uint32_t salt_base, int salt_mul,
              float inv_scale, float rate) {
  constexpr int LDS = DP + 4, KS = DP / 8, HN = DP / 16, HALF = DP / 2;
  constexpr int QN = QT / 16;               // n-tiles of a warp's queries
  constexpr int PLD = QT + 8;               // P~ / dS row stride
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                          // (TILE, LDS)
  float* Vs = Ks + TILE * LDS;               // (TILE, LDS)
  float* Qs = Vs + TILE * LDS;               // (QT, LDS)
  float* dOs = Qs + QT * LDS;                // (QT, LDS)
  float* Pt = dOs + QT * LDS;                // (key, query): P~
  float* dSt = Pt + TILE * PLD;              // (key, query): dS
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

  load_tile<DP, TILE, BWD_THREADS>(Ks, kp + hb + (size_t)k0 * DP);
  load_tile<DP, TILE, BWD_THREADS>(Vs, vp + hb + (size_t)k0 * DP);

  float adk[HN][4], adv[HN][4];
#pragma unroll
  for (int n = 0; n < HN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.0f;

  const int nqt = (R + QT - 1) / QT;
  for (int i = 0; i < nqt; ++i) {
    const int q0 = i * QT;
    __syncthreads();                  // every warp done with tile i - 1
    load_tile<DP, QT, BWD_THREADS>(Qs, qp + hb + (size_t)q0 * DP);
    load_tile<DP, QT, BWD_THREADS>(dOs, dop + hb + (size_t)q0 * DP);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float st[QN][4], dpt[QN][4];
#pragma unroll
    for (int n = 0; n < QN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
#pragma unroll KS_UNROLL
    for (int kk = 0; kk < KS; ++kk) {
      const FragA ka = load_a(Ks, LDS, wk * 16, kk * 8, lane);
      const FragA va = load_a(Vs, LDS, wk * 16, kk * 8, lane);
      FragB qb[QN], ob[QN];
#pragma unroll
      for (int n = 0; n < QN; n += 2) {
        const int qn = wh * (QT / 2) + n * 8;
        load_b_nk2(qb + n, Qs, LDS, qn, kk * 8, lane);
        load_b_nk2(ob + n, dOs, LDS, qn, kk * 8, lane);
      }
      mma3_n<QN>(st, ka, qb);
      mma3_n<QN>(dpt, va, ob);
    }

    // P~ and dS of each element (key, query) to shared memory
#pragma unroll
    for (int n = 0; n < QN; ++n) {
      const int qc = wh * (QT / 2) + n * 8 + 2 * t;   // query in the tile
      float l2[2], dl[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qq = q0 + qc + e;
        l2[e] = qq < R ? lse[hrow + qq] * LOG2E : 0.0f;
        dl[e] = qq < R ? delta[hrow + qq] : 0.0f;
      }
      ProbGrad pg[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pg[e] = prob_grad(st[n][e], dpt[n][e], l2[e & 1], dl[e & 1],
                          q0 + qc + (e & 1), key0 + 8 * (e >> 1), R, sl2,
                          dropping, mix, Rp, rate, inv_keep, inv_scale);
      const int r = wk * 16 + g;
      *reinterpret_cast<float2*>(Pt + r * PLD + qc) =
          make_float2(pg[0].pd, pg[1].pd);
      *reinterpret_cast<float2*>(Pt + (r + 8) * PLD + qc) =
          make_float2(pg[2].pd, pg[3].pd);
      *reinterpret_cast<float2*>(dSt + r * PLD + qc) =
          make_float2(pg[0].ds, pg[1].ds);
      *reinterpret_cast<float2*>(dSt + (r + 8) * PLD + qc) =
          make_float2(pg[2].ds, pg[3].ds);
    }
    __syncthreads();

    // this tile of dS^T to device memory, for dQ = dS K (bwd_dq_kernel)
    float* ds_out =
        dst_g + (((size_t)b * gridDim.y + head) * Rt + k0) * Rt + q0;
    for (int c = threadIdx.x; c < TILE * QT / 4; c += BWD_THREADS) {
      const int r = c / (QT / 4), col = (c % (QT / 4)) * 4;
      *reinterpret_cast<float4*>(ds_out + (size_t)r * Rt + col) =
          *reinterpret_cast<const float4*>(dSt + r * PLD + col);
    }

    // dV += P~^T dO, dK += dS^T Q over this warp's half of the head dims
#pragma unroll
    for (int kk = 0; kk < QT / 8; ++kk) {
      const FragA pa = load_a_perm(Pt, PLD, wk * 16, kk * 8, g, t);
      const FragA da = load_a_perm(dSt, PLD, wk * 16, kk * 8, g, t);
#pragma unroll
      for (int n = 0; n + 1 < HN; n += 2) {
        const int dn = wh * HALF + n * 8;
        const FragB ob[2] = {load_b_kn(dOs, LDS, kk * 8, dn, g, t),
                             load_b_kn(dOs, LDS, kk * 8, dn + 8, g, t)};
        const FragB qb[2] = {load_b_kn(Qs, LDS, kk * 8, dn, g, t),
                             load_b_kn(Qs, LDS, kk * 8, dn + 8, g, t)};
        mma3_n<2>(adv + n, pa, ob);
        mma3_n<2>(adk + n, da, qb);
      }
      if constexpr (HN % 2 == 1) {
        const int dn = wh * HALF + (HN - 1) * 8;
        const FragB ob = load_b_kn(dOs, LDS, kk * 8, dn, g, t);
        const FragB qb = load_b_kn(Qs, LDS, kk * 8, dn, g, t);
        mma3_n<1>(adv + HN - 1, pa, &ob);
        mma3_n<1>(adk + HN - 1, da, &qb);
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
          dk[at + d] = adk[n][2 * i + e];
          dv[at + d] = adv[n][2 * i + e];
        }
      }
  }
}

// A: rows (m) m0.. m0 + 15 by k0.. k0 + 7 from a tile stored (k, m)
// row-major, k order permuted as load_b_kn.
__device__ __forceinline__ FragA load_a_km(const float* s, int ld, int m0,
                                           int k0, int g, int t) {
  const float* p = s + (k0 + 2 * t) * ld + m0 + g;
  return frag_a(p[0], p[8], p[ld], p[ld + 8]);
}

// dQ = dS K, with dS^T as bwd_kv_kernel wrote it ((B, H, Rt, Rt), keys by
// queries).  One block per (64-query tile, head, row), walking the key
// tiles of dS^T and K, KT rows at a time, in a two-stage ring.  Warp w:
// queries 16 (w % 4).. of the tile, head dims (w / 4) dp / 2.. .
template <int DP, int KT>
__global__ void __launch_bounds__(BWD_THREADS, 2)
bwd_dq_kernel(const float* __restrict__ kp, const float* __restrict__ dst_g,
              float* __restrict__ dq, int R, int Rt, int D, int hs) {
  constexpr int LDS = DP + 4, HN = DP / 16, HALF = DP / 2;
  constexpr int SLD = TILE + 4;             // dS^T tile row stride
  constexpr int STG = KT * (SLD + LDS);     // one stage: dS^T, then K
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * TILE, head = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wq = warp & 3, wh = warp >> 2;
  const size_t bh = (size_t)b * gridDim.y + head;
  const float* kh = kp + bh * Rt * DP;
  const float* sh = dst_g + bh * Rt * Rt + q0;
  const int c0 = head * hs, dh = min(hs, D - c0);
  const int row0 = q0 + wq * 16 + g;  // this thread's queries: +0, +8

  auto load = [&](int j) {
    float* S = smem + (j & 1) * STG;
    for (int c = threadIdx.x; c < KT * TILE / 4; c += BWD_THREADS) {
      const int r = c / (TILE / 4), col = (c % (TILE / 4)) * 4;
      cp_async16(S + r * SLD + col, sh + (size_t)(j * KT + r) * Rt + col,
                 true);
    }
    load_tile<DP, KT, BWD_THREADS>(S + KT * SLD, kh + (size_t)j * KT * DP);
    cp_async_commit();
  };

  float adq[HN][4];
#pragma unroll
  for (int n = 0; n < HN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.0f;

  const int nkt = (R + KT - 1) / KT;
  load(0);
  for (int j = 0; j < nkt; ++j) {
    cp_async_wait<0>();
    __syncthreads();                  // tile j in; every warp done with j - 1
    if (j + 1 < nkt) load(j + 1);
    const float* S = smem + (j & 1) * STG;
    const float* Kb = S + KT * SLD;
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk) {
      const FragA da = load_a_km(S, SLD, wq * 16, kk * 8, g, t);
#pragma unroll
      for (int n = 0; n + 1 < HN; n += 2) {
        const int dn = wh * HALF + n * 8;
        const FragB kb[2] = {load_b_kn(Kb, LDS, kk * 8, dn, g, t),
                             load_b_kn(Kb, LDS, kk * 8, dn + 8, g, t)};
        mma3_n<2>(adq + n, da, kb);
      }
      if constexpr (HN % 2 == 1) {
        const FragB kb =
            load_b_kn(Kb, LDS, kk * 8, wh * HALF + (HN - 1) * 8, g, t);
        mma3_n<1>(adq + HN - 1, da, &kb);
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
        if (d < dh) dq[at + d] = adq[n][2 * i + e];
      }
  }
}

// ------------------------------------------------------------- launchers --
constexpr size_t fwd_smem(int dp) {
  return (size_t)(FWD_ROWS + 2 * FWD_KEYS) * (dp + 4) * sizeof(float);
}
// The dK / dV kernel's query tiles: 64 rows where two such tiles (Q, dO)
// fit beside K and V, else 32; the dQ kernel's key tiles: 32 rows, two
// stages.
constexpr int kv_rows(int dp) { return dp > 176 ? 32 : 64; }
constexpr int DQ_KEYS = 32;
constexpr size_t bwd_kv_smem(int dp) {
  return ((size_t)2 * (TILE + kv_rows(dp)) * (dp + 4) +
          2 * TILE * (kv_rows(dp) + 8)) *
         sizeof(float);
}
constexpr size_t bwd_dq_smem(int dp) {
  return (size_t)2 * DQ_KEYS * (TILE + 4 + dp + 4) * sizeof(float);
}
static_assert(bwd_kv_smem(176) <= 232448 && bwd_kv_smem(192) <= 232448,
              "the dK / dV tiles exceed a block's shared memory");

template <int DP, bool DROP>
int launch_fwd(const float* qp, const float* kp, const float* vp, void* out,
               float* lse, const long long* seed, int B, int R, int D, int hs,
               uint32_t salt_base, int salt_mul, float inv_scale, float rate,
               cudaStream_t s) {
  const size_t smem = fwd_smem(DP);
  cudaError_t e = gvd::allow_smem(fwd_kernel<DP, DROP>, smem);
  if (e != cudaSuccess) return (int)e;
  const int Rt = gvd::rows_padded(R);
  dim3 grid((Rt + FWD_ROWS - 1) / FWD_ROWS, (D + hs - 1) / hs, B);
  fwd_kernel<DP, DROP><<<grid, FWD_THREADS, smem, s>>>(
      qp, kp, vp, (float*)out, lse, seed, R, Rt, D, hs, salt_base, salt_mul,
      inv_scale, rate);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd(const float* qp, const float* kp, const float* vp,
               const float* dop, const float* lse, const float* delta,
               const long long* seed, float* dst_g, void* dq, void* dk,
               void* dv, int B, int R, int D, int hs, uint32_t salt_base,
               int salt_mul, float inv_scale, float rate, cudaStream_t s) {
  auto kv = bwd_kv_kernel<DP, kv_rows(DP)>;
  auto qk = bwd_dq_kernel<DP, DQ_KEYS>;
  cudaError_t e;
  if ((e = gvd::allow_smem(kv, bwd_kv_smem(DP))) != cudaSuccess) return (int)e;
  if ((e = gvd::allow_smem(qk, bwd_dq_smem(DP))) != cudaSuccess) return (int)e;
  const int Rt = gvd::rows_padded(R);
  dim3 grid(Rt / TILE, (D + hs - 1) / hs, B);
  kv<<<grid, BWD_THREADS, bwd_kv_smem(DP), s>>>(
      qp, kp, vp, dop, lse, delta, seed, (float*)dk, (float*)dv, dst_g, R,
      Rt, D, hs, salt_base, salt_mul, inv_scale, rate);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  qk<<<grid, BWD_THREADS, bwd_dq_smem(DP), s>>>(kp, dst_g, (float*)dq, R,
                                                  Rt, D, hs);
  return (int)cudaGetLastError();
}

size_t packed_elems(int B, int R, int D, int hs) {
  return (size_t)B * ((D + hs - 1) / hs) * gvd::rows_padded(R) *
         gvd::packed_width(hs);
}

}  // namespace

namespace gvd {

int attention_fwd_f32(const void* q, const void* k, const void* v, void* out,
                      float* lse, const long long* seed, void* scratch,
                      int B, int R, int D, int hs, int ld,
                      uint32_t salt_base, int salt_mul, float inv_scale,
                      float rate, bool drop, cudaStream_t s) {
  const void* src[3] = {q, k, v};
  int e = pack_heads(0, 3, src, scratch, B, R, D, hs, ld, s);
  if (e != 0) return e;
  const size_t per = packed_elems(B, R, D, hs);
  const float* qp = (const float*)scratch;
  const float* kp = qp + per;
  const float* vp = kp + per;
#define GVD_FWD(W)                                                          \
  case W:                                                                   \
    return drop ? launch_fwd<W, true>(qp, kp, vp, out, lse, seed, B, R, D,  \
                                      hs, salt_base, salt_mul, inv_scale,   \
                                      rate, s)                              \
                : launch_fwd<W, false>(qp, kp, vp, out, lse, seed, B, R, D, \
                                       hs, salt_base, salt_mul, inv_scale,  \
                                       rate, s);
  switch (packed_width(hs)) {
    GVD_FWD(64)
    GVD_FWD(128)
    GVD_FWD(176)
    GVD_FWD(192)
  }
#undef GVD_FWD
  return (int)cudaErrorInvalidValue;
}

int attention_bwd_f32(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const long long* seed, void* scratch, void* dq,
                      void* dk, void* dv, int B, int R, int D, int hs,
                      uint32_t salt_base, int salt_mul, float inv_scale,
                      float rate, cudaStream_t s) {
  const void* src[4] = {q, k, v, dout};
  int e = pack_heads(0, 4, src, scratch, B, R, D, hs, D, s);
  if (e != 0) return e;
  const size_t per = packed_elems(B, R, D, hs);
  const float* qp = (const float*)scratch;
  float* dst_g = (float*)scratch + 4 * per;
#define GVD_BWD(W)                                                            \
  case W:                                                                     \
    return launch_bwd<W>(qp, qp + per, qp + 2 * per, qp + 3 * per, lse,       \
                         delta, seed, dst_g, dq, dk, dv, B, R, D, hs,         \
                         salt_base, salt_mul, inv_scale, rate, s);
  switch (packed_width(hs)) {
    GVD_BWD(64)
    GVD_BWD(128)
    GVD_BWD(176)
    GVD_BWD(192)
  }
#undef GVD_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace gvd
