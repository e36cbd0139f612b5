// obj_interact self-attention in training, forward and backward, with
// dropout on the probabilities (K4).
//
// Replaces grounded_video_description_tpu/ops/pallas/attention_train.py
// ::mha_probs_dropout (_fwd_kernel, _bwd_kernel).  Per (batch row b, head h)
//   P = softmax(q_h k_h^T * inv_scale),  P~ = P * keep(b, h) / (1 - rate),
//   o_h = P~ v_h,
// where keep(b, h)[i, j] = u >= rate, u = the JAX package's counter hash
// (encoder_layer_train.py::uniform_hash): two murmur3 fmix32 passes over
// (i * Rp + j) ^ fmix32(seed + fmix32(salt)), Rp = R rounded up to 128,
// salt = 0x40000000 + b * max(n_heads, 8) + h, u = (hash >> 8) * 2^-24.
// The salt's base and multiplier are arguments: K5 (encoder_layer_train.cu)
// runs these kernels with its own prob site, 0x10000000 + b * 8 + h.
// The masks are bit for bit the JAX kernel's, so both passes regenerate
// them from (seed, b, h, i, j) and no mask is ever stored.
//
// q, k, v, o are (B, R, D) with the heads as torch.chunk column ranges
// (171 x 5 + 169 at D = 1024), as in K1; these f32 kernels read them in
// place, with no head split or padding.
//
// What bounds it on an H100: arithmetic.  At the flagship microbatch
// (B = 30, R = 1000, six heads of 171) the forward is two and the backward
// seven products of R x R x 171 per (row, head), ~0.4 TFLOP per layer and
// microbatch in all, against ~25 MB of q/k/v; the (B, 6, R, R) probs and
// masks that a plain autograd attention stores would be ~0.7 GB per layer.
// Design (FlashAttention-2 without tensor cores):
//  * forward: one block per (64-query tile, head, row), 256 threads as
//    16 x 16; 64-key tiles with an online softmax in f32 (running max and
//    normaliser over the undropped probs), the mask applied to each tile
//    of probs before P~ V; it writes o and the row log-sum-exp (B, H, R).
//  * backward: delta = rowsum(dO * o) per head (with dropout still
//    sum_j dP~_ij P_ij), then one kernel per 64-key tile that walks all
//    query tiles for dK and dV, and one per 64-query tile that walks all
//    key tiles for dQ.  Each recomputes P = exp(s - lse) and the mask.  No
//    atomics, so a second call gives the same bits.
// These SIMT kernels are the f32 path: scores, softmax, every backward
// elementwise chain and the products all run in f32, on the SIMT units.
// TF32 tensor-core products would keep ~3 decimal digits and miss the f32
// bars (1e-4 against the twin; the CPU parity tests against JAX), so f32
// stays here.  bf16 inputs go to the tensor-core kernels of
// csrc/attention_mma.cu (same function, same masks; see its note).
//
// K7, the inference flash attention, is this forward too (in f32; its bf16
// launch runs the tensor-core forward).
// gvd_flash_self_attention replaces grounded_video_description_tpu/ops/
// pallas/mha.py::flash_self_attention: softmax(q k^T) v per leading index
// of (N, R, d) tensors, q pre-scaled, d odd (171 at flagship width).  It
// launches fwd_kernel with B = N, one head of width d, inv_scale 1, the
// dropout code compiled out (DROP = false) and no log-sum-exp written.
// What bounds it on an H100: arithmetic, 2 R x R x d products per index
// (N = 600, R = 1000, d = 171 at flagship width: ~0.4 TFLOP per layer) on
// the f32 SIMT units; the (R, R) scores of the TPU kernel's VMEM never
// exist here, the 64 x 64 score tile lives in shared memory.  Rows are
// loaded element by element, so the odd row stride needs no padding, and
// keys past R are masked to -inf.

#include "attention_mma.cuh"
#include "common.cuh"

namespace {

constexpr int BQ = 64, BKEY = 64, TPT = 4, THREADS = 256;
constexpr int MAX_HEAD = 192;          // NV <= 3; keeps the backward <= 227 KB
constexpr int ST_LD = BKEY + 1;        // row stride of a 64 x 64 score tile

__host__ __device__ constexpr size_t fwd_smem(int ld) {
  return (size_t)(BQ * ld + BKEY * ld + BQ * ST_LD + 3 * BQ) * sizeof(float);
}

__host__ __device__ constexpr size_t bwd_smem(int ld) {
  return (size_t)(2 * BQ * ld + 2 * BKEY * ld + BQ * ST_LD + 2 * BQ) *
         sizeof(float);
}

// s[i][j] += a[r0 + i] . b[c + 16 j] over the padded head width dh4, from
// 16-byte shared-memory reads (rows of a and b with stride ld).
__device__ __forceinline__ void tile_dots(float s[TPT][4], const float* a,
                                          const float* b, int ld, int r0,
                                          int c, int dh4) {
#pragma unroll
  for (int i = 0; i < TPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
  for (int d = 0; d < dh4; d += 4) {
    float4 x[TPT], y[4];
#pragma unroll
    for (int i = 0; i < TPT; ++i)
      x[i] = *reinterpret_cast<const float4*>(&a[(r0 + i) * ld + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(&b[(c + 16 * j) * ld + d]);
#pragma unroll
    for (int i = 0; i < TPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += x[i].x * y[j].x;
        s[i][j] += x[i].y * y[j].y;
        s[i][j] += x[i].z * y[j].z;
        s[i][j] += x[i].w * y[j].w;
      }
  }
}

// acc[i][jj][e] += sum_{t < n} w[(r0 + i) * ST_LD + t] * m[t * ld + d],
// d = 4 c + 64 jj + e: rows r0.. of a score tile times a (n, ld) tile.
template <int NV>
__device__ __forceinline__ void tile_accumulate(float acc[TPT][NV][4],
                                                const float* w, const float* m,
                                                int ld, int r0, int c, int n,
                                                int dh4) {
  for (int t = 0; t < n; ++t) {
    float p[TPT];
#pragma unroll
    for (int i = 0; i < TPT; ++i) p[i] = w[(r0 + i) * ST_LD + t];
    const float* row = m + t * ld;
#pragma unroll
    for (int jj = 0; jj < NV; ++jj) {
      const int d = 4 * c + 64 * jj;
      if (d < dh4) {
        const float4 v = *reinterpret_cast<const float4*>(&row[d]);
#pragma unroll
        for (int i = 0; i < TPT; ++i) {
          acc[i][jj][0] += p[i] * v.x;
          acc[i][jj][1] += p[i] * v.y;
          acc[i][jj][2] += p[i] * v.z;
          acc[i][jj][3] += p[i] * v.w;
        }
      }
    }
  }
}

// rows r0 + i (< R) of acc * scale[i] into dst (B, R, D) at column c0.
template <typename T, int NV>
__device__ __forceinline__ void store_rows(T* dst, const float acc[TPT][NV][4],
                                           const float scale[TPT], size_t base,
                                           int r0, int R, int D, int c, int dh) {
#pragma unroll
  for (int i = 0; i < TPT; ++i) {
    if (r0 + i >= R) continue;
    T* row = dst + base + (size_t)(r0 + i) * D;
#pragma unroll
    for (int jj = 0; jj < NV; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * c + 64 * jj + e;
        if (d < dh) row[d] = gvd::from_f32<T>(acc[i][jj][e] * scale[i]);
      }
  }
}

// ---------------------------------------------------------------- forward --
// One block per (query tile, head, row).  Thread (tq, tk) owns queries
// 4 tq + i: keys tk + 16 j of each key tile for the scores, head dims
// 4 tk + 64 jj + e for o.
template <typename T, int NV, bool DROP>
__global__ void __launch_bounds__(THREADS, 2)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out,
           float* __restrict__ lse, const long long* __restrict__ seed, int R,
           int D, int hs, uint32_t salt_base, int salt_mul, float inv_scale,
           float rate) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z;
  const int c0 = head * hs, dh = min(hs, D - c0), dh4 = (dh + 3) / 4 * 4;
  const int ld = gvd::tile_ld(dh);
  float* Qs = smem;                  // (BQ, ld)
  float* KVs = Qs + BQ * ld;         // (BKEY, ld): K tile, then V tile
  float* St = KVs + BKEY * ld;       // (BQ, ST_LD): scores, then P~
  float* m_s = St + BQ * ST_LD;      // (BQ) running max
  float* l_s = m_s + BQ;             // (BQ) running sum of undropped probs
  float* c_s = l_s + BQ;             // (BQ) this tile's rescale factor
  const int tid = threadIdx.x, tq = tid / 16, tk = tid % 16;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)b * R * D + c0;
  const int Rp = (R + 127) / 128 * 128;
  const bool dropping = DROP && rate > 0.0f;
  const float inv_keep = 1.0f / (1.0f - rate);
  const uint32_t mix =
      dropping ? gvd::head_mix(seed, b, head, salt_base, salt_mul) : 0u;

  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  gvd::load_tile_rows(Qs, ld, q + base, D, q0, BQ, R, dh, dh4);

  float acc[TPT][NV][4];
#pragma unroll
  for (int i = 0; i < TPT; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int k0 = 0; k0 < R; k0 += BKEY) {
    __syncthreads();                 // KVs free (previous P~ V done)
    gvd::load_tile_rows(KVs, ld, k + base, D, k0, BKEY, R, dh, dh4);
    __syncthreads();
    float sc[TPT][4];
    tile_dots(sc, Qs, KVs, ld, tq * TPT, tk, dh4);
#pragma unroll
    for (int i = 0; i < TPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        St[(tq * TPT + i) * ST_LD + tk + 16 * j] =
            k0 + tk + 16 * j < R ? sc[i][j] * inv_scale : -INFINITY;
    __syncthreads();

    // online softmax, one warp per query row; every key tile holds at
    // least one real key, so the new max is finite.  The normaliser sums
    // the undropped probs; the tile keeps the dropped ones for P~ V.
    for (int r = warp; r < BQ; r += THREADS / 32) {
      float* srow = St + r * ST_LD;
      const float s0 = srow[lane], s1 = srow[lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, gvd::warp_max(fmaxf(s0, s1)));
      float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float tile_sum = gvd::warp_sum(p0 + p1);
      if (dropping) {
        p0 *= gvd::keep_scale(mix, q0 + r, k0 + lane, Rp, rate, inv_keep);
        p1 *= gvd::keep_scale(mix, q0 + r, k0 + lane + 32, Rp, rate,
                              inv_keep);
      }
      srow[lane] = p0;
      srow[lane + 32] = p1;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + tile_sum;
        m_s[r] = m_new;
      }
    }
    gvd::load_tile_rows(KVs, ld, v + base, D, k0, BKEY, R, dh, dh4);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const float corr = c_s[tq * TPT + i];
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= corr;
    }
    tile_accumulate<NV>(acc, St, KVs, ld, tq * TPT, tk, min(BKEY, R - k0),
                        dh4);
  }

  float inv_l[TPT];
#pragma unroll
  for (int i = 0; i < TPT; ++i) inv_l[i] = 1.0f / l_s[tq * TPT + i];
  store_rows<T, NV>(out, acc, inv_l, base, q0 + tq * TPT, R, D, tk, dh);
  if (lse != nullptr && tid < BQ && q0 + tid < R)
    lse[((size_t)b * gridDim.y + head) * R + q0 + tid] =
        m_s[tid] + logf(l_s[tid]);
}

// --------------------------------------------------------------- backward --
// delta[b, h, r] = sum over head h's columns of dO * o, in f32; one warp
// per (b, r).
template <typename T>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int rows, int R, int D, int hs,
             int heads) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int b = row / R, r = row % R;
  for (int h = 0; h < heads; ++h) {
    const int c0 = h * hs, dh = min(hs, D - c0);
    const size_t at = (size_t)row * D + c0;
    float s = 0.0f;
    for (int d = lane; d < dh; d += 32)
      s += gvd::to_f32(o[at + d]) * gvd::to_f32(dout[at + d]);
    s = gvd::warp_sum(s);
    if (lane == 0) delta[((size_t)b * heads + h) * R + r] = s;
  }
}

// Shared by both backward kernels.  Element (i, j) pairs row entity
// a0 + r0 + i with column entity b0 + c + 16 j: queries and keys when
// QROWS, keys and queries otherwise.  Turns the raw dot s into
// P = exp(s * inv_scale - lse[query]) (0 outside R) and sets m to the keep
// scale of that (query, key); lse_s is indexed by the query within its tile.
template <bool QROWS>
__device__ __forceinline__ void probs_and_mask(
    float s[TPT][4], float m[TPT][4], const float* lse_s, int r0, int c,
    int a0, int b0, int R, uint32_t mix, int Rp, bool dropping, float rate,
    float inv_keep, float inv_scale) {
#pragma unroll
  for (int i = 0; i < TPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ra = a0 + r0 + i, cb = b0 + c + 16 * j;
      const int qi = QROWS ? ra : cb, kj = QROWS ? cb : ra;
      const float l = lse_s[QROWS ? r0 + i : c + 16 * j];
      const bool ok = qi < R && kj < R;
      s[i][j] = ok ? expf(s[i][j] * inv_scale - l) : 0.0f;
      m[i][j] = dropping ? gvd::keep_scale(mix, qi, kj, Rp, rate, inv_keep)
                         : 1.0f;
    }
}

// One block per (key tile, head, row); walks every query tile.  Thread
// (ty, tx) owns keys 4 ty + i: queries tx + 16 j of each query tile for
// the scores, head dims 4 tx + 64 jj + e for dK and dV.
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS, 1)
bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const long long* __restrict__ seed, T* __restrict__ dk,
              T* __restrict__ dv, int R, int D, int hs, uint32_t salt_base,
              int salt_mul, float inv_scale, float rate) {
  extern __shared__ __align__(16) float smem[];
  const int k0 = blockIdx.x * BKEY, head = blockIdx.y, b = blockIdx.z;
  const int c0 = head * hs, dh = min(hs, D - c0), dh4 = (dh + 3) / 4 * 4;
  const int ld = gvd::tile_ld(dh);
  float* Ks = smem;                  // (BKEY, ld)
  float* Vs = Ks + BKEY * ld;        // (BKEY, ld)
  float* Qs = Vs + BKEY * ld;        // (BQ, ld)
  float* dOs = Qs + BQ * ld;         // (BQ, ld)
  float* St = dOs + BQ * ld;         // (BKEY, ST_LD): P~, then dS (key rows)
  float* lse_s = St + BKEY * ST_LD;  // (BQ)
  float* dl_s = lse_s + BQ;          // (BQ)
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t base = (size_t)b * R * D + c0;
  const size_t hrow = ((size_t)b * gridDim.y + head) * R;
  const int Rp = (R + 127) / 128 * 128;
  const bool dropping = rate > 0.0f;
  const float inv_keep = 1.0f / (1.0f - rate);
  const uint32_t mix =
      dropping ? gvd::head_mix(seed, b, head, salt_base, salt_mul) : 0u;

  gvd::load_tile_rows(Ks, ld, k + base, D, k0, BKEY, R, dh, dh4);
  gvd::load_tile_rows(Vs, ld, v + base, D, k0, BKEY, R, dh, dh4);
  float adk[TPT][NV][4], adv[TPT][NV][4];
#pragma unroll
  for (int i = 0; i < TPT; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) adk[i][j][e] = adv[i][j][e] = 0.0f;

  for (int q0 = 0; q0 < R; q0 += BQ) {
    __syncthreads();                 // Qs, dOs, St free
    gvd::load_tile_rows(Qs, ld, q + base, D, q0, BQ, R, dh, dh4);
    gvd::load_tile_rows(dOs, ld, dout + base, D, q0, BQ, R, dh, dh4);
    if (tid < BQ) {
      const bool ok = q0 + tid < R;
      lse_s[tid] = ok ? lse[hrow + q0 + tid] : 0.0f;
      dl_s[tid] = ok ? delta[hrow + q0 + tid] : 0.0f;
    }
    __syncthreads();
    float p[TPT][4], m[TPT][4], dp[TPT][4];
    tile_dots(p, Ks, Qs, ld, ty * TPT, tx, dh4);
    probs_and_mask<false>(p, m, lse_s, ty * TPT, tx, k0, q0, R, mix, Rp,
                          dropping, rate, inv_keep, inv_scale);
#pragma unroll
    for (int i = 0; i < TPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        St[(ty * TPT + i) * ST_LD + tx + 16 * j] = p[i][j] * m[i][j];
    tile_dots(dp, Vs, dOs, ld, ty * TPT, tx, dh4);
    __syncthreads();
    const int qn = min(BQ, R - q0);
    tile_accumulate<NV>(adv, St, dOs, ld, ty * TPT, tx, qn, dh4);
    __syncthreads();                 // St read for dV
#pragma unroll
    for (int i = 0; i < TPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        St[(ty * TPT + i) * ST_LD + tx + 16 * j] =
            p[i][j] * (m[i][j] * dp[i][j] - dl_s[tx + 16 * j]) * inv_scale;
    __syncthreads();
    tile_accumulate<NV>(adk, St, Qs, ld, ty * TPT, tx, qn, dh4);
  }
  const float one[TPT] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_rows<T, NV>(dk, adk, one, base, k0 + ty * TPT, R, D, tx, dh);
  store_rows<T, NV>(dv, adv, one, base, k0 + ty * TPT, R, D, tx, dh);
}

// One block per (query tile, head, row); walks every key tile.  Thread
// (tq, tk) owns queries 4 tq + i: keys tk + 16 j of each key tile for the
// scores, head dims 4 tk + 64 jj + e for dQ.
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS, 1)
bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const long long* __restrict__ seed, T* __restrict__ dq, int R,
             int D, int hs, uint32_t salt_base, int salt_mul, float inv_scale,
             float rate) {
  extern __shared__ __align__(16) float smem[];
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z;
  const int c0 = head * hs, dh = min(hs, D - c0), dh4 = (dh + 3) / 4 * 4;
  const int ld = gvd::tile_ld(dh);
  float* Qs = smem;                  // (BQ, ld)
  float* dOs = Qs + BQ * ld;         // (BQ, ld)
  float* Ks = dOs + BQ * ld;         // (BKEY, ld)
  float* Vs = Ks + BKEY * ld;        // (BKEY, ld)
  float* St = Vs + BKEY * ld;        // (BQ, ST_LD): dS (query rows)
  float* lse_s = St + BQ * ST_LD;    // (BQ)
  float* dl_s = lse_s + BQ;          // (BQ)
  const int tid = threadIdx.x, tq = tid / 16, tk = tid % 16;
  const size_t base = (size_t)b * R * D + c0;
  const size_t hrow = ((size_t)b * gridDim.y + head) * R;
  const int Rp = (R + 127) / 128 * 128;
  const bool dropping = rate > 0.0f;
  const float inv_keep = 1.0f / (1.0f - rate);
  const uint32_t mix =
      dropping ? gvd::head_mix(seed, b, head, salt_base, salt_mul) : 0u;

  gvd::load_tile_rows(Qs, ld, q + base, D, q0, BQ, R, dh, dh4);
  gvd::load_tile_rows(dOs, ld, dout + base, D, q0, BQ, R, dh, dh4);
  if (tid < BQ) {
    const bool ok = q0 + tid < R;
    lse_s[tid] = ok ? lse[hrow + q0 + tid] : 0.0f;
    dl_s[tid] = ok ? delta[hrow + q0 + tid] : 0.0f;
  }
  float adq[TPT][NV][4];
#pragma unroll
  for (int i = 0; i < TPT; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) adq[i][j][e] = 0.0f;

  for (int k0 = 0; k0 < R; k0 += BKEY) {
    __syncthreads();                 // Ks, Vs, St free
    gvd::load_tile_rows(Ks, ld, k + base, D, k0, BKEY, R, dh, dh4);
    gvd::load_tile_rows(Vs, ld, v + base, D, k0, BKEY, R, dh, dh4);
    __syncthreads();
    float p[TPT][4], m[TPT][4], dp[TPT][4];
    tile_dots(p, Qs, Ks, ld, tq * TPT, tk, dh4);
    probs_and_mask<true>(p, m, lse_s, tq * TPT, tk, q0, k0, R, mix, Rp,
                         dropping, rate, inv_keep, inv_scale);
    tile_dots(dp, dOs, Vs, ld, tq * TPT, tk, dh4);
#pragma unroll
    for (int i = 0; i < TPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        St[(tq * TPT + i) * ST_LD + tk + 16 * j] =
            p[i][j] * (m[i][j] * dp[i][j] - dl_s[tq * TPT + i]) * inv_scale;
    __syncthreads();
    tile_accumulate<NV>(adq, St, Ks, ld, tq * TPT, tk, min(BKEY, R - k0),
                        dh4);
  }
  const float one[TPT] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_rows<T, NV>(dq, adq, one, base, q0 + tq * TPT, R, D, tk, dh);
}

template <typename T, int NV, bool DROP = true>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, const long long* seed, int B, int R, int D, int hs,
               uint32_t salt_base, int salt_mul, float inv_scale, float rate,
               cudaStream_t s) {
  const size_t smem = fwd_smem(gvd::tile_ld(hs));
  cudaError_t e = gvd::allow_smem(fwd_kernel<T, NV, DROP>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((R + BQ - 1) / BQ, (D + hs - 1) / hs, B);
  fwd_kernel<T, NV, DROP><<<grid, THREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, seed, R, D, hs,
      salt_base, salt_mul, inv_scale, rate);
  return (int)cudaGetLastError();
}

template <typename T, int NV>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, const long long* seed,
               void* dq, void* dk, void* dv, float* delta, int B, int R,
               int D, int hs, uint32_t salt_base, int salt_mul,
               float inv_scale, float rate, cudaStream_t s) {
  const int heads = (D + hs - 1) / hs;
  const int rows = B * R;
  delta_kernel<T><<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0,
                    s>>>((const T*)out, (const T*)dout, delta, rows, R, D, hs,
                         heads);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = bwd_smem(gvd::tile_ld(hs));
  if ((e = gvd::allow_smem(bwd_kv_kernel<T, NV>, smem)) != cudaSuccess)
    return (int)e;
  if ((e = gvd::allow_smem(bwd_q_kernel<T, NV>, smem)) != cudaSuccess)
    return (int)e;
  dim3 grid_kv((R + BKEY - 1) / BKEY, heads, B);
  bwd_kv_kernel<T, NV><<<grid_kv, THREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, seed,
      (T*)dk, (T*)dv, R, D, hs, salt_base, salt_mul, inv_scale, rate);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dim3 grid_q((R + BQ - 1) / BQ, heads, B);
  bwd_q_kernel<T, NV><<<grid_q, THREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, seed,
      (T*)dq, R, D, hs, salt_base, salt_mul, inv_scale, rate);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: (B, R, D) contiguous; lse: (B, heads, R) f32, written;
// seed: one int64 on the device (its low 32 bits key the hash); the mask of
// (row b, head h) is salted salt_base + b * salt_mul + h.  bf16 runs the
// tensor-core kernels of csrc/attention_mma.cu, with scratch for three
// packed (B, heads, Rt, dp) bf16 tensors (gvd_packed_width, in
// attention_mma.cu, gives dp and the row padding);
// f32 the SIMT kernels above, with no scratch.
extern "C" int gvd_attention_train_fwd(int dtype, const void* q,
                                       const void* k, const void* v,
                                       void* out, void* lse, const void* seed,
                                       void* scratch, int B, int R, int D,
                                       int n_heads, float inv_scale,
                                       float rate, int salt_base,
                                       int salt_mul, void* stream) {
  const int hs = (D + n_heads - 1) / n_heads;
  if (hs > MAX_HEAD) return (int)cudaErrorInvalidValue;
  const int nv = (hs + 63) / 64;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* sd = (const long long*)seed;
  const uint32_t sb = (uint32_t)salt_base;
  if (dtype == 1)
    return gvd::attention_fwd_bf16(q, k, v, out, (float*)lse, sd, scratch, B,
                                   R, D, hs, D, sb, salt_mul, inv_scale,
                                   rate, true, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (nv) {
    case 1: return launch_fwd<float, 1>(q, k, v, out, (float*)lse, sd, B, R,
                                        D, hs, sb, salt_mul, inv_scale, rate,
                                        s);
    case 2: return launch_fwd<float, 2>(q, k, v, out, (float*)lse, sd, B, R,
                                        D, hs, sb, salt_mul, inv_scale, rate,
                                        s);
    default: return launch_fwd<float, 3>(q, k, v, out, (float*)lse, sd, B, R,
                                         D, hs, sb, salt_mul, inv_scale,
                                         rate, s);
  }
}

// dout: (B, R, D); dq, dk, dv: (B, R, D), written; delta: (B, heads, R) f32
// scratch; scratch: four packed bf16 tensors for bf16, unused for f32.
extern "C" int gvd_attention_train_bwd(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* out, const void* dout,
                                       const void* lse, const void* seed,
                                       void* dq, void* dk, void* dv,
                                       void* delta, void* scratch, int B,
                                       int R, int D, int n_heads,
                                       float inv_scale, float rate,
                                       int salt_base, int salt_mul,
                                       void* stream) {
  const int hs = (D + n_heads - 1) / n_heads;
  if (hs > MAX_HEAD) return (int)cudaErrorInvalidValue;
  const int nv = (hs + 63) / 64;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* sd = (const long long*)seed;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  const uint32_t sb = (uint32_t)salt_base;
  if (dtype == 1) {
    const int heads = (D + hs - 1) / hs, rows = B * R;
    delta_kernel<__nv_bfloat16>
        <<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, s>>>(
            (const __nv_bfloat16*)out, (const __nv_bfloat16*)dout, dl, rows,
            R, D, hs, heads);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return gvd::attention_bwd_bf16(q, k, v, dout, l, dl, sd, scratch, dq, dk,
                                   dv, B, R, D, hs, sb, salt_mul,
                                   inv_scale, rate, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (nv) {
    case 1: return launch_bwd<float, 1>(q, k, v, out, dout, l, sd, dq, dk,
                                        dv, dl, B, R, D, hs, sb, salt_mul,
                                        inv_scale, rate, s);
    case 2: return launch_bwd<float, 2>(q, k, v, out, dout, l, sd, dq, dk,
                                        dv, dl, B, R, D, hs, sb, salt_mul,
                                        inv_scale, rate, s);
    default: return launch_bwd<float, 3>(q, k, v, out, dout, l, sd, dq, dk,
                                         dv, dl, B, R, D, hs, sb, salt_mul,
                                         inv_scale, rate, s);
  }
}

// K7.  q, k, v, out: (N, R, d) contiguous, q pre-scaled; no dropout, no
// log-sum-exp.  bf16: the tensor-core forward with one head of width d,
// scratch for three packed (N, 1, Rt, dp) tensors; f32: the SIMT forward.
extern "C" int gvd_flash_self_attention(int dtype, const void* q,
                                        const void* k, const void* v,
                                        void* out, void* scratch, int N,
                                        int R, int d, void* stream) {
  if (d > MAX_HEAD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return gvd::attention_fwd_bf16(q, k, v, out, nullptr, nullptr, scratch,
                                   N, R, d, d, d, 0u, 0, 1.0f, 0.0f, false,
                                   s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch ((d + 63) / 64) {
    case 1: return launch_fwd<float, 1, false>(q, k, v, out, nullptr, nullptr,
                                               N, R, d, d, 0u, 0, 1.0f, 0.0f,
                                               s);
    case 2: return launch_fwd<float, 2, false>(q, k, v, out, nullptr, nullptr,
                                               N, R, d, d, 0u, 0, 1.0f, 0.0f,
                                               s);
    default: return launch_fwd<float, 3, false>(q, k, v, out, nullptr,
                                                nullptr, N, R, d, d, 0u, 0,
                                                1.0f, 0.0f, s);
  }
}
