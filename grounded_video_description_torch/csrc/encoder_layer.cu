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
// is ~1.05 TFLOP of projections and ~0.4 TFLOP of attention, against ~0.4
// GB of activations; the (B, 6, R, R) scores would add 2.4 GB per layer of
// f32 traffic if they were written out.  In f32 both run on the tensor
// cores in 3xTF32 (csrc/tf32x3.cuh), 164.9 TFLOP/s of f32-accurate
// products against the SIMT units' 67.  Design:
//  * gvd_gemm: C = A W^T (+bias, ReLU) with W in PyTorch's (out, in)
//    layout, 128 x 128 output tiles, f32 accumulation.  It serves the QKV
//    (one product with N = 3D), output and FFN projections.  A and W are
//    both K-major, so A is mma.sync's row operand and W its col operand as
//    they lie, by ldmatrix from shared memory, fed by a three-stage ring
//    that cp.async fills two tiles ahead of the products (two blocks an
//    SM); 8 warps of 64 x 32 outputs; the epilogue adds the bias and
//    applies the ReLU in f32 straight from the accumulator fragments.
//    - bf16 (K a multiple of 8; the wrapper zero-pads K otherwise):
//      mma.sync.m16n8k16, tiles 64 deep, rounded to bf16 at the store.  Of
//      the tilings tried on an H100 (BK 32 with 4 stages, BK 64 with 3 or
//      4, 128 x 256 tiles with BK 32 or 64) this one was fastest.
//    - f32 (K a multiple of 4; the wrapper zero-pads K otherwise):
//      mma.sync.m16n8k8 in 3xTF32, tiles 32 deep, each operand element
//      split into hi + lo as its fragment is loaded, W's too (W split once
//      a call into hi and lo copies, which would double its bytes in each
//      stage, was not tried).  wgmma (TF32, both operands K-major from
//      shared memory) would need hi and lo split into shared memory
//      first; not tried yet.
//  * attention, heads as column ranges of the qkv buffer: the tensor-core
//    forwards without dropout or log-sum-exp (as K7's launches), their
//    repack reading q, k and v straight from the (B, R, 3D) qkv buffer at
//    column offsets 0, D, 2D with a row stride of 3D.  Scores and softmax
//    stay f32 on the accumulators.
//    - bf16: csrc/attention_mma.cu's forward.
//    - f32: csrc/attention_tf32x3.cu's forward (3xTF32), for heads up to
//      192, the widest packed width.  A head of 193-256 takes the SIMT
//      kernel below (its own launch count): the 3xTF32 forward's 128-query
//      tile at a packed width of 256 would need 266 KB of shared memory,
//      past the 227 KB a block can have, and no configuration of the repo
//      has such heads (the flagship's are 171).
//  * gvd_residual_layer_norm: x + y, then the unbiased-std LayerNorm, one
//    block per row, statistics in f32.

#include "attention_mma.cuh"
#include "common.cuh"
#include "gemm_sm90.cuh"
#include "tf32x3.cuh"

namespace {

using bf16 = __nv_bfloat16;

using gvd::cp_async16;
using gvd::cp_async_commit;
using gvd::cp_async_wait;
using gvd::ldsm_x4;
using gvd::mma16816;

constexpr int GEMM_THREADS = 256;

// ------------------------------------------------------------ bf16 GEMM --
// TBM x TBN output tiles, 8 warps as 2 (rows) x 4 (columns), each warp
// 64 x WN = 4 x NT8 fragments of m16n8; K in steps of TBK through a ring of
// STAGES shared-memory stages (rows TLD = TBK + 8 elements apart: an odd
// number of 16-byte units, so the 8 rows an ldmatrix reads hit distinct
// banks).
constexpr int TBM = 128, TBN = 128, TBK = 64, STAGES = 3, TLD = TBK + 8;
constexpr int WN = TBN / 4, NT8 = WN / 8, MMA_BLOCKS = 2;  // blocks an SM
constexpr size_t MMA_GEMM_SMEM = (size_t)STAGES * (TBM + TBN) * TLD * 2;

__device__ __forceinline__ float epilogue(float v, const float* bias, int n,
                                          int relu) {
  if (bias != nullptr) v += bias[n];
  return relu ? fmaxf(v, 0.0f) : v;
}

// K % 8 == 0, A and W 16-byte aligned.
__global__ void __launch_bounds__(GEMM_THREADS, MMA_BLOCKS)
gemm_bf16_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                     const float* __restrict__ bias, bf16* __restrict__ C,
                     int M, int N, int K, int relu) {
  extern __shared__ __align__(16) bf16 gsm[];
  bf16* As = gsm;                          // STAGES x (TBM, TLD)
  bf16* Bs = gsm + STAGES * TBM * TLD;     // STAGES x (TBN, TLD)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;

  // a stage: TBM (TBN) rows x TBK k of A (W) in 16-byte chunks
  constexpr int CPR = TBK / 8;                 // chunks a row
  auto load = [&](int st, int k0) {
#pragma unroll
    for (int c = 0; c < TBM * CPR / GEMM_THREADS; ++c) {
      const int idx = tid + c * GEMM_THREADS, r = idx / CPR,
                kc = (idx % CPR) * 8, gk = k0 + kc, gm = m0 + r;
      const bool ok = gm < M && gk < K;
      cp_async16(As + (st * TBM + r) * TLD + kc,
                 ok ? A + (size_t)gm * K + gk : A, ok);
    }
#pragma unroll
    for (int c = 0; c < TBN * CPR / GEMM_THREADS; ++c) {
      const int idx = tid + c * GEMM_THREADS, r = idx / CPR,
                kc = (idx % CPR) * 8, gk = k0 + kc, gn = n0 + r;
      const bool ok = gn < N && gk < K;
      cp_async16(Bs + (st * TBN + r) * TLD + kc,
                 ok ? W + (size_t)gn * K + gk : W, ok);
    }
  };

  float acc[4][NT8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int nk = (K + TBK - 1) / TBK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s * TBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();     // stage kt has landed
    __syncthreads();                 // ... for every thread; stage kt - 1 free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load(nxt % STAGES, nxt * TBK);
    cp_async_commit();
    const bf16* as = As + (kt % STAGES) * TBM * TLD;
    const bf16* bs = Bs + (kt % STAGES) * TBN * TLD;
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 16) {
      uint32_t a[4][4], b[NT8][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(a[i], as + (wm * 64 + i * 16 + (lane & 15)) * TLD + kk +
                          (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < NT8 / 2; ++jj) {
        uint32_t r[4];
        ldsm_x4(r, bs + (wn * WN + jj * 16 + (lane >> 4) * 8 + (lane & 7)) *
                            TLD + kk + ((lane >> 3) & 1) * 8);
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NT8; ++j)
          mma16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // fragment (i, j): rows g and g + 8 (g = lane / 4), columns 2 (lane % 4)
  // + {0, 1} of the m16n8 tile
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + (lane >> 2) + h * 8;
      if (m >= M) continue;
      bf16* crow = C + (size_t)m * N;
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int n = n0 + wn * WN + j * 8 + (lane & 3) * 2;
        if (n >= N) continue;
        const float v0 = epilogue(acc[i][j][2 * h], bias, n, relu);
        if (pairs) {
          const float v1 = epilogue(acc[i][j][2 * h + 1], bias, n + 1, relu);
          *reinterpret_cast<__nv_bfloat162*>(crow + n) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          crow[n] = __float2bfloat16(v0);
          if (n + 1 < N)
            crow[n + 1] = __float2bfloat16(
                epilogue(acc[i][j][2 * h + 1], bias, n + 1, relu));
        }
      }
    }
  }
}

// ----------------------------------------------------- f32 GEMM, 3xTF32 --
// The bf16 kernel's tiling in f32: K in steps of FBK through the same
// ring, rows FLD = FBK + 4 floats apart (an odd number of 16-byte units,
// so the 8 rows an ldmatrix reads hit distinct banks).  Per 16-deep step
// a warp loads its W fragments (B of 32 columns, two 8-deep halves) once
// and the A fragments of one m16 tile at a time, each split into hi + lo,
// takes the step's six TF32 products into fresh accumulators and adds
// them to its 4 x 4 running sums in f32 (mma3_n_set: the tensor cores'
// truncating additions would drift over K).  Of the flushes tried on an
// H100 (every 8 or 16 deep, one or two blocks an SM) this was fastest;
// summing K in the tensor cores' accumulators alone ran faster still but
// missed the f32 bar.
constexpr int FBK = 32, FLD = FBK + 4;
constexpr size_t TF32_GEMM_SMEM = (size_t)STAGES * (TBM + TBN) * FLD * 4;

// K % 4 == 0, A and W 16-byte aligned.
__global__ void __launch_bounds__(GEMM_THREADS, MMA_BLOCKS)
gemm_tf32x3_kernel(const float* __restrict__ A, const float* __restrict__ W,
                   const float* __restrict__ bias, float* __restrict__ C,
                   int M, int N, int K, int relu) {
  extern __shared__ __align__(16) float fsm[];
  float* As = fsm;                         // STAGES x (TBM, FLD)
  float* Bs = fsm + STAGES * TBM * FLD;    // STAGES x (TBN, FLD)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;

  // a stage: TBM (TBN) rows x FBK k of A (W) in 16-byte chunks
  constexpr int CPR = FBK / 4;                 // chunks a row
  auto load = [&](int st, int k0) {
#pragma unroll
    for (int c = 0; c < TBM * CPR / GEMM_THREADS; ++c) {
      const int idx = tid + c * GEMM_THREADS, r = idx / CPR,
                kc = (idx % CPR) * 4, gk = k0 + kc, gm = m0 + r, gn = n0 + r;
      const bool oa = gm < M && gk < K, ow = gn < N && gk < K;
      cp_async16(As + (st * TBM + r) * FLD + kc,
                 oa ? A + (size_t)gm * K + gk : A, oa);
      cp_async16(Bs + (st * TBN + r) * FLD + kc,
                 ow ? W + (size_t)gn * K + gk : W, ow);
    }
  };

  float acc[4][NT8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int nk = (K + FBK - 1) / FBK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s * FBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();     // stage kt has landed
    __syncthreads();                 // ... for every thread; stage kt - 1 free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load(nxt % STAGES, nxt * FBK);
    cp_async_commit();
    const float* as = As + (kt % STAGES) * TBM * FLD;
    const float* bs = Bs + (kt % STAGES) * TBN * FLD;
#pragma unroll
    for (int kk = 0; kk < FBK; kk += 16) {
      gvd::FragB b0[NT8], b1[NT8];
#pragma unroll
      for (int j = 0; j < NT8; j += 2) {
        gvd::load_b_nk2(b0 + j, bs, FLD, wn * WN + j * 8, kk, lane);
        gvd::load_b_nk2(b1 + j, bs, FLD, wn * WN + j * 8, kk + 8, lane);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16;
        const gvd::FragA a0 = gvd::load_a(as, FLD, r, kk, lane);
        const gvd::FragA a1 = gvd::load_a(as, FLD, r, kk + 8, lane);
        float c[NT8][4];
        gvd::mma3_n_set<NT8>(c, a0, b0);
        gvd::mma3_n<NT8>(c, a1, b1);
        gvd::add_n<NT8>(acc[i], c);
      }
    }
  }
  cp_async_wait<0>();

  // fragment (i, j): rows g and g + 8 (g = lane / 4), columns 2 (lane % 4)
  // + {0, 1} of the m16n8 tile
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + (lane >> 2) + h * 8;
      if (m >= M) continue;
      float* crow = C + (size_t)m * N;
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int n = n0 + wn * WN + j * 8 + (lane & 3) * 2;
        if (n >= N) continue;
        const float v0 = epilogue(acc[i][j][2 * h], bias, n, relu);
        if (pairs) {
          *reinterpret_cast<float2*>(crow + n) =
              make_float2(v0, epilogue(acc[i][j][2 * h + 1], bias, n + 1,
                                       relu));
        } else {
          crow[n] = v0;
          if (n + 1 < N)
            crow[n + 1] = epilogue(acc[i][j][2 * h + 1], bias, n + 1, relu);
        }
      }
    }
  }
}

// ------------------------------------------ f32 attention, heads 193-256 --
// On the SIMT units, for the heads past the 3xTF32 forward's widest packed
// width (see the note at the top).  One block per (query tile of BQ = 64,
// head, batch row), 256 threads seen as a 16 x 16 grid (tq, tk).  Thread
// (tq, tk) owns queries 4 tq + i of the tile: for the scores, keys tk + 16
// j of each 64-key tile (a 4 x 4 block); for P V, head dims 4 tk + 64 j +
// e (NV = 4 groups of 4).  Rows are stored with a stride of 4 (mod 8)
// floats, so the 16-byte reads of 8 consecutive threads hit distinct
// banks.  The softmax runs online over the key tiles (running max m,
// normaliser l, accumulator rescaled by exp(m_old - m_new)), so shared
// memory holds one score tile.
constexpr int BQ = 64, QPT = BQ / 16, BKEY = 64, ATT_THREADS = 256;
constexpr int NV = 4, MAX_HEAD = 64 * NV;        // widest head
constexpr int ST_LD = BKEY + 1;                   // score-tile row stride

__host__ __device__ constexpr size_t attention_smem(int ld) {
  return (size_t)(BQ * ld + BKEY * ld + BQ * ST_LD + 3 * BQ) * sizeof(float);
}

// qkv: (B, R, 3D) = [q | k | v]; head h spans columns [h*hs, min(h*hs+hs, D))
// of each.  out: (B, R, D).
__global__ void __launch_bounds__(ATT_THREADS)
attention_simt_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                      int R, int D, int hs, float inv_scale) {
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
  const float* base = qkv + (size_t)b * R * row_stride + c0;

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
    float* orow = out + ((size_t)b * R + q0 + q) * D + c0;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tk + 64 * j + e;
        if (d < dh) orow[d] = acc[i][j][e] * inv_l;
      }
  }
}

int launch_attention_simt(const void* qkv, void* out, int B, int R, int D,
                          int hs, float inv_scale, cudaStream_t s) {
  const size_t smem = attention_smem(gvd::tile_ld(hs));
  cudaError_t e = gvd::allow_smem(attention_simt_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  // torch.chunk makes ceil(D / hs) heads, which can be fewer than n_heads
  const int heads = (D + hs - 1) / hs;
  dim3 grid((R + BQ - 1) / BQ, heads, B);
  attention_simt_kernel<<<grid, ATT_THREADS, smem, s>>>(
      (const float*)qkv, (float*)out, R, D, hs, inv_scale);
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
  if (dtype == 1) {
    if (K % 8 != 0) return (int)cudaErrorInvalidValue;
    cudaError_t e = gvd::allow_smem(gemm_bf16_mma_kernel, MMA_GEMM_SMEM);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
    gemm_bf16_mma_kernel<<<grid, GEMM_THREADS, MMA_GEMM_SMEM, s>>>(
        (const bf16*)A, (const bf16*)W, (const float*)bias, (bf16*)C, M, N,
        K, relu);
    return (int)cudaGetLastError();
  }
  if (dtype != 0 || K % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = gvd::allow_smem(gemm_tf32x3_kernel, TF32_GEMM_SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
  gemm_tf32x3_kernel<<<grid, GEMM_THREADS, TF32_GEMM_SMEM, s>>>(
      (const float*)A, (const float*)W, (const float*)bias, (float*)C, M, N,
      K, relu);
  return (int)cudaGetLastError();
}

// qkv (B, R, 3D) = [q | k | v], out (B, R, D).  bf16 runs the tensor-core
// forward of csrc/attention_mma.cu, f32 that of csrc/attention_tf32x3.cu
// (scratch: three packed (B, H, Rt, dp) tensors of qkv's dtype, as for
// K7); an f32 head of 193-256 the SIMT kernel above (scratch unused).
extern "C" int gvd_attention(int dtype, const void* qkv, void* out,
                             void* scratch, int B, int R, int D, int n_heads,
                             float inv_scale, void* stream) {
  const int hs = (D + n_heads - 1) / n_heads;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    const bf16* q = (const bf16*)qkv;
    return gvd::attention_fwd_bf16(q, q + D, q + 2 * D, out, nullptr, nullptr,
                                   scratch, B, R, D, hs, 3 * D, 0u, 0,
                                   inv_scale, 0.0f, false, s);
  }
  if (dtype != 0 || hs > MAX_HEAD) return (int)cudaErrorInvalidValue;
  if (gvd::packed_width(hs) == 0)
    return launch_attention_simt(qkv, out, B, R, D, hs, inv_scale, s);
  const float* q = (const float*)qkv;
  return gvd::attention_fwd_f32(q, q + D, q + 2 * D, out, nullptr, nullptr,
                                scratch, B, R, D, hs, 3 * D, 0u, 0, inv_scale,
                                0.0f, false, s);
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
