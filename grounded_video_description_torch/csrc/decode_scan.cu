// The whole greedy caption decode in one launch (K6).
//
// Replaces grounded_video_description_tpu/ops/pallas/decode_scan.py
// ::greedy_decode_fused.  For every batch row, over L steps:
//   att-LSTM on [fc, relu(embed[prev])] (BOS = token 0), torch gate order
//   i, f, g, o;
//   temporal additive attention: tanh(p_conv + h2att(h_att)) . w + b,
//   softmax over the T frames, weighted sum of conv;
//   region additive attention, the same over the R ROIs with scores SET to
//   MIN_VALUE where the pnt mask is on; those pre-softmax scores are the
//   step's grounding logits (att2 output);
//   lang-LSTM on [att + att2, h_att];
//   vocab logits, log-softmax over the first V columns;
//   first-index argmax, the runner-up when it is UNK;
//   the chosen token's embedding row through ReLU as the next input.
//
// What bounds it on an H100: bytes.  At eval flagship width (B = 100,
// R = 1000, T = 480, rnn 1024, att_hid 512) every step reads the four
// attention banks (pool 205 MB, p_pool 102 MB, conv 98 MB, p_conv 49 MB in
// bf16; twice that in f32) and ~58 MB of bf16 weights (~116 MB in f32):
// ~0.5 GB a step, ~10 GB a decode, ~3 ms at 3.35 TB/s in bf16.  The TPU
// kernel kept each batch tile's banks in VMEM across the 20 steps; 227 KB
// of shared memory per SM and a 50 MB L2 cannot hold them, so the banks
// stream from device memory every step.  What the kernel removes is the
// decode loop's ~60 host launches per step, and the round trips of the
// small per-step tensors through device memory between them.
//
// Design: one persistent cooperative launch (grid no larger than the
// co-resident blocks), seven phases per step, a grid-wide barrier (an
// atomic counter and a generation word, valid under the cooperative
// launch's co-residency guarantee) after each:
//   1. att-LSTM: tiles of 8 hidden units (their 32 gate columns) x 128
//      rows, so a block owns whole units and does the cell update itself;
//      fc's product and both biases are one (B, 4H) input made before the
//      launch;
//   2. the two h2att products, tiles of 32 columns x 32 rows;
//   3. attention scores, items of 128 bank rows of one (row, attention),
//      four rows per warp at a time;
//   4. softmax and weighted sums, items of 256 bank columns of one
//      (row, attention): each item reads its row's scores, takes the exact
//      max and sum-exp over the whole row (two passes), then sums the bank;
//   5. lang-LSTM, as 1;
//   6. vocab logits, tiles of 32 columns x 128 rows;
//   7. one block per row: the log-softmax, the UNK-suppressed pick, the
//      logprob and the next input's embedding row (a gather).
// The weights are split by output columns over the blocks, so each weight
// byte is read once per step (one block per batch tile looping over the
// steps would read all ~58-116 MB, more than L2, once per tile and step).
// Products accumulate in f32 on the SIMT units, the chunk being multiplied
// in shared memory while the next one loads; gate, softmax and log-softmax
// math in f32.  State (h, c of both cells), the next input and every
// per-step intermediate are f32 buffers the wrapper allocates; values
// written by other blocks are read with ld.global.cg (L2, not the
// incoherent L1).  No tensor cores, TMA or L2 residency yet: as built it
// takes ~20 ms a decode in f32 on an H100 80GB HBM3 at 700 W, over half of
// it in the four GEMM phases (one chunk in flight per block, and shared
// memory bandwidth on the SIMT products), not in the bank bytes.

#include "common.cuh"

#include <algorithm>
#include <climits>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int KC = 32;                  // depth of a GEMM chunk
constexpr int NC = 32;                  // output columns of a GEMM tile
constexpr int XLD = KC + 4;             // shared row stride of a chunk
constexpr int UNITS = NC / 4;           // LSTM hidden units of a tile
constexpr int ROWS_MAX = 128;           // rows of a GEMM tile with RI = 4
constexpr int GLD = NC + 1;             // shared row stride of a gate tile
constexpr int SROWS = 128;              // bank rows of a score item
constexpr int RQ = 4;                   // bank rows a warp scores at once
constexpr int DCH = 256;                // bank columns of a sum item
constexpr int NG = THREADS / (DCH / 4); // row groups of a sum item

template <typename T>
struct Args {
  const T* conv;            // (B, Tf, H)
  const T* p_conv;          // (B, Tf, A)
  const T* pool;            // (B, R, H)
  const T* p_pool;          // (B, R, A)
  const unsigned char* pnt; // (B, R), 1 = masked
  const T* w_att_x;         // (4H, E): att-LSTM W_ih, the xt columns
  const T* w_att_h;         // (4H, H)
  const float* g0;          // (B, 4H): fc W_ih[:, :H]^T + b_ih + b_hh
  const T* w_lang_ih;       // (4H, 2H)
  const T* w_lang_hh;       // (4H, H)
  const float* b_lang;      // (4H)
  const T* w_h2att;         // (2A, H): temporal rows, then region rows
  const float* b_h2att;     // (2A)
  const float* alpha_w;     // (2, A)
  const float* alpha_b;     // (2)
  const T* w_logit;         // (Vp, H)
  const float* b_logit;     // (Vp)
  const T* embed;           // (vocab, E)
  float* xt;                // (B, E) next input, relu(embed[prev])
  float* h_att;             // (2, B, H) ping-pong by step parity
  float* c_att;             // (B, H)
  float* h_lang;            // (2, B, H)
  float* c_lang;            // (B, H)
  float* ah;                // (B, 2A) h2att of both attentions
  float* scores;            // (B, Tf + R) temporal, then region scores
  float* attv;              // (B, 2, H) temporal and region results
  float* logits;            // (B, Vp)
  unsigned int* bar;        // (2) arrivals, generation; zero at launch
  int* seq;                 // (B, L)
  float* logprobs;          // (B, L)
  T* att2;                  // (B, L, R) grounding logits
  int B, Tf, R, H, A, E, V, Vp, L, unk;
};

// One operand of a GEMM: rows of x (f32 state, row stride ldx; plus x2 at
// the same offsets where x2 is not null) times rows of w (row stride ldw),
// over K columns.
template <typename T>
struct Seg {
  const float* x;
  const float* x2;
  int ldx;
  const T* w;
  int ldw;
  int K;
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Every block of the grid arrives, then all leave.  bar[0] counts the
// arrivals, bar[1] is the generation that the last arrival bumps.
__device__ void grid_sync(unsigned int* bar) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// (value, index) argmax over the block, larger value first, then the
// smaller index; every thread gets the result.
__device__ void block_argmax(float& v, int& i, float* rv, int* ri) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
  __syncthreads();
  if (lane == 0) {
    rv[warp] = v;
    ri[warp] = i;
  }
  __syncthreads();
  v = rv[0];
  i = ri[0];
  for (int w = 1; w < NWARPS; ++w)
    if (rv[w] > v || (rv[w] == v && ri[w] < i)) {
      v = rv[w];
      i = ri[w];
    }
}

// acc[i][j] = sum over the segments of x[r0 + ty + 32 i, :] .
// w[wrow[tx + 8 j], :], ty = tid / 8, tx = tid % 8; 0 for rows at or past B
// and columns with wrow < 0.  Chunks of KC columns pass through shared
// memory (Xs: 32 RI rows, Ws: NC rows, stride XLD); the next chunk's loads
// are in flight while this one is multiplied.  Rows ty + 32 i and columns
// tx + 8 j make the 16-byte shared reads of a warp conflict-free.  Every
// block reads the same rows of x: the walk over the chunks starts at chunk
// `start` (modulo their count) and wraps, so that blocks with different
// starts read different L2 lines at a time instead of queueing for the
// same ones.
template <typename T, int RI>
__device__ void gemm_tile(const Seg<T>* segs, int nseg, const int* wrow,
                          int r0, int B, int start, float acc[RI][4],
                          float* Xs, float* Ws) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 3, tx = tid & 7;
  constexpr int XR = 32 * RI / NWARPS;
  constexpr int WR = NC / NWARPS;
  float xr[XR], wr[WR];
  int wrow_l[WR];
#pragma unroll
  for (int j = 0; j < WR; ++j) wrow_l[j] = wrow[warp + NWARPS * j];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  // Straight-line loads: rows and columns are clamped into range and the
  // bounds applied afterwards, so that a warp issues all its loads before
  // it waits for the first (a load under a branch of its own is waited
  // for before the next one issues).
  auto load = [&](const Seg<T>& sg, int k0) {
    const int k = min(k0 + lane, sg.K - 1);
    const bool kok = k0 + lane < sg.K;
    const float* x = sg.x + k;
    const float* x2 = sg.x2 + k;
    if (sg.x2 != nullptr) {
#pragma unroll
      for (int i = 0; i < XR; ++i) {
        const size_t at = (size_t)min(r0 + warp + NWARPS * i, B - 1) * sg.ldx;
        xr[i] = __ldcg(x + at) + __ldcg(x2 + at);
      }
    } else {
#pragma unroll
      for (int i = 0; i < XR; ++i)
        xr[i] = __ldcg(x + (size_t)min(r0 + warp + NWARPS * i, B - 1) * sg.ldx);
    }
#pragma unroll
    for (int i = 0; i < XR; ++i)
      if (!kok || r0 + warp + NWARPS * i >= B) xr[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < WR; ++j) {
      const float v =
          gvd::to_f32(sg.w[(size_t)max(wrow_l[j], 0) * sg.ldw + k]);
      wr[j] = kok && wrow_l[j] >= 0 ? v : 0.0f;
    }
  };

  // the segment and first column of flat chunk c
  auto chunk = [&](int c, int& s, int& k0) {
    s = 0;
    while (s < nseg - 1 && c >= (segs[s].K + KC - 1) / KC) {
      c -= (segs[s].K + KC - 1) / KC;
      ++s;
    }
    k0 = c * KC;
  };
  int total = 0;
  for (int i = 0; i < nseg; ++i) total += (segs[i].K + KC - 1) / KC;
  int c = start % total, s, k0;
  chunk(c, s, k0);
  load(segs[s], k0);
  for (int n = 1;; ++n) {
#pragma unroll
    for (int i = 0; i < XR; ++i) Xs[(warp + NWARPS * i) * XLD + lane] = xr[i];
#pragma unroll
    for (int j = 0; j < WR; ++j) Ws[(warp + NWARPS * j) * XLD + lane] = wr[j];
    __syncthreads();
    const bool more = n < total;
    if (more) {
      c = c + 1 == total ? 0 : c + 1;
      chunk(c, s, k0);
      load(segs[s], k0);
    }
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float4 xv[RI], wv[4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        xv[i] = *reinterpret_cast<const float4*>(&Xs[(ty + 32 * i) * XLD + kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wv[j] = *reinterpret_cast<const float4*>(&Ws[(tx + 8 * j) * XLD + kk]);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = acc[i][j];
          a = fmaf(xv[i].x, wv[j].x, a);
          a = fmaf(xv[i].y, wv[j].y, a);
          a = fmaf(xv[i].z, wv[j].z, a);
          a = fmaf(xv[i].w, wv[j].w, a);
          acc[i][j] = a;
        }
    }
    __syncthreads();
    if (!more) break;
  }
}

// One LSTM cell for every row: gates = the segments' products + bias_mat
// (B, 4H) or bias (4H); c' = s(f) c + s(i) tanh(g), h' = s(o) tanh(c').
// c is updated in place (a unit's cell belongs to one block); h' goes to
// h_out, not to the h the segments read.
template <typename T>
__device__ void lstm_phase(const Seg<T>* segs, int nseg,
                           const float* bias_mat, const float* bias,
                           float* c, float* h_out, int B, int H, float* Xs,
                           float* Ws, int* wrow) {
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int n_ct = H / UNITS, n_rt = (B + ROWS_MAX - 1) / ROWS_MAX;
  for (int item = blockIdx.x; item < n_ct * n_rt; item += gridDim.x) {
    const int u0 = (item % n_ct) * UNITS, r0 = (item / n_ct) * ROWS_MAX;
    if (tid < NC) wrow[tid] = (tid / UNITS) * H + u0 + tid % UNITS;
    __syncthreads();
    float acc[4][4];
    gemm_tile<T, 4>(segs, nseg, wrow, r0, B, item, acc, Xs, Ws);
    float* G = Xs;                       // (ROWS_MAX, GLD) gates
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty + 32 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 8 * j;
        float v = acc[i][j];
        if (row < B)
          v += bias_mat != nullptr
                   ? bias_mat[(size_t)row * 4 * H + wrow[col]]
                   : bias[wrow[col]];
        G[(ty + 32 * i) * GLD + col] = v;
      }
    }
    __syncthreads();
    for (int e = tid; e < ROWS_MAX * UNITS; e += THREADS) {
      const int r = e / UNITS, u = e % UNITS, row = r0 + r;
      if (row >= B) continue;
      const float* g = G + r * GLD;
      const size_t at = (size_t)row * H + u0 + u;
      const float cn = sigmoidf(g[UNITS + u]) * __ldcg(c + at) +
                       sigmoidf(g[u]) * tanhf(g[2 * UNITS + u]);
      c[at] = cn;
      h_out[at] = sigmoidf(g[3 * UNITS + u]) * tanhf(cn);
    }
    __syncthreads();                     // G and wrow are rewritten next
  }
}

// out (B, N) = x w^T + bias for one segment, tiles of NC columns x 32 RI
// rows.
template <typename T, int RI>
__device__ void linear_phase(const Seg<T>& sg, const float* bias,
                             float* out, int N, int B, float* Xs, float* Ws,
                             int* wrow) {
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int n_ct = (N + NC - 1) / NC, n_rt = (B + 32 * RI - 1) / (32 * RI);
  for (int item = blockIdx.x; item < n_ct * n_rt; item += gridDim.x) {
    const int n0 = (item % n_ct) * NC, r0 = (item / n_ct) * 32 * RI;
    if (tid < NC) wrow[tid] = n0 + tid < N ? n0 + tid : -1;
    __syncthreads();
    float acc[RI][4];
    gemm_tile<T, RI>(&sg, 1, wrow, r0, B, item, acc, Xs, Ws);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = r0 + ty + 32 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 8 * j;
        if (row < B && n < N) out[(size_t)row * N + n] = acc[i][j] + bias[n];
      }
    }
    __syncthreads();                     // wrow is rewritten next
  }
}

// tanh(p_row + ah) . w over A columns for RQ rows of one warp (rows
// n + NWARPS q, those at or past n_end clamped to n_end - 1), 16-byte
// loads; the RQ rows' loads of a column group go out together.
template <typename T>
__device__ __forceinline__ void additive_scores(const T* bank, int n,
                                                int n_end, const float* ahs,
                                                const float* ws, int A,
                                                int lane, float s[RQ]) {
  const T* rows[RQ];
#pragma unroll
  for (int q = 0; q < RQ; ++q) {
    rows[q] = bank + (size_t)min(n + NWARPS * q, n_end - 1) * A;
    s[q] = 0.0f;
  }
  for (int d = 4 * lane; d < A; d += 128) {
    float v[RQ][4];
#pragma unroll
    for (int q = 0; q < RQ; ++q) gvd::load4(rows[q] + d, v[q]);
    const float4 h = *reinterpret_cast<const float4*>(&ahs[d]);
    const float4 w = *reinterpret_cast<const float4*>(&ws[d]);
#pragma unroll
    for (int q = 0; q < RQ; ++q) {
      s[q] = fmaf(tanhf(v[q][0] + h.x), w.x, s[q]);
      s[q] = fmaf(tanhf(v[q][1] + h.y), w.y, s[q]);
      s[q] = fmaf(tanhf(v[q][2] + h.z), w.z, s[q]);
      s[q] = fmaf(tanhf(v[q][3] + h.w), w.w, s[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < RQ; ++q) s[q] = gvd::warp_sum(s[q]);
}

// Phase 3: scores of SROWS bank rows of one (row b, attention) per item,
// region items first; one warp per bank row, RQ rows at a time.  Region
// scores under the pnt mask are SET to MIN_VALUE and also written to att2.
template <typename T>
__device__ void score_phase(const Args<T>& a, int t, float* sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int A = a.A;
  const int nR = (a.R + SROWS - 1) / SROWS, nT = (a.Tf + SROWS - 1) / SROWS;
  float* ahs = sm;                       // (A) h2att of this attention
  float* ws = sm + A;                    // (A) alpha_net weight
  for (int item = blockIdx.x; item < a.B * (nR + nT); item += gridDim.x) {
    const int b = item / (nR + nT), c = item % (nR + nT);
    const int which = c < nR ? 1 : 0;    // 1 = region, 0 = temporal
    const int n0 = (which ? c : c - nR) * SROWS;
    const int N = which ? a.R : a.Tf;
    const T* bank = (which ? a.p_pool : a.p_conv) + (size_t)b * N * A;
    float* out = a.scores + (size_t)b * (a.Tf + a.R) + (which ? a.Tf : 0);
    __syncthreads();                     // the previous item's reads done
    for (int d = tid; d < A; d += THREADS) {
      ahs[d] = __ldcg(a.ah + (size_t)b * 2 * A + which * A + d);
      ws[d] = a.alpha_w[which * A + d];
    }
    __syncthreads();
    const float ab = a.alpha_b[which];
    const int n_end = min(n0 + SROWS, N);
    for (int n = n0 + warp; n < n_end; n += RQ * NWARPS) {
      float s[RQ];
      additive_scores(bank, n, n_end, ahs, ws, A, lane, s);
      if (lane == 0) {
        for (int q = 0; q < RQ; ++q) {
          const int m = n + NWARPS * q;
          if (m >= n_end) break;
          float v = s[q] + ab;
          if (which) {
            if (a.pnt[(size_t)b * a.R + m]) v = gvd::MIN_VALUE;
            a.att2[((size_t)b * a.L + t) * a.R + m] = gvd::from_f32<T>(v);
          }
          out[m] = v;
        }
      }
    }
  }
}

// Phase 4: the softmax of one (row b, attention) and the weighted sum of
// DCH of its bank columns per item.  Each item takes the exact max and
// sum-exp over the whole score row; thread (g, cg) sums rows g + NG k for
// columns 4 cg .. 4 cg + 3, and the NG partial sums meet in shared memory.
template <typename T>
__device__ void sum_phase(const Args<T>& a, float* sm, float* red) {
  const int tid = threadIdx.x, H = a.H;
  const int nD = (H + DCH - 1) / DCH;
  float* pw = sm;                                    // (N) exp(s - max)
  float* part = sm + (max(a.Tf, a.R) + 3) / 4 * 4;   // (NG, DCH)
  const int g = tid / (DCH / 4), cg = tid % (DCH / 4);
  for (int item = blockIdx.x; item < a.B * 2 * nD; item += gridDim.x) {
    const int b = item / (2 * nD), c = item % (2 * nD);
    const int which = c < nD ? 1 : 0;
    const int d = (which ? c : c - nD) * DCH + 4 * cg;
    const int N = which ? a.R : a.Tf;
    const float* sc = a.scores + (size_t)b * (a.Tf + a.R) + (which ? a.Tf : 0);
    float m = -INFINITY;
    for (int n = tid; n < N; n += THREADS) {
      const float s = __ldcg(sc + n);
      pw[n] = s;
      m = fmaxf(m, s);
    }
    m = gvd::block_reduce<true>(m, red);
    float l = 0.0f;
    for (int n = tid; n < N; n += THREADS) {
      const float e = expf(pw[n] - m);
      pw[n] = e;
      l += e;
    }
    l = gvd::block_reduce<false>(l, red);
    __syncthreads();                     // every pw written
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (d < H) {
      const T* bank = (which ? a.pool : a.conv) + (size_t)b * N * H + d;
      int n = g;
      for (; n + 3 * NG < N; n += 4 * NG) {
        float v[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          gvd::load4(bank + (size_t)(n + q * NG) * H, v[q]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float p = pw[n + q * NG];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e] = fmaf(p, v[q][e], acc[e]);
        }
      }
      for (; n < N; n += NG) {
        float v[4];
        gvd::load4(bank + (size_t)n * H, v);
        const float p = pw[n];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = fmaf(p, v[e], acc[e]);
      }
    }
    *reinterpret_cast<float4*>(&part[g * DCH + 4 * cg]) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    __syncthreads();
    if (g == 0 && d < H) {
      const float inv_l = 1.0f / l;
      float* out = a.attv + ((size_t)b * 2 + which) * H + d;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = 0.0f;
        for (int q = 0; q < NG; ++q) s += part[q * DCH + 4 * cg + e];
        out[e] = s * inv_l;
      }
    }
    __syncthreads();                     // pw and part are rewritten next
  }
}

// Phase 7: one block per row: log-softmax over the first V logits as
// torch computes it ((x - max) - log(sum exp(x - max))), the first-index
// argmax of those logprobs, the runner-up when it is UNK (the winner's
// slot set to MIN_VALUE, as the plain loop does), and the chosen token's
// embedding row through ReLU as the next input.
template <typename T>
__device__ void finish_phase(const Args<T>& a, int t, float* red, int* redi) {
  const int tid = threadIdx.x;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const float* lg = a.logits + (size_t)b * a.Vp;
    float m = -INFINITY;
    for (int v = tid; v < a.V; v += THREADS) m = fmaxf(m, __ldcg(lg + v));
    m = gvd::block_reduce<true>(m, red);
    float s = 0.0f;
    for (int v = tid; v < a.V; v += THREADS) s += expf(__ldcg(lg + v) - m);
    const float log_s = logf(gvd::block_reduce<false>(s, red));
    float v1 = -INFINITY, v2 = -INFINITY;
    int i1 = INT_MAX, i2 = INT_MAX;
    for (int v = tid; v < a.V; v += THREADS) {
      const float lp = (__ldcg(lg + v) - m) - log_s;
      if (lp > v1) {
        v1 = lp;
        i1 = v;
      }
    }
    block_argmax(v1, i1, red, redi);
    for (int v = tid; v < a.V; v += THREADS) {
      const float lp = v == i1 ? gvd::MIN_VALUE : (__ldcg(lg + v) - m) - log_s;
      if (lp > v2) {
        v2 = lp;
        i2 = v;
      }
    }
    block_argmax(v2, i2, red, redi);
    const bool first = i1 != a.unk;
    const int tok = first ? i1 : i2;
    if (tid == 0) {
      a.seq[(size_t)b * a.L + t] = tok;
      a.logprobs[(size_t)b * a.L + t] = first ? v1 : v2;
    }
    const T* row = a.embed + (size_t)tok * a.E;
    for (int e = tid; e < a.E; e += THREADS)
      a.xt[(size_t)b * a.E + e] = fmaxf(gvd::to_f32(row[e]), 0.0f);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) decode_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  float* red = smem;                                 // (32) reductions
  int* redi = reinterpret_cast<int*>(smem + 32);     // (32)
  int* wrow = reinterpret_cast<int*>(smem + 64);     // (NC) weight rows
  float* sm = smem + 64 + NC;                        // phase scratch
  float* Xs = sm;
  float* Ws = sm + ROWS_MAX * XLD;
  const int B = a.B, H = a.H;
  const size_t BH = (size_t)B * H;
  for (int t = 0; t < a.L; ++t) {
    const float* ha_prev = a.h_att + (t & 1) * BH;
    float* ha = a.h_att + ((t + 1) & 1) * BH;
    const float* hl_prev = a.h_lang + (t & 1) * BH;
    float* hl = a.h_lang + ((t + 1) & 1) * BH;
    {
      const Seg<T> s[2] = {{a.xt, nullptr, a.E, a.w_att_x, a.E, a.E},
                           {ha_prev, nullptr, H, a.w_att_h, H, H}};
      lstm_phase<T>(s, 2, a.g0, nullptr, a.c_att, ha, B, H, Xs, Ws, wrow);
    }
    grid_sync(a.bar);
    {
      const Seg<T> s = {ha, nullptr, H, a.w_h2att, H, H};
      linear_phase<T, 1>(s, a.b_h2att, a.ah, 2 * a.A, B, Xs, Ws, wrow);
    }
    grid_sync(a.bar);
    score_phase<T>(a, t, sm);
    grid_sync(a.bar);
    sum_phase<T>(a, sm, red);
    grid_sync(a.bar);
    {
      const Seg<T> s[3] = {{a.attv, a.attv + H, 2 * H, a.w_lang_ih, 2 * H, H},
                           {ha, nullptr, H, a.w_lang_ih + H, 2 * H, H},
                           {hl_prev, nullptr, H, a.w_lang_hh, H, H}};
      lstm_phase<T>(s, 3, nullptr, a.b_lang, a.c_lang, hl, B, H, Xs, Ws,
                    wrow);
    }
    grid_sync(a.bar);
    {
      const Seg<T> s = {hl, nullptr, H, a.w_logit, H, H};
      linear_phase<T, 4>(s, a.b_logit, a.logits, a.Vp, B, Xs, Ws, wrow);
    }
    grid_sync(a.bar);
    finish_phase<T>(a, t, red, redi);
    grid_sync(a.bar);
  }
}

template <typename T>
int launch_decode(const Args<T>& a, cudaStream_t stream) {
  if (a.H % UNITS || a.H % 4 || a.A % 4 || a.B < 1 || a.L < 1 || a.V < 1 ||
      a.V > a.Vp)
    return (int)cudaErrorInvalidValue;
  const size_t sums = (size_t)(std::max(a.Tf, a.R) + 3) / 4 * 4 + NG * DCH;
  const size_t words =
      64 + NC +
      std::max({(size_t)(ROWS_MAX + NC) * XLD, (size_t)2 * a.A, sums});
  const size_t smem = words * sizeof(float);
  cudaError_t e = gvd::allow_smem(decode_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, decode_kernel<T>, THREADS, smem)) != cudaSuccess)
    return (int)e;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // every block must be resident at once for the grid barrier
  const int grid = sms * std::min(occ, 2);
  void* args[] = {const_cast<Args<T>*>(&a)};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(decode_kernel<T>), dim3(grid),
      dim3(THREADS), args, smem, stream);
}

}  // namespace

// Banks in the compute dtype, pnt (B, R) bytes; weights as Args lists them
// (matrices in the compute dtype, biases and alpha f32); state buffers f32,
// xt holding relu(embed[0]) and h_att[0], c_att, h_lang[0], c_lang zero,
// bar zero; outputs seq int32, logprobs f32, att2 in the compute dtype.
extern "C" int gvd_greedy_decode(
    int dtype, const void* conv, const void* p_conv, const void* pool,
    const void* p_pool, const void* pnt, const void* w_att_x,
    const void* w_att_h, const void* g0, const void* w_lang_ih,
    const void* w_lang_hh, const void* b_lang, const void* w_h2att,
    const void* b_h2att, const void* alpha_w, const void* alpha_b,
    const void* w_logit, const void* b_logit, const void* embed, void* xt,
    void* h_att, void* c_att, void* h_lang, void* c_lang, void* ah,
    void* scores, void* attv, void* logits, void* bar, void* seq,
    void* logprobs, void* att2, int B, int Tf, int R, int H, int A, int E,
    int V, int Vp, int L, int unk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  GVD_DISPATCH(dtype, T, {
    const Args<T> a = {
        (const T*)conv, (const T*)p_conv, (const T*)pool, (const T*)p_pool,
        (const unsigned char*)pnt, (const T*)w_att_x, (const T*)w_att_h,
        (const float*)g0, (const T*)w_lang_ih, (const T*)w_lang_hh,
        (const float*)b_lang, (const T*)w_h2att, (const float*)b_h2att,
        (const float*)alpha_w, (const float*)alpha_b, (const T*)w_logit,
        (const float*)b_logit, (const T*)embed, (float*)xt, (float*)h_att,
        (float*)c_att, (float*)h_lang, (float*)c_lang, (float*)ah,
        (float*)scores, (float*)attv, (float*)logits, (unsigned int*)bar,
        (int*)seq, (float*)logprobs, (T*)att2, B, Tf, R, H, A, E, V, Vp, L,
        unk};
    return launch_decode<T>(a, s);
  });
  return (int)cudaErrorInvalidValue;
}
