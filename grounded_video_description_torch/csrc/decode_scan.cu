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
// bf16; twice that in f32) and ~50 MB of bf16 weights (~100 MB in f32):
// ~0.5 GB a step, ~10 GB a decode, ~3 ms at 3.35 TB/s in bf16.  The TPU
// kernel kept each batch tile's banks in VMEM across the 20 steps; 227 KB
// of shared memory per SM and a 50 MB L2 cannot hold them, so the banks
// stream from device memory every step.  What the kernel removes is the
// decode loop's ~60 host launches per step, and the round trips of the
// small per-step tensors through device memory between them.
//
// Design: one persistent cooperative launch (grid no larger than the
// co-resident blocks), ten phases per step, a grid-wide barrier (an atomic
// counter and a generation word, valid under the cooperative launch's
// co-residency guarantee) after each:
//   1. att-LSTM gates: the GEMM below over [xt | h_att], N = 4H; fc's
//      product and both biases are one (B, 4H) input made before the
//      launch;
//   2. the att cell: each (row, unit) sums its four gates' split-K partial
//      sums in split order, adds the bias, updates c and h;
//   3. both h2att products (the GEMM, N = 2A);
//   4. their partial sums and bias into ah;
//   5. attention scores, items of 128 bank rows of one (row, attention),
//      four rows per warp at a time;
//   6. softmax and weighted sums, items of 256 bank columns of one row:
//      each item takes, for the temporal and then the region attention,
//      the exact max and sum-exp over the whole score row (two passes),
//      sums the bank, and writes att + att2;
//   7. lang-LSTM gates (the GEMM over [att + att2 | h_att | h_lang]);
//   8. the lang cell, as 2;
//   9. vocab logits (the GEMM, N = V);
//  10. one block per row: the logits' partial sums and bias into shared
//      memory, the log-softmax, the UNK-suppressed pick, the logprob and
//      the next input's embedding row (a gather).
// The four GEMM phases (1, 3, 7, 9) compute out (B, N) = x W^T with W in
// (out, in) layout, on the tensor cores with the operands swapped: 16
// weight rows (output columns) are mma.sync's A operand (m16), 8 batch
// rows of the f32 state its B operand (n8), both K-major as they lie.  An
// item is 128 output columns x 128 batch rows x one of S contiguous runs
// of 32-deep chunks of K (a split-K share; S from the launch plan, made in
// Python so that the items fill the grid); its 8 warps are 4 column groups
// of 2 m16 tiles x 2 row groups of 8 n8 tiles (16-row pairs interleaved,
// so both groups have rows at B = 100).  Each item writes its raw sum to
// its split's slice of a (S, B, N) f32 buffer, which the phase after the
// barrier sums in a fixed order (no atomics: a second launch gives the same
// bits).  Every weight byte is read once a step.  Chunks stream through a
// three-stage cp.async
// ring (weights and state both; the state from L2), and since the weights
// do not depend on the step, each block issues its next GEMM item's
// first two weight chunks before the barrier that precedes that GEMM
// phase (as soon as its shared memory is free).
//   - f32: 3xTF32 (csrc/tf32x3.cuh), both operands split at the fragment
//     load and summed in the accumulators: an item sums one split's share
//     of K (at most 384 deep at flagship), short enough for the tensor
//     cores' truncating additions (K1's GEMM, 1024 deep, flushes them).
//   - bf16 weights: mma.sync.m16n8k16, the state operands as the JAX K6
//     takes them (ops/pallas/decode_scan.py): the embedding, fc, h_att
//     (into h2att and the lang-LSTM's input), att + att2 and h_lang (into
//     the logits) rounded to bf16 once at the fragment load, one product
//     (its `.astype(xd)` before each dot); the recurrent h of both LSTMs,
//     which the JAX K6 dots from its f32 scratch against the bf16 W_hh (an
//     f32 product), as two bf16 terms hi = bf16(x), lo = bf16(x - hi), two
//     products, to ~2^-18 of the f32 state (`recurrent`: the last segment
//     of a phase of several).
// Gate, softmax and log-softmax math in f32.  State (h, c of both cells),
// the next input and every per-step intermediate are f32 buffers the
// wrapper allocates; values written by other blocks are read with
// ld.global.cg or cp.async.cg (L2, not the incoherent L1).  An optional
// buffer takes %globaltimer stamps from block 0 after every barrier, and
// an option runs the barriers alone: both for timing the phases.

#include "tf32x3.cuh"

#include <algorithm>
#include <climits>

namespace {

using gvd::cp_async16;
using gvd::cp_async_commit;
using gvd::cp_async_wait;

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int SROWS = 128;              // bank rows of a score item
constexpr int RQ = 4;                   // bank rows a warp scores at once
constexpr int DCH = 256;                // bank columns of a sum item
constexpr int NG = THREADS / (DCH / 4); // row groups of a sum item
constexpr int HEAD_WORDS = 64;          // reduction scratch before the rest

// The GEMM phases (ops/kernels/decode_scan.py holds the same numbers):
constexpr int NC = 128;                 // output columns of an item
constexpr int RT = 128;                 // batch rows of an item
constexpr int KC = 32;                  // depth of a chunk
constexpr int STAGES = 3;               // cp.async ring

// A stage of the ring: NC weight rows (LDW elements apart), then RT state
// rows (LDX floats apart).  f32: both K-major tiles are read by ldmatrix,
// rows 36 words apart (8 rows on distinct banks).  bf16: the weights by
// ldmatrix, rows 40 bf16 (20 words) apart; the f32 state by 8-byte loads,
// rows 40 words apart (the 16 rows of a half-warp on distinct banks).
template <typename T>
struct Ring {
  static constexpr int LDW = sizeof(T) == 4 ? KC + 4 : KC + 8;
  static constexpr int LDX = sizeof(T) == 4 ? KC + 4 : KC + 8;
  static constexpr int W_BYTES = NC * LDW * (int)sizeof(T);
  static constexpr int STAGE = W_BYTES + RT * LDX * 4;
  static constexpr int BYTES = STAGES * STAGE;
};

// One operand segment of a GEMM phase: rows of the f32 state x (row stride
// ldx) times rows of w (row stride ldw), over K columns.
template <typename T>
struct Seg {
  const float* x;
  int ldx;
  const T* w;
  int ldw;
  int K;
};

// out (B, N) = sum over the segments of x w^T, in S splits of the chunks.
template <typename T>
struct Gemm {
  Seg<T> seg[3];
  int nseg, N, S;

  __device__ int chunks() const {
    int c = 0;
    for (int s = 0; s < nseg; ++s) c += (seg[s].K + KC - 1) / KC;
    return c;
  }
  __device__ int items(int B) const {
    return (N + NC - 1) / NC * ((B + RT - 1) / RT) * S;
  }
};

// Item it of a GEMM phase: columns n0.., rows r0.., split z, chunks
// [c0, c1) of the phase's chunk order (segment by segment).
struct Item {
  int n0, r0, z, c0, c1;
};

template <typename T>
__device__ Item item_of(const Gemm<T>& g, int it) {
  const int n_ct = (g.N + NC - 1) / NC, unit = it / g.S, z = it % g.S;
  const int nch = g.chunks();
  return {(unit % n_ct) * NC, (unit / n_ct) * RT, z, z * nch / g.S,
          (z + 1) * nch / g.S};
}

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
  const T* w_logit;         // (Vp, H); the first V rows are used
  const float* b_logit;     // (Vp)
  const T* embed;           // (vocab, E)
  float* xt;                // (B, E) next input, relu(embed[prev])
  float* h_att;             // (2, B, H) ping-pong by step parity
  float* c_att;             // (B, H)
  float* h_lang;            // (2, B, H)
  float* c_lang;            // (B, H)
  float* ah;                // (B, 2A) h2att of both attentions
  float* scores;            // (B, Tf + R) temporal, then region scores
  float* attv;              // (B, H) att + att2
  float* part;              // (S, B, N) the GEMM phases' split sums
  unsigned int* bar;        // (2) arrivals, generation; zero at launch
  int* seq;                 // (B, L)
  float* logprobs;          // (B, L)
  T* att2;                  // (B, L, R) grounding logits
  unsigned long long* stamps;  // (1 + 10 L) or null: a stamp a barrier
  int B, Tf, R, H, A, E, V, Vp, L, unk;
  int s_att, s_h2att, s_lang, s_logit;   // splits of the GEMM phases
  int barriers_only;
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
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

// ------------------------------------------------------------ GEMM phases --
// The segment and first column of chunk c.
template <typename T>
__device__ __forceinline__ const Seg<T>& chunk_seg(const Gemm<T>& g, int c,
                                                   int& k0) {
  int s = 0;
  while (s < g.nseg - 1 && c >= (g.seg[s].K + KC - 1) / KC) {
    c -= (g.seg[s].K + KC - 1) / KC;
    ++s;
  }
  k0 = c * KC;
  return g.seg[s];
}

// Whether chunk c lies in the last segment of a phase of several: the
// recurrent h of both LSTM phases, which bf16 keeps whole.
template <typename T>
__device__ __forceinline__ bool recurrent(const Gemm<T>& g, int c) {
  int k0;
  return g.nseg > 1 && &chunk_seg(g, c, k0) == &g.seg[g.nseg - 1];
}

// Chunk c's NC weight rows into a stage, 16 bytes a copy; rows at or past
// N and columns at or past the segment's K arrive as zeros.
template <typename T>
__device__ void load_w(const Gemm<T>& g, const Item& im, int c,
                       char* stage) {
  constexpr int EPC = 16 / (int)sizeof(T), CPR = KC / EPC;
  int k0;
  const Seg<T>& sg = chunk_seg(g, c, k0);
  T* Ws = reinterpret_cast<T*>(stage);
#pragma unroll
  for (int i = 0; i < NC * CPR / THREADS; ++i) {
    const int p = threadIdx.x + i * THREADS, r = p / CPR,
              kc = (p % CPR) * EPC, n = im.n0 + r, k = k0 + kc;
    const bool ok = n < g.N && k < sg.K;
    cp_async16(Ws + r * Ring<T>::LDW + kc,
               ok ? sg.w + (size_t)n * sg.ldw + k : sg.w, ok);
  }
}

// Chunk c's RT state rows (f32) into a stage; rows at or past B and
// columns at or past K arrive as zeros.
template <typename T>
__device__ void load_x(const Gemm<T>& g, const Item& im, int c, int B,
                       char* stage) {
  constexpr int CPR = KC / 4;
  int k0;
  const Seg<T>& sg = chunk_seg(g, c, k0);
  float* Xs = reinterpret_cast<float*>(stage + Ring<T>::W_BYTES);
#pragma unroll
  for (int i = 0; i < RT * CPR / THREADS; ++i) {
    const int p = threadIdx.x + i * THREADS, r = p / CPR,
              kc = (p % CPR) * 4, b = im.r0 + r, k = k0 + kc;
    const bool ok = b < B && k < sg.K;
    cp_async16(Xs + r * Ring<T>::LDX + kc,
               ok ? sg.x + (size_t)b * sg.ldx + k : sg.x, ok);
  }
}

// The weight chunks of an item's first STAGES - 1 stages, one commit
// group each (empty past the item's chunks).
template <typename T>
__device__ void prefetch_w(const Gemm<T>& g, const Item& im, char* ring) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (im.c0 + s < im.c1) load_w(g, im, im.c0 + s, ring + s * Ring<T>::STAGE);
    cp_async_commit();
  }
}

// The block's first item of phase g, before the barrier that precedes it
// (shared memory must be free).
template <typename T>
__device__ void prefetch_phase(const Gemm<T>& g, int B, char* ring) {
  if ((int)blockIdx.x < g.items(B))
    prefetch_w(g, item_of(g, blockIdx.x), ring);
}

// Two f32 values rounded to a bf16 pair.
__device__ __forceinline__ uint32_t round_bf16(float2 x) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two f32 values as bf16 pairs hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float2 x, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x.x - hf.x, x.y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// acc[m][j] += the stage's products for warp (wm, wn): m16 tiles of weight
// rows 32 wm + 16 m, n8 tiles j of state rows 16 (2 (j / 2) + wn) + 8 (j %
// 2); row pairs at or past `rows` (B - r0) are skipped.
__device__ __forceinline__ void mma_chunk(const float* Ws, const float* Xs,
                                          float (&acc)[2][8][4], int wm,
                                          int wn, int lane, int rows) {
  constexpr int LDW = Ring<float>::LDW, LDX = Ring<float>::LDX;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 8) {
    const gvd::FragA a0 = gvd::load_a(Ws, LDW, wm * 32, kk, lane);
    const gvd::FragA a1 = gvd::load_a(Ws, LDW, wm * 32 + 16, kk, lane);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int rb = (2 * p + wn) * 16;
      if (rb >= rows) break;
      gvd::FragB b[2];
      gvd::load_b_nk2(b, Xs, LDX, rb, kk, lane);
      gvd::mma3_n<2>(acc[0] + 2 * p, a0, b);
      gvd::mma3_n<2>(acc[1] + 2 * p, a1, b);
    }
  }
}

// bf16: `split` keeps the chunk's f32 state whole as hi + lo, two
// products; else it is rounded to bf16, one product.
__device__ __forceinline__ void mma_chunk(const __nv_bfloat16* Ws,
                                          const float* Xs,
                                          float (&acc)[2][8][4], int wm,
                                          int wn, int lane, int rows,
                                          bool split) {
  constexpr int LDW = Ring<__nv_bfloat16>::LDW;
  constexpr int LDX = Ring<__nv_bfloat16>::LDX;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
      gvd::ldsm_x4(a[m], Ws + (wm * 32 + m * 16 + (lane & 15)) * LDW + kk +
                             (lane >> 4) * 8);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int rb = (2 * p + wn) * 16;
      if (rb >= rows) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* x = Xs + (rb + 8 * h + g) * LDX + kk + 2 * t;
        const float2 x0 = *reinterpret_cast<const float2*>(x);
        const float2 x1 = *reinterpret_cast<const float2*>(x + 8);
        uint32_t hi[2];
        if (split) {
          uint32_t lo[2];
          split_bf16(x0, hi[0], lo[0]);
          split_bf16(x1, hi[1], lo[1]);
#pragma unroll
          for (int m = 0; m < 2; ++m)
            gvd::mma16816(acc[m][2 * p + h], a[m], lo[0], lo[1]);
        } else {
          hi[0] = round_bf16(x0);
          hi[1] = round_bf16(x1);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
          gvd::mma16816(acc[m][2 * p + h], a[m], hi[0], hi[1]);
      }
    }
  }
}

// Every item of phase g: its chunks through the ring, then its raw sums to
// part[z] (B, N).  `prefetched`: the block's first item's weight chunks
// are in flight already (prefetch_phase).
template <typename T>
__device__ void gemm_phase(const Gemm<T>& g, float* part, int B, char* ring,
                           bool prefetched) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int items = g.items(B);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Item im = item_of(g, it);
    const int n = im.c1 - im.c0, rows = B - im.r0;
    if (!prefetched) prefetch_w(g, im, ring);
    prefetched = false;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n) load_x(g, im, im.c0 + s, B, ring + s * Ring<T>::STAGE);
      cp_async_commit();
    }
    float acc[2][8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
    for (int c = 0; c < n; ++c) {
      cp_async_wait<STAGES - 2>();   // chunk c has landed
      __syncthreads();               // ... for every thread; c - 1's stage free
      const int nxt = c + STAGES - 1;
      if (nxt < n) {
        char* st = ring + (nxt % STAGES) * Ring<T>::STAGE;
        load_w(g, im, im.c0 + nxt, st);
        load_x(g, im, im.c0 + nxt, B, st);
      }
      cp_async_commit();
      const char* st = ring + (c % STAGES) * Ring<T>::STAGE;
      const T* Ws = reinterpret_cast<const T*>(st);
      const float* Xs = reinterpret_cast<const float*>(st + Ring<T>::W_BYTES);
      if constexpr (sizeof(T) == 4)
        mma_chunk(Ws, Xs, acc, wm, wn, lane, rows);
      else
        mma_chunk(Ws, Xs, acc, wm, wn, lane, rows,
                  recurrent(g, im.c0 + c));
    }
    cp_async_wait<0>();
    __syncthreads();                 // the ring is free for the next item

    // accumulator e of tile (m, j): weight row (output column) g + 8 (e /
    // 2), state row (batch row) 2 t + e % 2
    float* P = part + (size_t)im.z * B * g.N;
    const int gq = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int rb = (2 * (j >> 1) + wn) * 16 + 8 * (j & 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = im.n0 + wm * 32 + m * 16 + gq + 8 * (e >> 1);
          const int row = im.r0 + rb + 2 * t + (e & 1);
          if (row < B && col < g.N) P[(size_t)row * g.N + col] = acc[m][j][e];
        }
      }
  }
}

// out[b, n] of a GEMM phase: its S split sums in split order.
__device__ __forceinline__ float split_sum(const float* part, int S, int B,
                                           int N, size_t at) {
  float s = 0.0f;
  for (int z = 0; z < S; ++z) s += __ldcg(part + (size_t)z * B * N + at);
  return s;
}

// One LSTM cell for every (row, unit), grid-stride: gates = the GEMM's
// sums + bias_mat (B, 4H) or bias (4H); c' = s(f) c + s(i) tanh(g), h' =
// s(o) tanh(c').  c is updated in place; h' goes to h_out, not to the h
// the GEMM read.
__device__ void cell_phase(const float* part, int S, const float* bias_mat,
                           const float* bias, float* c, float* h_out, int B,
                           int H) {
  const int N = 4 * H;
  for (int e = blockIdx.x * THREADS + threadIdx.x; e < B * H;
       e += gridDim.x * THREADS) {
    const int b = e / H, u = e - b * H;
    float gate[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t at = (size_t)b * N + j * H + u;
      gate[j] = split_sum(part, S, B, N, at) +
                (bias_mat != nullptr ? bias_mat[at] : bias[j * H + u]);
    }
    const float cn =
        sigmoidf(gate[1]) * __ldcg(c + e) + sigmoidf(gate[0]) * tanhf(gate[2]);
    c[e] = cn;
    h_out[e] = sigmoidf(gate[3]) * tanhf(cn);
  }
}

// out (B, N) = the GEMM's sums + bias, grid-stride.
__device__ void bias_phase(const float* part, int S, const float* bias,
                           float* out, int B, int N) {
  for (int e = blockIdx.x * THREADS + threadIdx.x; e < B * N;
       e += gridDim.x * THREADS)
    out[e] = split_sum(part, S, B, N, e) + bias[e % N];
}

// ------------------------------------------------------- attention phases --
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

// Scores of SROWS bank rows of one (row b, attention) per item, region
// items first; one warp per bank row, RQ rows at a time.  Region scores
// under the pnt mask are SET to MIN_VALUE and also written to att2.
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

// The softmaxes of one row b and the weighted sums of DCH of its bank
// columns per item, the temporal attention and then the region one: each
// takes the exact max and sum-exp over its whole score row; thread (g, cg)
// sums rows g + NG k for columns 4 cg .. 4 cg + 3, the NG partial sums
// meet in shared memory, and att + att2 goes to attv.
template <typename T>
__device__ void sum_phase(const Args<T>& a, float* sm, float* red) {
  const int tid = threadIdx.x, H = a.H;
  const int nD = (H + DCH - 1) / DCH;
  float* pw = sm;                                    // (N) exp(s - max)
  float* part = sm + (max(a.Tf, a.R) + 3) / 4 * 4;   // (NG, DCH)
  const int g = tid / (DCH / 4), cg = tid % (DCH / 4);
  for (int item = blockIdx.x; item < a.B * nD; item += gridDim.x) {
    const int b = item / nD, d = (item % nD) * DCH + 4 * cg;
    float res[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int which = 0; which < 2; ++which) {        // 0 = temporal
      const int N = which ? a.R : a.Tf;
      const float* sc =
          a.scores + (size_t)b * (a.Tf + a.R) + (which ? a.Tf : 0);
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
      __syncthreads();                   // every pw written
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
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = 0.0f;
          for (int q = 0; q < NG; ++q) s += part[q * DCH + 4 * cg + e];
          res[e] += s * inv_l;
        }
      }
      __syncthreads();                   // pw and part are rewritten next
    }
    if (g == 0 && d < H)
      *reinterpret_cast<float4*>(a.attv + (size_t)b * H + d) =
          make_float4(res[0], res[1], res[2], res[3]);
  }
}

// One block per row: the logits (the GEMM's sums + bias) into shared
// memory, the log-softmax over the first V as torch computes it ((x - max)
// - log(sum exp(x - max))), the first-index argmax of those logprobs, the
// runner-up when it is UNK (the winner's slot set to MIN_VALUE, as the
// plain loop does), and the chosen token's embedding row through ReLU as
// the next input.
template <typename T>
__device__ void finish_phase(const Args<T>& a, int t, float* sm, float* red,
                             int* redi) {
  const int tid = threadIdx.x;
  float* lg = sm;                                    // (V)
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    float m = -INFINITY;
    for (int v = tid; v < a.V; v += THREADS) {
      const float x = split_sum(a.part, a.s_logit, a.B, a.V,
                                (size_t)b * a.V + v) + a.b_logit[v];
      lg[v] = x;
      m = fmaxf(m, x);
    }
    m = gvd::block_reduce<true>(m, red);
    float s = 0.0f;
    for (int v = tid; v < a.V; v += THREADS) s += expf(lg[v] - m);
    const float log_s = logf(gvd::block_reduce<false>(s, red));
    float v1 = -INFINITY, v2 = -INFINITY;
    int i1 = INT_MAX, i2 = INT_MAX;
    for (int v = tid; v < a.V; v += THREADS) {
      const float lp = (lg[v] - m) - log_s;
      if (lp > v1) {
        v1 = lp;
        i1 = v;
      }
    }
    block_argmax(v1, i1, red, redi);
    for (int v = tid; v < a.V; v += THREADS) {
      const float lp = v == i1 ? gvd::MIN_VALUE : (lg[v] - m) - log_s;
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
    __syncthreads();                     // lg is rewritten next
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) decode_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  float* red = smem;                                 // (32) reductions
  int* redi = reinterpret_cast<int*>(smem + 32);     // (32)
  float* sm = smem + HEAD_WORDS;                     // phase scratch, ring
  char* ring = reinterpret_cast<char*>(sm);
  const int B = a.B, H = a.H;
  const size_t BH = (size_t)B * H;
  const bool work = !a.barriers_only;
  int n_stamp = 0;
  auto barrier = [&]() {
    grid_sync(a.bar);
    if (a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
      a.stamps[n_stamp++] = globaltimer();
  };
  if (a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    a.stamps[n_stamp++] = globaltimer();
  for (int t = 0; t < a.L; ++t) {
    const float* ha_prev = a.h_att + (t & 1) * BH;
    float* ha = a.h_att + ((t + 1) & 1) * BH;
    const float* hl_prev = a.h_lang + (t & 1) * BH;
    float* hl = a.h_lang + ((t + 1) & 1) * BH;
    // each LSTM's recurrent h is its phase's last segment (`recurrent`)
    const Gemm<T> g_att = {{{a.xt, a.E, a.w_att_x, a.E, a.E},
                            {ha_prev, H, a.w_att_h, H, H}},
                           2, 4 * H, a.s_att};
    const Gemm<T> g_h2att = {{{ha, H, a.w_h2att, H, H}}, 1, 2 * a.A,
                             a.s_h2att};
    const Gemm<T> g_lang = {{{a.attv, H, a.w_lang_ih, 2 * H, H},
                             {ha, H, a.w_lang_ih + H, 2 * H, H},
                             {hl_prev, H, a.w_lang_hh, H, H}},
                            3, 4 * H, a.s_lang};
    const Gemm<T> g_logit = {{{hl, H, a.w_logit, H, H}}, 1, a.V, a.s_logit};
    if (work) {
      if (t == 0) prefetch_phase(g_att, B, ring);
      gemm_phase(g_att, a.part, B, ring, true);
      prefetch_phase(g_h2att, B, ring);
    }
    barrier();
    if (work) cell_phase(a.part, a.s_att, a.g0, nullptr, a.c_att, ha, B, H);
    barrier();
    if (work) gemm_phase(g_h2att, a.part, B, ring, true);
    barrier();
    if (work) bias_phase(a.part, a.s_h2att, a.b_h2att, a.ah, B, 2 * a.A);
    barrier();
    if (work) score_phase<T>(a, t, sm);
    barrier();
    if (work) {
      sum_phase<T>(a, sm, red);
      prefetch_phase(g_lang, B, ring);
    }
    barrier();
    if (work) {
      gemm_phase(g_lang, a.part, B, ring, true);
      prefetch_phase(g_logit, B, ring);
    }
    barrier();
    if (work) cell_phase(a.part, a.s_lang, nullptr, a.b_lang, a.c_lang, hl, B,
                         H);
    barrier();
    if (work) gemm_phase(g_logit, a.part, B, ring, true);
    barrier();
    if (work) {
      finish_phase<T>(a, t, sm, red, redi);
      if (t + 1 < a.L) prefetch_phase(g_att, B, ring);
    }
    barrier();
  }
}

// Shared memory the kernel needs, in bytes (the plan's smem must cover it).
template <typename T>
size_t smem_need(const Args<T>& a) {
  const size_t sums = (size_t)(std::max(a.Tf, a.R) + 3) / 4 * 4 + NG * DCH;
  const size_t words = std::max({(size_t)Ring<T>::BYTES / 4,
                                 (size_t)2 * a.A, sums, (size_t)a.V});
  return (HEAD_WORDS + words) * sizeof(float);
}

template <typename T>
int launch_decode(const Args<T>& a, int grid, int smem, cudaStream_t stream) {
  if (a.H % 8 || a.E % 8 || a.A % 4 || a.B < 1 || a.L < 1 || a.V < 1 ||
      a.V > a.Vp || grid < 1 || a.s_att < 1 || a.s_h2att < 1 ||
      a.s_lang < 1 || a.s_logit < 1 || (size_t)smem < smem_need(a))
    return (int)cudaErrorInvalidValue;
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
  // every block must be resident at once for the grid barrier
  if (occ * sms < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<Args<T>*>(&a)};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(decode_kernel<T>), dim3(grid),
      dim3(THREADS), args, smem, stream);
}

}  // namespace

// Banks in the compute dtype, pnt (B, R) bytes; weights as Args lists them
// (matrices in the compute dtype, biases and alpha f32); state buffers f32,
// xt holding relu(embed[0]) and h_att[0], c_att, h_lang[0], c_lang zero,
// bar zero; part (max splits x B x N over the GEMM phases) f32; outputs
// seq int32, logprobs f32, att2 in the compute dtype; stamps null or
// 1 + 10 L uint64.  The plan (ops/kernels/decode_scan.py decode_scan_plan):
// the grid, the splits of the att-LSTM, h2att, lang-LSTM and logit GEMMs,
// and the shared memory a block.
extern "C" int gvd_greedy_decode(
    int dtype, const void* conv, const void* p_conv, const void* pool,
    const void* p_pool, const void* pnt, const void* w_att_x,
    const void* w_att_h, const void* g0, const void* w_lang_ih,
    const void* w_lang_hh, const void* b_lang, const void* w_h2att,
    const void* b_h2att, const void* alpha_w, const void* alpha_b,
    const void* w_logit, const void* b_logit, const void* embed, void* xt,
    void* h_att, void* c_att, void* h_lang, void* c_lang, void* ah,
    void* scores, void* attv, void* part, void* bar, void* seq,
    void* logprobs, void* att2, void* stamps, int B, int Tf, int R, int H,
    int A, int E, int V, int Vp, int L, int unk, int grid, int s_att,
    int s_h2att, int s_lang, int s_logit, int smem, int barriers_only,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  GVD_DISPATCH(dtype, T, {
    const Args<T> a = {
        (const T*)conv, (const T*)p_conv, (const T*)pool, (const T*)p_pool,
        (const unsigned char*)pnt, (const T*)w_att_x, (const T*)w_att_h,
        (const float*)g0, (const T*)w_lang_ih, (const T*)w_lang_hh,
        (const float*)b_lang, (const T*)w_h2att, (const float*)b_h2att,
        (const float*)alpha_w, (const float*)alpha_b, (const T*)w_logit,
        (const float*)b_logit, (const T*)embed,
        (float*)xt, (float*)h_att, (float*)c_att, (float*)h_lang,
        (float*)c_lang, (float*)ah,
        (float*)scores, (float*)attv, (float*)part, (unsigned int*)bar,
        (int*)seq, (float*)logprobs, (T*)att2, (unsigned long long*)stamps,
        B, Tf, R, H, A, E, V, Vp, L, unk, s_att, s_h2att, s_lang, s_logit,
        barriers_only};
    return launch_decode<T>(a, grid, smem, s);
  });
  return (int)cudaErrorInvalidValue;
}
