// Bidirectional GRU / LSTM recurrence over precomputed input projections (K2).
//
// Replaces grounded_video_description_tpu/ops/pallas/birnn.py
// ::birnn_recurrence.  Inputs: gi (T, 2, B, G) = x W_ih^T + b for both
// direction lanes (lane 1 already time-reversed by the caller), wh (2, H, G),
// bh (2, G) (GRU only; the LSTM bias is folded into gi).  Output: ys
// (T, 2, B, H), lane 1 still in reversed time.  G = 3H (GRU: r, z, n;
// n = tanh(i_n + r * (W_hn h + b_hn))) or 4H (LSTM: i, f, g, o).  The
// carry, the gate math and the product h W_hh are f32 in both dtypes.
// Training: the f32 SIMT kernel also stores each step's gates, and
// birnn_backward_kernel (below) runs the reverse-time pass.
//
// What bounds it on an H100: the T-step chain.  Each step needs the whole
// W_hh of its direction (512 x 1536 at the flagship: 1.5 MB in bf16, 3 MB
// in f32), far more than one block's 227 KB of shared memory, while the
// step's arithmetic is small (34 x 1536 x 512 FMAs per batch tile of 34).
// Re-reading W_hh from L2 every step made the previous design L2-bound.
// Design: one thread-block cluster per (direction, batch tile).
//  * W_hh stays in shared memory for the whole call.  The cluster's C
//    blocks split the direction's hidden units: block c owns units
//    [c Up, c Up + Up) and holds their NG gate columns, all H rows, so a
//    thread computes every gate of its (row, unit) and the gate math needs
//    no exchange.  Where a block's share does not fit beside h (the f32
//    GRU and LSTM) the first KR rows of each K-split stay resident and the
//    rest are read from global memory (L2) at every step.
//  * h moves through distributed shared memory (DSMEM) by PUSH: every
//    block holds the whole h of its batch tile (bt, C Up) in f32; after
//    the gate math it stores its new slice into every peer's copy.  The
//    stores are fire-and-forget, so no block waits on a remote read.  Two
//    cluster barriers a step order them: the first (arrive after the
//    product, wait after the gate math, so its latency hides behind the
//    gates) says every block has read the old h; the second says every
//    new slice has landed.
//  * gi[t + 1] is prefetched with cp.async into shared memory while step
//    t + 1's product runs.
//  * SIMT route (f32, and bf16 where the tensor-core route does not fit):
//    8 warps, 2 row groups x 4 K-splits, one lane per unit (with more
//    than 32 units a block, 2 unit groups x 2 row groups x 2 K-splits).
//    Each thread accumulates its NG x RPT (gate, row) sums over its K-split
//    in registers (f32, bf16 W widened as it is read); the K-split
//    partials meet in shared memory gate by gate, each thread summing a
//    quarter of its rows, so that all 8 warps run the gate math.
//  * Tensor-core route (bf16): see birnn_mma_kernel below.
// The plan (C, batch tile, Up, the K-split width, the resident rows, the
// shared memory) is computed in Python (ops/kernels/birnn.py::birnn_plan);
// this file checks it and launches.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;     // 8 warps
constexpr int SMEM_MAX = 232448;

struct Plan {
  int C;    // blocks per cluster
  int bt;   // batch rows per cluster
  int Up;   // hidden units per block (a multiple of 4, at most 64)
  int KW;   // rows of W_hh per K-split (a multiple of 4)
  int KR;   // resident rows per K-split (a multiple of 4, <= KW)
};

// Lanes are units: one group of 32 units, or two; the 8 warps are the
// unit groups x 2 row groups x the K-splits (4, or 2 with two unit groups).
__host__ __device__ constexpr int unit_groups(int Up) { return (Up + 31) / 32; }
__host__ __device__ constexpr int k_splits(int Up) {
  return 4 / unit_groups(Up);
}

// Rows of the SIMT route's h buffer: a row group reads RPT rows from its
// first, (bt + 1) / 2 or 0, whether they are the tile's or zero padding.
__host__ __device__ constexpr int h_rows(int bt, int rpt) {
  return (bt + 1) / 2 + rpt;
}

// Gate values per (step, row, unit) that the training route's forward saves
// for its backward: the GRU's r, z, n and W_hn h + b_hn; the LSTM's i, f, g,
// o and c.
__host__ __device__ constexpr int saved_gates(bool gru) { return gru ? 4 : 5; }

// Shared memory of one block, in bytes, in the order of the kernel's
// buffers; the Python plan computes the same (birnn.py::_smem_bytes).
__host__ size_t smem_bytes(const Plan& p, int rpt, int NG, bool lstm,
                           int tsize) {
  const int KS = k_splits(p.Up);
  const size_t w = (size_t)KS * p.KR * NG * p.Up * tsize;
  const size_t hfull = (size_t)h_rows(p.bt, rpt) * KS * p.KW * 4;
  const size_t slice = (size_t)p.bt * p.Up * 4;
  const size_t cell = lstm ? slice : 0;
  const size_t gbuf = ((size_t)p.bt * NG * p.Up * tsize + 15) / 16 * 16;
  const size_t red = (size_t)KS * p.bt * p.Up * 4;
  return w + hfull + slice + cell + gbuf + red;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// h' of one (row, unit) from its input projections x, recurrent products
// a (+ bias b for the GRU), old h (GRU) or cell c (LSTM, updated).  sv,
// where not null (the training route's forward), receives what the
// backward needs, ld floats apart: the GRU's r, z, n and W_hn h + b_hn, the
// LSTM's i, f, g, o and the new c.  The same instructions give h' either
// way, so the training route's output is the inference route's, bit for bit.
__device__ __forceinline__ float gru_gate(float xr, float xz, float xn,
                                         float ar, float az, float an,
                                         float br, float bz, float bn,
                                         float h_old, float* sv, int ld) {
  const float r = sigmoidf(xr + ar + br);
  const float z = sigmoidf(xz + az + bz);
  const float hn = an + bn;
  const float n = tanhf(xn + r * hn);
  if (sv != nullptr) {
    sv[0] = r;
    sv[ld] = z;
    sv[2 * ld] = n;
    sv[3 * ld] = hn;
  }
  return (1.0f - z) * n + z * h_old;
}
__device__ __forceinline__ float lstm_gate(float xi, float xf, float xg,
                                          float xo, float ai, float af,
                                          float ag, float ao, float& c,
                                          float* sv, int ld) {
  const float ig = sigmoidf(xi + ai);
  const float fg = sigmoidf(xf + af);
  const float gg = tanhf(xg + ag);
  const float og = sigmoidf(xo + ao);
  c = fg * c + ig * gg;
  if (sv != nullptr) {
    sv[0] = ig;
    sv[ld] = fg;
    sv[2 * ld] = gg;
    sv[3 * ld] = og;
    sv[4 * ld] = c;
  }
  return og * tanhf(c);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
// The two halves of a cluster barrier: memory before the arrive (release)
// is visible to every block of the cluster after its wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// gi[t] of this block's (rows, units) into gbuf (bt, NG, Up), 4 bytes per
// copy (two bf16 units: H is even in bf16); rows past B and units past H
// are zero-filled.
template <typename T, int NG>
__device__ void prefetch_gi(T* gbuf, const T* gi, int t, int k, int b0,
                            int B, int H, int j0, const Plan& p) {
  constexpr int PER = 4 / sizeof(T);
  const int wpr = p.Up / PER;
  const int n = p.bt * NG * wpr;
  const size_t G = (size_t)NG * H;
  const T* step = gi + ((size_t)t * 2 + k) * B * G;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int w = i % wpr, bg = i / wpr, g = bg % NG, b = bg / NG;
    const int u = w * PER, j = j0 + u;
    const bool ok = b0 + b < B && j < H;
    const T* src = ok ? step + (size_t)(b0 + b) * G + (size_t)g * H + j : gi;
    cp_async4(gbuf + (b * NG + g) * p.Up + u, src, ok);
  }
  cp_async_commit();
}

// acc[g][i] += sum over n rows q of h[i][q] * W[q][g], for the RPT rows
// of hs (row stride ld; rows past the tile's are zero, so no row needs a
// test) and one unit: W row q at w + q * wrow, gate g at + g * wg.  n is a
// multiple of 4.  GUARD: rows at or past kvalid read as zero (the streamed
// rows of global memory, unrolled further so that more loads are in
// flight; resident rows are zero-filled in shared memory).
template <typename T, int NG, int RPT, bool GUARD>
__device__ __forceinline__ void product(float (&acc)[NG][RPT],
                                        const float* hs, int ld, int n,
                                        const T* w, size_t wrow, size_t wg,
                                        int kvalid) {
#pragma unroll(GUARD ? 4 : 1)
  for (int q = 0; q < n; q += 4) {
    float wv[4][NG];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int g = 0; g < NG; ++g)
        wv[e][g] = !GUARD || q + e < kvalid
                       ? gvd::to_f32(w[(q + e) * wrow + g * wg]) : 0.0f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float4 h = *reinterpret_cast<const float4*>(hs + i * ld + q);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float a = acc[g][i];
        a = fmaf(h.x, wv[0][g], a);
        a = fmaf(h.y, wv[1][g], a);
        a = fmaf(h.z, wv[2][g], a);
        a = fmaf(h.w, wv[3][g], a);
        acc[g][i] = a;
      }
    }
  }
}

// The new slice (bt, Up) into columns [j0, j0 + Up) of every block's hfull
// (this one's too), rows HP apart, 16 bytes per DSMEM store.
__device__ __forceinline__ void push_slice(cg::cluster_group& cl,
                                           const float* slice, float* hfull,
                                           int HP, int j0, const Plan& p) {
  const int uq = p.Up / 4;
  for (int i = threadIdx.x; i < p.bt * uq; i += THREADS) {
    const int b = i / uq, u4 = (i - b * uq) * 4;
    const float4 v = *reinterpret_cast<const float4*>(slice + b * p.Up + u4);
    float* dst = hfull + b * HP + j0 + u4;
    for (int r = 0; r < p.C; ++r)
      *reinterpret_cast<float4*>(cl.map_shared_rank(dst, r)) = v;
  }
}

// Grid (C, tiles, 2): one cluster of C blocks per (batch tile, direction).
// exchange_only: run only the exchange of h through DSMEM and the two
// cluster barriers of every step (no product, no gates, no output), to
// time them alone.  gates_ (f32 only, else null): the training route's
// saved gates, (T, 2, B, NS, H) f32 with NS = saved_gates(GRU).
template <typename T, bool GRU, int RPT>
__global__ void __launch_bounds__(THREADS, 1)
birnn_cluster_kernel(const void* gi_, const void* wh_, const void* bh_,
                     void* out_, void* gates_, int n_steps, int B, int H,
                     Plan p, int exchange_only) {
  constexpr int NG = GRU ? 3 : 4;
  constexpr int NS = saved_gates(GRU);
  const T* gi = static_cast<const T*>(gi_);
  const T* bh = static_cast<const T*>(bh_);
  T* out = static_cast<T*>(out_);
  float* gates = static_cast<float*>(gates_);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.block_rank();
  const int k = blockIdx.z;
  const int b0 = blockIdx.y * p.bt, j0 = c * p.Up;
  const int G = NG * H;
  const int KS = k_splits(p.Up), RS = 2;
  const int HP = KS * p.KW;         // row stride of hfull (>= C Up)
  const T* W = static_cast<const T*>(wh_) + (size_t)k * H * G;

  const int HR = h_rows(p.bt, RPT);
  T* Ws = reinterpret_cast<T*>(smem_raw);                  // (KS, KR, NG, Up)
  float* hfull = reinterpret_cast<float*>(
      smem_raw + (size_t)KS * p.KR * NG * p.Up * sizeof(T));  // (HR, HP)
  float* slice = hfull + HR * HP;                           // (bt, Up)
  float* cell = slice + p.bt * p.Up;                        // (bt, Up), LSTM
  T* gbuf = reinterpret_cast<T*>(cell + (GRU ? 0 : p.bt * p.Up));
  float* red = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(gbuf) +
      ((size_t)p.bt * NG * p.Up * sizeof(T) + 15) / 16 * 16);  // (KS, bt, Up)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ks = warp % KS, rg = warp / KS;
  const int ug = rg / RS, rs = rg % RS;
  const int u = ug * 32 + lane;
  const bool u_ok = u < p.Up;
  const int uc = u_ok ? u : p.Up - 1;
  const int j = j0 + u;
  const int rpe = (p.bt + RS - 1) / RS;
  const int r0 = rs * rpe;
  const int nr = max(0, min(rpe, p.bt - r0));

  // resident rows of W_hh: local row r < KR of K-split s is row s KW + r
  {
    const int n = KS * p.KR * NG * p.Up;
    for (int i = tid; i < n; i += THREADS) {
      const int uu = i % p.Up, rest = i / p.Up, g = rest % NG;
      const int rr = rest / NG, r = rr % p.KR, s = rr / p.KR;
      const int kk = s * p.KW + r, jj = j0 + uu;
      Ws[i] = kk < H && jj < H ? W[(size_t)kk * G + g * H + jj]
                               : gvd::from_f32<T>(0.0f);
    }
    for (int i = tid; i < HR * HP; i += THREADS) hfull[i] = 0.0f;
    for (int i = tid; i < (GRU ? 1 : 2) * p.bt * p.Up; i += THREADS)
      slice[i] = 0.0f;              // the new slice, and c
  }
  // after the product, thread (ks, row group, unit) finishes the rows
  // ks, ks + KS, ... of its row group: RQ of them at most
  constexpr int RQ = (RPT + 1) / 2;
  float bias[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g)
    bias[g] = GRU && u_ok && j < H ? gvd::to_f32(bh[(size_t)k * G + g * H + j])
                                   : 0.0f;
  if (!exchange_only) prefetch_gi<T, NG>(gbuf, gi, 0, k, b0, B, H, j0, p);
  cl.sync();

  for (int t = 0; t < n_steps; ++t) {
    float acc[NG][RPT];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[g][i] = 0.0f;
    float h_old[RQ];
    if (!exchange_only) {
      const float* hs = hfull + r0 * HP + ks * p.KW;
      product<T, NG, RPT, false>(
          acc, hs, HP, p.KR, Ws + (size_t)ks * p.KR * NG * p.Up + uc,
          (size_t)NG * p.Up, (size_t)p.Up, p.KR);
      if (p.KR < p.KW) {            // streamed from global memory (L2)
        const int kk0 = ks * p.KW + p.KR;
        const int kvalid = j < H ? min(p.KW - p.KR, H - kk0) : 0;
        product<T, NG, RPT, true>(
            acc, hs + p.KR, HP, p.KW - p.KR,
            W + (size_t)min(kk0, H - 1) * G + min(j, H - 1), (size_t)G,
            (size_t)H, kvalid);
      }
      if (GRU) {
#pragma unroll
        for (int q = 0; q < RQ; ++q)
          h_old[q] = ks + q * KS < nr
                         ? hfull[(r0 + ks + q * KS) * HP + j0 + uc] : 0.0f;
      }
    }
    cluster_arrive();               // this block is done reading hfull

    if (!exchange_only) {
      cp_async_wait_all();          // gi[t] in gbuf (visible after a sync)
      // gate by gate, every K-split's partials into red, then each thread
      // sums its RQ (row, unit) pairs over the K-splits
      float fin[NG][RQ];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (u_ok) {
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            if (i < nr) red[(ks * p.bt + r0 + i) * p.Up + u] = acc[g][i];
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < RQ; ++q) {
          const int i = ks + q * KS;
          float sum = 0.0f;
          if (u_ok && i < nr)
            for (int s = 0; s < KS; ++s)
              sum += red[(s * p.bt + r0 + i) * p.Up + u];
          fin[g][q] = sum;
        }
        __syncthreads();
      }
      if (u_ok) {
#pragma unroll
        for (int q = 0; q < RQ; ++q) {
          const int i = ks + q * KS;
          if (i >= nr) break;
          const int b = r0 + i;
          float h_new = 0.0f;
          if (b0 + b < B && j < H) {
            const T* gq = gbuf + b * NG * p.Up + u;
            float* sv = gates == nullptr
                            ? nullptr
                            : gates + (((size_t)t * 2 + k) * B + b0 + b) *
                                          NS * H + j;
            if constexpr (GRU) {
              h_new = gru_gate(gvd::to_f32(gq[0]), gvd::to_f32(gq[p.Up]),
                               gvd::to_f32(gq[2 * p.Up]), fin[0][q],
                               fin[1][q], fin[2][q], bias[0], bias[1],
                               bias[2], h_old[q], sv, H);
            } else {
              h_new = lstm_gate(gvd::to_f32(gq[0]), gvd::to_f32(gq[p.Up]),
                                gvd::to_f32(gq[2 * p.Up]),
                                gvd::to_f32(gq[3 * p.Up]), fin[0][q],
                                fin[1][q], fin[2][q], fin[NG - 1][q],
                                cell[b * p.Up + u], sv, H);
            }
            out[(((size_t)t * 2 + k) * B + b0 + b) * H + j] =
                gvd::from_f32<T>(h_new);
          }
          slice[b * p.Up + u] = h_new;
        }
      }
      __syncthreads();              // the new slice is complete
    }
    cluster_wait();                 // every block is done reading hfull
    push_slice(cl, slice, hfull, HP, j0, p);
    cl.sync();                      // every new slice has landed
    if (!exchange_only && t + 1 < n_steps)
      prefetch_gi<T, NG>(gbuf, gi, t + 1, k, b0, B, H, j0, p);
  }
}

// ------------------------------------------------ bf16: the tensor cores --
// The route for bf16 when W_hh and the tile's h fit in shared memory
// whole (birnn.py::birnn_plan picks it).  The product h W_hh runs on
// mma.sync.m16n8k16 with f32 accumulation: W_hh is bf16 already, and h
// (f32) enters as two bf16 terms, hi = bf16(h) and lo = bf16(h - hi), two
// products each, so about 16 bits of h's mantissa reach the sum.  Block c's
// gate columns are the N dimension (n = g Up + u, NP of them padded to 16),
// the tile's rows M (MT m16 tiles), h's C Up units K (KP padded to 64).
// W_hh is stored n-major, (NP, KP) bf16, each row's 16-byte chunks XOR-
// swizzled by n % 8 so that the 8 rows an ldmatrix reads hit distinct
// banks; h (bt, KP + 8) f32, the pad keeping a warp's fragment loads to two
// wavefronts.  Warp w computes the n16 groups w, w + 8, ... for every m16
// tile (MT x 2 accumulator fragments), writes them to pre (bt, NP) f32;
// then every thread runs the gate math of up to MAXP (row, unit) pairs,
// the LSTM's c held in its registers from step to step.
constexpr int MAXP = 8;

__host__ __device__ constexpr int mma_np(int NG, int Up) {
  return (NG * Up + 15) / 16 * 16;
}
__host__ __device__ constexpr int mma_kp(int C, int Up) {
  return (C * Up + 63) / 64 * 64;
}

// Shared memory of the tensor-core route (birnn.py::_mma_smem_bytes):
// W_hh, h, pre, the new slice, gi, and the GRU's b_hh.
__host__ size_t mma_smem_bytes(const Plan& p, int NG, bool gru) {
  const size_t NP = mma_np(NG, p.Up), KP = mma_kp(p.C, p.Up);
  return NP * KP * 2 + (size_t)p.bt * (KP + 8) * 4 + (size_t)p.bt * NP * 4 +
         (size_t)p.bt * p.Up * 4 +
         ((size_t)p.bt * NG * p.Up * 2 + 15) / 16 * 16 +
         (gru ? (size_t)NG * p.Up * 4 : 0);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16, col).
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as bf16 pairs hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split2(float2 x, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x.x - hf.x, x.y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <bool GRU, int MT>
__global__ void __launch_bounds__(THREADS, 1)
birnn_mma_kernel(const void* gi_, const void* wh_, const void* bh_,
                 void* out_, void* /* gates: the SIMT route's alone */,
                 int n_steps, int B, int H, Plan p, int exchange_only) {
  using T = __nv_bfloat16;
  constexpr int NG = GRU ? 3 : 4;
  const T* gi = static_cast<const T*>(gi_);
  const T* bh = static_cast<const T*>(bh_);
  T* out = static_cast<T*>(out_);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.block_rank();
  const int k = blockIdx.z;
  const int b0 = blockIdx.y * p.bt, j0 = c * p.Up;
  const int G = NG * H;
  const int NU = NG * p.Up, NP = mma_np(NG, p.Up), KP = mma_kp(p.C, p.Up);
  const int HP = KP + 8;
  const T* W = static_cast<const T*>(wh_) + (size_t)k * H * G;

  T* Ws = reinterpret_cast<T*>(smem_raw);                   // (NP, KP)
  float* hfull = reinterpret_cast<float*>(smem_raw + (size_t)NP * KP * 2);
  float* pre = hfull + p.bt * HP;                           // (bt, NP)
  float* slice = pre + p.bt * NP;                           // (bt, Up)
  T* gbuf = reinterpret_cast<T*>(slice + p.bt * p.Up);      // (bt, NG, Up)
  float* bsm = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(gbuf) +
      ((size_t)p.bt * NG * p.Up * 2 + 15) / 16 * 16);       // (NG, Up), GRU

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // W_hh column n = g Up + u (gate g of unit j0 + u), row kk; consecutive
  // threads read consecutive units of one row
  for (int i = tid; i < NP * KP; i += THREADS) {
    const int n = i % NP, kk = i / NP;
    const int g = n / p.Up, jj = j0 + n % p.Up;
    const T v = n < NU && kk < H && jj < H ? W[(size_t)kk * G + g * H + jj]
                                           : __float2bfloat16(0.0f);
    Ws[n * KP + ((((kk >> 3) ^ (n & 7)) << 3) | (kk & 7))] = v;
  }
  for (int i = tid; i < p.bt * HP; i += THREADS) hfull[i] = 0.0f;
  for (int i = tid; i < p.bt * p.Up; i += THREADS) slice[i] = 0.0f;
  if (GRU) {
    for (int i = tid; i < NU; i += THREADS) {
      const int jj = j0 + i % p.Up;
      bsm[i] = jj < H ? __bfloat162float(bh[(size_t)k * G + (i / p.Up) * H + jj])
                      : 0.0f;
    }
  }
  const int n_pairs = p.bt * p.Up;
  float cst[MAXP];
#pragma unroll
  for (int i = 0; i < MAXP; ++i) cst[i] = 0.0f;
  if (!exchange_only) prefetch_gi<T, NG>(gbuf, gi, 0, k, b0, B, H, j0, p);
  cl.sync();

  for (int t = 0; t < n_steps; ++t) {
    float h_old[MAXP];
    if (!exchange_only) {
      for (int ng = warp; ng < NP / 16; ng += THREADS / 32) {
        float acc[MT][2][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h8 = 0; h8 < 2; ++h8)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][h8][e] = 0.0f;
        const int bn = ng * 16 + (lane >> 4) * 8 + (lane & 7);
        const T* wrow = Ws + bn * KP;
        const int gr = lane >> 2, tc = (lane & 3) * 2;
#pragma unroll 2
        for (int k0 = 0; k0 < KP; k0 += 16) {
          uint32_t bfr[4];
          const int ch = (k0 >> 3) + ((lane >> 3) & 1);
          ldsm_x4(bfr, wrow + ((ch ^ (bn & 7)) << 3));
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int r0 = m * 16 + gr, r1 = r0 + 8;
            const float2 z2 = make_float2(0.0f, 0.0f);
            const float* h0 = hfull + r0 * HP + k0 + tc;
            const float* h1 = hfull + r1 * HP + k0 + tc;
            const float2 x0 = r0 < p.bt ? *reinterpret_cast<const float2*>(h0) : z2;
            const float2 x1 = r1 < p.bt ? *reinterpret_cast<const float2*>(h1) : z2;
            const float2 x2 = r0 < p.bt ? *reinterpret_cast<const float2*>(h0 + 8) : z2;
            const float2 x3 = r1 < p.bt ? *reinterpret_cast<const float2*>(h1 + 8) : z2;
            uint32_t hi[4], lo[4];
            split2(x0, hi[0], lo[0]);
            split2(x1, hi[1], lo[1]);
            split2(x2, hi[2], lo[2]);
            split2(x3, hi[3], lo[3]);
            mma16816(acc[m][0], hi, bfr[0], bfr[1]);
            mma16816(acc[m][0], lo, bfr[0], bfr[1]);
            mma16816(acc[m][1], hi, bfr[2], bfr[3]);
            mma16816(acc[m][1], lo, bfr[2], bfr[3]);
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h8 = 0; h8 < 2; ++h8)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int row = m * 16 + gr + half * 8;
              if (row < p.bt)
                *reinterpret_cast<float2*>(pre + row * NP + ng * 16 + h8 * 8 +
                                           tc) =
                    make_float2(acc[m][h8][2 * half], acc[m][h8][2 * half + 1]);
            }
      }
      if (GRU) {
#pragma unroll
        for (int i = 0; i < MAXP; ++i) {
          const int q = tid + i * THREADS;
          h_old[i] = q < n_pairs
                         ? hfull[(q / p.Up) * HP + j0 + q % p.Up] : 0.0f;
        }
      }
    }
    cluster_arrive();               // this block is done reading hfull

    if (!exchange_only) {
      cp_async_wait_all();          // gi[t] in gbuf
      __syncthreads();              // ... and pre, for every thread
#pragma unroll
      for (int i = 0; i < MAXP; ++i) {
        const int q = tid + i * THREADS;
        if (q >= n_pairs) break;
        const int b = q / p.Up, u = q - b * p.Up, j = j0 + u;
        float h_new = 0.0f;
        if (b0 + b < B && j < H) {
          const T* gq = gbuf + b * NG * p.Up + u;
          const float* a = pre + b * NP + u;
          if constexpr (GRU) {
            h_new = gru_gate(__bfloat162float(gq[0]),
                             __bfloat162float(gq[p.Up]),
                             __bfloat162float(gq[2 * p.Up]), a[0], a[p.Up],
                             a[2 * p.Up], bsm[u], bsm[p.Up + u],
                             bsm[2 * p.Up + u], h_old[i], nullptr, 0);
          } else {
            h_new = lstm_gate(__bfloat162float(gq[0]),
                              __bfloat162float(gq[p.Up]),
                              __bfloat162float(gq[2 * p.Up]),
                              __bfloat162float(gq[3 * p.Up]), a[0], a[p.Up],
                              a[2 * p.Up], a[3 * p.Up], cst[i], nullptr,
                              0);
          }
          out[(((size_t)t * 2 + k) * B + b0 + b) * H + j] =
              __float2bfloat16(h_new);
        }
        slice[b * p.Up + u] = h_new;
      }
      __syncthreads();              // the new slice is complete
    }
    cluster_wait();                 // every block is done reading hfull
    push_slice(cl, slice, hfull, HP, j0, p);
    cl.sync();                      // every new slice has landed
    if (!exchange_only && t + 1 < n_steps)
      prefetch_gi<T, NG>(gbuf, gi, t + 1, k, b0, B, H, j0, p);
  }
}

// ------------------------------------------ training: the reverse-time pass --
// The backward of the SIMT kernel's recurrence, in f32 (the training route
// casts every dtype to f32 once).  Inputs: dy (T, 2, B, H), the forward's ys
// (T, 2, B, H) and saved gates (T, 2, B, NS, H), W_hh^T (2, G, H).  Outputs:
// dgi (T, 2, B, G), the gradient of gi; dgh (2, T, B, G), the gradient of
// the recurrent pre-activations h W_hh (+ b_hh), which for the GRU differs
// from dgi in its n block (dgi_n r); hp (2, T, B, H), h_{t-1} (0 at t = 0).
// dW_hh = hp^T dgh over all T B rows and db_hh = the sum of dgh are one
// product and one sum outside the kernel (ops/kernels/birnn.py).
//
// It replaces no TPU kernel: the JAX package trains this recurrence with an
// XLA scan.  It exists because the plain twin under autograd launches ~33
// small kernels for every step of every layer, forward and backward, which
// left a training step waiting on the host.
//
// What bounds it: the same T-step chain as the forward, run backwards.  The
// carried dh_{t-1} = dgh_t W_hh^T (+ dh_t z_t for the GRU) needs every
// block's columns of W_hh, while each block forms the gate gradients of its
// own units only.  Design: the forward's plan and clusters, each block
// owning the same units; its NG Up columns of W_hh are held transposed in
// shared memory, (K = NG Up rows, C Up columns), rows past KB streamed from
// L2.  A step:
//  * gate phase: each thread takes up to NPAIR (row, unit) pairs; dh = dy +
//    the local term (GRU) + the C partials in its slots, summed in block
//    order (no atomics: the same bits from run to run); the gate gradients
//    go to dgi, dgh and into D (the step's dgh of the block's units);
//  * product: the partial dgh W_hh^T of the block's K rows over all C Up
//    units, (bt, C Up), each thread 4 columns x RPT rows, read as float4;
//  * reduce-scatter: each thread pushes its 4 columns to their owner's slot
//    for this block through DSMEM, the mirror of the forward's all-gather;
//  * two cluster barriers, as in the forward: the first (arrive after the
//    gate phase, wait before the push, so the product hides it) says every
//    owner has read its slots; the second that every partial has landed.
//    dy_{t-1}, the saved gates and h_{t-2} are prefetched with cp.async.
__host__ __device__ constexpr int bwd_inputs(bool gru) { return gru ? 6 : 8; }

// Shared memory of one backward block (birnn.py::_bwd_smem_bytes): the
// resident rows of W_hh^T, D (its rows zero-padded as the forward's h),
// the slots, the prefetched inputs.
__host__ size_t bwd_smem_bytes(const Plan& p, int rpt, int NG, bool lstm,
                               int KB) {
  const size_t K = (size_t)NG * p.Up, CU = (size_t)p.C * p.Up;
  return (size_t)KB * CU * 4 + (size_t)h_rows(p.bt, rpt) * K * 4 +
         (size_t)p.C * p.bt * p.Up * 4 +
         (size_t)p.bt * bwd_inputs(!lstm) * p.Up * 4;
}

// Step t's inputs of this block's (rows, units) into gbuf (bt, NI, Up): dy,
// the NS saved gates, h_{t-1} and (LSTM) c_{t-1}; zero past B, past H and
// before the first step.
template <bool GRU>
__device__ void prefetch_bwd(float* gbuf, const float* dy, const float* ys,
                             const float* gates, int t, int k, int b0, int B,
                             int H, int j0, const Plan& p) {
  constexpr int NS = saved_gates(GRU), NI = bwd_inputs(GRU);
  const int n = p.bt * NI * p.Up;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int u = i % p.Up, rest = i / p.Up, s = rest % NI, b = rest / NI;
    const int j = j0 + u;
    const bool prev = s > NS;
    const bool ok = b0 + b < B && j < H && (!prev || t > 0);
    const float* src = dy;
    if (ok) {
      const size_t row = ((size_t)(prev ? t - 1 : t) * 2 + k) * B + b0 + b;
      if (s == 0) src = dy + row * H + j;
      else if (s <= NS) src = gates + (row * NS + s - 1) * H + j;
      else if (s == NS + 1) src = ys + row * H + j;
      else src = gates + (row * NS + NS - 1) * H + j;
    }
    cp_async4(gbuf + (b * NI + s) * p.Up + u, src, ok);
  }
  cp_async_commit();
}

template <bool GRU, int RPT>
__global__ void __launch_bounds__(THREADS, 1)
birnn_backward_kernel(const float* __restrict__ dy,
                      const float* __restrict__ ys,
                      const float* __restrict__ gates,
                      const float* __restrict__ whT, float* __restrict__ dgi,
                      float* __restrict__ dgh, float* __restrict__ hp,
                      int n_steps, int B, int H, Plan p, int KB) {
  constexpr int NG = GRU ? 3 : 4, NI = bwd_inputs(GRU);
  constexpr int NPAIR = (RPT + 1) / 2;   // bt Up <= 2 RPT x 64 pairs
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.block_rank();
  const int k = blockIdx.z;
  const int b0 = blockIdx.y * p.bt, j0 = c * p.Up;
  const int G = NG * H, K = NG * p.Up, CU = p.C * p.Up;
  const int HR = h_rows(p.bt, RPT);
  const float* Wg = whT + (size_t)k * G * H;          // (G, H)

  float* Wt = reinterpret_cast<float*>(smem_raw);      // (KB, CU)
  float* D = Wt + (size_t)KB * CU;                     // (HR, K)
  float* slots = D + HR * K;                           // (C, bt, Up)
  float* gbuf = slots + p.C * p.bt * p.Up;             // (bt, NI, Up)

  const int tid = threadIdx.x;
  // resident row kk = g Up + u of W_hh^T: row g H + j0 + u, all H columns
  for (int i = tid; i < KB * CU; i += THREADS) {
    const int q = i % CU, kk = i / CU;
    const int jj = j0 + kk % p.Up;
    Wt[i] = q < H && jj < H ? Wg[(size_t)((kk / p.Up) * H + jj) * H + q]
                            : 0.0f;
  }
  for (int i = tid; i < HR * K; i += THREADS) D[i] = 0.0f;
  for (int i = tid; i < p.C * p.bt * p.Up; i += THREADS) slots[i] = 0.0f;
  // GRU: the local term dh z of the carried dh; LSTM: the carried dc
  float loc[NPAIR];
#pragma unroll
  for (int i = 0; i < NPAIR; ++i) loc[i] = 0.0f;
  const int n_pairs = p.bt * p.Up;
  // the product's items: (row group, 4 columns), one or two a thread
  const int NQ = CU / 4, n_items = 2 * NQ;
  const int rpe = (p.bt + 1) / 2;
  prefetch_bwd<GRU>(gbuf, dy, ys, gates, n_steps - 1, k, b0, B, H, j0, p);
  cl.sync();

  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    cp_async_wait_all();
    __syncthreads();              // step t's inputs, for every thread
#pragma unroll
    for (int pi = 0; pi < NPAIR; ++pi) {
      const int q = tid + pi * THREADS;
      if (q >= n_pairs) break;
      const int b = q / p.Up, u = q - b * p.Up, j = j0 + u;
      if (b0 + b >= B || j >= H) continue;
      float carried = GRU ? loc[pi] : 0.0f;
      for (int r = 0; r < p.C; ++r) carried += slots[(r * p.bt + b) * p.Up + u];
      const float* in = gbuf + b * NI * p.Up + u;
      const float dh = in[0] + carried;
      const size_t row = ((size_t)t * 2 + k) * B + b0 + b;
      const size_t lrow = ((size_t)k * n_steps + t) * B + b0 + b;
      float* gi_out = dgi + row * G + j;
      float* gh_out = dgh + lrow * G + j;
      float* d = D + b * K + u;
      if constexpr (GRU) {
        const float r = in[p.Up], z = in[2 * p.Up], n = in[3 * p.Up];
        const float hn = in[4 * p.Up], h_old = in[5 * p.Up];
        const float dn = dh * (1.0f - z) * (1.0f - n * n);
        const float dr = dn * hn * r * (1.0f - r);
        const float dz = dh * (h_old - n) * z * (1.0f - z);
        const float dhn = dn * r;
        loc[pi] = dh * z;
        gi_out[0] = dr;
        gi_out[H] = dz;
        gi_out[2 * H] = dn;
        gh_out[0] = dr;
        gh_out[H] = dz;
        gh_out[2 * H] = dhn;
        d[0] = dr;
        d[p.Up] = dz;
        d[2 * p.Up] = dhn;
        hp[lrow * H + j] = h_old;
      } else {
        const float ig = in[p.Up], fg = in[2 * p.Up], gg = in[3 * p.Up];
        const float og = in[4 * p.Up], cn = in[5 * p.Up];
        const float h_old = in[6 * p.Up], c_old = in[7 * p.Up];
        const float tc = tanhf(cn);
        const float dc = loc[pi] + dh * og * (1.0f - tc * tc);
        const float g4[4] = {dc * gg * ig * (1.0f - ig),
                             dc * c_old * fg * (1.0f - fg),
                             dc * ig * (1.0f - gg * gg),
                             dh * tc * og * (1.0f - og)};
        loc[pi] = dc * fg;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          gi_out[g * H] = g4[g];
          gh_out[g * H] = g4[g];
          d[g * p.Up] = g4[g];
        }
        hp[lrow * H + j] = h_old;
      }
    }
    cluster_arrive();             // this block is done reading its slots
    __syncthreads();              // D is complete; gbuf is free
    if (t > 0)
      prefetch_bwd<GRU>(gbuf, dy, ys, gates, t - 1, k, b0, B, H, j0, p);
    const bool more = t > 0;      // dh_{-1} is not needed
    for (int it = 0; it < 2; ++it) {
      const int item = tid + it * THREADS;
      float acc[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
      const bool mine = more && item < n_items;
      const int rs = item / NQ, cq = item - (item / NQ) * NQ;
      const int r0 = rs * rpe, q0 = 4 * cq;
      if (mine) {
        const float* drow = D + r0 * K;
        int kk = 0;
        const int kres = min(KB, K);
        for (; kk < kres; kk += 4) {
          float4 w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[e] = *reinterpret_cast<const float4*>(Wt + (kk + e) * CU + q0);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float4 dv = *reinterpret_cast<const float4*>(drow + i * K + kk);
            const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][0] = fmaf(dd[e], w[e].x, acc[i][0]);
              acc[i][1] = fmaf(dd[e], w[e].y, acc[i][1]);
              acc[i][2] = fmaf(dd[e], w[e].z, acc[i][2]);
              acc[i][3] = fmaf(dd[e], w[e].w, acc[i][3]);
            }
          }
        }
        for (; kk < K; kk += 4) {   // streamed from global memory (L2)
          float w[4][4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = j0 + (kk + e) % p.Up;
            const float* src = Wg + (size_t)(((kk + e) / p.Up) * H + jj) * H;
#pragma unroll
            for (int f = 0; f < 4; ++f)
              w[e][f] = jj < H && q0 + f < H ? src[q0 + f] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float4 dv = *reinterpret_cast<const float4*>(drow + i * K + kk);
            const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int f = 0; f < 4; ++f)
                acc[i][f] = fmaf(dd[e], w[e][f], acc[i][f]);
          }
        }
      }
      if (it == 0) cluster_wait();  // every owner has read its slots
      if (mine) {
        const int owner = q0 / p.Up, u0 = q0 - owner * p.Up;
        const int nr = max(0, min(rpe, p.bt - r0));
        float* dst = cl.map_shared_rank(slots, owner) +
                     (c * p.bt + r0) * p.Up + u0;
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          if (i < nr)
            *reinterpret_cast<float4*>(dst + i * p.Up) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
    cl.sync();                      // every partial has landed
  }
}

using BackwardFn = void (*)(const float*, const float*, const float*,
                            const float*, float*, float*, float*, int, int,
                            int, Plan, int);

BackwardFn pick_backward(int mode, int rpt) {
  switch (rpt * 2 + mode) {
    case 8: return birnn_backward_kernel<true, 4>;
    case 9: return birnn_backward_kernel<false, 4>;
    case 16: return birnn_backward_kernel<true, 8>;
    case 17: return birnn_backward_kernel<false, 8>;
    case 26: return birnn_backward_kernel<true, 13>;
    case 27: return birnn_backward_kernel<false, 13>;
    case 34: return birnn_backward_kernel<true, 17>;
    case 35: return birnn_backward_kernel<false, 17>;
    case 50: return birnn_backward_kernel<true, 25>;
    case 51: return birnn_backward_kernel<false, 25>;
  }
  return nullptr;
}

using KernelFn = void (*)(const void*, const void*, const void*, void*,
                          void*, int, int, int, Plan, int);

// route 1: the tensor-core kernel of MT = rpt m16 tiles (bf16 only)
KernelFn pick_mma(int mode, int mt) {
  switch (mt * 2 + mode) {
    case 2: return birnn_mma_kernel<true, 1>;
    case 3: return birnn_mma_kernel<false, 1>;
    case 4: return birnn_mma_kernel<true, 2>;
    case 5: return birnn_mma_kernel<false, 2>;
    case 6: return birnn_mma_kernel<true, 3>;
    case 7: return birnn_mma_kernel<false, 3>;
    case 8: return birnn_mma_kernel<true, 4>;
    case 9: return birnn_mma_kernel<false, 4>;
  }
  return nullptr;
}

#define GVD_RPT_TABLE(T, GRU)                         \
  switch (rpt) {                                       \
    case 4: return birnn_cluster_kernel<T, GRU, 4>;   \
    case 8: return birnn_cluster_kernel<T, GRU, 8>;   \
    case 13: return birnn_cluster_kernel<T, GRU, 13>; \
    case 17: return birnn_cluster_kernel<T, GRU, 17>; \
    case 25: return birnn_cluster_kernel<T, GRU, 25>; \
  }                                                    \
  return nullptr;

// The rows-per-thread instantiations (birnn.py ROWS_PER_THREAD).
KernelFn pick(int dtype, int mode, int rpt) {
  if (dtype == 0 && mode == 0) { GVD_RPT_TABLE(float, true) }
  if (dtype == 0 && mode == 1) { GVD_RPT_TABLE(float, false) }
  if (dtype == 1 && mode == 0) { GVD_RPT_TABLE(__nv_bfloat16, true) }
  if (dtype == 1 && mode == 1) { GVD_RPT_TABLE(__nv_bfloat16, false) }
  return nullptr;
}
#undef GVD_RPT_TABLE

// The kernel for a checked plan, with its attributes set; null if the plan
// is not one this file takes.
KernelFn prepare(int dtype, int mode, int H, int route, const Plan& p,
                 int rpt, int smem, cudaError_t* err) {
  *err = cudaErrorInvalidValue;
  if (mode != 0 && mode != 1) return nullptr;
  KernelFn kern = route == 1 ? (dtype == 1 ? pick_mma(mode, rpt) : nullptr)
                             : pick(dtype, mode, rpt);
  if (kern == nullptr) return nullptr;
  const int NG = mode == 0 ? 3 : 4;
  const bool common =
      (p.C == 1 || p.C == 2 || p.C == 4 || p.C == 8 || p.C == 16) &&
      p.Up % 4 == 0 && p.Up >= 4 && p.Up <= 64 && p.C * p.Up >= H &&
      p.bt >= 1 && H >= 1 && (dtype == 0 || H % 2 == 0) && smem <= SMEM_MAX;
  const bool ok =
      common &&
      (route == 1
           ? (p.bt + 15) / 16 == rpt && p.bt * p.Up <= MAXP * THREADS &&
                 p.KW == mma_kp(p.C, p.Up) && p.KR == p.KW &&
                 (size_t)smem == mma_smem_bytes(p, NG, mode == 0)
           : p.KW % 4 == 0 && p.KR % 4 == 0 && p.KR >= 0 && p.KR <= p.KW &&
                 k_splits(p.Up) * p.KW >= p.C * p.Up &&
                 (p.bt + 1) / 2 <= rpt &&
                 (size_t)smem ==
                     smem_bytes(p, rpt, NG, mode == 1, dtype == 0 ? 4 : 2));
  if (!ok) return nullptr;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute((const void*)kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  *err = e;
  return e == cudaSuccess ? kern : nullptr;
}

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    const Plan& p, int tiles, int smem, cudaStream_t s) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(p.C, tiles, 2);
  cfg->blockDim = dim3(THREADS, 1, 1);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace

// mode: 0 = GRU, 1 = LSTM.  route: 0 = the SIMT kernel, 1 = the
// tensor-core kernel (bf16).  The plan (C, bt, Up, KW, KR, rows per thread
// or m16 tiles, shared memory) is birnn.py::birnn_plan's; a plan this file
// does not take returns cudaErrorInvalidValue.  gates: null at inference;
// the training route's saved gates (f32, the SIMT kernel only).
// exchange_only: see the kernels.
extern "C" int gvd_birnn_recurrence(int dtype, int mode, const void* gi,
                                    const void* wh, const void* bh, void* out,
                                    void* gates, int n_steps, int B, int H,
                                    int route, int C, int bt, int Up, int KW,
                                    int KR, int rpt, int smem,
                                    int exchange_only, void* stream) {
  const Plan p{C, bt, Up, KW, KR};
  if (gates != nullptr && (dtype != 0 || route != 0 || exchange_only))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  KernelFn kern = prepare(dtype, mode, H, route, p, rpt, smem, &e);
  if (kern == nullptr) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, p, (B + bt - 1) / bt, smem,
                 (cudaStream_t)stream);
  void* args[] = {(void*)&gi, (void*)&wh, (void*)&bh, (void*)&out,
                  (void*)&gates, (void*)&n_steps, (void*)&B, (void*)&H,
                  (void*)&p, (void*)&exchange_only};
  e = cudaLaunchKernelExC(&cfg, (const void*)kern, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of this plan's kernel the card holds at once
// (cudaOccupancyMaxActiveClusters); a negative value is -cudaError.
extern "C" int gvd_birnn_max_clusters(int dtype, int mode, int H, int route,
                                      int C, int bt, int Up, int KW, int KR,
                                      int rpt, int smem) {
  const Plan p{C, bt, Up, KW, KR};
  cudaError_t e;
  KernelFn kern = prepare(dtype, mode, H, route, p, rpt, smem, &e);
  if (kern == nullptr) return -(int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, p, 1, smem, 0);
  cfg.gridDim = dim3(C, 1, 1);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (const void*)kern, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// The training route's backward (f32): see birnn_backward_kernel.  The plan
// is the forward's (C, bt, Up, rows per thread), with KB resident rows of
// W_hh^T and the shared memory of birnn.py::birnn_backward_plan; a plan this
// file does not take returns cudaErrorInvalidValue.
extern "C" int gvd_birnn_backward(int mode, const void* dy, const void* ys,
                                  const void* gates, const void* whT,
                                  void* dgi, void* dgh, void* hp,
                                  int n_steps, int B, int H, int C, int bt,
                                  int Up, int rpt, int KB, int smem,
                                  void* stream) {
  const Plan p{C, bt, Up, 0, 0};
  BackwardFn kern = mode == 0 || mode == 1 ? pick_backward(mode, rpt)
                                           : nullptr;
  const int NG = mode == 0 ? 3 : 4;
  const bool ok =
      kern != nullptr && (C == 1 || C == 2 || C == 4 || C == 8 || C == 16) &&
      Up % 4 == 0 && Up >= 4 && Up <= 64 && C * Up >= H && H >= 1 &&
      bt >= 1 && (bt + 1) / 2 <= rpt && KB % 4 == 0 && KB >= 0 &&
      KB <= NG * Up && n_steps >= 1 && smem <= SMEM_MAX &&
      (size_t)smem == bwd_smem_bytes(p, rpt, NG, mode == 1, KB);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute((const void*)kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, p, (B + bt - 1) / bt, smem,
                 (cudaStream_t)stream);
  const float* dy_ = static_cast<const float*>(dy);
  const float* ys_ = static_cast<const float*>(ys);
  const float* gates_ = static_cast<const float*>(gates);
  const float* whT_ = static_cast<const float*>(whT);
  float* dgi_ = static_cast<float*>(dgi);
  float* dgh_ = static_cast<float*>(dgh);
  float* hp_ = static_cast<float*>(hp);
  void* args[] = {(void*)&dy_, (void*)&ys_, (void*)&gates_, (void*)&whT_,
                  (void*)&dgi_, (void*)&dgh_, (void*)&hp_, (void*)&n_steps,
                  (void*)&B, (void*)&H, (void*)&p, (void*)&KB};
  e = cudaLaunchKernelExC(&cfg, (const void*)kern, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
