// Per-token additive region attention (K3).
//
// Replaces grounded_video_description_tpu/ops/pallas/region_attention.py
// ::fused_region_attention.  For each batch row b:
//   s[r]   = sum_h tanh(p_pool[b,r,h] + att_h[b,h]) * alpha_w[h] + alpha_b
//   s[r]   = MIN_VALUE where att_mask[b,r]          (attention softmax)
//   grd[r] = MIN_VALUE where pnt_mask[b,r], else s[r] (grounding logits)
//   att_res[b,:] = softmax(s) @ pool[b]
//
// What bounds it on an H100: memory.  Each call reads the (B,R,H) and
// (B,R,D) banks once (at B=100, R=1000, H=512, D=1024: 614 MB in f32, 307
// MB in bf16, far more than the 50 MB L2) and does ~2 flops per byte; but
// its ~51 M tanhf (two MUFU operations and ~20 instructions each) are a
// third of the bf16 bound's time in issue alone, so the loads and the
// arithmetic must overlap everywhere.  The design:
//  * Each row's ROIs are split over the S blocks of one thread-block
//    cluster, S chosen (ops/kernels/region_attention.py::
//    region_attention_plan) so that all B x S blocks are resident at once.
//  * A block has 4 or 8 warps; each group of G of them (G = 1 at D <=
//    1024) is a stream of its own: it takes every (warps/G)-th run of KS
//    consecutive ROIs of the block's split (KS = 1 in f32, 2 in bf16: ~6
//    KB of rows) and keeps its own ring of shared-memory slots, a run (its
//    p_pool rows, then its pool rows) a slot, filled by asynchronous copies
//    (the 1-D bulk copy of the TMA; for bf16 rows that are not whole 16
//    bytes, 8-byte cp.async by the group's threads) that complete on one
//    mbarrier a slot.  No block barrier runs inside
//    the stream, so the warps drift apart and hide each other's latencies
//    (a block barrier a stage, tried first, left the kernel latency-bound).
//    The plan sets how many warps stream at once: too few leave the tanh
//    work exposed (bf16), too many slow the memory system (f32).
//  * The softmax is online, per group: each slot's scores (the group's
//    lanes split H, tanhf in f32, a warp reduction) rescale the group's
//    running max, normalizer and f32 weighted sum (D / (32 G) columns a
//    lane, in registers) when they raise the max.  Every bank byte is read
//    once.
//  * At the end each group leaves its partial (max, normalizer, sum) in
//    its block's shared memory, and the cluster's first block merges the
//    row's partials (block by block, group by group) through distributed
//    shared memory, in that fixed order, with no atomics: two launches
//    give the same bits.
// The running max starts at -inf and is only ever raised by finite scores,
// so a group or split with no ROI keeps (-inf, 0, 0) and weighs exp(-inf)
// = 0 in the merge; a fully masked row has every score MIN_VALUE and comes
// out uniform.  H and D must be multiples of 4; the masks are read through
// their row strides (the model passes [:, 1:] views).  All arithmetic is
// f32; outputs are returned in the input dtype, as the TPU kernel does.

#include <cooperative_groups.h>

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // at most; a block has 4 or 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 16;
constexpr int kMaxSlotRois = 2;
constexpr int kRingSlots = 2;  // the slots of a group's ring
constexpr int kSmemMax = 232448;
constexpr int kMaxDevices = 16;

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Byte offsets in a block's shared memory: the groups' rings (WB / G groups
// of kRingSlots slots, a slot KS ROIs' p_pool rows then their pool rows), att_h
// and alpha_w in f32, the warps' partial scores (two buffers: slot parity;
// for G > 1), the rings' mbarriers.  ops/kernels/region_attention.py::
// smem_bytes mirrors it.  After the stream the rings' space holds the
// groups' partials (m, l, pad, pad, acc[D]) for the merge.
struct Layout {
  size_t p_bytes, slot, ah, w, part, bars, total;
};

__host__ __device__ inline Layout layout(int H, int D, int itemsize, int WB,
                                         int G, int KS) {
  constexpr int RS = kRingSlots;
  Layout L;
  L.p_bytes = round16((size_t)KS * H * itemsize);
  L.slot = L.p_bytes + round16((size_t)KS * D * itemsize);
  L.ah = (size_t)(WB / G) * RS * L.slot;
  L.w = L.ah + round16((size_t)4 * H);
  L.part = L.w + round16((size_t)4 * H);
  L.bars = L.part + 2 * kWarps * kMaxSlotRois * sizeof(float);
  L.total = L.bars + round16((size_t)8 * (WB / G) * RS);
  return L;
}

struct Args {
  const void* p_pool;
  const void* att_h;
  const void* pool;
  const float* alpha_w;
  const float* alpha_b;
  const uint8_t* att_mask;
  const uint8_t* pnt_mask;
  void* att_res;
  void* grd;
  int R, H, D;
  int am_stride, pm_stride;  // the masks' row strides, in bytes (bool)
  int rps, G;  // ROIs per split, warps per group
};

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to this block's shared memory by the TMA, completing on `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(gvd::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(gvd::smem_addr(bar))
      : "memory");
}

// kPiece bytes (8-byte aligned) from global to shared memory by cp.async.
constexpr int kPiece = 8;
__device__ __forceinline__ void cp_async_piece(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   gvd::smem_addr(dst)),
               "l"(src)
               : "memory");
}

// This thread arrives on `bar` once its earlier cp.async copies have
// landed (the barrier counts every thread of the group).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   gvd::smem_addr(bar))
               : "memory");
}

// A barrier of the `threads` threads of one group (named barrier `id`).
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The scores of a slot's nk ROIs (KS but at a split's end): each lane sums
// tanh(p_pool + att_h) alpha_w over its h, four at a time, into s[k]
// (before the warp's reduction).  Hoisting the nk and column checks out of
// these loops into a second, unchecked copy measured slower on an H100.
template <typename T, int KS>
__device__ __forceinline__ void slot_scores(float (&s)[KS], const T* sp,
                                            const float* s_ah,
                                            const float* s_w, int H, int gl,
                                            int GT, int nk) {
#pragma unroll
  for (int k = 0; k < KS; ++k) s[k] = 0.0f;
#pragma unroll 4
  for (int h = 4 * gl; h < H; h += 4 * GT) {
    const float4 ah = *reinterpret_cast<const float4*>(s_ah + h);
    const float4 w = *reinterpret_cast<const float4*>(s_w + h);
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (k < nk) {
        float v[4];
        gvd::load4(sp + (size_t)k * H + h, v);
        s[k] += tanhf(v[0] + ah.x) * w.x;
        s[k] += tanhf(v[1] + ah.y) * w.y;
        s[k] += tanhf(v[2] + ah.z) * w.z;
        s[k] += tanhf(v[3] + ah.w) * w.w;
      }
    }
  }
}

// acc += p[k] x the slot's pool rows k < nk, over this lane's columns.
template <typename T, int KS, int NV>
__device__ __forceinline__ void slot_sum(float (&acc)[4 * NV],
                                         const float (&p)[KS], const T* sv,
                                         int D, int gl, int GT, int nk) {
#pragma unroll
  for (int g = 0; g < NV; ++g) {
    const int c = 4 * (gl + g * GT);
    if (c < D) {
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        if (k < nk) {
          float x[4];
          gvd::load4(sv + (size_t)k * D + c, x);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * g + e] += p[k] * x[e];
        }
      }
    }
  }
}

// Grid (S, B), clusters of (S, 1, 1): block s of cluster b takes ROIs
// [s rps, (s + 1) rps) of row b, its group g every NG-th run of KS of them
// from the g-th.  COPY: 0 = bulk copies issued by the group's first
// thread, 8 = cp.async pieces of kPiece bytes by every thread of the group
// (bf16 rows that are not whole 16 bytes).
// NV: groups of four columns of the weighted sum a thread holds.  KS: ROIs
// a slot holds (a run of consecutive ROIs: one bulk copy a bank).
template <typename T, int COPY, int NV, int KS>
__global__ void __launch_bounds__(kThreads, NV <= 4 ? 3 : 2)
region_attention_split_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int S = gridDim.x, split = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.R, H = a.H, D = a.D, G = a.G;
  constexpr int RS = kRingSlots;
  const int NT = blockDim.x, NG = NT / 32 / G, GT = 32 * G;
  const int group = warp / G, gl = tid % GT;
  const Layout L = layout(H, D, (int)sizeof(T), NT / 32, G, KS);
  float* s_ah = reinterpret_cast<float*>(smem + L.ah);
  float* s_w = reinterpret_cast<float*>(smem + L.w);
  float* s_part = reinterpret_cast<float*>(smem + L.part);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars) + group * RS;
  unsigned char* ring = smem + (size_t)group * RS * L.slot;

  const int r0 = min(R, split * a.rps), r1 = min(R, r0 + a.rps);
  // this group's slots: slot t holds the KS ROIs from r0 + KS (group + NG t)
  // (fewer at the split's end); nt of them, nr ROIs in all
  const int n_all = (r1 - r0 + KS - 1) / KS;  // the split's slots
  const int nt = n_all > group ? (n_all - group + NG - 1) / NG : 0;
  auto first_roi = [&](int t) { return r0 + KS * (group + NG * t); };
  const int nr = nt == 0 ? 0 : KS * (nt - 1) + min(KS, r1 - first_roi(nt - 1));
  const T* pp = static_cast<const T*>(a.p_pool) + (size_t)b * R * H;
  const T* pv = static_cast<const T*>(a.pool) + (size_t)b * R * D;

  if (tid == 0) {
    for (int s = 0; s < NG * RS; ++s)
      gvd::mbar_init(reinterpret_cast<uint64_t*>(smem + L.bars) + s,
                     COPY == 0 ? 1 : GT);
    gvd::mbar_init_fence();
  }
  for (int h = tid; h < H; h += NT) {
    s_ah[h] = gvd::to_f32(static_cast<const T*>(a.att_h)[(size_t)b * H + h]);
    s_w[h] = a.alpha_w[h];
  }
  __syncthreads();

  // The group's slot t into ring slot t % RS.  Every thread of the group
  // calls it (the cp.async routes copy and arrive with all of them).
  auto issue = [&](int t) {
    const int slot = t % RS, r = first_roi(t), nk = min(KS, r1 - r);
    unsigned char* dst = ring + slot * L.slot;
    const char* sp = reinterpret_cast<const char*>(pp + (size_t)r * H);
    const char* sv = reinterpret_cast<const char*>(pv + (size_t)r * D);
    const uint32_t pb = nk * H * sizeof(T), vb = nk * D * sizeof(T);
    if (COPY == 0) {
      if (gl == 0) {
        gvd::mbar_expect_tx(&full[slot], pb + vb);
        bulk_g2s(dst, sp, pb, &full[slot]);
        bulk_g2s(dst + L.p_bytes, sv, vb, &full[slot]);
      }
    } else {
      for (uint32_t o = gl * kPiece; o < pb; o += GT * kPiece)
        cp_async_piece(dst + o, sp + o);
      for (uint32_t o = gl * kPiece; o < vb; o += GT * kPiece)
        cp_async_piece(dst + L.p_bytes + o, sv + o);
      cp_async_arrive(&full[slot]);
    }
  };
  for (int t = 0; t < min(RS, nt); ++t) issue(t);

  // The mask flags of the group's ROIs, 32 at a time: lane l holds those
  // of its ROI 32 q + l (bit 0 att_mask, bit 1 pnt_mask), the next 32 read
  // a window ahead.
  auto flags_of = [&](int q) -> int {
    const int u = 32 * q + lane;
    if (u >= nr) return 0;
    const int r = first_roi(u / KS) + u % KS;
    return (a.att_mask[(size_t)b * a.am_stride + r] ? 1 : 0) |
           (a.pnt_mask[(size_t)b * a.pm_stride + r] ? 2 : 0);
  };
  int fl_cur = flags_of(0), fl_next = flags_of(1);

  const float ab = a.alpha_b[0];
  T* grd = static_cast<T*>(a.grd) + (size_t)b * R;
  float m = -INFINITY, l = 0.0f, acc[4 * NV];
#pragma unroll
  for (int c = 0; c < 4 * NV; ++c) acc[c] = 0.0f;

  for (int t = 0; t < nt; ++t) {
    const int slot = t % RS, rb = first_roi(t), nk = min(KS, r1 - rb);
    gvd::mbar_wait(&full[slot], (uint32_t)(t / RS) & 1u);
    const T* sp = reinterpret_cast<const T*>(ring + slot * L.slot);
    const T* sv = reinterpret_cast<const T*>(ring + slot * L.slot +
                                             L.p_bytes);
    // the slot's scores: each lane sums four h at a time of every ROI
    float s[KS];
    slot_scores<T, KS>(s, sp, s_ah, s_w, H, gl, GT, nk);
#pragma unroll
    for (int k = 0; k < KS; ++k)
      if (k < nk) s[k] = gvd::warp_sum(s[k]);
    if (G > 1) {
      float* pb = s_part + (t & 1) * kWarps * kMaxSlotRois;
#pragma unroll
      for (int k = 0; k < KS; ++k)
        if (lane == 0 && k < nk) pb[k * kWarps + warp] = s[k];
      group_sync(1 + group, GT);  // also: the group is done with slot t - 1
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        if (k < nk) {
          s[k] = 0.0f;
          for (int w = 0; w < G; ++w) s[k] += pb[k * kWarps + group * G + w];
        }
      }
      if (t >= 1 && t - 1 + RS < nt) issue(t - 1 + RS);
    }
    // masks, grounding logits, the slot's max
    const int u0 = KS * t;
    if (u0 % 32 == 0 && u0 > 0) {
      fl_cur = fl_next;
      fl_next = flags_of(u0 / 32 + 1);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (k < nk) {
        const int f = __shfl_sync(0xffffffffu, fl_cur, (u0 + k) & 31);
        s[k] = (f & 1) ? gvd::MIN_VALUE : s[k] + ab;
        if (gl == k)
          grd[rb + k] = gvd::from_f32<T>((f & 2) ? gvd::MIN_VALUE : s[k]);
        mx = fmaxf(mx, s[k]);
      }
    }
    if (mx > m) {  // the same in every lane of the group
      const float scale = expf(m - mx);  // 0 at the first slot
      l *= scale;
#pragma unroll
      for (int c = 0; c < 4 * NV; ++c) acc[c] *= scale;
      m = mx;
    }
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (k < nk) {
        s[k] = expf(s[k] - m);
        l += s[k];
      }
    }
    slot_sum<T, KS, NV>(acc, s, sv, D, gl, GT, nk);
    if (G == 1) {
      __syncwarp();  // every lane is done with the slot
      if (t + RS < nt) issue(t + RS);
    }
  }

  // The groups' partials into the rings' space, then the merge of the
  // row's S x NG partials by the cluster's first block.
  __syncthreads();
  float* parts = reinterpret_cast<float*>(smem);
  const size_t stride = 4 + (size_t)D;
  float* mine = parts + group * stride;
  if (gl == 0) {
    mine[0] = m;
    mine[1] = l;
  }
#pragma unroll
  for (int g = 0; g < NV; ++g) {
    const int c = 4 * (gl + g * GT);
    if (c < D)
      *reinterpret_cast<float4*>(mine + 4 + c) =
          make_float4(acc[4 * g], acc[4 * g + 1], acc[4 * g + 2],
                      acc[4 * g + 3]);
  }
  cl.sync();  // every partial of the row written
  if (split == 0) {
    float top = -INFINITY;
    for (int s2 = 0; s2 < S; ++s2) {
      const float* q = cl.map_shared_rank(parts, s2);
      for (int g2 = 0; g2 < NG; ++g2) top = fmaxf(top, q[g2 * stride]);
    }
    T* out = static_cast<T*>(a.att_res) + (size_t)b * D;
    for (int c = 4 * tid; c < D; c += 4 * NT) {
      float total = 0.0f;
      float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int s2 = 0; s2 < S; ++s2) {
        const float* q = cl.map_shared_rank(parts, s2);
        for (int g2 = 0; g2 < NG; ++g2) {
          const float* pq = q + g2 * stride;
          const float w = expf(pq[0] - top);  // 0 for a partial of no ROI
          total += pq[1] * w;
          const float4 x = *reinterpret_cast<const float4*>(pq + 4 + c);
          o.x += w * x.x;
          o.y += w * x.y;
          o.z += w * x.z;
          o.w += w * x.w;
        }
      }
      out[c] = gvd::from_f32<T>(o.x / total);
      out[c + 1] = gvd::from_f32<T>(o.y / total);
      out[c + 2] = gvd::from_f32<T>(o.z / total);
      out[c + 3] = gvd::from_f32<T>(o.w / total);
    }
  }
  cl.sync();  // the peers' shared memory stays until block 0 has read it
}

using KernelFn = void (*)(const Args);

template <typename T, int COPY, int KS>
KernelFn pick_nv(int nv) {
  switch (nv) {
    case 1: return region_attention_split_kernel<T, COPY, 1, KS>;
    case 2: return region_attention_split_kernel<T, COPY, 2, KS>;
    case 4: return region_attention_split_kernel<T, COPY, 4, KS>;
    case 8: return region_attention_split_kernel<T, COPY, 8, KS>;
    default: return nullptr;
  }
}

template <typename T, int COPY>
KernelFn pick_ks(int ks, int nv) {
  return ks == 1 ? pick_nv<T, COPY, 1>(nv)
         : ks == 2 ? pick_nv<T, COPY, 2>(nv)
                   : nullptr;
}

// f32 rows (H, D multiples of 4) are always whole 16 bytes: only bf16 has
// the cp.async route.
template <typename T>
KernelFn pick(int copy, int ks, int nv) {
  if (copy == 0) return pick_ks<T, 0>(ks, nv);
  if constexpr (sizeof(T) == 2)
    if (copy == 8) return pick_ks<T, 8>(ks, nv);
  return nullptr;
}

// The kernel of (dtype, copy, ks, nv) with its shared memory and cluster
// size allowed on the current device (set once per device, kernel and
// size, not at every launch); nullptr (and *err) for a combination this
// file does not have.
KernelFn prepare(int dtype, int copy, int ks, int nv, int smem,
                 cudaError_t* err) {
  // the smem each kernel was allowed, per device
  static int allowed[kMaxDevices][2][2][2][4];
  KernelFn kern = dtype == 0 ? pick<float>(copy, ks, nv)
                  : dtype == 1 ? pick<__nv_bfloat16>(copy, ks, nv)
                               : nullptr;
  *err = cudaErrorInvalidValue;
  if (kern == nullptr || smem <= 0 || smem > kSmemMax) return nullptr;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) {
    *err = e;
    return nullptr;
  }
  const int vi = nv == 1 ? 0 : nv == 2 ? 1 : nv == 4 ? 2 : 3;
  int beyond = 0;  // past kMaxDevices: set the attributes at every launch
  int* done = dev < kMaxDevices
                  ? &allowed[dev][dtype][copy == 0 ? 0 : 1][ks - 1][vi]
                  : &beyond;
  if (smem > *done) {
    e = cudaFuncSetAttribute((const void*)kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          (const void*)kern, cudaFuncAttributeNonPortableClusterSizeAllowed,
          1);
    if (e == cudaSuccess) *done = smem;
  }
  *err = e;
  return e == cudaSuccess ? kern : nullptr;
}

void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                   int splits, int rows, int warps, int smem,
                   cudaStream_t s) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(splits, rows, 1);
  cfg->blockDim = dim3(32 * warps, 1, 1);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace

// The plan (splits, ROIs per split, warps per block, warps per group, ROIs
// per slot, copy route, column groups, smem) is ops/kernels/
// region_attention.py::region_attention_plan's; a plan this file does not
// take returns cudaErrorInvalidValue.
extern "C" int gvd_region_attention(
    int dtype, const void* p_pool, const void* att_h, const void* pool,
    const void* alpha_w, const void* alpha_b, const void* att_mask,
    const void* pnt_mask, void* att_res, void* grd, int B, int R, int H,
    int D, int am_stride, int pm_stride, int splits, int rps, int WB, int G,
    int KS, int copy, int nv, int smem, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  const bool g_ok = (WB == 4 || WB == kWarps) &&
                    (G == 1 || G == 2 || G == 4 || G == kWarps) && G <= WB;
  const bool ks_ok = KS == 1 || KS == kMaxSlotRois;
  const Layout L =
      layout(H, D, itemsize, g_ok ? WB : 8, g_ok ? G : 1, ks_ok ? KS : 1);
  const int row_align = copy == 8 ? kPiece : 16;
  const bool ok =
      B >= 1 && B <= 65535 && R >= 1 && H >= 4 && D >= 4 && H % 4 == 0 &&
      D % 4 == 0 && splits >= 1 && splits <= kMaxSplits && g_ok && ks_ok &&
      rps >= 1 && (long long)rps * splits >= R &&
      128LL * G * nv >= D && (H * itemsize) % row_align == 0 &&
      (D * itemsize) % row_align == 0 && (size_t)smem == L.total &&
      (size_t)(WB / G) * (4 + D) * sizeof(float) <= L.ah &&
      am_stride >= 0 && pm_stride >= 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  KernelFn kern = prepare(dtype, copy, KS, nv, smem, &e);
  if (kern == nullptr) return (int)e;
  const Args a{p_pool,   att_h,   pool,      (const float*)alpha_w,
               (const float*)alpha_b, (const uint8_t*)att_mask,
               (const uint8_t*)pnt_mask, att_res, grd, R, H, D, am_stride,
               pm_stride, rps, G};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, splits, B, WB, smem, (cudaStream_t)stream);
  void* args[] = {(void*)&a};
  e = cudaLaunchKernelExC(&cfg, (const void*)kern, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many blocks of this kernel the card holds at once (splits = 1: the
// blocks an SM holds, cudaOccupancyMaxActiveBlocksPerMultiprocessor, times
// the SMs), or how many clusters of `splits` blocks
// (cudaOccupancyMaxActiveClusters); a negative value is -cudaError.
extern "C" int gvd_region_attention_max_clusters(int dtype, int copy, int ks,
                                                 int nv, int warps,
                                                 int splits, int smem) {
  cudaError_t e;
  KernelFn kern = prepare(dtype, copy, ks, nv, smem, &e);
  if (kern == nullptr) return -(int)e;
  if (splits < 1 || splits > kMaxSplits || (warps != 4 && warps != kWarps))
    return -(int)cudaErrorInvalidValue;
  int n = 0;
  if (splits == 1) {
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, (const void*)kern, 32 * warps, (size_t)smem);
    return e == cudaSuccess ? n * sms : -(int)e;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, splits, 1, warps, smem, 0);
  e = cudaOccupancyMaxActiveClusters(&n, (const void*)kern, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}
