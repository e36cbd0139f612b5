// obj_interact self-attention in training, forward and backward, with
// dropout on the probabilities (K4): the C entry points, and the backward's
// delta pass.
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
// (171 x 5 + 169 at D = 1024), as in K1.  Both dtypes run on Hopper's
// tensor cores, on one skeleton: a repack into zero-padded head-major
// (B, H, Rt, dp) scratch, a FlashAttention-2 forward that writes o and the
// row log-sum-exp (B, H, R), and a backward of delta = rowsum(dO * o) per
// head (below), one kernel per 64-key tile for dK and dV and one per
// 64-query tile for dQ, each recomputing P = exp(s - lse) and the mask.
// No atomics, so a second call gives the same bits.
//  * bf16: csrc/attention_mma.cu, mma.sync.m16n8k16, P~ and dS rounded to
//    bf16 where they enter a product (as the JAX TPU kernel rounds them).
//  * f32: csrc/attention_tf32x3.cu, mma.sync.m16n8k8 in 3xTF32 (each
//    operand split into two TF32 terms, three products per product), so
//    that f32 keeps its bars; P~ and dS stay f32.  Bound: the tensor cores
//    at 494.7 / 3 TFLOP/s; at the flagship microbatch (B = 30, R = 1000,
//    six heads of 171) 0.745 ms forward and 1.863 ms backward (see that
//    file's note for the budget).
//
// K7, the inference flash attention, is this forward too, dropout compiled
// out: gvd_flash_self_attention replaces grounded_video_description_tpu/
// ops/pallas/mha.py::flash_self_attention, softmax(q k^T) v per leading
// index of (N, R, d) tensors, q pre-scaled, d odd (171 at flagship width).
// It runs the forward with B = N, one head of width d, inv_scale 1 and no
// log-sum-exp written; the (R, R) scores of the TPU kernel's VMEM never
// exist here.  At flagship width (N = 600, R = 1000) that is 0.410 TFLOP,
// 2.489 ms at the 3xTF32 rate in f32.

#include "attention_mma.cuh"
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

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

template <typename T>
int launch_delta(const void* out, const void* dout, float* delta, int B,
                 int R, int D, int hs, cudaStream_t s) {
  const int heads = (D + hs - 1) / hs, rows = B * R;
  delta_kernel<T><<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0,
                    s>>>((const T*)out, (const T*)dout, delta, rows, R, D, hs,
                         heads);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: (B, R, D) contiguous; lse: (B, heads, R) f32, written;
// seed: one int64 on the device (its low 32 bits key the hash); the mask of
// (row b, head h) is salted salt_base + b * salt_mul + h.  dtype 0 (f32)
// or 1 (bf16); scratch holds three packed (B, heads, Rt, dp) tensors of
// that dtype (gvd_packed_width, in attention_mma.cu, gives dp and the row
// padding).
extern "C" int gvd_attention_train_fwd(int dtype, const void* q,
                                       const void* k, const void* v,
                                       void* out, void* lse, const void* seed,
                                       void* scratch, int B, int R, int D,
                                       int n_heads, float inv_scale,
                                       float rate, int salt_base,
                                       int salt_mul, void* stream) {
  const int hs = (D + n_heads - 1) / n_heads;
  if (gvd::packed_width(hs) == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* sd = (const long long*)seed;
  const uint32_t sb = (uint32_t)salt_base;
  if (dtype == 1)
    return gvd::attention_fwd_bf16(q, k, v, out, (float*)lse, sd, scratch, B,
                                   R, D, hs, D, sb, salt_mul, inv_scale,
                                   rate, true, s);
  if (dtype == 0)
    return gvd::attention_fwd_f32(q, k, v, out, (float*)lse, sd, scratch, B,
                                  R, D, hs, D, sb, salt_mul, inv_scale, rate,
                                  true, s);
  return (int)cudaErrorInvalidValue;
}

// dout: (B, R, D); dq, dk, dv: (B, R, D), written; delta: (B, heads, R) f32
// scratch; scratch: four packed tensors of the dtype, and for f32 then
// dS^T, (B, heads, Rt, Rt) f32.
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
  if (gvd::packed_width(hs) == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* sd = (const long long*)seed;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  const uint32_t sb = (uint32_t)salt_base;
  if (dtype == 1) {
    const int e = launch_delta<__nv_bfloat16>(out, dout, dl, B, R, D, hs, s);
    if (e != 0) return e;
    return gvd::attention_bwd_bf16(q, k, v, dout, l, dl, sd, scratch, dq, dk,
                                   dv, B, R, D, hs, sb, salt_mul,
                                   inv_scale, rate, s);
  }
  if (dtype == 0) {
    const int e = launch_delta<float>(out, dout, dl, B, R, D, hs, s);
    if (e != 0) return e;
    return gvd::attention_bwd_f32(q, k, v, dout, l, dl, sd, scratch, dq, dk,
                                  dv, B, R, D, hs, sb, salt_mul, inv_scale,
                                  rate, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K7.  q, k, v, out: (N, R, d) contiguous, q pre-scaled; no dropout, no
// log-sum-exp.  The forward of the dtype with one head of width d, scratch
// for three packed (N, 1, Rt, dp) tensors of that dtype.
extern "C" int gvd_flash_self_attention(int dtype, const void* q,
                                        const void* k, const void* v,
                                        void* out, void* scratch, int N,
                                        int R, int d, void* stream) {
  if (gvd::packed_width(d) == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return gvd::attention_fwd_bf16(q, k, v, out, nullptr, nullptr, scratch,
                                   N, R, d, d, d, 0u, 0, 1.0f, 0.0f, false,
                                   s);
  if (dtype == 0)
    return gvd::attention_fwd_f32(q, k, v, out, nullptr, nullptr, scratch, N,
                                  R, d, d, d, 0u, 0, 1.0f, 0.0f, false, s);
  return (int)cudaErrorInvalidValue;
}
