// The bf16 tensor-core attention of csrc/attention_mma.cu, called by the C
// entry points of csrc/attention_train.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gvd {

// q, k, v (B, R, D) with rows ld elements apart (ld = D, or 3D for K1's
// QKV buffer), out (B, R, D), heads as column ranges of width hs; scratch
// holds three packed (B, H, Rt, dp) bf16 tensors (Rt = R rounded up to the
// tile, dp = gvd_packed_width(hs)).  lse may be null (K1, K7), and drop =
// false compiles the dropout out.
int attention_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                       float* lse, const long long* seed, void* scratch,
                       int B, int R, int D, int hs, int ld,
                       uint32_t salt_base, int salt_mul, float inv_scale,
                       float rate, bool drop, cudaStream_t s);

// delta (B, H, R) f32 already written; scratch holds four packed tensors.
int attention_bwd_bf16(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const long long* seed, void* scratch, void* dq,
                       void* dk, void* dv, int B, int R, int D, int hs,
                       uint32_t salt_base, int salt_mul, float inv_scale,
                       float rate, cudaStream_t s);

}  // namespace gvd
