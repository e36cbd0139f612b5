// The tensor-core attention kernels, called by the C entry points of
// csrc/attention_train.cu and by K1 (csrc/encoder_layer.cu): bf16 in
// csrc/attention_mma.cu, f32 (3xTF32) in csrc/attention_tf32x3.cu.  Both
// run on the same packed layout, made by the same repack.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gvd {

// Rows of a query or key tile; the packed rows are padded to a multiple.
constexpr int ATTN_TILE = 64;

inline int rows_padded(int R) {
  return (R + ATTN_TILE - 1) / ATTN_TILE * ATTN_TILE;
}

// The packed width of a head hs wide (64, 128, 176 or 192; 0 past 192).
int packed_width(int hs);

// n <= 4 tensors (B, R, D) of dtype 0 (f32) or 1 (bf16), rows ld elements
// apart, into dst: n packed (B, H, Rt, dp) one after another, pads zero.
int pack_heads(int dtype, int n, const void* const* src, void* dst, int B,
               int R, int D, int hs, int ld, cudaStream_t s);

// q, k, v (B, R, D) with rows ld elements apart (ld = D, or 3D for K1's
// QKV buffer), out (B, R, D), heads as column ranges of width hs; scratch
// holds three packed (B, H, Rt, dp) tensors of the inputs' dtype (Rt = R
// rounded up to the tile, dp = gvd_packed_width(hs)).  lse may be null
// (K1, K7), and drop = false compiles the dropout out.
int attention_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                       float* lse, const long long* seed, void* scratch,
                       int B, int R, int D, int hs, int ld,
                       uint32_t salt_base, int salt_mul, float inv_scale,
                       float rate, bool drop, cudaStream_t s);
int attention_fwd_f32(const void* q, const void* k, const void* v, void* out,
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
int attention_bwd_f32(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const long long* seed, void* scratch, void* dq,
                      void* dk, void* dv, int B, int R, int D, int hs,
                      uint32_t salt_base, int salt_mul, float inv_scale,
                      float rate, cudaStream_t s);

}  // namespace gvd
