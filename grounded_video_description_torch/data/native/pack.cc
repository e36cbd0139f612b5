// Native batch packer for the feature-ingest path (host code).
//
// The port's copy of grounded_video_description_tpu/data/native/pack.cc.
// The reference's per-item Python work (misc/dataloader_anet.py:317-348)
// — proposal/feature padding, confidence/background masking, masked
// zeroing, and the proposal-vs-GT frame mask — in one pass per segment.
// data/native_pack.py builds it with the host C++ compiler at first use
// into grounded_video_description_torch/_build/ and binds it with ctypes;
// without a compiler it takes its NumPy path, which has the same
// semantics.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// proposals: (num_pps_in, 7) float64 (h5 dtype)
// region_feat: (num_pps_in, feat_dim) float32
// gt_frms: (num_box,) float32
// outputs (pre-allocated, any content):
//   pad_proposals: (max_proposal, 7) float32
//   pad_pnt_mask:  (max_proposal,) uint8            (1 = masked)
//   pad_feat:      (max_proposal, feat_dim) float32
//   pad_frm_mask:  (max_proposal, max_box) uint8    (1 = different frame)
void pack_segment(const double* proposals, int64_t num_pps_in,
                  const float* region_feat, int64_t feat_dim,
                  double prop_thresh, int exclude_bgd,
                  int64_t max_proposal,
                  const float* gt_frms, int64_t num_box,
                  int64_t max_box,
                  float* pad_proposals, uint8_t* pad_pnt_mask,
                  float* pad_feat, uint8_t* pad_frm_mask) {
  const int64_t n = std::min(num_pps_in, max_proposal);

  // zero/mask only the padded TAIL up front; live rows are written
  // (or zeroed when masked) in the loop below — a full-buffer memset
  // doubled the memory traffic of the hot 8 MB feature block
  if (n < max_proposal) {
    std::memset(pad_proposals + n * 7, 0,
                sizeof(float) * (max_proposal - n) * 7);
    std::memset(pad_feat + n * feat_dim, 0,
                sizeof(float) * (max_proposal - n) * feat_dim);
    std::memset(pad_pnt_mask + n, 1, max_proposal - n);
    std::memset(pad_frm_mask + n * max_box, 1,
                (max_proposal - n) * max_box);
  }

  for (int64_t i = 0; i < n; ++i) {
    const double* p = proposals + i * 7;
    const bool masked =
        (p[6] <= prop_thresh) || (exclude_bgd && p[5] == 0.0);
    pad_pnt_mask[i] = masked ? 1 : 0;

    // frame mask uses the original frame index even for masked
    // proposals (the reference computes it before the masked zeroing,
    // dataloader_anet.py:333 vs :343)
    const float frm = static_cast<float>(p[4]);
    uint8_t* fm = pad_frm_mask + i * max_box;
    for (int64_t j = 0; j < num_box; ++j) {
      fm[j] = (frm != gt_frms[j]) ? 1 : 0;
    }
    if (num_box < max_box) {           // pad-box columns stay masked
      std::memset(fm + num_box, 1, max_box - num_box);
    }

    if (masked) {  // masked rows are zeroed (dataloader:343-344)
      std::memset(pad_proposals + i * 7, 0, sizeof(float) * 7);
      std::memset(pad_feat + i * feat_dim, 0,
                  sizeof(float) * feat_dim);
      continue;
    }

    float* out = pad_proposals + i * 7;
    for (int k = 0; k < 7; ++k) out[k] = static_cast<float>(p[k]);
    std::memcpy(pad_feat + i * feat_dim, region_feat + i * feat_dim,
                sizeof(float) * feat_dim);
  }
}

// Collate a batch of already-packed segments into one contiguous
// (B, ...) block — trivial but keeps the GIL-free copy in C.
void stack_f32(const float** srcs, int64_t n, int64_t elems,
               float* dst) {
  for (int64_t b = 0; b < n; ++b) {
    std::memcpy(dst + b * elems, srcs[b], sizeof(float) * elems);
  }
}

}  // extern "C"
