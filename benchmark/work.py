"""The yardstick's arithmetic: the card's peaks and the operations and
bytes of the model's work, computed from shapes alone.

Operations count 2 per multiply-add of a product; element-wise work,
softmaxes and gathers are not counted. The peaks are one number per
dtype, whatever route a kernel takes: an f32 product may run on the SIMT
units, in 3xTF32 or in TF32, and the fastest of these, the TF32 tensor
cores' 495 TFLOP/s, bounds them all (NVIDIA H100 SXM data sheet, dense,
at 700 W).
"""

from __future__ import annotations

from typing import Dict

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def linear(rows: int, fan_in: int, fan_out: int) -> int:
    return 2 * rows * fan_in * fan_out


def encoder_layer_flops(B: int, R: int, D: int, F: int) -> int:
    """One obj_interact layer's forward on (B, R, D): the QKV, Wo and FFN
    products and QK^T and PV over every head (the heads tile D)."""
    return 2 * B * R * (4 * D * D + 2 * D * F) + 4 * B * R * R * D


def encoder_layer_bytes(B: int, R: int, D: int, F: int, dtype: str) -> int:
    """One layer's forward reads its input and its f32 weights once and
    writes its output once."""
    weights = 4 * D * D + 2 * D * F + F + D + 4 * D
    return 2 * B * R * D * ITEMSIZE[dtype] + 4 * weights


def birnn_flops(B: int, T: int, d_in: int, H: int, layers: int,
                gates: int = 3) -> int:
    """A stacked bidirectional GRU: each direction's input projection and
    recurrent product at every step."""
    total, d = 0, d_in
    for _ in range(layers):
        total += 2 * (linear(B * T, d, gates * H) + linear(B * T, H, gates * H))
        d = 2 * H
    return total


def encode_flops(m: Dict, B: int) -> int:
    """The encode of B segments (model.py:302-409)."""
    R = m["num_sampled_frm"] * m["num_prop_per_frm"]
    T, rnn, hid = m["t_attn_size"], m["rnn_size"], m["att_hid_size"]
    vis, C = m["att_feat_size"], m["detect_size"] + 1
    return (linear(B, 4, m["seg_info_size"])
            + linear(B * R, vis, vis)                        # ctx2pool_grd
            + 2 * B * C * R * vis                            # grounder
            + linear(B * R, 5, m["loc_encoding_size"])
            + linear(B * R, vis + m["loc_encoding_size"] + C, rnn)
            + linear(B, m["fc_feat_size"] + m["seg_info_size"], rnn)
            + 2 * encoder_layer_flops(B, R, rnn, rnn // 2)  # obj_interact
            + linear(B * R, rnn, hid)                        # ctx2pool
            + linear(B * T, m["rgb_feat_size"], rnn // 2)
            + linear(B * T, m["motion_feat_size"], rnn // 2)
            + birnn_flops(B, T, rnn, rnn // 2, 2)
            + linear(B * T, rnn, hid))                       # ctx2att


def topdown_decode_flops(m: Dict, B: int, rows: int, steps: int) -> int:
    """``steps`` TopDown steps of ``rows`` caption rows over the banks of
    B segments, with the vocab head at every step: both LSTM cells (the
    fc part of the attention LSTM's input once per row), both h2att
    projections, and the temporal and region attentions (3 operations a
    score column and 2 a weighted-sum column, chip_smoke.py's
    ``decode_work``). The banks' projections are the encode's."""
    R = m["num_sampled_frm"] * m["num_prop_per_frm"]
    T, rnn, hid = m["t_attn_size"], m["rnn_size"], m["att_hid_size"]
    E, V = m["input_encoding_size"], m["vocab_size"]
    step = (linear(rows, E + rnn, 4 * rnn) + linear(rows, 2 * rnn, 4 * rnn)
            + 2 * linear(rows, rnn, hid)
            + rows * (T + R) * (3 * hid + 2 * rnn)
            + linear(rows, rnn, V))
    return steps * step + linear(rows, rnn, 4 * rnn)


def transformer_decode_flops(m: Dict, B: int, steps: int) -> int:
    """The Masked-Transformer decoder's incremental greedy decode: each
    layer's cross keys and values once per decode; per step the self- and
    cross-attention projections, their scores and sums over the keys so
    far, the FFN and the vocab head."""
    R = m["num_sampled_frm"] * m["num_prop_per_frm"]
    D, V = m["rnn_size"], m["vocab_size"]
    total = 0
    for keys in (m["t_attn_size"], R):                 # layer 0, layer 1
        total += 2 * linear(B * keys, D, D)
        for t in range(steps):
            total += (6 * linear(B, D, D) + 4 * B * (t + 1) * D
                      + 4 * B * keys * D + 2 * linear(B, D, D // 2))
    return total + steps * linear(B, D, V)


def serve_flops(m: Dict, B: int, beam: int) -> int:
    """One batch of B segments captioned with ``seq_length`` words."""
    L = m["seq_length"]
    enc = encode_flops(m, B)
    if m["att_model"] == "transformer":
        return enc + transformer_decode_flops(m, B, L)
    return enc + topdown_decode_flops(m, B, B * beam, L)


def train_flops(m: Dict, B: int) -> int:
    """One supervised step on B segments: the teacher-forced forward (the
    encode, ``seq_length`` TopDown steps with the vocab head, the grounder
    over the target words) and a backward of twice its operations."""
    R = m["num_sampled_frm"] * m["num_prop_per_frm"]
    L = m["seq_length"]
    forward = (encode_flops(m, B) + topdown_decode_flops(m, B, B, L)
               + 2 * B * L * R * m["att_feat_size"])
    return 3 * forward


def k5_work(m: Dict, B: int, microbatches: int, dtype: str):
    """(operations, bytes) of the obj_interact encoder in training: two
    layers forward and backward (twice the forward's operations) on each
    microbatch of B / microbatches rows."""
    R = m["num_sampled_frm"] * m["num_prop_per_frm"]
    D = m["rnn_size"]
    rows = B // microbatches
    per = 3 * 2 * encoder_layer_flops(rows, R, D, D // 2)
    # forward: x, W in, out; backward: dout, x, W in, dx, dW out
    n_bytes = 2 * (2 * encoder_layer_bytes(rows, R, D, D // 2, dtype)
                   + 2 * rows * R * D * ITEMSIZE[dtype])
    return microbatches * per, microbatches * n_bytes


def k1_work(m: Dict, B: int, dtype: str):
    """(operations, bytes) of the obj_interact encoder at inference: two
    layers on (B, R, rnn)."""
    R = m["num_sampled_frm"] * m["num_prop_per_frm"]
    D = m["rnn_size"]
    return (2 * encoder_layer_flops(B, R, D, D // 2),
            2 * encoder_layer_bytes(B, R, D, D // 2, dtype))


def least_seconds(flops: float, n_bytes: float, dtype: str) -> float:
    """The least time the card could take for the work: the larger of its
    operations at the dtype's peak and its bytes at the memory's."""
    return max(flops / PEAK_FLOPS[dtype], n_bytes / PEAK_BYTES)
