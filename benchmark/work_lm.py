"""The yardstick's arithmetic for an "lm" configuration: the operations
and bytes of the language model's work, from its block's shapes and the
counts its spans carry (``models/lm.py``), at the peaks of ``work.py``.

Operations count 2 per multiply-add of a product; norms, RoPE, the
softmax, routing's top-k and gathers are not counted. Bytes count each
weight read once, the activations read once and written once, and the
latent cache written (prefill) or read (decode) once, in the model's
dtype (bytes of ``bfloat16``: 2).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from benchmark import work
from benchmark.work import ITEMSIZE, PEAK_BYTES, PEAK_FLOPS, linear


def _dims(b: Dict):
    return (b["hidden_size"], b["num_attention_heads"],
            b["qk_nope_head_dim"], b["qk_rope_head_dim"], b["v_head_dim"],
            b["kv_lora_rank"])


def mla_weights(b: Dict) -> int:
    """Parameters of one layer's attention (its norm left out)."""
    H, nH, nope, rd, v, r = _dims(b)
    return (H * nH * (nope + rd) + H * (r + rd) + r * nH * (nope + v)
            + nH * v * H)


def mla_work(b: Dict, rows: int, key_rows: int, decode: bool,
             dtype: str) -> Tuple[int, int]:
    """(operations, bytes) of one layer's attention over ``rows`` tokens
    that attend ``key_rows`` keys in all (the ``mla`` span's counts).
    Prefill: the projections, the expanded keys and values, QK^T and PV
    over the causal pairs, the cache written. Decode: the projections,
    W_kvb's halves absorbed per row, scores and context over the latent
    cache, the cache read."""
    H, nH, nope, rd, v, r = _dims(b)
    size = ITEMSIZE[dtype]
    proj = (linear(rows, H, nH * (nope + rd)) + linear(rows, H, r + rd)
            + linear(rows, nH * v, H))
    if decode:
        flops = (proj + 2 * rows * nH * (nope + v) * r
                 + 2 * key_rows * nH * ((r + rd) + r))
        cache = key_rows * (r + rd) * size
    else:
        flops = (proj + linear(rows, r, nH * (nope + v))
                 + 2 * key_rows * nH * ((nope + rd) + v))
        cache = rows * (r + rd) * size
    n_bytes = mla_weights(b) * size + 2 * rows * H * size + cache
    return flops, n_bytes


def moe_work(b: Dict, rows: int, routed_rows: int, experts_active: int,
             dtype: str) -> Tuple[int, int]:
    """(operations, bytes) of one MoE layer on ``rows`` tokens: the
    router, ``routed_rows`` token-expert pairs through a routed SwiGLU,
    every token through the shared one; the weights of the
    ``experts_active`` experts touched, the router's and the shared
    experts', the tokens in and out."""
    H, E, I = b["hidden_size"], b["n_routed_experts"], \
        b["moe_intermediate_size"]
    S = b["n_shared_experts"] * I
    size = ITEMSIZE[dtype]
    flops = (linear(rows, H, E) + routed_rows * 6 * H * I
             + rows * 6 * H * S)
    n_bytes = ((experts_active * 3 * H * I + 3 * H * S + E * H) * size
               + 2 * rows * H * size)
    return flops, n_bytes


def least(flops: int, n_bytes: int, dtype: str) -> float:
    """The least seconds the card could take: operations at the dtype's
    peak or bytes at the memory's, the larger."""
    return max(flops / PEAK_FLOPS[dtype], n_bytes / PEAK_BYTES)


def lm_flops(b: Dict, d_visual: int, B: int, S: int, L: int) -> int:
    """A greedy caption of L words for B sequences of S tokens (the
    visual tokens and the start id): the projector over the visual
    tokens, the prefill of S tokens, L - 1 steps through the cache, and
    the vocabulary head at the L decoded positions."""
    H, V, k = b["hidden_size"], b["vocab_size"], b["num_experts_per_tok"]
    P = b["projector_hidden_size"]
    dense = b["first_k_dense_replace"]
    moe_layers = b["num_hidden_layers"] - dense

    def layers(rows: int, key_rows: int, decode: bool) -> int:
        attn = mla_work(b, rows, key_rows, decode, "bfloat16")[0]
        ffn = linear(rows, H, 2 * b["intermediate_size"]) \
            + linear(rows, b["intermediate_size"], H)
        moe = moe_work(b, rows, rows * k, 0, "bfloat16")[0]
        return b["num_hidden_layers"] * attn + dense * ffn + moe_layers * moe

    total = linear(B * (S - 1), d_visual, P) + linear(B * (S - 1), P, H)
    total += layers(B * S, B * S * (S + 1) // 2, False)
    for t in range(1, L):
        total += layers(B, B * (S + t), True)
    return total + linear(B * L, H, V)


def serve_flops(config: Dict, B: int) -> int:
    """One batch of B segments captioned by the lm configuration: GVD's
    encode and the language model's greedy decode over its 480 + 1000
    encodings."""
    m, b = config["model"], config["lm"]
    S = m["t_attn_size"] + m["num_sampled_frm"] * m["num_prop_per_frm"] + 1
    return work.encode_flops(m, B) + lm_flops(b, m["rnn_size"], B, S,
                                              m["seq_length"])


def count(record, name: str) -> Optional[int]:
    """A span record's count ``name`` (None where the program keeps no
    such count)."""
    counts = getattr(record, "counts", None)
    return None if not counts or name not in counts else counts[name]
