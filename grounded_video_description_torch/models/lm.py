"""The language-model captioner of ``att_model`` "lm": a DeepSeek-V3
language model (multi-head latent attention, a mixture of experts with
sigmoid routing and shared experts, a leading dense layer) behind a
vision-language model's MLP projector, reading GVD's frame and region
encodings as visual tokens and decoding a caption greedily through a
latent cache.  The block's keys are those of the published
``config.json`` (the benchmark's configuration is Kimi-VL-A3B-Instruct's
language model).

Per layer, with RMSNorm ``n(.)`` (statistics in f32):

    h = x + MLA(n(x)),  y = h + FFN(n(h))

MLA (``q_lora_rank`` null): ``q = W_q x`` split per head into ``q_nope``
(``qk_nope_head_dim``) and ``q_pe`` (``qk_rope_head_dim``);
``[c_kv, k_pe] = W_kva x`` with ``c_kv`` (``kv_lora_rank``) through its
RMSNorm and ``k_pe`` shared by the heads; ``[k_nope, v] = W_kvb c_kv``
per head; RoPE at ``rope_theta`` on ``q_pe`` and ``k_pe`` (``rope``:
the pairs (x[2i], x[2i+1]) rotated by pos / theta^(2i/d), the result
laid out de-interleaved, as the published modelling code's
``apply_rotary_pos_emb``); ``softmax((q_nope.k_nope + q_pe.k_pe) /
sqrt(nope + rope))`` under a causal mask, the probabilities in f32;
``W_o`` over the heads' ``softmax.v``.  Prefill computes the expanded
keys and values; decode keeps only ``[c_kv, k_pe]`` in the cache (576
values a token a layer) and absorbs ``W_kvb``'s key half into the query
and its value half after the latent context.

FFN: layers below ``first_k_dense_replace`` a dense SwiGLU of
``intermediate_size``; the others the MoE: ``s = sigmoid(W_g x)`` in f32,
the experts the top ``num_experts_per_tok`` of ``s + b``
(``e_score_correction_bias``; ``n_group`` 1), their weights ``s[top] /
sum(s[top]) * routed_scaling_factor``, ``sum_i w_i E_i(x) + S(x)`` with
``E_i(x) = W2 (silu(W1 x) * W3 x)`` of width ``moe_intermediate_size``
and ``S`` the ``n_shared_experts`` shared experts as one SwiGLU.  The
token-expert pairs are sorted by expert and each expert's GEMMs run over
its contiguous rows: ``torch._grouped_mm`` for bf16 on a CUDA device
where torch has it, one GEMM per expert otherwise.

Head: a final RMSNorm and ``lm_head``, at the decoded positions only.
The projector (the family's): LayerNorm, Linear, GELU, Linear to the
hidden width, from GVD's encoding width.

Tokens: the frame encodings, then the region encodings, then
``start_id``, at positions 0..; then greedy steps through the cache.
Id 0 ends a caption: after it a row's words and log-probabilities are 0.

Departures from the published model: the visual tokens are GVD's
encodings through the projector (no vision tower, no text prompt); every
proposal slot is a token (``pnt_mask`` is not applied); the scores of
the latent decode are summed in one product over ``[c_kv, k_pe]``.

Parameters are in the block's ``torch_dtype`` (bfloat16 as published;
the tests build float32), except ``e_score_correction_bias``, f32 as in
the published model; activations run in it, products accumulate in f32.
Spans (``utils/logging.py``): ``lm_prefill`` (with ``cache_bytes``) and
``lm_decode``; in each layer ``mla`` (``rows``, ``key_rows``: the keys
attended, summed over the rows) and ``moe`` (``routed_rows``,
``experts_active``, ``max_expert_rows``) or, in a dense layer, ``ffn``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from grounded_video_description_torch.utils.logging import (
    recording, span, span_count)

# the block's keys the model reads (a published config.json has more)
SHAPE_KEYS = ("hidden_size", "num_attention_heads", "qk_nope_head_dim",
              "qk_rope_head_dim", "v_head_dim", "kv_lora_rank",
              "num_hidden_layers", "first_k_dense_replace",
              "intermediate_size", "n_routed_experts", "num_experts_per_tok",
              "n_shared_experts", "moe_intermediate_size", "vocab_size",
              "rms_norm_eps", "rope_theta", "routed_scaling_factor",
              "projector_hidden_size", "start_id")
# what the model implements of the published options
SUPPORTED = {"q_lora_rank": None, "scoring_func": "sigmoid",
             "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
             "norm_topk_prob": True, "rope_scaling": None,
             "hidden_act": "silu", "moe_layer_freq": 1,
             "attention_bias": False, "tie_word_embeddings": False}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class LMShape:
    hidden: int
    heads: int
    nope: int
    rope: int
    v: int
    kv_rank: int
    layers: int
    dense_layers: int
    dense_width: int
    experts: int
    top_k: int
    shared: int
    expert_width: int
    vocab: int
    eps: float
    theta: float
    scale: float
    projector_hidden: int
    start_id: int
    dtype: torch.dtype

    @classmethod
    def of(cls, block: Dict) -> "LMShape":
        missing = [k for k in SHAPE_KEYS if k not in block]
        if missing:
            raise ValueError(f"the lm block lacks {missing}")
        for key, want in SUPPORTED.items():
            if block.get(key, want) != want:
                raise ValueError(f"the lm block's {key} {block[key]!r}: the "
                                 f"model implements {want!r}")
        dtype = block.get("torch_dtype", "bfloat16")
        if dtype not in DTYPES:
            raise ValueError(f"unknown torch_dtype {dtype!r}")
        b = block
        return cls(b["hidden_size"], b["num_attention_heads"],
                   b["qk_nope_head_dim"], b["qk_rope_head_dim"],
                   b["v_head_dim"], b["kv_lora_rank"],
                   b["num_hidden_layers"], b["first_k_dense_replace"],
                   b["intermediate_size"], b["n_routed_experts"],
                   b["num_experts_per_tok"], b["n_shared_experts"],
                   b["moe_intermediate_size"], b["vocab_size"],
                   float(b["rms_norm_eps"]), float(b["rope_theta"]),
                   float(b["routed_scaling_factor"]),
                   b["projector_hidden_size"], b["start_id"], DTYPES[dtype])

    @property
    def qk(self) -> int:
        return self.nope + self.rope

    @property
    def latent(self) -> int:
        """Values a token a layer in the cache: c_kv and k_pe."""
        return self.kv_rank + self.rope


def _param(*shape, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype):
        super().__init__()
        self.eps = eps
        self.weight = _param(dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * xf.to(x.dtype)


def _linear(d_in: int, d_out: int, dtype, bias: bool = False) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=bias, dtype=dtype)


class SwiGLU(nn.Module):
    """W2 (silu(W1 x) * W3 x), with W1 and W3 stacked as ``gate_up_proj``
    (the gate's rows first)."""

    def __init__(self, hidden: int, width: int, dtype):
        super().__init__()
        self.gate_up_proj = _param(2 * width, hidden, dtype=dtype)
        self.down_proj = _param(hidden, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(_swiglu(F.linear(x, self.gate_up_proj)),
                        self.down_proj)


def _swiglu(gu: torch.Tensor) -> torch.Tensor:
    g, u = gu.chunk(2, dim=-1)
    return F.silu(g) * u


class MLA(nn.Module):
    def __init__(self, s: LMShape):
        super().__init__()
        dt = s.dtype
        self.q_proj = _linear(s.hidden, s.heads * s.qk, dt)
        self.kv_a_proj_with_mqa = _linear(s.hidden, s.latent, dt)
        self.kv_a_layernorm = RMSNorm(s.kv_rank, s.eps, dt)
        self.kv_b_proj = _linear(s.kv_rank, s.heads * (s.nope + s.v), dt)
        self.o_proj = _linear(s.heads * s.v, s.hidden, dt)


class Experts(nn.Module):
    """The routed experts' SwiGLUs stacked: ``gate_up_proj`` (E, 2I, H),
    ``down_proj`` (E, H, I)."""

    def __init__(self, s: LMShape):
        super().__init__()
        dt = s.dtype
        self.gate_up_proj = _param(s.experts, 2 * s.expert_width, s.hidden,
                                   dtype=dt)
        self.down_proj = _param(s.experts, s.hidden, s.expert_width, dtype=dt)


class Router(nn.Module):
    def __init__(self, s: LMShape):
        super().__init__()
        self.weight = _param(s.experts, s.hidden, dtype=s.dtype)
        self.e_score_correction_bias = _param(s.experts, dtype=torch.float32)


class MoE(nn.Module):
    def __init__(self, s: LMShape):
        super().__init__()
        self.gate = Router(s)
        self.experts = Experts(s)
        self.shared_experts = SwiGLU(s.hidden, s.shared * s.expert_width,
                                     s.dtype)


class Layer(nn.Module):
    def __init__(self, s: LMShape, dense: bool):
        super().__init__()
        self.input_layernorm = RMSNorm(s.hidden, s.eps, s.dtype)
        self.self_attn = MLA(s)
        self.post_attention_layernorm = RMSNorm(s.hidden, s.eps, s.dtype)
        self.mlp = SwiGLU(s.hidden, s.dense_width, s.dtype) if dense \
            else MoE(s)


class Projector(nn.Module):
    def __init__(self, d_in: int, s: LMShape):
        super().__init__()
        self.pre_norm = nn.LayerNorm(d_in, eps=1e-5, dtype=s.dtype)
        self.linear_1 = _linear(d_in, s.projector_hidden, s.dtype, bias=True)
        self.linear_2 = _linear(s.projector_hidden, s.hidden, s.dtype,
                                bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ln = self.pre_norm
        x = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                         ln.bias.float(), ln.eps).to(ln.weight.dtype)
        return self.linear_2(F.gelu(self.linear_1(x)))


# --------------------------------------------------------------------- #
# the pieces of a pass
# --------------------------------------------------------------------- #

def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE on the last axis of x (even width d) at positions ``pos``
    (broadcast against x's leading axes without the last): the pairs
    (x[2i], x[2i+1]) rotated by pos * theta^(-2i/d), the result laid out
    de-interleaved (the rotated first members, then the second), in f32,
    returned in x's dtype."""
    d = x.shape[-1]
    xf = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    inv = theta ** (-torch.arange(0, d, 2, device=x.device,
                                  dtype=torch.float32) / d)
    ang = pos.float()[..., None] * inv
    cos, sin = ang.cos(), ang.sin()
    a, b = xf[..., :d // 2], xf[..., d // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1).to(x.dtype)


def grouped_gemm_available(x: torch.Tensor) -> bool:
    """The grouped dispatch's route: ``torch._grouped_mm`` takes bf16 on
    a CUDA device where the installed torch has it."""
    return (x.is_cuda and x.dtype == torch.bfloat16
            and hasattr(torch, "_grouped_mm"))


def route(moe: MoE, x: torch.Tensor, top_k: int, scale: float
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(experts (N, k), weights (N, k) f32) of the tokens x (N, H)."""
    g = moe.gate
    s = torch.sigmoid(F.linear(x.float(), g.weight.float()))
    top = (s + g.e_score_correction_bias).topk(top_k, dim=-1).indices
    w = s.gather(-1, top)
    return top, w / (w.sum(-1, keepdim=True) + 1e-20) * scale


def experts_forward(ex: Experts, x: torch.Tensor, top: torch.Tensor,
                    grouped: Optional[bool] = None) -> torch.Tensor:
    """Every routed pair's expert output, (N, k, H) in x's dtype: the
    pairs sorted by expert, each expert's two GEMMs over its contiguous
    rows (``torch._grouped_mm`` where ``grouped``, else one GEMM per
    expert), the outputs put back in the pairs' order.  Counts the
    ``moe`` span's rows while a span records."""
    N, k = top.shape
    E = ex.gate_up_proj.shape[0]
    flat = top.reshape(-1)
    order = flat.argsort(stable=True)
    # the rows of each expert, counted without a host sync (bincount
    # reads its input's largest value back to size its output)
    counts = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    if recording():
        span_count(routed_rows=N * k, experts_active=(counts > 0).sum(),
                   max_expert_rows=counts.max())
    xs = x[order // k]                                       # (N k, H)
    if grouped is None:
        grouped = grouped_gemm_available(x)
    if grouped:
        offs = counts.cumsum(0).to(torch.int32)
        act = _swiglu(torch._grouped_mm(
            xs, ex.gate_up_proj.transpose(-2, -1), offs=offs))
        del xs
        ys = torch._grouped_mm(act, ex.down_proj.transpose(-2, -1),
                               offs=offs)
    else:
        ys = torch.empty_like(xs)
        o = 0
        for e, n in enumerate(counts.tolist()):
            if n:
                ys[o:o + n] = F.linear(_swiglu(F.linear(
                    xs[o:o + n], ex.gate_up_proj[e])), ex.down_proj[e])
            o += n
    out = torch.empty_like(ys)
    out[order] = ys
    return out.view(N, k, -1)


def moe_forward(moe: MoE, x: torch.Tensor, top_k: int, scale: float
                ) -> torch.Tensor:
    """The MoE on tokens x (N, H): the routed experts' outputs weighted
    and summed in f32 (in the order of each token's picks), plus the
    shared experts', in x's dtype."""
    top, w = route(moe, x, top_k, scale)
    y = experts_forward(moe.experts, x, top)
    out = moe.shared_experts(x).float()
    for j in range(top_k):
        out += y[:, j].float() * w[:, j:j + 1]
    return out.to(x.dtype)


def ffn(layer: Layer, x: torch.Tensor, s: LMShape) -> torch.Tensor:
    """The layer's FFN under its span: ``moe``, or ``ffn`` where dense."""
    if isinstance(layer.mlp, MoE):
        with span("moe"):
            return moe_forward(layer.mlp, x, s.top_k, s.scale)
    with span("ffn"):
        return layer.mlp(x)


def _latent(attn: MLA, x: torch.Tensor, pos: torch.Tensor, s: LMShape
            ) -> torch.Tensor:
    """[RMSNorm(c_kv), RoPE(k_pe)] of tokens x (..., H) at ``pos``: what
    the cache holds."""
    kva = attn.kv_a_proj_with_mqa(x)
    return torch.cat([attn.kv_a_layernorm(kva[..., :s.kv_rank]),
                      rope(kva[..., s.kv_rank:], pos, s.theta)], -1)


def _query(attn: MLA, x: torch.Tensor, pos: torch.Tensor, s: LMShape
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope, RoPE(q_pe)) per head of tokens x (..., H)."""
    q = attn.q_proj(x).unflatten(-1, (s.heads, s.qk))
    return q[..., :s.nope], rope(q[..., s.nope:], pos[..., None], s.theta)


def mla_prefill(attn: MLA, x: torch.Tensor, cache: torch.Tensor,
                s: LMShape) -> torch.Tensor:
    """Causal MLA over whole sequences x (B, S, H) with the expanded keys
    and values; writes the latent of every position into ``cache`` (B,
    T, latent)."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    if recording():
        span_count(rows=B * S, key_rows=B * S * (S + 1) // 2)
    lat = _latent(attn, x, pos, s)
    cache[:, :S] = lat
    q_nope, q_pe = _query(attn, x, pos, s)
    kv = attn.kv_b_proj(lat[..., :s.kv_rank]).unflatten(
        -1, (s.heads, s.nope + s.v))
    k = torch.cat([kv[..., :s.nope], lat[..., None, s.kv_rank:].expand(
        B, S, s.heads, s.rope)], -1)
    q = torch.cat([q_nope, q_pe], -1)
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2),
        kv[..., s.nope:].transpose(1, 2), is_causal=True,
        scale=1.0 / math.sqrt(s.qk))                    # (B, heads, S, v)
    return attn.o_proj(o.transpose(1, 2).flatten(2))


def mla_decode(attn: MLA, x: torch.Tensor, cache: torch.Tensor, p: int,
               s: LMShape) -> torch.Tensor:
    """MLA of one token a row, x (B, H) at position ``p``, through the
    latent cache (B, T, latent): its latent written at ``p``, W_kvb's key
    half absorbed into the query, its value half applied after the latent
    context."""
    B = x.shape[0]
    pos = torch.full((1,), p, device=x.device)
    if recording():
        span_count(rows=B, key_rows=B * (p + 1))
    cache[:, p] = _latent(attn, x, pos, s)
    q_nope, q_pe = _query(attn, x, pos, s)              # (B, heads, .)
    w = attn.kv_b_proj.weight.view(s.heads, s.nope + s.v, s.kv_rank)
    q_lat = torch.einsum("bhd,hdc->bhc", q_nope, w[:, :s.nope])
    keys = cache[:, :p + 1]                              # (B, p+1, latent)
    scores = torch.matmul(torch.cat([q_lat, q_pe], -1), keys.transpose(1, 2))
    probs = torch.softmax(scores.float() / math.sqrt(s.qk), dim=-1)
    ctx = torch.matmul(probs.to(x.dtype), keys[..., :s.kv_rank])
    o = torch.einsum("bhc,hvc->bhv", ctx, w[:, s.nope:])
    return attn.o_proj(o.flatten(1))


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #

class LanguageModel(nn.Module):
    """The projector and the language model of an lm block, over visual
    tokens of width ``d_visual``.  Build it on the meta device and load
    its weights with ``load_state_dict(..., assign=True)``."""

    def __init__(self, block: Dict, d_visual: int):
        super().__init__()
        s = self.shape = LMShape.of(block)
        self.projector = Projector(d_visual, s)
        self.embed_tokens = nn.Embedding(s.vocab, s.hidden, dtype=s.dtype)
        self.layers = nn.ModuleList([Layer(s, i < s.dense_layers)
                                     for i in range(s.layers)])
        self.norm = RMSNorm(s.hidden, s.eps, s.dtype)
        self.lm_head = _linear(s.hidden, s.vocab, s.dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator,
                         std: float = 0.02) -> "LanguageModel":
        """The family's initialisation: every matrix N(0, std), the norms'
        weights 1, the projector's biases 0, the routers' score bias 0."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device) * std)
            elif leaf == "weight":
                p.fill_(1.0)
            else:
                p.zero_()
        return self

    def visual_tokens(self, encodings: List[torch.Tensor]) -> torch.Tensor:
        """The projector over the encodings (each (B, n, d_visual)), in
        order, then the start id: (B, sum n + 1, H)."""
        s, B = self.shape, encodings[0].shape[0]
        vis = self.projector(torch.cat(encodings, 1))
        start = self.embed_tokens.weight[s.start_id].expand(B, 1, s.hidden)
        return torch.cat([vis, start], 1)

    def logprobs(self, h: torch.Tensor) -> torch.Tensor:
        """f32 log-probabilities of the vocabulary after the final norm."""
        return torch.log_softmax(self.lm_head(self.norm(h)).float(), -1)

    def layer(self, i: int, x: torch.Tensor, attend) -> torch.Tensor:
        L = self.layers[i]
        with span("mla"):
            h = x + attend(L.self_attn, L.input_layernorm(x))
        shape = h.shape
        y = ffn(L, L.post_attention_layernorm(h).reshape(-1, shape[-1]),
                self.shape)
        return h + y.view(shape)

    def new_cache(self, B: int, T: int, device) -> torch.Tensor:
        """The latent cache of B rows of T positions, every layer:
        (layers, B, T, latent) in the model's dtype."""
        s = self.shape
        return torch.empty((s.layers, B, T, s.latent), dtype=s.dtype,
                           device=device)

    def prefill(self, x: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
        """Every layer over the sequences x (B, S, H), filling the cache;
        the last position's hidden state (B, H)."""
        for i in range(self.shape.layers):
            x = self.layer(i, x, lambda a, h: mla_prefill(
                a, h, cache[i], self.shape))
        return x[:, -1]

    def step(self, tokens: torch.Tensor, p: int, cache: torch.Tensor
             ) -> torch.Tensor:
        """One token a row (B,) at position ``p`` through the cache; its
        hidden state (B, H)."""
        x = self.embed_tokens(tokens)
        for i in range(self.shape.layers):
            x = self.layer(i, x, lambda a, h: mla_decode(
                a, h, cache[i], p, self.shape))
        return x

    @torch.no_grad()
    def greedy(self, encodings: List[torch.Tensor], L: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy captions of L words over the visual tokens: the prefill
        (span ``lm_prefill``) gives the first word, L - 1 steps through
        the latent cache (span ``lm_decode``) the rest.  Returns (seq (B,
        L) int32, the served words' log-probabilities (B, L) f32); id 0
        ends a row, whose later words and log-probabilities are 0."""
        x = self.visual_tokens(encodings)
        B, S, _ = x.shape
        cache = self.new_cache(B, S + L - 1, x.device)
        words, lps = [], []
        done = torch.zeros(B, dtype=torch.bool, device=x.device)

        def pick(h):
            nonlocal done
            lp = self.logprobs(h)
            w = lp.argmax(-1)
            served = lp.gather(-1, w[:, None])[:, 0]
            words.append(w.masked_fill(done, 0))
            lps.append(served.masked_fill(done, 0.0))
            done = done | (w == 0)

        with span("lm_prefill"):
            if recording():
                span_count(cache_bytes=cache.nbytes)
            pick(self.prefill(x, cache))
        del x
        with span("lm_decode"):
            for t in range(1, L):
                pick(self.step(words[-1], S + t - 1, cache))
        return torch.stack(words, 1).int(), torch.stack(lps, 1)
