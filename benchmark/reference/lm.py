"""Plain PyTorch reference of the "lm" captioner: a DeepSeek-V3 language
model (the block of Kimi-VL-A3B-Instruct's config.json) behind the
family's MLP projector, over GVD's frame and region encodings.

Written for the benchmark from the published description (DeepSeek-V3,
arXiv:2412.19437, and its modelling code's layer equations) and imports
nothing of the program under test. One full forward over the whole
sequence (the projected encodings, the start id, the words), with no
cache, no absorption of ``W_kvb`` and no grouped dispatch: each layer's
keys and values are expanded, the experts run in a loop over their
tokens. Every product goes through ``LMOps`` in float32 with TF32 off
(``"f32"``), or with both operands rounded to float8 e4m3 first
(``"fp8"``: the precision below the configuration's bfloat16, which the
benchmark's control uses; each row of an operand along the summed axis
scaled to the format's largest value, as fp8 is used). The weights stay
in their stored dtype and each layer is upcast to f32 when it runs.

Conventions shared with the program: RoPE rotates the pairs (x[2i],
x[2i+1]) by pos * theta^(-2i/d) and lays the result out de-interleaved
(the published ``apply_rotary_pos_emb``); the MoE picks the top k of
sigmoid(W_g x) + e_score_correction_bias and weights each pick by its
unbiased score over their sum times routed_scaling_factor; id 0 ends a
caption. Parameter names are the program's (``plan``), so one dict of
weights loads into both.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
LN_EPS = 1e-5           # the projector's LayerNorm


def plan(block: Dict, d_visual: int) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter of an lm block over visual
    tokens of width ``d_visual``; kind "normal" (a matrix), "ones" (a
    norm's weight), "zeros" (a bias) or "score_bias" (a router's
    e_score_correction_bias, float32)."""
    H, nH = block["hidden_size"], block["num_attention_heads"]
    nope, rope_d, v = (block["qk_nope_head_dim"], block["qk_rope_head_dim"],
                       block["v_head_dim"])
    r, E = block["kv_lora_rank"], block["n_routed_experts"]
    I = block["moe_intermediate_size"]
    P = block["projector_hidden_size"]
    out = [("projector.pre_norm.weight", (d_visual,), "ones"),
           ("projector.pre_norm.bias", (d_visual,), "zeros"),
           ("projector.linear_1.weight", (P, d_visual), "normal"),
           ("projector.linear_1.bias", (P,), "zeros"),
           ("projector.linear_2.weight", (H, P), "normal"),
           ("projector.linear_2.bias", (H,), "zeros"),
           ("embed_tokens.weight", (block["vocab_size"], H), "normal")]
    for i in range(block["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "input_layernorm.weight", (H,), "ones"),
                (p + "self_attn.q_proj.weight", (nH * (nope + rope_d), H),
                 "normal"),
                (p + "self_attn.kv_a_proj_with_mqa.weight", (r + rope_d, H),
                 "normal"),
                (p + "self_attn.kv_a_layernorm.weight", (r,), "ones"),
                (p + "self_attn.kv_b_proj.weight", (nH * (nope + v), r),
                 "normal"),
                (p + "self_attn.o_proj.weight", (H, nH * v), "normal"),
                (p + "post_attention_layernorm.weight", (H,), "ones")]
        if i < block["first_k_dense_replace"]:
            W = block["intermediate_size"]
            out += [(p + "mlp.gate_up_proj", (2 * W, H), "normal"),
                    (p + "mlp.down_proj", (H, W), "normal")]
        else:
            S = block["n_shared_experts"] * I
            out += [(p + "mlp.gate.weight", (E, H), "normal"),
                    (p + "mlp.gate.e_score_correction_bias", (E,),
                     "score_bias"),
                    (p + "mlp.experts.gate_up_proj", (E, 2 * I, H), "normal"),
                    (p + "mlp.experts.down_proj", (E, H, I), "normal"),
                    (p + "mlp.shared_experts.gate_up_proj", (2 * S, H),
                     "normal"),
                    (p + "mlp.shared_experts.down_proj", (H, S), "normal")]
    out += [("norm.weight", (H,), "ones"),
            ("lm_head.weight", (block["vocab_size"], H), "normal")]
    return out


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 (to nearest), each row along ``dim``
    scaled so that its largest magnitude is the format's largest value,
    returned in f32 at x's scale."""
    x = x.float()
    s = x.abs().amax(dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    y = (x / s).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return y.float() * s


class LMOps:
    """The reference's products in one precision: ``"f32"`` (TF32 off)
    or ``"fp8"`` (both operands rounded to e4m3 along the summed axis,
    the sum in f32)."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b (broadcasting batch dimensions)."""
        if self.fp8:
            a, b = fp8_round(a, -1), fp8_round(b, -2)
        return torch.matmul(a, b)

    def lin(self, x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.mm(x, w.t())
        return y if b is None else y + b


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE on x's last axis (width d) at ``pos`` (x's leading axes but
    the last, broadcast): pair i = (x[2i], x[2i+1]) turned by pos *
    theta^(-2i/d); out[i] and out[i + d/2] are the pair's two members."""
    d = x.shape[-1]
    even, odd = x[..., 0::2], x[..., 1::2]
    ang = pos.float()[..., None] * theta ** (
        -torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    return torch.cat([even * ang.cos() - odd * ang.sin(),
                      odd * ang.cos() + even * ang.sin()], -1)


def swiglu(ops: LMOps, x: torch.Tensor, gate_up: torch.Tensor,
           down: torch.Tensor) -> torch.Tensor:
    g, u = ops.lin(x, gate_up).chunk(2, dim=-1)
    return ops.lin(F.silu(g) * u, down)


class LMReference:
    """The lm block's model over ``weights`` (the names of ``plan``, in
    their stored dtype, on one device)."""

    def __init__(self, block: Dict, weights: Dict[str, torch.Tensor]):
        self.b = block
        self.w = weights

    def _layer(self, i: int) -> Dict[str, torch.Tensor]:
        p = f"layers.{i}."
        return {k[len(p):]: v.float() for k, v in self.w.items()
                if k.startswith(p)}

    def _f32(self, name: str) -> torch.Tensor:
        return self.w[name].float()

    def attention(self, ops: LMOps, W: Dict, x: torch.Tensor
                  ) -> torch.Tensor:
        """Causal MLA over whole sequences x (B, S, H), keys and values
        expanded per head."""
        b = self.b
        B, S, _ = x.shape
        nH, nope, rd = (b["num_attention_heads"], b["qk_nope_head_dim"],
                        b["qk_rope_head_dim"])
        r, v = b["kv_lora_rank"], b["v_head_dim"]
        pos = torch.arange(S, device=x.device)
        q = ops.lin(x, W["self_attn.q_proj.weight"]).view(B, S, nH,
                                                          nope + rd)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], pos[:, None],
                                           b["rope_theta"])], -1)
        kva = ops.lin(x, W["self_attn.kv_a_proj_with_mqa.weight"])
        c = rms_norm(kva[..., :r], W["self_attn.kv_a_layernorm.weight"],
                     b["rms_norm_eps"])
        k_pe = rope(kva[..., r:], pos, b["rope_theta"])
        kv = ops.lin(c, W["self_attn.kv_b_proj.weight"]).view(B, S, nH,
                                                              nope + v)
        k = torch.cat([kv[..., :nope],
                       k_pe[:, :, None].expand(B, S, nH, rd)], -1)
        scores = ops.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) \
            / math.sqrt(nope + rd)                          # (B, nH, S, S)
        causal = torch.ones(S, S, dtype=torch.bool,
                            device=x.device).triu(1)
        probs = torch.softmax(scores.masked_fill(causal, -math.inf), -1)
        o = ops.mm(probs, kv[..., nope:].transpose(1, 2))   # (B, nH, S, v)
        return ops.lin(o.transpose(1, 2).reshape(B, S, nH * v),
                       W["self_attn.o_proj.weight"])

    def moe(self, ops: LMOps, W: Dict, x: torch.Tensor,
            top_k: int) -> torch.Tensor:
        """The routed experts, each over the tokens that picked it, and the
        shared experts, on tokens x (N, H)."""
        b = self.b
        s = torch.sigmoid(ops.lin(x, W["mlp.gate.weight"]))
        top = (s + W["mlp.gate.e_score_correction_bias"]).topk(
            top_k, dim=-1).indices
        w = s.gather(-1, top)
        w = w / (w.sum(-1, keepdim=True) + 1e-20) \
            * b["routed_scaling_factor"]
        out = swiglu(ops, x, W["mlp.shared_experts.gate_up_proj"],
                     W["mlp.shared_experts.down_proj"])
        for e in range(b["n_routed_experts"]):
            tok, j = (top == e).nonzero(as_tuple=True)
            if len(tok):
                y = swiglu(ops, x[tok], W["mlp.experts.gate_up_proj"][e],
                           W["mlp.experts.down_proj"][e])
                out.index_add_(0, tok, y * w[tok, j, None])
        return out

    def logits(self, ops: LMOps, visual: torch.Tensor, words: torch.Tensor,
               top_k: Optional[int] = None) -> torch.Tensor:
        """Teacher-forced logits (B, n + 1, V) f32 over [projected visual
        tokens (B, S0, d_visual), the start id, words (B, n)]: at the start
        id and at each word, what the next word is."""
        b = self.b
        eps = b["rms_norm_eps"]
        top_k = top_k or b["num_experts_per_tok"]
        emb = self.w["embed_tokens.weight"]
        proj = F.layer_norm(visual.float(), (visual.shape[-1],),
                            self._f32("projector.pre_norm.weight"),
                            self._f32("projector.pre_norm.bias"), LN_EPS)
        proj = ops.lin(F.gelu(ops.lin(
            proj, self._f32("projector.linear_1.weight"),
            self._f32("projector.linear_1.bias"))),
            self._f32("projector.linear_2.weight"),
            self._f32("projector.linear_2.bias"))
        B, S0 = visual.shape[:2]
        start = torch.full((B, 1), b["start_id"], dtype=torch.long,
                           device=visual.device)
        x = torch.cat([proj, emb[torch.cat([start, words.long()], 1)]
                       .float()], 1)
        for i in range(b["num_hidden_layers"]):
            W = self._layer(i)
            h = x + self.attention(ops, W, rms_norm(
                x, W["input_layernorm.weight"], eps))
            n = rms_norm(h, W["post_attention_layernorm.weight"], eps)
            if i < b["first_k_dense_replace"]:
                f = swiglu(ops, n, W["mlp.gate_up_proj"], W["mlp.down_proj"])
            else:
                f = self.moe(ops, W, n.reshape(-1, n.shape[-1]),
                             top_k).view(n.shape)
            x = h + f
            del W
        last = rms_norm(x[:, S0:], self._f32("norm.weight"), eps)
        return ops.lin(last, self._f32("lm_head.weight"))


def served_positions(seq: torch.Tensor) -> torch.Tensor:
    """The positions of a caption up to and with its first end word (id
    0): those a caption serves."""
    ended = (seq == 0).long().cumsum(1)
    return (ended == 0) | ((ended == 1) & (seq == 0))


def control_outputs(logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """What a model with these teacher-forced logits serves in the
    program's place: its argmax at each position and its
    log-probability."""
    lp = torch.log_softmax(logits.float(), -1)
    w = lp.argmax(-1)
    return {"seq": w.int(), "logprobs": lp.gather(-1, w[..., None])[..., 0]}


def position_errors(logits: torch.Tensor, seq: torch.Tensor,
                    logprobs: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """At every served position of ``seq`` (B, L) (``served_positions``),
    against the reference's teacher-forced ``logits`` (B, L, V) on it:
    |the served log-probability ``logprobs`` - the reference's|, and the
    reference's top logit less its logit at the served word."""
    seq = seq.long()
    lg = logits.float()
    lp = torch.log_softmax(lg, -1).gather(-1, seq[..., None])[..., 0]
    at = lg.gather(-1, seq[..., None])[..., 0]
    valid = served_positions(seq)
    return ((logprobs.float() - lp).abs()[valid],
            (lg.max(-1).values - at)[valid])


def statistic(values: torch.Tensor, quantile: Optional[float]) -> float:
    """The largest of ``values`` (quantile None), or their quantile."""
    v = values.double()
    return float(v.max() if quantile is None else v.quantile(quantile))
