"""Plain PyTorch reference of the Grounded-Video-Description model at
inference: the encode path, the TopDown core, greedy and beam decoding,
and the Masked-Transformer decoder.

Written for the benchmark from the model's published description
(Zhou et al., CVPR 2019, arXiv:1812.06587, and the reference code's
misc/model.py, misc/AttModel.py, misc/transformer.py,
misc/CaptionModelBU.py) and imports nothing of the program under test.
Parameter names follow the reference code's state dict, so one dict of
weights, drawn by the benchmark, loads into the program and into this
model alike.

Every product goes through ``Ops``, which computes it in float32
(``"f32"``, with TF32 switched off) or with both operands rounded to
TF32 first (``"tf32"``: the precision one step below float32, which
the benchmark's control uses). Departures from the reference code: the
LSTM cells keep one bias trained (``bias_hh`` stays zero), beam search
shares nothing between items and has no ROI re-use ban (the logit head
emits only word indices, so the ban never fires).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

MIN_VALUE = -1e8        # masked scores (model.py)
INF = 1e10              # the transformer's causal mask (transformer.py:100)
LN_EPS = 1e-6           # the transformer's LayerNorm (transformer.py:66)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest, ties to even."""
    i = x.float().contiguous().view(torch.int32)
    r = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32)


class _Rounded(torch.autograd.Function):
    """x rounded to TF32; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _GradRounded(torch.autograd.Function):
    """x as it is; its gradient rounded to TF32."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)


class Ops:
    """The products of the reference in one precision. In ``"tf32"``
    every product, forward and backward, takes its operands rounded to
    TF32 and sums in f32, as the tensor cores' TF32 route does."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tf32 = precision == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b (broadcasting batch dimensions)."""
        if not self.tf32:
            return torch.matmul(a, b)
        return _GradRounded.apply(torch.matmul(_Rounded.apply(a),
                                               _Rounded.apply(b)))

    def lin(self, x: torch.Tensor, m: nn.Linear) -> torch.Tensor:
        y = self.mm(x, m.weight.t())
        return y if m.bias is None else y + m.bias


def layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free LayerNorm (biased variance)."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def layer_norm_std(ln: "LayerNormParams", x: torch.Tensor) -> torch.Tensor:
    """The transformer's LayerNorm: (x - mean) / (unbiased std + eps)."""
    mean = x.mean(-1, keepdim=True)
    return ln.gamma * (x - mean) / (x.std(-1, keepdim=True) + LN_EPS) \
        + ln.beta


def seq1(m: nn.Module) -> nn.Sequential:
    return nn.Sequential(m)


class LSTMCell(nn.Module):
    """Gates i, f, g, o (torch order)."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_dim))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_ih = nn.Parameter(torch.empty(4 * hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden),
                                    requires_grad=False)

    def forward(self, ops: Ops, x, h, c):
        gates = (ops.mm(x, self.weight_ih.t()) + ops.mm(h, self.weight_hh.t())
                 + self.bias_ih + self.bias_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c


class BiGRU(nn.Module):
    """A stacked bidirectional GRU under nn.GRU's parameter names (gates
    r, z, n)."""

    def __init__(self, in_dim: int, hidden: int, layers: int):
        super().__init__()
        self.hidden, self.layers = hidden, layers
        d = in_dim
        for li in range(layers):
            for sfx in ("", "_reverse"):
                for name, shape in (("weight_ih", (3 * hidden, d)),
                                    ("weight_hh", (3 * hidden, hidden)),
                                    ("bias_ih", (3 * hidden,)),
                                    ("bias_hh", (3 * hidden,))):
                    self.register_parameter(f"{name}_l{li}{sfx}",
                                            nn.Parameter(torch.empty(shape)))
            d = 2 * hidden

    def _direction(self, ops: Ops, x, li: int, sfx: str):
        p = lambda n: getattr(self, f"{n}_l{li}{sfx}")   # noqa: E731
        gi = ops.mm(x, p("weight_ih").t()) + p("bias_ih")      # (B, T, 3H)
        if sfx:
            gi = gi.flip(1)
        h = x.new_zeros(x.shape[0], self.hidden)
        out = []
        for t in range(x.shape[1]):
            gh = ops.mm(h, p("weight_hh").t()) + p("bias_hh")
            ir, iz, inn = gi[:, t].chunk(3, dim=-1)
            hr, hz, hn = gh.chunk(3, dim=-1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            n = torch.tanh(inn + r * hn)
            h = (1 - z) * n + z * h
            out.append(h)
        out = torch.stack(out, dim=1)
        return out.flip(1) if sfx else out

    def forward(self, ops: Ops, x, between=None):
        """``between``, where given, maps the output of each layer but the
        last (dropout in training)."""
        for li in range(self.layers):
            x = torch.cat([self._direction(ops, x, li, ""),
                           self._direction(ops, x, li, "_reverse")], dim=-1)
            if between is not None and li < self.layers - 1:
                x = between(x)
        return x


class LayerNormParams(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))


class MultiHead(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, nn.Linear(d, d, bias=False))


class FeedForward(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Linear(d, hidden)
        self.linear2 = nn.Linear(hidden, d)


class Residual(nn.Module):
    def __init__(self, layer: nn.Module, d: int):
        super().__init__()
        self.layer = layer
        self.layernorm = LayerNormParams(d)


def attention_heads(ops: Ops, p: MultiHead, q_in, kv_in, n_heads: int,
                    causal: bool = False, probs=None):
    """Multi-head attention with the reference's uneven head chunks
    (torch.chunk: 1024 over 6 heads is 171 x 5 + 169) and one score scale
    sqrt(d_model) for every head; the causal mask subtracts INF above the
    diagonal before the scale. ``probs(p, head)``, where given, maps each
    head's probabilities (dropout in training)."""
    d = q_in.shape[-1]
    q, k, v = ops.lin(q_in, p.wq), ops.lin(kv_in, p.wk), ops.lin(kv_in, p.wv)
    heads = []
    for h, (qh, kh, vh) in enumerate(zip(q.chunk(n_heads, -1),
                                         k.chunk(n_heads, -1),
                                         v.chunk(n_heads, -1))):
        s = ops.mm(qh, kh.transpose(-1, -2))
        if causal:
            s = s - torch.full(s.shape[-2:], INF, device=s.device).triu(1)
        w = torch.softmax(s / math.sqrt(d), dim=-1)
        heads.append(ops.mm(w if probs is None else probs(w, h), vh))
    return ops.lin(torch.cat(heads, dim=-1), p.wo)


class EncoderLayer(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.selfattn = Residual(MultiHead(d), d)
        self.feedforward = Residual(FeedForward(d, hidden), d)

    def forward(self, ops: Ops, x, n_heads: int):
        x = layer_norm_std(self.selfattn.layernorm,
                           x + attention_heads(ops, self.selfattn.layer, x,
                                               x, n_heads))
        ff = self.feedforward.layer
        f = ops.lin(F.relu(ops.lin(x, ff.linear1)), ff.linear2)
        return layer_norm_std(self.feedforward.layernorm, x + f)


class Encoder(nn.Module):
    def __init__(self, d: int, hidden: int, layers: int):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(d, hidden)
                                    for _ in range(layers))


class ObjInteract(nn.Module):
    def __init__(self, d: int, hidden: int, layers: int):
        super().__init__()
        self.encoder = Encoder(d, hidden, layers)


class DecoderLayer(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.selfattn = Residual(MultiHead(d), d)
        self.attention = Residual(MultiHead(d), d)
        self.feedforward = Residual(FeedForward(d, hidden), d)


class Decoder(nn.Module):
    def __init__(self, d: int, hidden: int, vocab: int, layers: int):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(d, hidden)
                                    for _ in range(layers))
        self.out = nn.Linear(d, vocab)


class CapModel(nn.Module):
    def __init__(self, d: int, hidden: int, vocab: int, layers: int):
        super().__init__()
        self.decoder = Decoder(d, hidden, vocab, layers)


def positions(T: int, d: int, device) -> torch.Tensor:
    """Sinusoidal positions: channel c of position p is sin (c even) or
    cos (c odd) of p / 10000^(2 floor(c / 2) / d)."""
    pos = torch.arange(T, dtype=torch.float64)[:, None]
    c = torch.arange(d, dtype=torch.float64)[None, :]
    angle = pos / torch.pow(10000.0, (c - c % 2) / d)
    enc = torch.where(c % 2 == 0, torch.sin(angle), torch.cos(angle))
    return enc.float().to(device)


class Attn(nn.Module):
    def __init__(self, rnn: int, hid: int):
        super().__init__()
        self.h2att = nn.Linear(rnn, hid)
        self.alpha_net = nn.Linear(hid, 1)


class Core(nn.Module):
    def __init__(self, m: Dict):
        super().__init__()
        rnn, hid = m["rnn_size"], m["att_hid_size"]
        self.att_lstm = LSTMCell(m["input_encoding_size"] + rnn, rnn)
        self.lang_lstm = LSTMCell(2 * rnn, rnn)
        self.attention = Attn(rnn, hid)
        self.attention2 = Attn(rnn, hid)


class GVDReference(nn.Module):
    """The model of a configuration's ``model`` block (its field names):
    ``transfer_mode`` cls, ``region_attn_mode`` mix, ``att_input_mode``
    both, a BiGRU temporal encoder, obj_interact, and the TopDown or the
    Masked-Transformer captioner."""

    def __init__(self, m: Dict):
        super().__init__()
        for key, want in (("transfer_mode", "cls"), ("region_attn_mode", "mix"),
                          ("att_input_mode", "both"), ("t_attn_mode", "bigru"),
                          ("obj_interact", True), ("enable_BUTD", False)):
            if m.get(key, want) != want:
                raise ValueError(f"the reference models {key} {want!r} only")
        self.m = m
        rnn, C = m["rnn_size"], m["detect_size"]
        vis = m["att_feat_size"]
        self.loc_fc = seq1(nn.Linear(5, m["loc_encoding_size"]))
        self.embed = seq1(nn.Embedding(m["vocab_size"],
                                       m["input_encoding_size"]))
        self.vis_embed = seq1(nn.Embedding(C + 1, vis))
        self.fc_embed = seq1(nn.Linear(m["fc_feat_size"] + m["seg_info_size"],
                                       rnn))
        self.seg_info_embed = seq1(nn.Linear(4, m["seg_info_size"]))
        self.att_embed = nn.ModuleList([
            seq1(nn.Linear(m["rgb_feat_size"], rnn // 2)),
            seq1(nn.Linear(m["motion_feat_size"], rnn // 2))])
        self.att_embed_aux = seq1(nn.BatchNorm1d(rnn))
        self.pool_embed = seq1(nn.Linear(
            vis + m["loc_encoding_size"] + C + 1, rnn))
        self.ctx2att = nn.Linear(rnn, m["att_hid_size"])
        self.ctx2pool = nn.Linear(rnn, m["att_hid_size"])
        self.logit = nn.Linear(rnn, m["vocab_size"])
        self.ctx2pool_grd = seq1(nn.Linear(vis, vis))
        self.context_enc = BiGRU(rnn, rnn // 2, 2)
        self.vis_classifiers_bias = nn.Parameter(torch.zeros(C + 1))
        self.core = Core(m)
        self.obj_interact = ObjInteract(rnn, rnn // 2, 2)
        if m["att_model"] == "transformer":
            self.cap_model = CapModel(rnn, rnn // 2, m["vocab_size"], 2)
        self.unk = m["vocab_size"] - 1

    # ---------------------------------------------------------------- #

    def encode(self, ops: Ops, b: Dict[str, torch.Tensor]) -> Dict:
        """The attention banks of a batch at inference (model.py:302-409)."""
        m = self.m
        seg, ppls = b["seg_feat"].float(), b["ppls"].float()
        pnt = b["pnt_mask"].bool()[:, 1:]                       # (B, R)
        fc = torch.cat([layer_norm(seg.mean(1)), layer_norm(F.relu(
            ops.lin(b["num"].float()[:, 3:7], self.seg_info_embed[0])))], -1)
        g_pool = F.relu(ops.lin(b["ppls_feat"].float(), self.ctx2pool_grd[0]))
        words = F.relu(self.vis_embed[0].weight)                 # (C+1, E)
        sim = ops.mm(words, g_pool.transpose(1, 2)) \
            + self.vis_classifiers_bias[None, :, None]           # (B, C+1, R)
        sim = torch.softmax(sim.masked_fill(pnt[:, None], MIN_VALUE), dim=1)
        loc = F.relu(ops.lin(torch.cat([ppls[..., :4] / 720.0,
                                        ppls[..., 4:5] / m["num_sampled_frm"]],
                                       -1), self.loc_fc[0]))
        pool = F.relu(ops.lin(torch.cat(
            [layer_norm(g_pool), layer_norm(loc),
             layer_norm(sim.transpose(1, 2))], -1), self.pool_embed[0]))
        for layer in self.obj_interact.encoder.layers:
            pool = layer(ops, pool, 6)
        rgb = seg[..., :m["rgb_feat_size"]]
        motion = seg[..., m["rgb_feat_size"]:]
        conv = torch.cat([F.relu(ops.lin(rgb, self.att_embed[0][0])),
                          F.relu(ops.lin(motion, self.att_embed[1][0]))], -1)
        bn = self.att_embed_aux[0]
        conv = (conv - bn.running_mean) / torch.sqrt(bn.running_var + 1e-5) \
            * bn.weight + bn.bias
        conv = self.context_enc(ops, F.relu(conv))
        t = torch.arange(conv.shape[1], device=conv.device)[None]
        idx = b["sample_idx"].long()
        inside = (t >= idx[:, :1]) & (t < idx[:, 1:2])
        conv = conv * inside[..., None]
        return {"fc": F.relu(ops.lin(fc, self.fc_embed[0])), "conv": conv,
                "p_conv": ops.lin(conv, self.ctx2att), "pool": pool,
                "p_pool": ops.lin(pool, self.ctx2pool), "mask": pnt,
                "sim_mat": sim}

    def core_step(self, ops: Ops, enc: Dict, x: torch.Tensor, state,
                  att_mask: torch.Tensor, pnt_mask: torch.Tensor):
        """One TopDown core step (AttModel.py:134-164) on the embedded word
        ``x``: the language LSTM's output, the region scores (the softmax
        masked by ``att_mask``, the returned scores by ``pnt_mask`` too)
        and the new state. The banks of ``enc`` may hold one row per state
        row or fewer, each shared by ``rows // len(bank)`` consecutive
        state rows."""
        core = self.core
        h_att, c_att, h_lang, c_lang = state
        W = x.shape[0] // enc["fc"].shape[0]
        rep = (lambda t: t.repeat_interleave(W, 0)) if W > 1 else \
            (lambda t: t)
        h_att, c_att = core.att_lstm(ops, torch.cat([rep(enc["fc"]), x], -1),
                                     h_att, c_att)
        a = core.attention
        s = ops.lin(torch.tanh(rep(enc["p_conv"])
                               + ops.lin(h_att, a.h2att)[:, None]),
                    a.alpha_net)[..., 0]
        att = ops.mm(torch.softmax(s, 1)[:, None], rep(enc["conv"]))[:, 0]
        a = core.attention2
        s = ops.lin(torch.tanh(rep(enc["p_pool"])
                               + ops.lin(h_att, a.h2att)[:, None]),
                    a.alpha_net)[..., 0]
        s = s.masked_fill(rep(att_mask), MIN_VALUE)
        att2 = ops.mm(torch.softmax(s, 1)[:, None], rep(enc["pool"]))[:, 0]
        h_lang, c_lang = core.lang_lstm(ops, torch.cat([att + att2, h_att], -1),
                                        h_lang, c_lang)
        return h_lang, s.masked_fill(rep(pnt_mask), MIN_VALUE), \
            (h_att, c_att, h_lang, c_lang)

    def step(self, ops: Ops, enc: Dict, tok: torch.Tensor, state):
        """One step at inference from word ``tok``: the vocab
        log-probabilities, the pnt-masked region scores and the new
        state."""
        x = F.relu(self.embed[0].weight[tok])
        h_lang, s, state = self.core_step(ops, enc, x, state, enc["mask"],
                                          enc["mask"])
        return torch.log_softmax(ops.lin(h_lang, self.logit), dim=-1), s, \
            state

    def zero_state(self, rows: int, device):
        z = torch.zeros(rows, self.m["rnn_size"], device=device)
        return (z, z, z, z)

    def teacher_forced(self, ops: Ops, enc: Dict, seq: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The log-probabilities (B, L, V) and region scores (B, L, R) of
        each step when word t - 1 of ``seq`` (BOS = 0 at t = 0) is fed."""
        B, L = seq.shape
        state = self.zero_state(B, seq.device)
        tok = torch.zeros(B, dtype=torch.long, device=seq.device)
        lps, scores = [], []
        for t in range(L):
            lp, s, state = self.step(ops, enc, tok, state)
            lps.append(lp)
            scores.append(s)
            tok = seq[:, t].long()
        return torch.stack(lps, 1), torch.stack(scores, 1)

    def greedy(self, ops: Ops, enc: Dict, L: int) -> Dict:
        """UNK-suppressed greedy decode for every one of L steps
        (model.py:589-594): the program's outputs."""
        B = enc["fc"].shape[0]
        dev = enc["fc"].device
        state = self.zero_state(B, dev)
        tok = torch.zeros(B, dtype=torch.long, device=dev)
        seq, lps, scores = [], [], []
        for _ in range(L):
            lp, s, state = self.step(ops, enc, tok, state)
            tok = lp.masked_fill(self._unk_column(lp), -math.inf).argmax(-1)
            seq.append(tok)
            lps.append(lp.gather(1, tok[:, None])[:, 0])
            scores.append(s)
        return {"seq": torch.stack(seq, 1), "logprobs": torch.stack(lps, 1),
                "att2_weights": torch.stack(scores, 1),
                "sim_mat": enc["sim_mat"]}

    def _unk_column(self, lp: torch.Tensor) -> torch.Tensor:
        return torch.arange(lp.shape[-1], device=lp.device) == self.unk

    def beam(self, ops: Ops, enc: Dict, L: int, W: int) -> Dict:
        """Beam search of width W (CaptionModelBU.py:24-185): each step
        every live beam forks by cumulative log-probability into the W
        best (beam, word) pairs of its item; a beam ends at EOS (word 0)
        or at the last step, and its item keeps the best ended beam.
        Returns the program's outputs: the kept beam's words, each word's
        own log-probability, the argmax proposal of each step's region
        scores and its argmax in every frame."""
        m = self.m
        B = enc["fc"].shape[0]
        dev = enc["fc"].device
        nf, ppf = m["num_sampled_frm"], m["num_prop_per_frm"]
        V = m["vocab_size"]
        state = self.zero_state(B * W, dev)
        tok = torch.zeros(B * W, dtype=torch.long, device=dev)
        words = torch.zeros(B, W, 0, dtype=torch.long, device=dev)
        wlps = torch.zeros(B, W, 0, device=dev)
        R = nf * ppf
        scores = torch.zeros(B, W, 0, R, device=dev)
        cum = torch.zeros(B, W, device=dev)
        best = torch.full((B,), -math.inf, device=dev)
        out_seq = torch.zeros(B, L, dtype=torch.long, device=dev)
        out_lp = torch.zeros(B, L, device=dev)
        out_sc = torch.zeros(B, L, R, device=dev)
        rows = torch.arange(B, device=dev)
        for t in range(L):
            lp, s, state = self.step(ops, enc, tok, state)
            lp, s = lp.view(B, W, V), s.view(B, W, -1)
            total = cum[:, :, None] + lp
            if t == 0:
                total[:, 1:] = -math.inf
            cand, flat = total.view(B, -1).sort(dim=1, descending=True,
                                                stable=True)
            cand, flat = cand[:, :W], flat[:, :W]
            parent, word = flat // V, flat % V
            pick = lambda x: x[rows[:, None], parent]   # noqa: E731
            words = torch.cat([pick(words), word[..., None]], 2)
            wlps = torch.cat([pick(wlps), lp.view(B, -1).gather(1, flat)
                              [..., None]], 2)
            scores = torch.cat([pick(scores), pick(s)[:, :, None]], 2)
            done = (word == 0) if t < L - 1 else torch.ones_like(
                word, dtype=torch.bool)
            fin = torch.where(done, cand, -math.inf)
            w_best = fin.argmax(1)
            better = fin[rows, w_best] > best
            best = torch.where(better, fin[rows, w_best], best)
            n = t + 1
            out_seq[:, :n] = torch.where(better[:, None], words[rows, w_best],
                                         out_seq[:, :n])
            out_seq[:, n:] = torch.where(better[:, None], 0, out_seq[:, n:])
            out_lp[:, :n] = torch.where(better[:, None], wlps[rows, w_best],
                                        out_lp[:, :n])
            out_lp[:, n:] = torch.where(better[:, None], 0.0, out_lp[:, n:])
            out_sc[:, :n] = torch.where(better[:, None, None],
                                        scores[rows, w_best], out_sc[:, :n])
            cum = torch.where(done, -1000.0, cand)
            h = [x.view(B, W, -1)[rows[:, None], parent].view(B * W, -1)
                 for x in state]
            state = tuple(h)
            tok = word.reshape(-1)
        return {"seq": out_seq, "logprobs": out_lp,
                "att2_ind": out_sc.argmax(-1),
                "att2_frm_ind": out_sc.view(B, L, nf, ppf).argmax(-1)}

    # ---------------------------------------------------------------- #

    def transformer_logits(self, ops: Ops, enc: Dict, seq: torch.Tensor
                           ) -> torch.Tensor:
        """The decoder's logits (B, L, V) at each position when word t - 1
        of ``seq`` (BOS = 0 at t = 0) is fed (transformer.py:177-241):
        layer 0 cross-attends the frame encoding, layer 1 the regions'."""
        dec = self.cap_model.decoder
        d = enc["pool"].shape[-1]
        B, L = seq.shape
        tokens = torch.cat([seq.new_zeros(B, 1), seq[:, :-1]], 1).long()
        x = dec.out.weight[tokens] * math.sqrt(d) \
            + positions(L, d, seq.device)[None]
        for layer, mem in zip(dec.layers, (enc["conv"], enc["pool"])):
            x = layer_norm_std(layer.selfattn.layernorm, x + attention_heads(
                ops, layer.selfattn.layer, x, x, 6, causal=True))
            x = layer_norm_std(layer.attention.layernorm, x + attention_heads(
                ops, layer.attention.layer, x, mem, 6))
            ff = layer.feedforward.layer
            x = layer_norm_std(layer.feedforward.layernorm, x + ops.lin(
                F.relu(ops.lin(x, ff.linear1)), ff.linear2))
        return ops.lin(x, dec.out)

    def transformer_greedy(self, ops: Ops, enc: Dict, L: int) -> Dict:
        """Argmax decoding, word by word, each step a whole causal pass
        over the words so far: the program's outputs (its zero
        log-probabilities and region scores are not compared)."""
        B = enc["fc"].shape[0]
        seq = torch.zeros(B, L, dtype=torch.long, device=enc["fc"].device)
        for t in range(L):
            seq[:, t] = self.transformer_logits(ops, enc, seq[:, :t + 1])[
                :, t].argmax(-1)
        return {"seq": seq, "sim_mat": enc["sim_mat"]}


PARAM_KINDS = (
    # (module type, {parameter: kind}); kind "fan_in" draws U(+-1/sqrt(the
    # weight's fan-in)), "hidden" U(+-1/sqrt(hidden)), "normal" N(0, 1)
    (nn.Linear, {"weight": "fan_in", "bias": "fan_in"}),
    (nn.Embedding, {"weight": "normal"}),
    (LSTMCell, {"weight_ih": "hidden", "weight_hh": "hidden",
                "bias_ih": "hidden", "bias_hh": "zeros"}),
    (BiGRU, {"*": "hidden"}),
    (LayerNormParams, {"gamma": "ones", "beta": "zeros"}),
    (nn.BatchNorm1d, {"weight": "ones", "bias": "zeros"}),
    (GVDReference, {"vis_classifiers_bias": "zeros"}),
)


def parameter_plan(model: nn.Module):
    """(name, shape, dtype, kind, bound) of every parameter and buffer:
    the distributions the model's own initialisation uses."""
    plan = []
    for prefix, mod in model.named_modules():
        kinds = next((k for t, k in PARAM_KINDS if type(mod) is t), {})
        for name, p in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            full = f"{prefix}.{name}" if prefix else name
            kind = kinds.get(name, kinds.get("*"))
            if isinstance(mod, nn.BatchNorm1d) and kind is None:
                kind = {"running_var": "ones"}.get(name, "zeros")
            if kind is None:
                raise ValueError(f"no initialisation for {full}")
            if kind == "fan_in":
                bound = 1.0 / math.sqrt(mod.weight.shape[1])
            elif kind == "hidden":
                bound = 1.0 / math.sqrt(mod.weight_hh.shape[1]
                                        if isinstance(mod, LSTMCell)
                                        else mod.hidden)
            else:
                bound = 0.0
            plan.append((full, tuple(p.shape), p.dtype, kind, bound))
    return plan
