"""K6: the whole greedy caption decode, one kernel launch.

Replaces ``grounded_video_description_tpu/ops/pallas/decode_scan.py
::greedy_decode_fused``.  The CUDA source is ``csrc/decode_scan.cu``: a
persistent cooperative kernel that runs every step (both LSTM cells, the
temporal and region attentions, the vocab log-softmax, the UNK-suppressed
pick and the next token's embedding) with grid-wide barriers between its
phases.  The TPU kernel kept each batch tile's banks in VMEM across the
steps; on the card they stream from device memory every step, and what
the kernel removes is the step loop's host launches (see the source).
Its four products (both LSTMs' gates, h2att, the vocab logits) run on the
tensor cores (f32 in 3xTF32; bf16 weights times the state as the JAX K6
takes it, ``STATE_WHOLE``), split over K so that their items fill the
grid: ``decode_scan_plan`` chooses the splits, the grid and the shared
memory.

``greedy_decode_fused_plain`` is the port's step loop, the one
``GVDModel.sample_greedy`` runs without K6 (K3 inside it where the model's
``use_pallas`` asks for it).  CPU tensors take it, and it is the reference
on the card.  Both return (seq (B, L) int32, logprobs (B, L) f32, att2
(B, L, R) in the model's compute dtype: the pnt-masked region logits of
each step).

The kernel applies where the JAX package's does: ``att_input_mode`` both
and ``region_attn_mode`` add or mix (``GVDModel.sample_greedy`` checks).
The TPU kernel also needed a batch that its tile of 4 divides; this one
takes any batch size.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from grounded_video_description_torch.ops import MIN_VALUE
from grounded_video_description_torch.ops.kernels import _build


# csrc/decode_scan.cu: the GEMM phases' item (output columns x batch
# rows), chunk depth and cp.async stages; a block's reduction words
# before the phase scratch; the sum phase's row groups and columns; the
# barriers a step
NC, RT, KC, STAGES = 128, 128, 32, 3
HEAD_WORDS = 64
NG, DCH = 4, 256
PHASES = 10
# an H100 SM's shared memory, and what the runtime keeps per block
SM_SMEM, BLOCK_RESERVED = 233472, 1024
# bf16, per GEMM phase and operand segment: whether the f32 state enters
# whole, as two bf16 terms hi + lo (the recurrent h of both LSTMs, which the
# JAX K6 dots from its f32 scratch against the bf16 W_hh), or rounded to
# bf16 once (the rest, which it casts to bf16 before the dot); csrc
# ``recurrent``: the last segment of a phase of several
STATE_WHOLE = {"att_lstm": (False, True), "h2att": (False,),
               "lang_lstm": (False, False, True), "logit": (False,)}
# route counts beside ``decode_scan``'s own, by dtype: the GEMM phases
GEMM_ROUTES = {torch.float32: "decode_scan_tf32x3",
               torch.bfloat16: "decode_scan_mma"}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


class GemmPhasePlan(NamedTuple):
    """One GEMM phase: out (B, n) = x W^T over segments of depth ``ks``,
    in ``splits`` contiguous runs of the phase's 32-deep chunks."""
    name: str
    n: int
    ks: Tuple[int, ...]
    col_tiles: int
    row_tiles: int
    chunks: int
    splits: int

    @property
    def items(self) -> int:
        return self.col_tiles * self.row_tiles * self.splits

    def item(self, it: int) -> Tuple[int, int, int, range]:
        """(n0, r0, z, chunks) of item ``it``: columns n0.. n0 + NC, rows
        r0.. r0 + RT, split z, and the run of chunks it walks, in order
        (csrc item_of)."""
        unit, z = divmod(it, self.splits)
        return ((unit % self.col_tiles) * NC, (unit // self.col_tiles) * RT,
                z, range(z * self.chunks // self.splits,
                         (z + 1) * self.chunks // self.splits))

    def chunk(self, c: int) -> Tuple[int, int]:
        """(segment, first column) of chunk ``c`` (csrc chunk_seg)."""
        for s, k in enumerate(self.ks):
            n = _ceil(k, KC)
            if c < n or s == len(self.ks) - 1:
                return s, c * KC
            c -= n
        raise AssertionError("unreachable")

    @property
    def longest(self) -> int:
        """Chunks of the longest item."""
        return _ceil(self.chunks, self.splits)


class DecodePlan(NamedTuple):
    """How ``csrc/decode_scan.cu`` is launched: ``grid`` co-resident
    blocks of ``smem`` bytes, and the four GEMM phases (att-LSTM, h2att,
    lang-LSTM, logits) with their splits; ``part_floats`` sizes the (S, B,
    N) buffer of their split sums."""
    grid: int
    smem: int
    phases: Tuple[GemmPhasePlan, ...]
    part_floats: int


def ring_bytes(dtype: torch.dtype) -> int:
    """The GEMM ring a block holds (csrc Ring): per stage NC weight rows
    and RT f32 state rows, KC + 4 (f32) or KC + 8 (bf16) elements apart."""
    pad = 4 if dtype == torch.float32 else 8
    w = NC * (KC + pad) * (4 if dtype == torch.float32 else 2)
    return STAGES * (w + RT * (KC + pad) * 4)


def decode_scan_plan(B: int, T: int, R: int, H: int, A: int, E: int, V: int,
                     dtype: torch.dtype, sms: int) -> DecodePlan:
    """The launch plan of a decode of batch B over T frames and R ROIs,
    rnn H, att_hid A, input encoding E and V words, on a card of ``sms``
    SMs: blocks as many as fit an SM (two at most, the kernel's launch
    bound) on every SM, and per GEMM phase as many K-splits as keep the
    grid busy (at most one per chunk), so the longest item is as short as
    whole splits allow; every (column, row, chunk) in exactly one item."""
    sums = _ceil(max(T, R), 4) * 4 + NG * DCH
    smem = 4 * (HEAD_WORDS + max(ring_bytes(dtype) // 4, 2 * A, sums, V))
    per_sm = min(2, SM_SMEM // (smem + BLOCK_RESERVED))
    _build.require(per_sm >= 1, f"K6 needs {smem} bytes of shared memory a "
                   "block, more than an SM has")
    grid = sms * per_sm
    phases = []
    for name, n, ks in (("att_lstm", 4 * H, (E, H)), ("h2att", 2 * A, (H,)),
                        ("lang_lstm", 4 * H, (H, H, H)),
                        ("logit", V, (H,))):
        col_tiles, row_tiles = _ceil(n, NC), _ceil(B, RT)
        chunks = sum(_ceil(k, KC) for k in ks)
        splits = max(1, min(chunks, grid // (col_tiles * row_tiles)))
        phases.append(GemmPhasePlan(name, n, ks, col_tiles, row_tiles,
                                    chunks, splits))
    return DecodePlan(grid, smem, tuple(phases),
                      max(p.splits * B * p.n for p in phases))


def greedy_decode_fused_plain(model, enc: Dict[str, torch.Tensor],
                              pnt_mask: torch.Tensor
                              ) -> Tuple[torch.Tensor, ...]:
    """UNK-suppressed greedy decode of ``model`` (a ``GVDModel``) over the
    banks ``enc`` of ``GVDModel.encode``: ``cfg.seq_length`` steps of
    ``core_step`` from BOS = token 0, two first-index argmaxes per step
    (model.py:589-594)."""
    B = pnt_mask.shape[0]
    dev = pnt_mask.device
    state = model.init_state(B, dev)
    tok = torch.zeros((B,), dtype=torch.long, device=dev)
    toks, lps, att2s = [], [], []
    for _ in range(model.cfg.seq_length):
        xt = model.embed_words(tok)
        out, state, att2_w, _ = model.core_step(
            xt, enc["fc_feats"], enc["conv_feats"], enc["p_conv_feats"],
            enc["pool_feats"], enc["p_pool_feats"], pnt_mask, pnt_mask,
            state)
        logprobs = model.logit_logprobs(out)
        i1 = logprobs.argmax(dim=1)
        v1 = logprobs.gather(1, i1[:, None])[:, 0]
        masked = logprobs.scatter(1, i1[:, None], MIN_VALUE)
        i2 = masked.argmax(dim=1)
        v2 = masked.gather(1, i2[:, None])[:, 0]
        use_first = i1 != model.unk_idx
        tok = torch.where(use_first, i1, i2)
        toks.append(tok)
        lps.append(torch.where(use_first, v1, v2))
        att2s.append(att2_w)
    seq = torch.stack(toks, dim=1).to(torch.int32)
    return seq, torch.stack(lps, dim=1), torch.stack(att2s, dim=1)


def greedy_decode_fused(model, enc: Dict[str, torch.Tensor],
                        pnt_mask: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Same contract as ``greedy_decode_fused_plain``.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (one count of
    ``decode_scan`` per decode, and one of its GEMM phases' route,
    ``GEMM_ROUTES``).  No backward: under grad mode, banks or weights that
    require grad raise."""
    banks = [enc[k] for k in ("fc_feats", "conv_feats", "p_conv_feats",
                              "pool_feats", "p_pool_feats")]
    _build.refuse_grad("greedy_decode", *banks, *model.parameters())
    if not pnt_mask.is_cuda:
        return greedy_decode_fused_plain(model, enc, pnt_mask)
    out = _launch(model, enc, pnt_mask, None, False)
    _build.launches["decode_scan"] += 1
    _build.launches[GEMM_ROUTES[banks[1].dtype]] += 1
    return out


def greedy_decode_timed(model, enc: Dict[str, torch.Tensor],
                        pnt_mask: torch.Tensor, *,
                        barriers_only: bool = False) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors that also writes, from
    block 0, the card's %globaltimer (ns) at the start and after each of
    the 10 barriers of every step: (1 + 10 L,) int64, for splitting a
    decode's time by phase.  ``barriers_only`` runs the barriers and none
    of the phases' work (its outputs are then not set).  For timing only:
    counts no launch."""
    _build.require(pnt_mask.is_cuda, "the timed decode runs on the card")
    stamps = torch.zeros(1 + PHASES * model.cfg.seq_length,
                         dtype=torch.int64, device=pnt_mask.device)
    with torch.no_grad():
        _launch(model, enc, pnt_mask, stamps, barriers_only)
    return stamps


def _launch(model, enc, pnt_mask, stamps, barriers_only: bool):
    core = model.core
    att, lang = core.att_lstm, core.lang_lstm
    cfg = model.cfg
    fc, conv, p_conv, pool, p_pool = (
        enc[k] for k in ("fc_feats", "conv_feats", "p_conv_feats",
                         "pool_feats", "p_pool_feats"))
    banks = (fc, conv, p_conv, pool, p_pool)
    dt = conv.dtype
    B, Tf, H = conv.shape
    R, A = pool.shape[1], p_pool.shape[2]
    E, L = cfg.input_encoding_size, cfg.seq_length
    V, Vp = cfg.vocab_size, model.logit.weight.shape[0]
    dev = pnt_mask.device
    req = _build.require
    req(fc.shape == (B, H) and p_conv.shape == (B, Tf, A)
        and pool.shape == (B, R, H) and pnt_mask.shape == (B, R + 1),
        "bank shapes")
    req(all(t.dtype == dt for t in banks), "banks must share one dtype")
    req(all(t.device == dev for t in banks)
        and model.logit.weight.device == dev,
        "banks, mask and model must be on one device")
    req(Vp == cfg.vocab_size_padded and getattr(model, "tp", None) is None,
        f"K6 takes the whole vocab head ({cfg.vocab_size_padded} rows), "
        f"not a model-axis rank's {Vp}: decode with "
        "parallel.whole_model(model)")
    req(H % 8 == 0 and E % 8 == 0 and A % 4 == 0,
        f"the kernel takes rnn_size {H} and input_encoding_size {E} in "
        f"multiples of 8 (16-byte rows) and att_hid {A} in loads of 4")
    code = _build.dtype_code(conv)
    plan = decode_scan_plan(B, Tf, R, H, A, E, V, dt, torch.cuda
                            .get_device_properties(dev).multi_processor_count)

    def mat(w):
        return _build.aligned16(w.detach().to(dt))

    def vec(*ts):
        return sum(t.detach().float() for t in ts).contiguous()

    w_ih = att.weight_ih.detach().to(dt)
    g0 = F.linear(fc.float(), w_ih[:, :H].float()) + vec(att.bias_ih,
                                                          att.bias_hh)
    weights = [
        mat(w_ih[:, H:]), mat(att.weight_hh), g0.contiguous(),
        mat(lang.weight_ih), mat(lang.weight_hh),
        vec(lang.bias_ih, lang.bias_hh),
        mat(torch.cat([core.attention.h2att.weight,
                       core.attention2.h2att.weight])),
        vec(torch.cat([core.attention.h2att.bias,
                       core.attention2.h2att.bias])),
        vec(torch.stack([core.attention.alpha_net.weight.reshape(A),
                         core.attention2.alpha_net.weight.reshape(A)])),
        vec(torch.cat([core.attention.alpha_net.bias.reshape(1),
                       core.attention2.alpha_net.bias.reshape(1)])),
        mat(model.logit.weight), vec(model.logit.bias),
        mat(model.embed[0].weight)]

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    xt = F.relu(weights[-1][0].float()).expand(B, E).contiguous()
    state = [xt, torch.zeros(2, B, H, device=dev), torch.zeros(B, H,
                                                               device=dev),
             torch.zeros(2, B, H, device=dev), torch.zeros(B, H, device=dev),
             f32(B, 2 * A), f32(B, Tf + R), f32(B, H), f32(plan.part_floats),
             torch.zeros(2, dtype=torch.int32, device=dev)]
    seq = torch.empty((B, L), dtype=torch.int32, device=dev)
    logprobs = f32(B, L)
    att2 = torch.empty((B, L, R), dtype=dt, device=dev)
    args = ([_build.aligned16(t) for t in (conv, p_conv, pool, p_pool)]
            + [pnt_mask[:, 1:].contiguous()] + weights + state
            + [seq, logprobs, att2])
    with torch.cuda.device(dev):
        code = _build.lib().gvd_greedy_decode(
            code, *[t.data_ptr() for t in args], _build.ptr(stamps), B, Tf,
            R, H, A, E, V, Vp, L, model.unk_idx, plan.grid,
            *[p.splits for p in plan.phases], plan.smem, int(barriers_only),
            _build.stream_of(conv))
    _build.check(code, "greedy_decode")
    return seq, logprobs, att2
