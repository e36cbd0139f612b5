"""K5: the whole obj_interact encoder layer in training, forward and
backward, with dropout at three sites.

Replaces ``grounded_video_description_tpu/ops/pallas/encoder_layer_train.py
::fused_encoder_layer_train`` (``_fwd_kernel``, ``_bwd_kernel``).  The
CUDA source is ``csrc/encoder_layer_train.cu``; the layer is one
``torch.autograd.Function`` whose forward and backward are sequences of
the port's own kernels (that file's GEMM, LayerNorm passes and column
sums, and K4's attention with K5's salts).  Every product, six forward
and twelve backward, runs on the one GEMM in three layouts (x W^T, dY W,
A^T B), each launch planned by ``k5_gemm_plan``: in bf16 on the tensor
cores, in f32 on the SIMT units.  The attention runs on the tensor cores
in both dtypes (in f32 in 3xTF32, counting ``attention_tf32x3``).  No
product goes to cuBLAS, and no (B, heads, R, R) tensor reaches device
memory.

The layer: per batch row b of the call, q/k/v projections, per head
softmax(q_h k_h^T / sqrt(D)) with dropout on the probs, the output
projection with dropout, residual + LayerNorm (unbiased std), the ReLU
FFN with dropout, residual + LayerNorm.  The masks are the JAX kernel's
bit for bit (``uniform_hash``): the prob site salted 0x10000000 + b * 8 + h
over an (Rp, Rp) counter, Rp = R rounded up to 128; the residual sites
0x20000000 + b and 0x30000000 + b over an (R, D) counter; b is the row
within the call plus ``row0``, the global index of the call's first row
(a data-parallel rank's offset in the microbatch; the salts are affine in
b, so the kernels take it in their salt bases).  A kept value is divided
by (1 - drop).

Numerics (both versions): q, k, v, the attention output, the FFN input
x1c and the FFN activation are stored in the input dtype; every product
sums in f32; scores, softmax, the residual sums, LayerNorm and every
backward elementwise chain run in f32, and the second residual takes x1
in f32, as the TPU kernel does.  In bf16 the attention's P~ and dS enter
their products in bf16 (the TPU kernel casts p and ds to the compute
dtype too).  The JAX kernel runs its softmax in the
compute dtype and divides the bf16 probs by bf16(1 - drop); the port
keeps both in f32 (ROADMAP Queue 3).  Gradients are f32.

``fused_encoder_layer_train_plain`` is the same function in plain PyTorch
with materialized probs, the same masks and autograd for the backward.
CPU tensors take it, and it is the reference on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from grounded_video_description_torch.nn.core import layer_norm_affine
from grounded_video_description_torch.ops.kernels import _build
from grounded_video_description_torch.ops.kernels.attention_train import (
    MAX_HEAD, MMA_TILE, attention_backward, attention_forward, uniform_hash)
from grounded_video_description_torch.ops.kernels.encoder_layer import (
    LN_EPS, EncoderLayerWeights, head_slices)

SITE_PROBS = 0x10000000
SITE_RESID1 = 0x20000000
SITE_RESID2 = 0x30000000
SALT_MUL = 8            # the prob site's per-row stride, whatever n_heads
NT, NN, TN = 0, 1, 2    # gvd_k5_gemm layouts (csrc/encoder_layer_train.cu)
COLSUM_ROWS = 256       # rows per block in the column sums' first pass


def _dropped(t: torch.Tensor, u: torch.Tensor, drop: float) -> torch.Tensor:
    """Kept where u >= drop and divided by (1 - drop), else 0."""
    return torch.where(u >= drop, t / (1.0 - drop), 0.0)


class _Rounded(torch.autograd.Function):
    """f32 values rounded to ``dt`` and back; the gradient passes in f32."""

    @staticmethod
    def forward(ctx, t, dt):
        return t.to(dt).float()

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradRounded(torch.autograd.Function):
    """The identity, whose gradient is rounded to ``dt``."""

    @staticmethod
    def forward(ctx, t, dt):
        ctx.dt = dt
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dt).float(), None


def flash_rounding(z: torch.Tensor, u, drop: float, dt) -> torch.Tensor:
    """The factor by which the bf16 forward kernel's rounding scales each
    dropped prob.  z (..., R, R) are the scaled scores.  The kernel walks
    key tiles of ``MMA_TILE`` rows (the library's own tile, which every
    bf16 launch checks) with a running row max m_t and rounds
    e = exp(z - m_t) * keep / (1 - drop) to ``dt`` before e V; the final
    output divides by the f32 normaliser.  So its output is
    (P~ * rho) V with rho = round(e) / e (1 where e = 0), P~ the twin's
    dropped probs."""
    R = z.shape[-1]
    tiles = -(-R // MMA_TILE)
    zt = F.pad(z, (0, tiles * MMA_TILE - R), value=-math.inf)
    zt = zt.unflatten(-1, (tiles, MMA_TILE))
    m = zt.amax(-1).cummax(-1).values                   # m_t per row
    e = torch.exp(zt - m[..., None]).flatten(-2)[..., :R]
    if drop > 0.0:
        e = _dropped(e, u, drop)
    return torch.where(e > 0, e.to(dt).float() / e, 1.0)


class _FlashPV(torch.autograd.Function):
    """o = (p * rho) v, the bf16 forward kernel's P~ V (``flash_rounding``),
    with the bf16 backward kernels' gradients: dp = dO v^T in f32, and
    dv = p^T dO with p rounded to ``dt``."""

    @staticmethod
    def forward(ctx, p, rho, v, dt):
        ctx.save_for_backward(p, v)
        ctx.dt = dt
        return (p * rho) @ v

    @staticmethod
    def backward(ctx, g):
        p, v = ctx.saved_tensors
        dv = p.to(ctx.dt).float().transpose(-1, -2) @ g
        return g @ v.transpose(-1, -2), None, dv, None


class _Plain:
    """The twin's pieces for inputs of dtype ``dt`` and shape (B, R, D)."""

    def __init__(self, x: torch.Tensor, seed: torch.Tensor, drop: float,
                 row0: int = 0):
        self.dt, self.seed, self.drop = x.dtype, seed, drop
        B, self.R, self.D = x.shape
        self.rows = row0 + torch.arange(B, device=x.device)
        self.lowp = self.dt != torch.float32

    def rounded(self, t):
        return _Rounded.apply(t, self.dt) if self.lowp else t

    def grad_rounded(self, t):
        return _GradRounded.apply(t, self.dt) if self.lowp else t

    def mm(self, a, m):
        """a m^T with both operands in the compute dtype, summed in f32."""
        return F.linear(self.rounded(a.float()), self.rounded(m.float()))

    def resid_drop(self, t, site):
        if self.drop <= 0.0:
            return t
        u = uniform_hash((self.R, self.D), self.seed, site + self.rows)
        return _dropped(t, u, self.drop)

    @staticmethod
    def ln(y, gamma, beta):
        return layer_norm_affine(gamma.float(), beta.float(), y, LN_EPS,
                                 use_std=True)


def attention_heads_plain(q, k, v, seed: torch.Tensor, *, n_heads: int,
                          drop: float, row0: int = 0) -> torch.Tensor:
    """The twin's attention: concat_h drop(softmax(q_h k_h^T / sqrt(D)))
    v_h for q, k, v (B, R, D) in the compute dtype, returned in it;
    differentiable, with the bf16 kernels' rounding of P~ and dS."""
    ops = _Plain(q, seed, drop, row0)
    dt, R, D = ops.dt, ops.R, ops.D
    Rp = -(-R // 128) * 128
    inv_scale = 1.0 / math.sqrt(D)
    heads = []
    for h, sl in enumerate(head_slices(D, n_heads)):
        # in bf16 the score gradient dS enters dQ and dK in bf16, and P~
        # enters P~ V (and dV) in bf16, as in the tensor-core kernels
        s = ops.grad_rounded(q[..., sl].float()
                             @ k[..., sl].float().transpose(1, 2))
        z = s * inv_scale
        p = torch.softmax(z, dim=-1)
        u = None
        if drop > 0.0:
            u = uniform_hash((Rp, Rp), seed,
                             SITE_PROBS + ops.rows * SALT_MUL + h)[:, :R, :R]
            p = _dropped(p, u, drop)
        vh = v[..., sl].float()
        if ops.lowp:
            rho = flash_rounding(z.detach(), u, drop, dt)
            heads.append(_FlashPV.apply(p, rho, vh, dt).to(dt))
        else:
            heads.append((p @ vh).to(dt))
    return torch.cat(heads, dim=-1)


def attention_sublayer_plain(x: torch.Tensor, w: EncoderLayerWeights,
                             seed: torch.Tensor, *, n_heads: int,
                             drop: float, row0: int = 0) -> torch.Tensor:
    """The twin's first half: x1 = LN1(x + drop(attention(x) Wo)) in f32,
    the FFN's input (its ReLU pre-activation is mm(x1, W1) + b1)."""
    ops = _Plain(x, seed, drop, row0)
    dt = ops.dt
    xf = x.float()            # one node, so dx is rounded once, at the end
    q, k, v = (ops.mm(xf, m).to(dt) for m in (w.wq, w.wk, w.wv))
    o = attention_heads_plain(q, k, v, seed, n_heads=n_heads, drop=drop,
                              row0=row0)
    a = ops.grad_rounded(ops.mm(o, w.wo))
    return ops.ln(xf + ops.resid_drop(a, SITE_RESID1), w.g1, w.be1)


def fused_encoder_layer_train_plain(x: torch.Tensor, w: EncoderLayerWeights,
                                    seed: torch.Tensor, *, n_heads: int,
                                    drop: float, row0: int = 0
                                    ) -> torch.Tensor:
    """x (B, R, D) in f32 or bf16; w the layer's tensors (f32, linear
    weights in (out, in) layout); seed an int64 tensor of one element.
    Returns the layer's output (B, R, D) in x's dtype.  Differentiable by
    autograd, with the backward rounded where the kernels round it (as
    the TPU kernel's ``_bwd_kernel``): the output gradients of the Wo, W1
    and W2 products enter their two backward products in the compute
    dtype, the weight gradients and the gradients of x and x1 stay f32,
    and db1, db2 sum the f32 gradients.  In the attention, the dropped
    probs P~ enter P~ V (and dV) and the score gradient dS enters dQ and
    dK in the compute dtype, as in the bf16 tensor-core kernels, and the
    forward rounds P~ as their online softmax does (``flash_rounding``)."""
    ops = _Plain(x, seed, drop, row0)
    x1 = attention_sublayer_plain(x, w, seed, n_heads=n_heads, drop=drop,
                                  row0=row0)
    hid = ops.rounded(torch.relu(ops.grad_rounded(ops.mm(x1, w.w1))
                                 + w.b1.float()))
    f = ops.grad_rounded(ops.mm(hid, w.w2)) + w.b2.float()
    return ops.ln(x1 + ops.resid_drop(f, SITE_RESID2), w.g2,
                  w.be2).to(ops.dt)


# --------------------------------------------------------------------- #
# the kernel path
# --------------------------------------------------------------------- #
# Each launch below runs its kernel on a CUDA tensor.  On a CPU tensor it
# runs that kernel's plain version instead (the GEMM as its planned tiles
# and splits, the LayerNorm passes and column sums as formulas, the
# attention as the twin's), so the CPU tests can hold the whole planned
# sequence of ``_kernel_forward`` and ``_kernel_backward`` against the
# twin's autograd.  ``fused_encoder_layer_train`` itself gives CPU
# tensors the twin.

# route, output tile (rows, columns), K step, blocks an SM, for each dtype
GEMM_ROUTES = {torch.bfloat16: ("tc", 128, 128, 64, 2),
               torch.float32: ("simt", 128, 128, 16, 2)}
H100_SMS = 132
SPLIT_MIN_ROWS = 1024   # a weight gradient's split sums at least this many
# the layouts of the layer's products in launch order: the forward's Q, K,
# V, Wo, W1 and W2; the backward's dW2, dz1, dW1, dx1, dWo, dattn, dWq,
# dWk, dWv and the dx chain through Wq, Wk, Wv
GEMM_LAYOUTS = (NT,) * 6 + (TN, NN, TN, NN, TN, NN, TN, TN, TN, NN, NN, NN)
FWD_GEMMS, BWD_GEMMS = 6, 12


class GemmPlan(NamedTuple):
    """One launch of ``gvd_k5_gemm``: C (M, N) = A op B over K."""
    route: str          # "tc": bf16 on the tensor cores; "simt": f32
    layout: int         # NT, NN or TN
    M: int
    N: int
    K: int
    tile_m: int
    tile_n: int
    tile_k: int
    splits: int         # blocks along K (the grid's z)
    k_split: int        # K rows per split, a multiple of tile_k
    lda: int            # the operands' row strides as launched: their
    ldb: int            # row lengths, padded where a row is not 16-byte
                        # aligned (bf16 rows go to TMA)

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (-(-self.N // self.tile_n), -(-self.M // self.tile_m),
                self.splits)

    def blocks(self):
        """(split z, output rows, output columns, K rows) of each block of
        the grid, in launch order."""
        gx, gy, gz = self.grid
        for z in range(gz):
            ks = slice(z * self.k_split, min(self.K, (z + 1) * self.k_split))
            for by in range(gy):
                rows = slice(by * self.tile_m,
                             min(self.M, (by + 1) * self.tile_m))
                for bx in range(gx):
                    cols = slice(bx * self.tile_n,
                                 min(self.N, (bx + 1) * self.tile_n))
                    yield z, rows, cols, ks


def row_lengths(layout: int, M: int, N: int, K: int) -> Tuple[int, int]:
    """The contiguous (row) length of A and of B in ``layout``: NT A (M, K)
    B (N, K); NN A (M, K) B (K, N); TN A (K, M) B (K, N)."""
    return (M if layout == TN else K), (K if layout == NT else N)


def k5_gemm_plan(layout: int, M: int, N: int, K: int, dtype, *,
                 splits: Optional[int] = None,
                 sms: int = H100_SMS) -> GemmPlan:
    """The launch of one K5 product in ``dtype`` (the operands' compute
    dtype).  bf16 takes the tensor-core route, whose TMA reads rows 16
    bytes apart: a row length that is not a multiple of 8 is padded.  f32
    takes the SIMT route (4-byte copies: no padding).  A weight gradient
    (TN, K = the B * R rows) is split along K so that its few output tiles
    fill the card's ``sms`` once (``splits`` overrides), each split at
    least SPLIT_MIN_ROWS rows, none empty; the other layouts take one."""
    route, tm, tn, tk, per_sm = GEMM_ROUTES[dtype]
    align = 8 if route == "tc" else 1
    la, lb = row_lengths(layout, M, N, K)
    if splits is None:
        splits = 1
        if layout == TN:
            tiles = -(-M // tm) * -(-N // tn)
            splits = max(1, min(sms * per_sm // tiles, K // SPLIT_MIN_ROWS))
    k_split = _round_up(-(-K // splits), tk)
    return GemmPlan(route, layout, M, N, K, tm, tn, tk, -(-K // k_split),
                    k_split, _round_up(la, align), _round_up(lb, align))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _padded(t: torch.Tensor, ld: int) -> torch.Tensor:
    """t (rows, n) with rows ``ld`` >= n elements apart (zeros after n)."""
    if t.shape[1] != ld:
        t = F.pad(t, (0, ld - t.shape[1]))
    return _build.aligned16(t)


def gemm_plain(plan: GemmPlan, a, b, *, out_f32: bool, bias=None,
               relu=False, mask=None, resid=None,
               copy_bf16: bool = False):
    """What the launch of ``plan`` computes, in plain PyTorch: each block's
    f32 sum over its split's K rows of its output tile, from A and B in
    the compute dtype (b's), the splits summed in order, then the
    epilogue (bias, ReLU, zero where mask <= 0, + resid) and the output
    as f32 or the compute dtype, with its bf16 copy when asked."""
    dt = b.dtype
    A = a.to(dt).float()
    Bm = b.float()
    op_a = A.t() if plan.layout == TN else A           # (M, K)
    op_b = Bm.t() if plan.layout == NT else Bm         # (K, N)
    acc = torch.zeros((plan.splits, plan.M, plan.N), dtype=torch.float32,
                      device=b.device)
    for z, rows, cols, ks in plan.blocks():
        acc[z, rows, cols] = op_a[rows, ks] @ op_b[ks, cols]
    c = acc[0]
    for z in range(1, plan.splits):
        c = c + acc[z]
    if bias is not None:
        c = c + bias
    if relu:
        c = torch.relu(c)
    if mask is not None:
        c = torch.where(mask.float() > 0, c, 0.0)
    if resid is not None:
        c = c + resid
    out = c if out_f32 else c.to(dt)
    return (out, c.to(torch.bfloat16)) if copy_bf16 else out


def _mm(layout: int, a, b, M: int, N: int, K: int, *, out_f32: bool,
        bias=None, relu=False, mask=None, resid=None, out=None,
        copy_bf16: bool = False, splits: Optional[int] = None):
    """C (M, N) = A op B on ``gvd_k5_gemm``, planned by ``k5_gemm_plan``
    in b's dtype (A in another dtype is rounded to it first; the layer
    hands it the bf16 copies its producers wrote).  ``out`` (f32) may be
    ``resid``.  With ``copy_bf16`` also returns C's bf16 copy.  One count
    of ``k5_gemm_tc`` or ``k5_gemm_simt`` a launch."""
    dt = b.dtype
    dev = b.device
    plan = k5_gemm_plan(layout, M, N, K, dt, splits=splits,
                        sms=(torch.cuda.get_device_properties(dev)
                             .multi_processor_count if b.is_cuda
                             else H100_SMS))
    if not b.is_cuda:
        got = gemm_plain(plan, a, b, out_f32=out_f32, bias=bias, relu=relu,
                         mask=mask, resid=resid, copy_bf16=copy_bf16)
        if out is None:
            return got
        out.copy_(got[0] if copy_bf16 else got)
        return (out, got[1]) if copy_bf16 else out
    a = _padded(a.to(dt), plan.lda)
    b = _padded(b, plan.ldb)
    if out is None:
        out = torch.empty((M, N), device=dev,
                          dtype=torch.float32 if out_f32 else dt)
    c2 = (torch.empty((M, N), device=dev, dtype=torch.bfloat16)
          if copy_bf16 else None)
    partial = (torch.empty((plan.splits, M, N), dtype=torch.float32,
                           device=dev) if plan.splits > 1 else None)
    ptr = _build.ptr
    code = _build.lib().gvd_k5_gemm(
        _build.dtype_code(b), layout, a.data_ptr(), plan.lda, b.data_ptr(),
        plan.ldb, M, N, K, plan.splits, plan.k_split, ptr(bias), int(relu),
        ptr(mask), ptr(resid), out.data_ptr(), int(out_f32), ptr(c2),
        ptr(partial), _build.stream_of(b))
    _build.check(code, "k5_gemm")
    _build.launches[f"k5_gemm_{plan.route}"] += 1
    return (out, c2) if copy_bf16 else out


def _grad_w(dy, x):
    """dW = dy^T x over the rows: (N_out, N_in) in f32."""
    K, M = dy.shape
    return _mm(TN, dy, x, M, x.shape[1], K, out_f32=True)


def _resid_masks(seed, site, R, rows, D, drop, device):
    """The residual site's dropout uniforms (rows, D), rows = B * R."""
    salts = site + torch.arange(rows // R, device=device)
    return uniform_hash((R, D), seed, salts).reshape(rows, D)


def _ln_fwd(x, a, seed, site, R, drop, gamma, beta, *, f32_out: bool,
            dt):
    """y = x + drop(a), then the unbiased-std LayerNorm: (out in dt, out
    in f32 (or the dt one where f32_out is off or dt is f32), normed,
    sigma)."""
    rows, D = a.shape
    if not a.is_cuda:
        if drop > 0.0:
            a = _dropped(a, _resid_masks(seed, site, R, rows, D, drop,
                                         a.device), drop)
        y = x.float() + a
        mean = y.mean(-1, keepdim=True)
        sigma = y.std(-1, keepdim=True)
        normed = (y - mean) / (sigma + LN_EPS)
        o = gamma * normed + beta
        return o.to(dt), (o if f32_out else o.to(dt)), normed, sigma[:, 0]
    out_t = torch.empty((rows, D), dtype=dt, device=a.device)
    out_f32 = (torch.empty_like(a) if f32_out and dt != torch.float32
               else None)
    normed = torch.empty_like(a)
    sigma = torch.empty((rows,), dtype=torch.float32, device=a.device)
    code = _build.lib().gvd_k5_ln_fwd(
        _build.dtype_code(out_t), int(x.dtype == torch.float32),
        x.data_ptr(), a.data_ptr(), seed.data_ptr(), site, R, drop,
        1.0 - drop, gamma.data_ptr(), beta.data_ptr(),
        _build.ptr(out_f32), out_t.data_ptr(), normed.data_ptr(),
        sigma.data_ptr(), rows, D, LN_EPS, _build.stream_of(a))
    _build.check(code, "k5_ln_fwd")
    return out_t, (out_f32 if out_f32 is not None else out_t), normed, sigma


def _ln_bwd(g, normed, sigma, gamma, seed, site, R, drop, dt):
    """The LayerNorm's backward for its output gradient g: (dy, drop(dy),
    drop(dy) as the compute dtype's operand): f32, f32, and bf16 (or the
    f32 one itself in f32)."""
    rows, D = normed.shape
    lowp = dt != torch.float32
    if not normed.is_cuda:
        dn = g.float() * gamma
        t = ((dn * normed).sum(-1, keepdim=True)
             / ((D - 1) * sigma.clamp_min(1e-30)[:, None]))
        dy = ((dn - dn.mean(-1, keepdim=True)) / (sigma[:, None] + LN_EPS)
              - normed * t)
        dyd = dy
        if drop > 0.0:
            dyd = _dropped(dy, _resid_masks(seed, site, R, rows, D, drop,
                                            dy.device), drop)
        return dy, dyd, (dyd.to(torch.bfloat16) if lowp else dyd)
    dy, dyd = torch.empty_like(normed), torch.empty_like(normed)
    dyd_t = (torch.empty((rows, D), dtype=torch.bfloat16, device=dy.device)
             if lowp else None)
    code = _build.lib().gvd_k5_ln_bwd(
        _build.DTYPE_CODES[dt],
        int(g.dtype == torch.float32), g.data_ptr(), normed.data_ptr(),
        sigma.data_ptr(), gamma.data_ptr(), seed.data_ptr(), site, R, drop,
        1.0 - drop, dy.data_ptr(), dyd.data_ptr(), _build.ptr(dyd_t), rows,
        D, LN_EPS, _build.stream_of(normed))
    _build.check(code, "k5_ln_bwd")
    return dy, dyd, (dyd_t if lowp else dyd)


def _colsum(a, b=None, *, dt):
    """(sum over rows of a, of a * b) per column, in f32."""
    M, N = a.shape
    if not a.is_cuda:
        af = a.float()
        return af.sum(0), ((af * b).sum(0) if b is not None else None)
    chunks = -(-M // COLSUM_ROWS)
    partial = torch.empty((2, chunks, N), dtype=torch.float32,
                          device=a.device)
    out1 = torch.empty((N,), dtype=torch.float32, device=a.device)
    out2 = torch.empty_like(out1) if b is not None else None
    code = _build.lib().gvd_k5_colsum(
        _build.DTYPE_CODES[dt],
        int(a.dtype == torch.float32), a.data_ptr(), _build.ptr(b), M, N,
        chunks, partial.data_ptr(), out1.data_ptr(), _build.ptr(out2),
        _build.stream_of(a))
    _build.check(code, "k5_colsum")
    return out1, out2


def _attn_fwd(q, k, v, seed, n_heads, drop, row0=0):
    """K4's forward with K5's salts: the output and the row log-sum-exp
    (None on the CPU, whose backward recomputes the attention)."""
    if q.is_cuda:
        return attention_forward(q, k, v, seed, n_heads=n_heads,
                                 scale=math.sqrt(q.shape[-1]), drop=drop,
                                 salt_base=SITE_PROBS + row0 * SALT_MUL,
                                 salt_mul=SALT_MUL)
    return attention_heads_plain(q, k, v, seed, n_heads=n_heads,
                                 drop=drop, row0=row0), None


def _attn_bwd(q, k, v, o, lse, seed, dout, n_heads, drop, row0=0):
    """K4's backward with K5's salts: dq, dk, dv in q's dtype."""
    if q.is_cuda:
        return attention_backward(q, k, v, o, lse, seed, dout,
                                  n_heads=n_heads, scale=math.sqrt(
                                      q.shape[-1]), drop=drop,
                                  salt_base=SITE_PROBS + row0 * SALT_MUL,
                                  salt_mul=SALT_MUL)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        out = attention_heads_plain(*leaves, seed, n_heads=n_heads,
                                    drop=drop, row0=row0)
        return torch.autograd.grad(out, leaves, dout)


class K5Saved(NamedTuple):
    """What K5's forward saves for its backward (beside x)."""
    x2: torch.Tensor            # x (M, D), the compute dtype (T)
    q: torch.Tensor             # (B, R, D) T
    k: torch.Tensor
    v: torch.Tensor
    o: torch.Tensor             # the attention's output (M, D) T
    lse: torch.Tensor           # its row log-sum-exp (B, heads, R) f32
    x1c: torch.Tensor           # LN1's output (M, D) T, the FFN's input
    hid: torch.Tensor           # the FFN activation (M, F) T
    n1: torch.Tensor            # LN1's normalised values (M, D) f32
    s1: torch.Tensor            # and its sigma (M,)
    n2: torch.Tensor
    s2: torch.Tensor
    wq: torch.Tensor            # the linear weights in T
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    w1: torch.Tensor
    w2: torch.Tensor
    g1: torch.Tensor            # the LayerNorm scales in f32
    g2: torch.Tensor
    seed: torch.Tensor


def _kernel_forward(x, w, seed, n_heads, drop, row0=0):
    """Returns the output (B, R, D) and the ``K5Saved`` of the backward.
    Row b of the call is hashed as global row row0 + b."""
    B, R, D = x.shape
    M, dt = B * R, x.dtype
    Fh = w.w1.shape[0]
    x2 = x.reshape(M, D)
    wq, wk, wv, wo, w1, w2 = (_build.aligned16(t.to(dt)) for t in (
        w.wq, w.wk, w.wv, w.wo, w.w1, w.w2))
    b1, b2, g1, be1, g2, be2 = (t.float().contiguous() for t in (
        w.b1, w.b2, w.g1, w.be1, w.g2, w.be2))
    q, k, v = (_mm(NT, x2, m, M, D, D, out_f32=False).view(B, R, D)
               for m in (wq, wk, wv))
    o, lse = _attn_fwd(q, k, v, seed, n_heads, drop, row0)
    o = o.reshape(M, D)
    a = _mm(NT, o, wo, M, D, D, out_f32=True)
    x1c, x1, n1, s1 = _ln_fwd(x2, a, seed, SITE_RESID1 + row0, R, drop, g1,
                              be1, f32_out=True, dt=dt)
    del a
    hid = _mm(NT, x1c, w1, M, Fh, D, out_f32=False, bias=b1, relu=True)
    f = _mm(NT, hid, w2, M, D, Fh, out_f32=True, bias=b2)
    out, _, n2, s2 = _ln_fwd(x1, f, seed, SITE_RESID2 + row0, R, drop, g2,
                             be2, f32_out=False, dt=dt)
    return out.view(B, R, D), K5Saved(x2, q, k, v, o, lse, x1c, hid, n1, s1,
                                      n2, s2, wq, wk, wv, wo, w1, w2, g1,
                                      g2, seed)


def _kernel_backward(g, saved: K5Saved, n_heads, drop, shape, row0=0):
    """dx and the twelve weight gradients (f32) for the output gradient g.
    In bf16 every product takes bf16 operands: the f32 gradients df, dz1
    and dacc enter as the bf16 copies their producers write, while db1,
    db2 and the LayerNorm gradients sum the f32 values."""
    s = saved
    B, R, D = shape
    M, dt, Fh = B * R, s.x2.dtype, s.hid.shape[1]
    g2d = g.reshape(M, D).contiguous()
    lowp = dt != torch.float32
    # LN2, the FFN and its dropout
    dy2, df, df_t = _ln_bwd(g2d, s.n2, s.s2, s.g2, s.seed,
                            SITE_RESID2 + row0, R, drop, dt)
    dbe2, dg2 = _colsum(g2d, s.n2, dt=dt)
    db2, _ = _colsum(df, dt=dt)
    del df
    dw2 = _grad_w(df_t, s.hid)
    if lowp:
        dz1, dz1_t = _mm(NN, df_t, s.w2, M, Fh, D, out_f32=True,
                         mask=s.hid, copy_bf16=True)
    else:
        dz1 = dz1_t = _mm(NN, df_t, s.w2, M, Fh, D, out_f32=True,
                          mask=s.hid)
    del df_t
    db1, _ = _colsum(dz1, dt=dt)
    del dz1
    dw1 = _grad_w(dz1_t, s.x1c)
    dx1 = _mm(NN, dz1_t, s.w1, M, D, Fh, out_f32=True, resid=dy2, out=dy2)
    del dz1_t
    # LN1, the output projection and its dropout
    dbe1, dg1 = _colsum(dx1, s.n1, dt=dt)
    dy1, dacc, dacc_t = _ln_bwd(dx1, s.n1, s.s1, s.g1, s.seed,
                                SITE_RESID1 + row0, R, drop, dt)
    del dx1, dacc                    # its products read dacc_t
    dwo = _grad_w(dacc_t, s.o)
    dattn = _mm(NN, dacc_t, s.wo, M, D, D, out_f32=False)
    del dacc_t
    # the attention, then the projections
    dq, dk, dv = _attn_bwd(s.q, s.k, s.v, s.o.view(B, R, D), s.lse, s.seed,
                           dattn.view(B, R, D), n_heads, drop, row0)
    del dattn
    dq, dk, dv = (t.reshape(M, D) for t in (dq, dk, dv))
    dwq, dwk, dwv = (_grad_w(t, s.x2) for t in (dq, dk, dv))
    _mm(NN, dq, s.wq, M, D, D, out_f32=True, resid=dy1, out=dy1)
    _mm(NN, dk, s.wk, M, D, D, out_f32=True, resid=dy1, out=dy1)
    dx = _mm(NN, dv, s.wv, M, D, D, out_f32=False, resid=dy1)
    return dx.view(B, R, D), (dwq, dwk, dwv, dwo, dw1, db1, dw2, db2, dg1,
                              dbe1, dg2, dbe2)


class _EncoderLayerTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, n_heads, drop, row0, *weights):
        out, saved = _kernel_forward(x, EncoderLayerWeights(*weights), seed,
                                     n_heads, drop, row0)
        ctx.save_for_backward(*saved)
        ctx.args = (n_heads, drop, tuple(x.shape),
                    [t.dtype for t in weights], row0)
        _build.launches["encoder_layer_train_fwd"] += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        n_heads, drop, shape, wdtypes, row0 = ctx.args
        dx, dw = _kernel_backward(dout, K5Saved(*ctx.saved_tensors), n_heads,
                                  drop, shape, row0)
        _build.launches["encoder_layer_train_bwd"] += 1
        return (dx, None, None, None, None,
                *(d.to(t) for d, t in zip(dw, wdtypes)))


def _check(x, w, seed, n_heads):
    req = _build.require
    req(x.dim() == 3, f"x must be (B, R, D), got {tuple(x.shape)}")
    _build.dtype_code(x)
    B, R, D = x.shape
    Fh = w.w1.shape[0]
    req(-(-D // n_heads) <= MAX_HEAD, f"a head is at most {MAX_HEAD} wide")
    shapes = {"wq": (D, D), "wk": (D, D), "wv": (D, D), "wo": (D, D),
              "w1": (Fh, D), "b1": (Fh,), "w2": (D, Fh), "b2": (D,),
              "g1": (D,), "be1": (D,), "g2": (D,), "be2": (D,)}
    for name, shape in shapes.items():
        t = getattr(w, name)
        req(tuple(t.shape) == shape, f"{name} {tuple(t.shape)} != {shape}")
        req(t.device == x.device, f"{name} is on {t.device}")
    req(seed.device == x.device and seed.dtype == torch.int64
        and seed.numel() == 1, "seed must be one int64 on x's device")


def fused_encoder_layer_train(x: torch.Tensor, w: EncoderLayerWeights,
                              seed: torch.Tensor, *, n_heads: int,
                              drop: float, row0: int = 0) -> torch.Tensor:
    """Same contract as ``fused_encoder_layer_train_plain``.  A CPU tensor
    takes the plain version; a CUDA tensor runs the forward kernels, and
    its backward the backward kernels (one count each per layer call)."""
    if not x.is_cuda:
        return fused_encoder_layer_train_plain(x, w, seed, n_heads=n_heads,
                                               drop=drop, row0=row0)
    _check(x, w, seed, n_heads)
    return _EncoderLayerTrain.apply(x.contiguous(), seed, n_heads,
                                    float(drop), int(row0), *w)
