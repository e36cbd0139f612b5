"""K5: the whole obj_interact encoder layer in training, forward and
backward, with dropout at three sites.

Replaces ``grounded_video_description_tpu/ops/pallas/encoder_layer_train.py
::fused_encoder_layer_train`` (``_fwd_kernel``, ``_bwd_kernel``).  The
CUDA source is ``csrc/encoder_layer_train.cu``; the layer is one
``torch.autograd.Function`` whose forward and backward are sequences of
the port's own kernels (K1's GEMM, K4's attention with K5's salts, and
that file's GEMM layouts, LayerNorm passes and column sums).  No product
goes to cuBLAS, and no (B, heads, R, R) tensor reaches device memory.

The layer: per batch row b of the call, q/k/v projections, per head
softmax(q_h k_h^T / sqrt(D)) with dropout on the probs, the output
projection with dropout, residual + LayerNorm (unbiased std), the ReLU
FFN with dropout, residual + LayerNorm.  The masks are the JAX kernel's
bit for bit (``uniform_hash``): the prob site salted 0x10000000 + b * 8 + h
over an (Rp, Rp) counter, Rp = R rounded up to 128; the residual sites
0x20000000 + b and 0x30000000 + b over an (R, D) counter; b is the row
within the call.  A kept value is divided by (1 - drop).

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

import torch
import torch.nn.functional as F

from grounded_video_description_torch.nn.core import layer_norm_affine
from grounded_video_description_torch.ops.kernels import _build
from grounded_video_description_torch.ops.kernels.attention_train import (
    MAX_HEAD, MMA_TILE, attention_backward, attention_forward, uniform_hash)
from grounded_video_description_torch.ops.kernels.encoder_layer import (
    LN_EPS, EncoderLayerWeights, _gemm, head_slices)

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

    def __init__(self, x: torch.Tensor, seed: torch.Tensor, drop: float):
        self.dt, self.seed, self.drop = x.dtype, seed, drop
        B, self.R, self.D = x.shape
        self.rows = torch.arange(B, device=x.device)
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


def attention_sublayer_plain(x: torch.Tensor, w: EncoderLayerWeights,
                             seed: torch.Tensor, *, n_heads: int,
                             drop: float) -> torch.Tensor:
    """The twin's first half: x1 = LN1(x + drop(attention(x) Wo)) in f32,
    the FFN's input (its ReLU pre-activation is mm(x1, W1) + b1)."""
    ops = _Plain(x, seed, drop)
    dt, R, D = ops.dt, ops.R, ops.D
    Rp = -(-R // 128) * 128
    inv_scale = 1.0 / math.sqrt(D)
    xf = x.float()            # one node, so dx is rounded once, at the end
    q, k, v = (ops.mm(xf, m).to(dt) for m in (w.wq, w.wk, w.wv))
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
    o = torch.cat(heads, dim=-1)
    a = ops.grad_rounded(ops.mm(o, w.wo))
    return ops.ln(xf + ops.resid_drop(a, SITE_RESID1), w.g1, w.be1)


def fused_encoder_layer_train_plain(x: torch.Tensor, w: EncoderLayerWeights,
                                    seed: torch.Tensor, *, n_heads: int,
                                    drop: float) -> torch.Tensor:
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
    ops = _Plain(x, seed, drop)
    x1 = attention_sublayer_plain(x, w, seed, n_heads=n_heads, drop=drop)
    hid = ops.rounded(torch.relu(ops.grad_rounded(ops.mm(x1, w.w1))
                                 + w.b1.float()))
    f = ops.grad_rounded(ops.mm(hid, w.w2)) + w.b2.float()
    return ops.ln(x1 + ops.resid_drop(f, SITE_RESID2), w.g2,
                  w.be2).to(ops.dt)


# --------------------------------------------------------------------- #
# the kernel path
# --------------------------------------------------------------------- #

def _mm(layout: int, a, b, M: int, N: int, K: int, *, out_f32: bool,
        bias=None, relu=False, mask=None, resid=None, out=None,
        splits: int = 1):
    """gvd_k5_gemm: C (M, N) = A op B, with B in the compute dtype and A
    in it or in f32 (rounded to it as it loads)."""
    dt = b.dtype
    if out is None:
        out = torch.empty((M, N), device=b.device,
                          dtype=torch.float32 if out_f32 else dt)
    partial = (torch.empty((splits, M, N), dtype=torch.float32,
                           device=b.device) if splits > 1 else None)
    ptr = _build.ptr
    code = _build.lib().gvd_k5_gemm(
        _build.dtype_code(b), int(a.dtype == torch.float32), layout,
        a.data_ptr(), b.data_ptr(), M, N, K, splits, ptr(bias), int(relu),
        ptr(mask), ptr(resid), out.data_ptr(), int(out_f32), ptr(partial),
        _build.stream_of(b))
    _build.check(code, "k5_gemm")
    return out


def _row_splits(M: int, N: int, K: int) -> int:
    """Blocks along the K rows of a weight gradient A^T B, so that its
    (M / 128) x (N / 128) output tiles fill the card about twice; each
    split keeps at least 1024 rows."""
    tiles = -(-M // 128) * -(-N // 128)
    return max(1, min(-(-264 // tiles), K // 1024))


def _grad_w(dy, x):
    """dW = dy^T x over the rows: (N_out, N_in) in f32."""
    K, M = dy.shape
    N = x.shape[1]
    return _mm(TN, dy, x, M, N, K, out_f32=True,
               splits=_row_splits(M, N, K))


def _ln_fwd(x, a, seed, site, R, drop, gamma, beta, *, f32_out: bool,
            dt):
    rows, D = a.shape
    out_t = torch.empty((rows, D), dtype=dt, device=a.device)
    out_f32 = (torch.empty_like(a) if f32_out and dt != torch.float32
               else None)
    normed = torch.empty_like(a)
    sigma = torch.empty((rows,), dtype=torch.float32, device=a.device)
    code = _build.lib().gvd_k5_ln_fwd(
        _build.dtype_code(out_t), int(x.dtype == torch.float32),
        x.data_ptr(), a.data_ptr(), seed.data_ptr(), site, R, drop,
        1.0 - drop, gamma.data_ptr(), beta.data_ptr(),
        out_f32.data_ptr() if out_f32 is not None else None,
        out_t.data_ptr(), normed.data_ptr(), sigma.data_ptr(), rows, D,
        LN_EPS, _build.stream_of(a))
    _build.check(code, "k5_ln_fwd")
    return out_t, (out_f32 if out_f32 is not None else out_t), normed, sigma


def _ln_bwd(g, normed, sigma, gamma, seed, site, R, drop, dt):
    rows, D = normed.shape
    dy, dyd = torch.empty_like(normed), torch.empty_like(normed)
    code = _build.lib().gvd_k5_ln_bwd(
        _build.DTYPE_CODES[dt],
        int(g.dtype == torch.float32), g.data_ptr(), normed.data_ptr(),
        sigma.data_ptr(), gamma.data_ptr(), seed.data_ptr(), site, R, drop,
        1.0 - drop, dy.data_ptr(), dyd.data_ptr(), rows, D, LN_EPS,
        _build.stream_of(normed))
    _build.check(code, "k5_ln_bwd")
    return dy, dyd


def _colsum(a, b=None, *, dt):
    """(sum over rows of a, of a * b) per column, in f32."""
    M, N = a.shape
    chunks = -(-M // COLSUM_ROWS)
    partial = torch.empty((2, chunks, N), dtype=torch.float32,
                          device=a.device)
    out1 = torch.empty((N,), dtype=torch.float32, device=a.device)
    out2 = torch.empty_like(out1) if b is not None else None
    code = _build.lib().gvd_k5_colsum(
        _build.DTYPE_CODES[dt],
        int(a.dtype == torch.float32), a.data_ptr(),
        b.data_ptr() if b is not None else None, M, N, chunks,
        partial.data_ptr(), out1.data_ptr(),
        out2.data_ptr() if out2 is not None else None,
        _build.stream_of(a))
    _build.check(code, "k5_colsum")
    return out1, out2


def _kernel_forward(x, w, seed, n_heads, drop):
    """Returns the output (B, R, D) and the tensors the backward reads."""
    B, R, D = x.shape
    M, dt = B * R, x.dtype
    scale = math.sqrt(D)
    x2 = x.reshape(M, D)
    wq, wk, wv, wo, w1, w2 = (_build.aligned16(t.to(dt)) for t in (
        w.wq, w.wk, w.wv, w.wo, w.w1, w.w2))
    b1, b2, g1, be1, g2, be2 = (t.float().contiguous() for t in (
        w.b1, w.b2, w.g1, w.be1, w.g2, w.be2))
    q, k, v = (_gemm(x2, m, None, relu=False).view(B, R, D)
               for m in (wq, wk, wv))
    o, lse = attention_forward(q, k, v, seed, n_heads=n_heads, scale=scale,
                               drop=drop, salt_base=SITE_PROBS,
                               salt_mul=SALT_MUL)
    o = o.view(M, D)
    a = _mm(NT, o, wo, M, D, D, out_f32=True)
    x1c, x1, n1, s1 = _ln_fwd(x2, a, seed, SITE_RESID1, R, drop, g1, be1,
                              f32_out=True, dt=dt)
    del a
    hid = _gemm(x1c, w1, b1, relu=True)
    f = _mm(NT, hid, w2, M, D, w2.shape[1], out_f32=True, bias=b2)
    out, _, n2, s2 = _ln_fwd(x1, f, seed, SITE_RESID2, R, drop, g2, be2,
                             f32_out=False, dt=dt)
    saved = (x2, q, k, v, o, lse, x1c, hid, n1, s1, n2, s2,
             wq, wk, wv, wo, w1, w2, g1, g2, seed)
    return out.view(B, R, D), saved


def _kernel_backward(g, saved, n_heads, drop, shape):
    """dx and the twelve weight gradients (f32) for the output gradient g."""
    (x2, q, k, v, o, lse, x1c, hid, n1, s1, n2, s2,
     wq, wk, wv, wo, w1, w2, g1, g2, seed) = saved
    B, R, D = shape
    M, dt, Fh = B * R, x2.dtype, hid.shape[1]
    g2d = g.reshape(M, D).contiguous()
    # LN2, the FFN and its dropout
    dy2, df = _ln_bwd(g2d, n2, s2, g2, seed, SITE_RESID2, R, drop, dt)
    dbe2, dg2 = _colsum(g2d, n2, dt=dt)
    db2, _ = _colsum(df, dt=dt)
    dw2 = _grad_w(df, hid)
    dz1 = _mm(NN, df, w2, M, Fh, D, out_f32=True, mask=hid)
    del df
    db1, _ = _colsum(dz1, dt=dt)
    dw1 = _grad_w(dz1, x1c)
    dx1 = _mm(NN, dz1, w1, M, D, Fh, out_f32=True, resid=dy2, out=dy2)
    del dz1
    # LN1, the output projection and its dropout
    dbe1, dg1 = _colsum(dx1, n1, dt=dt)
    dy1, dacc = _ln_bwd(dx1, n1, s1, g1, seed, SITE_RESID1, R, drop, dt)
    del dx1
    dwo = _grad_w(dacc, o)
    dattn = _mm(NN, dacc, wo, M, D, D, out_f32=False)
    del dacc
    # the attention, then the projections
    dq, dk, dv = attention_backward(
        q, k, v, o.view(B, R, D), lse, seed, dattn.view(B, R, D),
        n_heads=n_heads, scale=math.sqrt(D), drop=drop,
        salt_base=SITE_PROBS, salt_mul=SALT_MUL)
    del dattn
    dq, dk, dv = (t.view(M, D) for t in (dq, dk, dv))
    dwq, dwk, dwv = (_grad_w(t, x2) for t in (dq, dk, dv))
    _mm(NN, dq, wq, M, D, D, out_f32=True, resid=dy1, out=dy1)
    _mm(NN, dk, wk, M, D, D, out_f32=True, resid=dy1, out=dy1)
    dx = _mm(NN, dv, wv, M, D, D, out_f32=False, resid=dy1)
    return dx.view(B, R, D), (dwq, dwk, dwv, dwo, dw1, db1, dw2, db2, dg1,
                              dbe1, dg2, dbe2)


class _EncoderLayerTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, n_heads, drop, *weights):
        out, saved = _kernel_forward(x, EncoderLayerWeights(*weights), seed,
                                     n_heads, drop)
        ctx.save_for_backward(*saved)
        ctx.args = (n_heads, drop, tuple(x.shape),
                    [t.dtype for t in weights])
        _build.launches["encoder_layer_train_fwd"] += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        n_heads, drop, shape, wdtypes = ctx.args
        dx, dw = _kernel_backward(dout, ctx.saved_tensors, n_heads, drop,
                                  shape)
        _build.launches["encoder_layer_train_bwd"] += 1
        return (dx, None, None, None,
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
                              drop: float) -> torch.Tensor:
    """Same contract as ``fused_encoder_layer_train_plain``.  A CPU tensor
    takes the plain version; a CUDA tensor runs the forward kernels, and
    its backward the backward kernels (one count each per layer call)."""
    if not x.is_cuda:
        return fused_encoder_layer_train_plain(x, w, seed, n_heads=n_heads,
                                               drop=drop)
    _check(x, w, seed, n_heads)
    return _EncoderLayerTrain.apply(x.contiguous(), seed, n_heads,
                                    float(drop), *w)
