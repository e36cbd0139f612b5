"""K4: the obj_interact self-attention in training, with dropout on the
probabilities, forward and backward.

Replaces ``grounded_video_description_tpu/ops/pallas/attention_train.py
::mha_probs_dropout`` (``_fwd_kernel``, ``_bwd_kernel``) and
``mha_probs_dropout_hybrid``.  The CUDA sources: a flash-style forward
that saves the row log-sum-exp, and a FlashAttention-2 backward that
recomputes the probs, so q, k, v, the output and the log-sum-exp are the
only residuals.  Both dtypes run on Hopper's tensor cores, after a repack
of each head into a zero-padded, 16-byte aligned (B, H, Rt, dp) tensor of
the input's dtype (Rt = R rounded up to ``MMA_TILE``, dp the packed width
of the head) in scratch that the wrapper allocates, sized by the
library's own ``gvd_packed_width``; ``pack_heads_plain`` is that repack
in plain PyTorch.  bf16 runs ``csrc/attention_mma.cu``; f32 runs
``csrc/attention_tf32x3.cu``, whose products are 3xTF32: each operand
split into two TF32 terms (``split_tf32``), three TF32 products summed
in f32 (``mm_3xtf32``, the plain version of that arithmetic, which the
tests hold to f32 accuracy).  Each f32 launch also counts
``TF32_ROUTE``.

Layout: q, k, v (B, R, D) with the heads as ``torch.chunk`` column
ranges (171 x 5 + 169 at D = 1024), the port's layout, where the JAX
primitive takes (B, H, R, d) with the heads zero-padded to one width.  A
head's zero pad changes no product, so the two compute the same function.

The dropout masks are the JAX kernel's bit for bit: ``uniform_hash`` is
its counter hash in int64 arithmetic held to 32 bits, keyed by one seed
per call (an int64 tensor on the device, of which the low 32 bits count)
and salted per (batch row, head).  ``row0`` is the global index of the
call's first row: a data-parallel rank holding rows row0.. of the
microbatch hashes those rows, so D ranks draw the masks of one device.
The salt is affine in the row, so the kernels take row0 in their salt
base.  Scores, softmax and the softmax
backward run in f32 in both dtypes, as the port's K1 does (in bf16 the
dropped probs and the score gradient enter their products in bf16, as
in the JAX primitive); the JAX primitive casts the scores to the compute
dtype before its softmax.

``mha_probs_dropout_plain`` is the same function in plain PyTorch, with
materialized probs, the same masks and autograd for the backward.  CPU
tensors take it, and it is the reference on the card.
"""

from __future__ import annotations

import torch

from grounded_video_description_torch.ops.kernels import _build
from grounded_video_description_torch.parallel.mesh import generator_of
from grounded_video_description_torch.ops.kernels.encoder_layer import (
    head_slices)

MASK32 = 0xFFFFFFFF
SITE_ATTN = 0x40000000
MAX_HEAD = 192          # widest head the kernels take (gvd_packed_width)
# Rows of a query or key tile of the bf16 kernels, and the multiple their
# packed rows are padded to (csrc/attention_mma.cu TILE; ``_mma_lib``
# holds the two equal before any bf16 launch).
MMA_TILE = 64
# The packed widths instantiated in csrc/attention_mma.cu, for the plain
# repack; the kernels take theirs from gvd_packed_width (held equal to
# ``packed_width`` for every head width by tests/test_torch_cuda.py).
PACKED_WIDTHS = (64, 128, 176, 192)
# The launch count of the f32 attention's route (3xTF32 on the tensor
# cores), beside the kernel's own count: K4's forward and backward, K5's
# attention and K7 each add one per f32 launch.
TF32_ROUTE = "attention_tf32x3"


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: the 13 low bits of the pattern
    cleared after adding half their range.  inf and NaN stay as they
    are; a finite value past TF32's range becomes inf."""
    bits = x.float().contiguous().view(torch.int32).long() & MASK32
    r = ((bits + 0x1000) & 0xFFFFE000)
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)
    return torch.where(torch.isfinite(x), r.view(torch.float32), x.float())


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 x cut to TF32: the 13 low bits of the pattern cleared, as the
    tensor cores read an f32 register as a TF32 operand."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """x = hi + lo as the f32 kernels split each operand element: hi =
    ``tf32_round(x)``, lo = x - hi as the tensor cores read it
    (``tf32_trunc``)."""
    hi = tf32_round(x)
    return hi, tf32_trunc(x.float() - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the f32 kernels compute it: lo_a hi_b + hi_a lo_b + hi_a
    hi_b, each a product of TF32 values (exact in f32) summed in f32, the
    small terms first; lo_a lo_b and what the cut of lo drops, ~2^-21 of
    the product, are lost."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), in two 16-bit halves
    so that no partial product leaves int64."""
    hi = ((x >> 16) * c) & 0xFFFF
    return ((hi << 16) + (x & 0xFFFF) * c) & MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform_hash(shape, seed: torch.Tensor, salt: torch.Tensor
                 ) -> torch.Tensor:
    """JAX ``encoder_layer_train.py::uniform_hash`` for a batch of salts.

    shape (rows, cols); seed an int64 tensor of one element; salt an int64
    tensor of any shape S.  Returns f32 uniforms in [0, 1) of shape
    S + (rows, cols), element (..., i, j) from the counter i * cols + j."""
    rows, cols = shape
    dev = salt.device
    ctr = (torch.arange(rows, device=dev)[:, None] * cols
           + torch.arange(cols, device=dev)[None, :])
    mix = _fmix32(((seed.reshape(()).long() & MASK32)
                   + _fmix32(salt.long() & MASK32)) & MASK32)
    h = _fmix32(ctr ^ mix[..., None, None])
    return (h >> 8).float() * (1.0 / (1 << 24))


def _salts(B: int, head: int, n_heads: int, device,
           row0: int = 0) -> torch.Tensor:
    """JAX ``attention_train.py::_salt`` for the batch rows row0 ..
    row0 + B - 1 of a head."""
    return (SITE_ATTN + (row0 + torch.arange(B, device=device))
            * max(n_heads, 8) + head)


def _head_scores(q, k, sl, inv_scale) -> torch.Tensor:
    """q_h k_h^T * inv_scale of one head, in f32."""
    return (q[..., sl].float() @ k[..., sl].float().transpose(1, 2)) \
        * inv_scale


def packed_width(head: int) -> int:
    """The packed width of a head ``head`` wide: the least of
    ``PACKED_WIDTHS`` that holds it (the plain version of csrc
    ``gvd_packed_width``)."""
    for w in PACKED_WIDTHS:
        if head <= w:
            return w
    raise ValueError(f"a head is at most {MAX_HEAD} wide, got {head}")


def packed_shape(B: int, R: int, D: int, n_heads: int, dp: int):
    """(B, H, Rt, dp) of (B, R, D) packed in ``n_heads`` heads of width
    ``dp``."""
    return (B, len(head_slices(D, n_heads)), -(-R // MMA_TILE) * MMA_TILE,
            dp)


def pack_heads_plain(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """x (B, R, D) -> (B, H, Rt, dp), dp = ``packed_width`` of a head:
    head h (the ``torch.chunk`` column range h) transposed to its own
    slot, rows past R and columns past the head's width zero.  The JAX
    package's ``_split_heads`` moved to (B, H, R, d) and zero-padded to
    (Rt, dp)."""
    B, R, D = x.shape
    out = x.new_zeros(packed_shape(B, R, D, n_heads,
                                   packed_width(-(-D // n_heads))))
    for h, sl in enumerate(head_slices(D, n_heads)):
        out[:, h, :R, :sl.stop - sl.start] = x[..., sl]
    return out


def _mma_lib():
    """The kernel library, once its bf16 kernels' tile is known to be
    ``MMA_TILE``: the tile that the plain repack and K5's twin
    (``flash_rounding``) assume."""
    lib = _build.lib()
    tile = lib.gvd_attention_tile()
    if tile != MMA_TILE:
        raise RuntimeError(f"the bf16 attention kernels tile by {tile} "
                           f"rows, the port's twins by {MMA_TILE}")
    return lib


def _pack_scratch(n: int, B: int, R: int, D: int, n_heads: int, device,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Room for n packed (B, H, Rt, dp) copies in ``dtype``, dp from the
    library."""
    return torch.empty((n,) + _lib_packed_shape(B, R, D, n_heads),
                       dtype=dtype, device=device)


def _lib_packed_shape(B: int, R: int, D: int, n_heads: int):
    """``packed_shape`` at the library's packed width."""
    dp = _mma_lib().gvd_packed_width(-(-D // n_heads))
    _build.require(dp > 0, f"a head is at most {MAX_HEAD} wide")
    return packed_shape(B, R, D, n_heads, dp)


def pack_heads(xs, n_heads: int) -> torch.Tensor:
    """One to four tensors (B, R, D) of one shape -> (len(xs), B, H, Rt,
    dp), each packed as ``pack_heads_plain``.  The attention runs this
    repack inside its own launches; this entry of its own is for the
    tests and for timing the repack alone, so it counts no launch.  CPU
    tensors take the plain version; f32 or bf16 CUDA tensors one launch of
    the repack kernel."""
    xs = list(xs)
    req = _build.require
    req(1 <= len(xs) <= 4, "pack_heads takes one to four tensors")
    req(all(x.dim() == 3 and x.shape == xs[0].shape for x in xs),
        "pack_heads takes (B, R, D) tensors of one shape")
    if not xs[0].is_cuda:
        return torch.stack([pack_heads_plain(x, n_heads) for x in xs])
    req(all(x.dtype == xs[0].dtype and x.device == xs[0].device
            for x in xs), "the repack kernel takes one dtype on one device")
    code = _build.dtype_code(xs[0])
    xs = [x.contiguous() for x in xs]
    B, R, D = xs[0].shape
    out = _pack_scratch(len(xs), B, R, D, n_heads, xs[0].device,
                        xs[0].dtype)
    ptrs = [x.data_ptr() for x in xs] + [None] * (4 - len(xs))
    code = _build.lib().gvd_pack_heads(
        code, len(xs), *ptrs, out.data_ptr(), B, R, D, n_heads, D,
        _build.stream_of(xs[0]))
    _build.check(code, "pack_heads")
    return out


def mha_probs_dropout_plain(q, k, v, seed, *, n_heads: int, scale: float,
                            drop: float, row0: int = 0) -> torch.Tensor:
    """q, k, v (B, R, D); seed an int64 tensor of one element.  Returns
    the attention output (B, R, D) in q's dtype: per head
    softmax(q_h k_h^T / scale) with dropout at ``drop`` on the probs
    (kept where the hash is >= drop, scaled by 1 / (1 - drop); row b
    hashed as global row row0 + b), times v_h.  Differentiable by
    autograd."""
    B, R, D = q.shape
    inv_scale = 1.0 / scale
    Rp = -(-R // 128) * 128
    keep = 1.0 - drop
    outs = []
    for h, sl in enumerate(head_slices(D, n_heads)):
        p = torch.softmax(_head_scores(q, k, sl, inv_scale), dim=-1)
        if drop > 0.0:
            u = uniform_hash((Rp, Rp), seed,
                             _salts(B, h, n_heads, q.device, row0)
                             )[:, :R, :R]
            p = torch.where(u >= drop, p / keep, 0.0)
        outs.append((p @ v[..., sl].float()).to(q.dtype))
    return torch.cat(outs, dim=-1)


def _check(q, k, v, seed, n_heads):
    req = _build.require
    req(q.dim() == 3, f"q must be (B, R, D), got {tuple(q.shape)}")
    req(q.shape == k.shape == v.shape, "self-attention: q, k, v of one shape")
    req(q.dtype == k.dtype == v.dtype, "q, k, v must share one dtype")
    req(k.device == q.device and v.device == q.device
        and seed.device == q.device, "all inputs must be on one device")
    req(seed.dtype == torch.int64 and seed.numel() == 1,
        "seed must be one int64")
    req(-(-q.shape[-1] // n_heads) <= MAX_HEAD,
        f"a head is at most {MAX_HEAD} wide")
    _build.dtype_code(q)


def packed_scratch(n: int, q: torch.Tensor, n_heads: int):
    """Room for n packed copies of q's heads in q's dtype, which the
    kernels fill first."""
    B, R, D = q.shape
    return _pack_scratch(n, B, R, D, n_heads, q.device, q.dtype)


def count_route(q: torch.Tensor) -> None:
    """One count of ``TF32_ROUTE`` for an f32 attention launch."""
    if q.dtype == torch.float32:
        _build.launches[TF32_ROUTE] += 1


def attention_forward(q, k, v, seed, *, n_heads: int, scale: float,
                      drop: float, salt_base: int, salt_mul: int):
    """The forward kernel on CUDA tensors (B, R, D), the masks of (row b,
    head h) salted ``salt_base + b * salt_mul + h``: returns the output
    and the row log-sum-exp (B, heads, R) f32.  Counts only the f32
    route's launch (``count_route``): K4's and K5's wrappers count their
    own."""
    B, R, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, len(head_slices(D, n_heads)), R),
                      dtype=torch.float32, device=q.device)
    scratch = packed_scratch(3, q, n_heads)
    code = _build.lib().gvd_attention_train_fwd(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), seed.data_ptr(), scratch.data_ptr(),
        B, R, D, n_heads, 1.0 / scale, drop, salt_base, salt_mul,
        _build.stream_of(q))
    _build.check(code, "attention_train_fwd")
    count_route(q)
    return out, lse


def attention_backward(q, k, v, out, lse, seed, dout, *, n_heads: int,
                       scale: float, drop: float, salt_base: int,
                       salt_mul: int):
    """The backward kernels for ``attention_forward``'s output: dq, dk, dv
    in q's dtype.  Counts only the f32 route's launch."""
    B, R, D = q.shape
    dout = dout.contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty_like(lse)
    if q.dtype == torch.float32:
        # four packed copies, then dS^T (B, H, Rt, Rt) f32, which the f32
        # backward writes for its dQ product
        _, H, Rt, dp = _lib_packed_shape(B, R, D, n_heads)
        scratch = torch.empty(B * H * Rt * (4 * dp + Rt),
                              dtype=torch.float32, device=q.device)
    else:
        scratch = packed_scratch(4, q, n_heads)
    code = _build.lib().gvd_attention_train_bwd(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), seed.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        scratch.data_ptr(), B, R, D, n_heads, 1.0 / scale, drop,
        salt_base, salt_mul, _build.stream_of(q))
    _build.check(code, "attention_train_bwd")
    count_route(q)
    return dq, dk, dv


def _salt_base(n_heads: int, row0: int) -> int:
    """The salt of (row 0 of the call, head 0): global row row0."""
    return SITE_ATTN + row0 * max(n_heads, 8)


def _kernel_forward(q, k, v, seed, n_heads, scale, drop, row0):
    return attention_forward(q, k, v, seed, n_heads=n_heads, scale=scale,
                             drop=drop, salt_base=_salt_base(n_heads, row0),
                             salt_mul=max(n_heads, 8))


def _plain_forward(q, k, v, seed, n_heads, scale, drop, row0):
    """The plain forward of the hybrid schedule, with the row
    log-sum-exp that the backward kernel reads."""
    D = q.shape[-1]
    out = mha_probs_dropout_plain(q, k, v, seed, n_heads=n_heads,
                                  scale=scale, drop=drop, row0=row0)
    lse = torch.stack([
        torch.logsumexp(_head_scores(q, k, sl, 1.0 / scale), dim=-1)
        for sl in head_slices(D, n_heads)], dim=1)
    return out, lse


class _AttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed, n_heads, scale, drop, plain_forward,
                row0):
        if plain_forward:
            out, lse = _plain_forward(q, k, v, seed, n_heads, scale, drop,
                                      row0)
        else:
            out, lse = _kernel_forward(q, k, v, seed, n_heads, scale, drop,
                                       row0)
            _build.launches["attention_train_fwd"] += 1
        ctx.save_for_backward(q, k, v, out, lse, seed)
        ctx.args = (n_heads, scale, drop, row0)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, seed = ctx.saved_tensors
        n_heads, scale, drop, row0 = ctx.args
        dq, dk, dv = attention_backward(
            q, k, v, out, lse, seed, dout, n_heads=n_heads, scale=scale,
            drop=drop, salt_base=_salt_base(n_heads, row0),
            salt_mul=max(n_heads, 8))
        _build.launches["attention_train_bwd"] += 1
        return dq, dk, dv, None, None, None, None, None, None


def _dispatch(q, k, v, seed, n_heads, scale, drop, plain_forward, row0):
    if not q.is_cuda:
        return mha_probs_dropout_plain(q, k, v, seed, n_heads=n_heads,
                                       scale=scale, drop=drop, row0=row0)
    _check(q, k, v, seed, n_heads)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _AttentionTrain.apply(q, k, v, seed, n_heads, float(scale),
                                 float(drop), plain_forward, int(row0))


def mha_probs_dropout(q, k, v, seed, *, n_heads: int, scale: float,
                      drop: float, row0: int = 0) -> torch.Tensor:
    """Same contract as ``mha_probs_dropout_plain``.  A CPU tensor takes
    the plain version; a CUDA tensor runs the forward kernel, and its
    backward runs the backward kernels (one count each per call)."""
    return _dispatch(q, k, v, seed, n_heads, scale, drop, False, row0)


def mha_probs_dropout_hybrid(q, k, v, seed, *, n_heads: int, scale: float,
                             drop: float, row0: int = 0) -> torch.Tensor:
    """The JAX package's hybrid schedule: the plain forward (same masks)
    and the backward kernels.  A CPU tensor takes the plain version."""
    return _dispatch(q, k, v, seed, n_heads, scale, drop, True, row0)


def draw_seed(generator) -> torch.Tensor:
    """One dropout seed for a layer call: an int64 in [0, 2**32) on the
    generator's device, drawn without a host synchronisation.  A
    ``RowShard`` draws from its generator, the same seed on every
    rank."""
    generator = generator_of(generator)
    return torch.randint(0, 1 << 32, (1,), generator=generator,
                         device=generator.device, dtype=torch.int64)

