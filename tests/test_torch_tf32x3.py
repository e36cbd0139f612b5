"""The arithmetic of the f32 attention kernels (csrc/attention_tf32x3.cu),
on the CPU: TF32 rounding as ``cvt.rna.tf32.f32`` does it (the kernels'
hi), the tensor cores' cut of an f32 operand (their lo), the 3xTF32
product, and a tiled emulation of the kernels' forward and backward in
their tile order, held at the f32 bars that the kernels meet on the card
(chip_smoke.py: 1e-4 for K4's output and gradients, 1e-5 for K7)."""

from __future__ import annotations

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import math

import numpy as np
import pytest
import torch

from grounded_video_description_torch.ops.kernels.attention_train import (
    SITE_ATTN, mha_probs_dropout_plain, mm_3xtf32, split_tf32, tf32_round,
    tf32_trunc, uniform_hash)
from grounded_video_description_torch.ops.kernels.mha import (
    flash_self_attention_plain)

FWD_KEYS, TILE = 32, 64       # the forward's key tile, the dK / dV tiles
DQ_KEYS = 32                  # the dQ product's key tile


def _bits(x: torch.Tensor) -> list:
    return [int(v) for v in x.numpy().view(np.uint32)]


# (input bits, bits after rounding to 10 mantissa bits, ties away from 0)
ROUNDING = [
    (0x3F800FFF, 0x3F800000),     # below half: down
    (0x3F801000, 0x3F802000),     # a tie, even below: away from zero
    (0x3F803000, 0x3F804000),     # a tie, odd below: away from zero
    (0xBF801000, 0xBF802000),     # a negative tie: away from zero
    (0xBF800FFF, 0xBF800000),
    (0x00000FFF, 0x00000000),     # subnormals round in the same bits
    (0x00001000, 0x00002000),
    (0x007FF000, 0x00800000),     # the largest subnormals round up to normal
    (0x7F7FFFFF, 0x7F800000),     # past TF32's range: inf
    (0x7F800000, 0x7F800000),     # inf stays
    (0xFF800000, 0xFF800000),
    (0x00000000, 0x00000000),
    (0x80000000, 0x80000000),
]


@pytest.mark.parametrize("src,want", ROUNDING)
def test_tf32_round_bit_patterns(src, want):
    x = torch.from_numpy(np.array([src], dtype=np.uint32).view(np.float32))
    assert _bits(tf32_round(x)) == [want]


@pytest.mark.parametrize("src,want", [
    (0x3F801FFF, 0x3F800000), (0xBF801FFF, 0xBF800000),
    (0x00001FFF, 0x00000000), (0x7F800000, 0x7F800000)])
def test_tf32_trunc_bit_patterns(src, want):
    """The tensor cores' reading of an f32 operand: the low 13 bits cut."""
    x = torch.from_numpy(np.array([src], dtype=np.uint32).view(np.float32))
    assert _bits(tf32_trunc(x)) == [want]


def test_tf32_split_is_exact_to_21_bits():
    """hi holds 11 significant bits, lo the next 11 as the tensor cores
    read it: hi + lo is x to ~2^-21 relative, and both halves are TF32
    values."""
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.standard_normal(4096).astype(np.float32) * 7.0)
    hi, lo = split_tf32(x)
    assert torch.equal(tf32_round(hi), hi) and torch.equal(tf32_round(lo), lo)
    assert all(b & 0x1FFF == 0 for b in _bits(hi) + _bits(lo))
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -20


@pytest.mark.parametrize("K", [171, 1000])
def test_split_product_is_f32_accurate(K):
    """At the head width and at R as contraction depth, 3xTF32 is within
    1e-6 of max |ref| of the f64 product (f32 itself reads ~4e-7); one
    plain TF32 product misses 1e-4."""
    g = np.random.default_rng(K)
    a = g.standard_normal((64, K)).astype(np.float32)
    b = g.standard_normal((K, 64)).astype(np.float32)
    ref = torch.from_numpy(a.astype(np.float64) @ b.astype(np.float64))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    top = float(ref.abs().max())
    err3 = float((mm_3xtf32(at, bt).double() - ref).abs().max()) / top
    err1 = float(((tf32_round(at) @ tf32_round(bt)).double() - ref).abs()
                 .max()) / top
    assert err3 <= 1e-6, err3
    assert err1 > 1e-4, err1


def _keep(R: int, seed: torch.Tensor, drop: float):
    """The kept-prob scale of (batch row 0, head 0) of a one-head call."""
    if drop == 0.0:
        return None
    Rp = -(-R // 128) * 128
    u = uniform_hash((Rp, Rp), seed, torch.tensor([SITE_ATTN]))[0, :R, :R]
    return torch.where(u >= drop, 1.0 / (1.0 - drop), 0.0)


def emulate_forward(q, k, v, keep, inv_scale):
    """The forward kernel's arithmetic for one head, (R, d) f32: 32-key
    tiles in order, an online softmax over the undropped probs, each
    product in 3xTF32.  Returns o and the row log-sum-exp."""
    R = q.shape[0]
    m = torch.full((R,), -math.inf)
    l = torch.zeros(R)
    o = torch.zeros_like(q)
    for k0 in range(0, R, FWD_KEYS):
        ks = slice(k0, min(k0 + FWD_KEYS, R))
        s = mm_3xtf32(q, k[ks].T) * inv_scale
        m_new = torch.maximum(m, s.max(dim=1).values)
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        l = l * corr + p.sum(dim=1)
        if keep is not None:
            p = p * keep[:, ks]
        o = o * corr[:, None] + mm_3xtf32(p, v[ks])
        m = m_new
    return o / l[:, None], m + torch.log(l)


def emulate_backward(q, k, v, o, lse, dout, keep, inv_scale):
    """The backward kernels' arithmetic for one head: delta = rowsum(dO o);
    per 64-key tile, over the 64-query tiles in order, S^T and dP^T, P
    recomputed from lse, dV and dK, and dS^T kept; then dQ = dS K over
    32-key tiles in order.  Each product in 3xTF32."""
    R = q.shape[0]
    delta = (dout * o).sum(dim=1)
    tiles = [slice(i, min(i + TILE, R)) for i in range(0, R, TILE)]
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    ds_t = torch.zeros(R, R)                  # (key, query)
    for ks in tiles:
        for qs in tiles:
            st = mm_3xtf32(k[ks], q[qs].T) * inv_scale
            dpt = mm_3xtf32(v[ks], dout[qs].T)
            p = torch.exp(st - lse[None, qs])
            mk = keep[qs, ks].T if keep is not None else torch.ones_like(p)
            ds = p * (mk * dpt - delta[None, qs]) * inv_scale
            ds_t[ks, qs] = ds
            dv[ks] += mm_3xtf32(p * mk, dout[qs])
            dk[ks] += mm_3xtf32(ds, q[qs])
    for qs in tiles:
        for k0 in range(0, R, DQ_KEYS):
            ks = slice(k0, min(k0 + DQ_KEYS, R))
            dq[qs] += mm_3xtf32(ds_t[ks, qs].T, k[ks])
    return dq, dk, dv


@pytest.mark.parametrize("drop", [0.2, 0.0])
def test_emulated_kernels_meet_k4_f32_bars(drop):
    """One flagship-depth head (B = 1, R = 1000, d = 171, K4's scale
    sqrt(1024)): the emulated 3xTF32 output and q/k/v gradients are within
    1e-4 of the plain twin's autograd on the same masks."""
    R, d = 1000, 171
    g = np.random.default_rng(3)
    q, k, v, w = (torch.from_numpy(g.standard_normal((1, R, d))
                                   .astype(np.float32)) for _ in range(4))
    seed = torch.tensor([0x9E3779B9])
    inv_scale = 1.0 / 32.0
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = mha_probs_dropout_plain(*leaves, seed, n_heads=1, scale=32.0,
                                  drop=drop)
    grads = torch.autograd.grad(ref, leaves, w)
    keep = _keep(R, seed, drop)
    o, lse = emulate_forward(q[0], k[0], v[0], keep, inv_scale)
    got = (o,) + emulate_backward(q[0], k[0], v[0], o, lse, w[0], keep,
                                  inv_scale)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got,
                          (ref.detach(),) + grads):
        err = float((a - b[0]).abs().max())
        assert err <= 1e-4, (name, err)


def test_emulated_forward_meets_k7_f32_bar():
    """K7's launch (q pre-scaled by 1/sqrt(1024), no dropout, inv_scale 1)
    at one flagship head: within 1e-5 of the plain version."""
    R, d = 1000, 171
    g = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(g.standard_normal((1, R, d))
                                .astype(np.float32)) for _ in range(3))
    q = q / 32.0
    ref = flash_self_attention_plain(q, k, v)
    o, _ = emulate_forward(q[0], k[0], v[0], None, 1.0)
    assert float((o - ref[0]).abs().max()) <= 1e-5
