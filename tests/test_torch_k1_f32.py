"""K1's f32 route on the CPU: a tiled emulation of its 3xTF32 GEMM
(csrc/encoder_layer.cu gemm_tf32x3_kernel) in the kernel's K order, held
against float64 at K1's f32 GEMM bar (1e-4, chip_smoke.py and
tests/test_torch_cuda.py), and the attention route K1 takes for each head
width (``encoder_layer.attention_route``)."""

from __future__ import annotations

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from grounded_video_description_torch.ops.kernels.attention_train import (
    MAX_HEAD, mm_3xtf32, packed_width, split_tf32)
from grounded_video_description_torch.ops.kernels.encoder_layer import (
    ATTENTION_ROUTES, WIDEST_F32_HEAD, attention_route)

TBM, TBN, FBK = 128, 128, 32      # the kernel's tiles and chunk depth


def emulate_gemm_tf32x3(a, w, bias, relu):
    """C = A W^T (+ bias, ReLU) as the kernel computes it: K zero-padded
    to a multiple of 4 (the wrapper), output tiles of TBM x TBN, K in
    chunks of FBK and within them 16-deep steps, each step's six TF32
    products (two 8-deep halves, operands split into hi + lo) in a fresh
    f32 sum that is added to the tile's running sum, then the bias and
    the ReLU in f32."""
    K = a.shape[1]
    if K % 4:
        a, w = F.pad(a, (0, -K % 4)), F.pad(w, (0, -K % 4))
        K = a.shape[1]
    M, N = a.shape[0], w.shape[0]
    c = torch.empty(M, N)
    for m0 in range(0, M, TBM):
        for n0 in range(0, N, TBN):
            at, wt = a[m0:m0 + TBM], w[n0:n0 + TBN]
            acc = torch.zeros(at.shape[0], wt.shape[0])
            for k0 in range(0, K, FBK):
                for kk in range(k0, min(k0 + FBK, K), 16):
                    step = mm_3xtf32(at[:, kk:kk + 8], wt[:, kk:kk + 8].T)
                    step = step + mm_3xtf32(at[:, kk + 8:kk + 16],
                                            wt[:, kk + 8:kk + 16].T)
                    acc = acc + step
            c[m0:m0 + TBM, n0:n0 + TBN] = acc
    if bias is not None:
        c = c + bias
    return torch.relu(c) if relu else c


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("M,N,K", [(160, 136, 512), (131, 130, 1024),
                                   (70, 40, 77)])
def test_emulated_tf32x3_gemm_meets_k1_f32_bar(M, N, K, relu):
    """At the card test's operand scales (A ~ N(0, 1), W ~ N(0, 0.01),
    bias ~ N(0, 1)), M and N past one tile and ragged, K = 512, 1024 and
    77 (padded to 80): within 1e-4 of the float64 product; one plain TF32
    product is not."""
    g = np.random.default_rng(K + M)
    a = torch.from_numpy(g.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy((g.standard_normal((N, K)) * 0.1).astype(np.float32))
    bias = torch.from_numpy(g.standard_normal(N).astype(np.float32))
    ref = a.double() @ w.double().T + bias.double()
    ref = torch.relu(ref) if relu else ref
    got = emulate_gemm_tf32x3(a, w, bias, relu)
    assert float((got.double() - ref).abs().max()) <= 1e-4
    one = split_tf32(a)[0] @ split_tf32(w)[0].T + bias
    one = torch.relu(one) if relu else one
    assert float((one.double() - ref).abs().max()) > 1e-4


def test_emulated_gemm_splits_both_operands():
    """The emulation splits each operand: feeding it the TF32 parts of A
    and W (whose lo is zero) gives the plain TF32 product of those parts,
    so the lo terms are what carry A and W past TF32."""
    g = np.random.default_rng(1)
    a = torch.from_numpy(g.standard_normal((40, 64)).astype(np.float32))
    w = torch.from_numpy(g.standard_normal((24, 64)).astype(np.float32))
    ah, wh = split_tf32(a)[0], split_tf32(w)[0]
    got = emulate_gemm_tf32x3(ah, wh, None, False)
    assert float((got.double() - ah.double() @ wh.double().T).abs().max()) \
        <= 1e-5
    full = emulate_gemm_tf32x3(a, w, None, False)
    assert float((full - got).abs().max()) > 1e-4


@pytest.mark.parametrize("head", [64, 96, 128, 171, 176, 192, 193, 200, 256])
def test_k1_f32_attention_route_by_head_width(head):
    """f32 heads up to the widest packed width (192) run the 3xTF32
    forward, which has a packed slot for them; 193-256 the SIMT kernel,
    for which no packed width exists.  Each route has its own count."""
    route = attention_route(torch.float32, head)
    if head <= MAX_HEAD:
        assert route == "tf32x3" and packed_width(head) >= head
    else:
        assert route == "simt"
        with pytest.raises(ValueError):
            packed_width(head)
    assert ATTENTION_ROUTES[route].startswith("encoder_layer_attention_")
    assert len(set(ATTENTION_ROUTES.values())) == len(ATTENTION_ROUTES)


@pytest.mark.parametrize("head", [64, 171, 192])
def test_k1_bf16_attention_route(head):
    assert attention_route(torch.bfloat16, head) == "mma"


@pytest.mark.parametrize("dtype,head", [(torch.float32, WIDEST_F32_HEAD + 1),
                                        (torch.bfloat16, MAX_HEAD + 1)])
def test_k1_attention_route_refuses_wider_heads(dtype, head):
    with pytest.raises(ValueError):
        attention_route(dtype, head)
