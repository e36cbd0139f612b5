"""PyTorch port, K4 (the obj_interact attention in training): the counter
hash bit for bit against the JAX package's, and the kernel's plain twin
against the Pallas primitive ``mha_probs_dropout`` in interpret mode on the
CPU, forward and q/k/v gradients, with six uneven heads.  The CUDA kernels
are tested against the twin on the card by tests/test_torch_cuda.py."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_description_tpu.models.transformer import _split_heads
from grounded_video_description_tpu.ops.pallas.attention_train import (
    mha_probs_dropout as pallas_mha_probs_dropout)
from grounded_video_description_tpu.ops.pallas.encoder_layer_train import (
    uniform_hash as jax_uniform_hash)
from grounded_video_description_torch.ops.kernels import _build
from grounded_video_description_torch.ops.kernels.attention_train import (
    MMA_TILE, draw_seed, mha_probs_dropout, mha_probs_dropout_hybrid,
    mha_probs_dropout_plain, pack_heads, pack_heads_plain, packed_shape,
    packed_width, uniform_hash)
from grounded_video_description_torch.ops.kernels.encoder_layer import (
    head_slices)

# int32 seeds as the JAX primitive takes them: 0, small, negative, the
# int32 extremes
SEEDS = [0, 7, -987654321, 2 ** 31 - 1, -2 ** 31]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("salt,Rp", [(0x40000000, 128),
                                      (0x40000000 + 8 * 29 + 5, 1024),
                                      (0xFFFFFFFF, 256)])
def test_uniform_hash_bit_equal_to_jax(seed, salt, Rp):
    """Every uniform of the (Rp, Rp) tile equal bit for bit; the port's
    int64 seed carries the int32 seed's low 32 bits."""
    ref = np.asarray(jax_uniform_hash((Rp, Rp), jnp.int32(seed),
                                      np.uint32(salt)))
    got = uniform_hash((Rp, Rp), torch.tensor([seed]),
                       torch.tensor(salt)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_uniform_hash_batches_salts():
    salts = torch.tensor([[1, 2], [3, 0x40000000]])
    seed = torch.tensor([12345])
    batched = uniform_hash((16, 128), seed, salts)
    assert batched.shape == (2, 2, 16, 128)
    for i in range(2):
        for j in range(2):
            assert torch.equal(batched[i, j],
                               uniform_hash((16, 128), seed, salts[i, j]))


# B = 2, R = 200 (Rp = 256), D = 64 in six heads (11 x 5 + 9)
B, R, D, H = 2, 200, 64, 6
SEED = -123456789


def _inputs():
    rng = np.random.RandomState(0)
    q, k, v, w = (rng.randn(B, R, D).astype(np.float32) for _ in range(4))
    return q, k, v, w


def _pallas(q, k, v, drop):
    """The Pallas primitive in interpret mode, on the JAX package's
    layout: heads split and zero-padded to 11, (B, H, R, 11)."""
    def heads(x):
        return jnp.moveaxis(_split_heads(x, H), 2, 1)

    o = pallas_mha_probs_dropout(heads(q), heads(k), heads(v),
                                 jnp.int32(SEED), math.sqrt(D), drop, True)
    return jnp.moveaxis(o, 1, 2).reshape(B, R, -1)[..., :D]


@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_twin_matches_pallas_interpret(drop):
    """Forward and q/k/v gradients of sum(out * w) within 1e-5 (f32, the
    same masks, sums in another order)."""
    q, k, v, w = _inputs()
    ref = np.asarray(_pallas(q, k, v, drop))
    jgrads = jax.grad(lambda a, b, c: jnp.sum(_pallas(a, b, c, drop) * w),
                      argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = mha_probs_dropout_plain(*leaves, torch.tensor([SEED]), n_heads=H,
                                  scale=math.sqrt(D), drop=drop)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5)
    for name, leaf, g in zip("qkv", leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   atol=1e-5, err_msg=f"d{name}")


def test_twin_masks_follow_the_seed():
    """One seed, one output; another seed, other masks; about 30% of the
    probs dropped at drop 0.3 (a prob's share of the output moves)."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs())
    kw = dict(n_heads=H, scale=math.sqrt(D), drop=0.3)
    a = mha_probs_dropout_plain(q, k, v, torch.tensor([1]), **kw)
    b = mha_probs_dropout_plain(q, k, v, torch.tensor([1]), **kw)
    c = mha_probs_dropout_plain(q, k, v, torch.tensor([2]), **kw)
    assert torch.equal(a, b) and not torch.allclose(a, c, atol=1e-3)
    u = uniform_hash((256, 256), torch.tensor([1]), torch.tensor(5))
    assert abs(float((u[:R, :R] < 0.3).float().mean()) - 0.3) < 0.01


def test_wrappers_take_the_twin_on_cpu():
    """On CPU tensors both schedules are the twin, gradients included, and
    no kernel is launched; a generator-drawn seed is an int64 in
    [0, 2**32)."""
    q, k, v, w = (torch.from_numpy(x) for x in _inputs())
    seed = draw_seed(torch.Generator().manual_seed(0))
    assert seed.dtype == torch.int64 and 0 <= int(seed) < 2 ** 32
    kw = dict(n_heads=H, scale=math.sqrt(D), drop=0.3)
    _build.reset_launches()
    results = []
    for fn in (mha_probs_dropout_plain, mha_probs_dropout,
               mha_probs_dropout_hybrid):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, seed, **kw)
        (out * w).sum().backward()
        results.append([out.detach()] + [t.grad for t in leaves])
    assert not _build.launches
    for got in results[1:]:
        for a, b in zip(got, results[0]):
            assert torch.equal(a, b)


# (B, R, D, n_heads): the flagship's uneven heads (171 x 5 + 169), this
# file's (11 x 5 + 9), six heads of 20, one odd head of 171 (K7's call)
PACK_SHAPES = [(2, 70, 1024, 6), (2, 200, 64, 6), (1, 65, 120, 6),
               (3, 10, 171, 1)]


@pytest.mark.parametrize("shape", PACK_SHAPES)
def test_pack_heads_plain_matches_jax_split_heads(shape):
    """The bf16 kernels' head-major operands equal the JAX package's head
    split, moved to (B, H, R, d) and zero-padded to (Rt, dp)."""
    B, R, D, H = shape
    x = np.random.RandomState(1).randn(B, R, D).astype(np.float32)
    ref = np.moveaxis(np.asarray(_split_heads(jnp.asarray(x), H)), 2, 1)
    _, Hp, Rt, dp = packed_shape(B, R, D, H, packed_width(-(-D // H)))
    assert ref.shape[1] == Hp and Rt % MMA_TILE == 0 and Rt - R < MMA_TILE
    ref = np.pad(ref, [(0, 0), (0, 0), (0, Rt - R), (0, dp - ref.shape[-1])])
    np.testing.assert_array_equal(
        pack_heads_plain(torch.from_numpy(x), H).numpy(), ref)


@pytest.mark.parametrize("shape", PACK_SHAPES)
def test_pack_heads_round_trip_and_zero_pads(shape):
    """Each head's slot holds its column range, every pad is zero, and the
    columns read back give the input; on CPU tensors ``pack_heads`` is the
    plain version for each tensor and launches nothing."""
    B, R, D, H = shape
    rng = np.random.RandomState(2)
    xs = [torch.from_numpy(rng.randn(B, R, D).astype(np.float32))
          .to(torch.bfloat16) for _ in range(3)]
    _build.reset_launches()
    packed = pack_heads(xs, H)
    assert not _build.launches
    assert packed.shape == (3,) + packed_shape(B, R, D, H,
                                               packed_width(-(-D // H)))
    assert packed.dtype == torch.bfloat16
    for x, p in zip(xs, packed):
        assert torch.equal(p, pack_heads_plain(x, H))
        back = torch.cat([p[:, h, :R, :sl.stop - sl.start]
                          for h, sl in enumerate(head_slices(D, H))], dim=-1)
        assert torch.equal(back, x)
        pad = torch.ones_like(p, dtype=torch.bool)
        for h, sl in enumerate(head_slices(D, H)):
            pad[:, h, :R, :sl.stop - sl.start] = False
        assert not bool(p[pad].any())


@pytest.mark.parametrize("head,width", [(1, 64), (16, 64), (64, 64),
                                        (65, 128), (128, 128), (171, 176),
                                        (176, 176), (177, 192), (192, 192)])
def test_packed_width(head, width):
    assert packed_width(head) == width


def test_packed_width_refuses_wider_heads():
    with pytest.raises(ValueError):
        packed_width(193)
