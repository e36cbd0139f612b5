"""PyTorch port, geometry and losses: the same inputs (numpy, seeded)
through the JAX function and its port, f32 on the CPU, including the
degenerate-box conventions and the cls BCE's where-guard at p = 0."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_description_tpu import losses as jlosses
from grounded_video_description_tpu.ops import geometry as jgeo
from grounded_video_description_torch import losses as tlosses
from grounded_video_description_torch.ops import geometry as tgeo


def _boxes(rng, B, N, frames=3):
    x1 = rng.uniform(0, 500, (B, N))
    y1 = rng.uniform(0, 300, (B, N))
    w = rng.uniform(1, 200, (B, N))
    h = rng.uniform(1, 100, (B, N))
    b = np.stack([x1, y1, x1 + w, y1 + h,
                  rng.randint(0, frames, (B, N)),
                  rng.randint(1, 9, (B, N))], axis=-1).astype(np.float32)
    return b


def test_bbox_overlaps_and_targets_match_jax():
    """IoU with a frame mask, a degenerate (1 x 1) GT box (column 0) and a
    degenerate proposal (row -1); sim_mat_target and bbox_target exactly
    equal."""
    rng = np.random.RandomState(0)
    B, N, K = 2, 40, 6
    ppls, gt = _boxes(rng, B, N), _boxes(rng, B, K)
    gt[:, 2:4] = ppls[:, 5:7] + rng.uniform(-3, 3, (B, 2, 6)).astype(
        np.float32) * [1, 1, 1, 1, 0, 0]              # two good overlaps
    gt[0, 1, 2:4] = gt[0, 1, 0:2]                     # 1 x 1 GT box
    ppls[1, 3, 2:4] = ppls[1, 3, 0:2]                 # 1 x 1 proposal
    frm = ppls[:, :, None, 4] != gt[:, None, :, 4]
    ref = np.asarray(jgeo.bbox_overlaps(jnp.asarray(ppls), jnp.asarray(gt),
                                        jnp.asarray(frm)))
    got = tgeo.bbox_overlaps(torch.from_numpy(ppls), torch.from_numpy(gt),
                             torch.from_numpy(frm))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    assert np.all(got.numpy()[0, :, 1] == 0)
    assert np.all(got.numpy()[1, 3, :] == -1)
    assert (ref > 0.5).sum() > 0
    labels = gt[:, :, 5]
    np.testing.assert_array_equal(
        tgeo.sim_mat_target(got, torch.from_numpy(labels)).numpy(),
        np.asarray(jgeo.sim_mat_target(jnp.asarray(ref),
                                       jnp.asarray(labels))))
    mask = rng.rand(B, K) < 0.5
    np.testing.assert_array_equal(
        tgeo.bbox_target(torch.from_numpy(mask), got).numpy(),
        np.asarray(jgeo.bbox_target(jnp.asarray(mask), jnp.asarray(ref))))


def test_lm_criterion_matches_jax():
    """The three masked means (END position counted) and the two counts:
    values within 1e-5 relative (a masked logit of -1e8 inside the ROI
    mask makes the grounding mean ~1e6, summed in f32 in another order)
    and input gradients within 1e-6."""
    rng = np.random.RandomState(1)
    B, S, V, R = 3, 7, 11, 9
    decoded = np.log(rng.dirichlet(np.ones(V), (B, S))).astype(np.float32)
    att2 = rng.randn(B, S, R).astype(np.float32)
    grd = rng.randn(B, S, R).astype(np.float32)
    grd[0, 0, :3] = -1e8                              # masked logits
    target = rng.randint(0, V, (B, S))
    target[1, 4:] = 0
    roi = (rng.rand(B, S, R) < 0.3).astype(np.float32)

    def jf(d, a, g):
        out = jlosses.lm_criterion_with_counts(d, a, g, jnp.asarray(target),
                                               jnp.asarray(roi))
        return sum(out[:3]), out

    (jsum, jout), jg = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                          has_aux=True)(decoded, att2, grd)
    leaves = [torch.tensor(x, requires_grad=True)
              for x in (decoded, att2, grd)]
    out = tlosses.lm_criterion_with_counts(
        *leaves, torch.from_numpy(target), torch.from_numpy(roi))
    sum(out[:3]).backward()
    for a, b in zip(out, jout):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-5)
    for leaf, g in zip(leaves, jg):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   atol=1e-6)


@pytest.mark.parametrize("case", ["regular", "zero_prob"])
def test_cls_criterion_matches_jax_with_where_guard(case):
    """Mean of min(-log p[target], 100) over non-zero targets.  A p of
    exactly 0 (and a denormal one) gives exactly 100 with zero gradient,
    never NaN: the where-guard, not an epsilon floor."""
    rng = np.random.RandomState(2)
    B, C, K, R = 2, 5, 3, 6
    probs = rng.dirichlet(np.ones(C), (B, R)).transpose(0, 2, 1)
    probs = probs.astype(np.float32)
    target = rng.randint(0, C, (B, K, R))
    target[0, 1, 2] = 2
    target[1, 0, 4] = 3
    if case == "zero_prob":
        probs[0, 2, 2] = 0.0
        probs[1, 3, 4] = 1e-45
    jloss, jgrad = jax.value_and_grad(
        lambda p: jlosses.cls_criterion_with_counts(
            p, jnp.asarray(target))[0])(probs)
    p = torch.tensor(probs, requires_grad=True)
    loss, count = tlosses.cls_criterion_with_counts(p,
                                                    torch.from_numpy(target))
    loss.backward()
    assert float(count) == float((target > 0).sum())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    assert torch.isfinite(p.grad).all()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), atol=1e-6)
    if case == "zero_prob":
        assert float(p.grad[0, 2, 2]) == 0.0 and float(p.grad[1, 3, 4]) == 0.0
        gathered = torch.from_numpy(probs).gather(
            1, torch.from_numpy(target)).numpy()[target > 0]
        zero = gathered <= 0
        want = np.where(zero, 100.0, np.minimum(
            -np.log(np.where(zero, 1.0, gathered)), 100.0)).mean()
        np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-6)


@pytest.mark.parametrize("disable_caption", [False, True])
def test_total_loss_matches_jax(disable_caption):
    vals = [np.float32(x) for x in (2.5, 0.7, 1.3, 0.2)]
    kw = dict(w_att2=0.05, w_grd=0.0, w_cls=0.1,
              disable_caption=disable_caption)
    ref = jlosses.total_loss(*(jnp.asarray(v) for v in vals), **kw)
    got = tlosses.total_loss(*(torch.tensor(v) for v in vals), **kw)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-7)
