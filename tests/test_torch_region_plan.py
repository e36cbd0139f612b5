"""PyTorch port, K3's launch plan (ops/kernels/region_attention.py::
region_attention_plan), on the CPU: the splits of each row and their ROI
ranges, the ring's stages, the copy route and the shared memory that
csrc/region_attention.cu is launched with.  The kernel itself runs only on
the card (tests/test_torch_cuda.py); here the plan is held to what the
kernel needs, and a plain emulation of the planned kernel (its splits, the
online rescaling, the merge order) is held against the plain version and
against the Pallas kernel in interpret mode."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grounded_video_description_tpu.ops.pallas.region_attention import (
    RT as PALLAS_RT, fused_region_attention as pallas_region_attention)
from grounded_video_description_torch.ops.kernels import region_attention as ra
from grounded_video_description_torch.ops.kernels.region_attention import (
    fused_region_attention_plain, region_attention_plan,
    region_attention_split_plain)

DTYPES = [torch.float32, torch.bfloat16]
# an H100 SXM holds 2 blocks of the flagship plan an SM: 132 x 2
RESIDENT = 264


def _ceil(a, b):
    return -(-a // b)


def _check_plan(p):
    """What csrc/region_attention.cu needs of a plan."""
    # the splits cover [0, R) once, in order, each a whole number of runs
    # (one slot for every group) but the last one that holds ROIs
    rois = [r for lo, hi in p.ranges() for r in range(lo, hi)]
    assert rois == list(range(p.R))
    run = p.groups * p.slot_rois
    assert p.rois_per_split % run == 0
    sizes = [hi - lo for lo, hi in p.ranges()]
    live = [n for n in sizes if n]
    assert all(n == p.rois_per_split for n in live[:-1])
    assert sizes == live + [0] * (len(sizes) - len(live))
    # inside a split the groups' slots cover it once, in runs of slot_rois
    for s, (lo, hi) in enumerate(p.ranges()):
        got = sorted(r for g in range(p.groups)
                     for run_ in p.group_slots(s, g) for r in run_)
        assert got == list(range(lo, hi))
        for g in range(p.groups):
            assert all(0 < len(x) <= p.slot_rois
                       for x in p.group_slots(s, g))
    assert p.block_warps in ra.BLOCK_WARPS
    assert p.group_warps in ra.GROUP_WARPS
    assert p.groups * p.group_warps == p.block_warps
    assert p.slot_rois in ra.SLOT_ROIS and p.ring_slots >= 2
    assert 128 * p.group_warps * p.col_groups >= p.D
    assert p.col_groups in ra.COL_GROUPS
    assert p.smem <= ra.SMEM_MAX
    assert p.smem == ra.smem_bytes(p.H, p.D, p.itemsize, p.block_warps,
                                   p.group_warps, p.slot_rois)
    rings = p.groups * p.ring_slots * p.slot_rois * (p.H + p.D) * p.itemsize
    assert p.groups * (4 + p.D) * 4 <= rings     # the merge's partials fit
    assert 1 <= p.splits <= ra.MAX_SPLITS


@pytest.mark.parametrize("resident", [132, RESIDENT, 528])
@pytest.mark.parametrize("R", [10, 300, 1000])
@pytest.mark.parametrize("B", [1, 5, 100])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_covers_fits_and_is_resident(dtype, B, R, resident):
    p = region_attention_plan(B, R, 512, 1024, dtype, resident=resident)
    _check_plan(p)
    # every block resident in one wave (an int resident counts blocks of
    # 8 warps: blocks of 4 fit twice as many)
    assert p.resident == resident * 8 // p.block_warps and p.waves == 1
    run = p.groups * p.slot_rois
    top = min(ra.MAX_SPLITS, max(1, p.resident // B), _ceil(R, run))
    assert 1 <= p.splits <= top
    # as many streaming warps as the target asks, as far as the splits go
    target = ra.STREAM_WARPS * 4 // p.itemsize
    warps = p.blocks * p.block_warps
    assert (target / 2 <= warps <= 2 * target or p.splits == top
            or p.splits == 1)
    assert p.copy == "bulk" and p.group_warps == 1 and p.col_groups == 8


@pytest.mark.parametrize("dtype,S,K", [(torch.float32, 1, 1),
                                       (torch.bfloat16, 2, 2)])
def test_flagship_plan(dtype, S, K):
    """B = 100 on an H100 that holds 264 blocks of 8 warps: one f32 split
    (800 one-warp streams), two bf16 splits (1600); slots of 6 KB (one f32
    ROI, two bf16), two slots a stream, two blocks' shared memory an
    SM."""
    p = region_attention_plan(100, 1000, 512, 1024, dtype,
                              resident=RESIDENT)
    _check_plan(p)
    assert (p.block_warps, p.splits, p.slot_rois, p.ring_slots) == (
        8, S, K, 2)
    assert p.blocks * p.block_warps == ra.STREAM_WARPS * 4 // p.itemsize
    assert p.rois_per_split == _ceil(_ceil(1000, S), 8 * K) * 8 * K
    assert K * (512 + 1024) * p.itemsize == ra.SLOT_BYTES
    assert 2 * (p.smem + 1024) <= 233472        # the SM's 228 KB


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 5])
def test_small_batches_take_the_cap(B, dtype):
    p = region_attention_plan(B, 1000, 512, 1024, dtype, resident=RESIDENT)
    assert p.splits == ra.MAX_SPLITS and p.block_warps == 8


def test_empty_split_and_groups():
    """R = 20 over 4 forced splits of 16 (8 one-warp groups, slots of two
    ROIs): 16 + 4 ROIs, two splits hold none, and in the second split six
    of the eight groups hold none."""
    p = region_attention_plan(1, 20, 32, 64, torch.float32, resident=4,
                              _splits=4)
    _check_plan(p)
    assert (p.block_warps, p.group_warps, p.slot_rois) == (8, 1, 2)
    assert p.ranges() == [(0, 16), (16, 20), (20, 20), (20, 20)]
    assert [len(p.group_slots(1, g)) for g in range(8)] == [1, 1] + [0] * 6


def test_cluster_residency_lowers_the_splits():
    """Fewer clusters of S resident than rows: the plan takes no such S
    (bf16 at B = 50 would take 4 splits of 8 warps)."""
    held = {4: 45, 3: 49, 2: 132}
    p = region_attention_plan(50, 1000, 512, 1024, torch.bfloat16,
                              resident=RESIDENT,
                              max_clusters=lambda wb, smem, s: held.get(s, 0))
    assert (p.splits, p.block_warps) == (2, 8)
    p = region_attention_plan(50, 1000, 512, 1024, torch.bfloat16,
                              resident=RESIDENT)
    assert p.blocks * p.block_warps == 1600


def test_wide_columns_take_groups_of_warps():
    p = region_attention_plan(3, 200, 64, 2052, torch.float32,
                              resident=RESIDENT)
    _check_plan(p)
    assert p.group_warps == 4 and p.col_groups == 8
    p = region_attention_plan(3, 200, 64, ra.MAX_D, torch.bfloat16,
                              resident=RESIDENT)
    _check_plan(p)
    assert p.group_warps == 8 and p.col_groups == 8


def test_copy_routes_and_refusals():
    # bf16 rows of 8-byte multiples (H = 36) take the 8-byte cp.async;
    # f32 rows of 4-element multiples are whole 16 bytes: the bulk copy
    p = region_attention_plan(2, 50, 36, 64, torch.bfloat16,
                              resident=RESIDENT)
    assert p.copy == "cp8"
    p = region_attention_plan(2, 50, 36, 64, torch.float32,
                              resident=RESIDENT)
    assert p.copy == "bulk"
    with pytest.raises(ValueError, match="multiples of 4"):
        region_attention_plan(2, 50, 34, 64, torch.float32,
                              resident=RESIDENT)
    with pytest.raises(ValueError, match="at most"):
        region_attention_plan(2, 50, 32, ra.MAX_D + 4, torch.float32,
                              resident=RESIDENT)
    with pytest.raises(ValueError, match="at least 1"):
        region_attention_plan(2, 0, 32, 64, torch.float32,
                              resident=RESIDENT)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        region_attention_plan(2, 50, 32, 64, torch.float16,
                              resident=RESIDENT)
    # two slots of one f32 ROI at H = 16384, D = 8192 (96 KB each) and
    # att_h, alpha_w (128 KB) outgrow a block's shared memory
    with pytest.raises(ValueError, match="shared memory"):
        region_attention_plan(2, 50, 16384, 8192, torch.float32,
                              resident=RESIDENT)


def _inputs(B, R, H, D, seed, *, full_row=False, masked_split=None):
    """Seeded numpy inputs; ``masked_split`` = (row, lo, hi) masks those
    ROIs of a live row (att and pnt)."""
    rng = np.random.RandomState(seed)
    x = dict(p_pool=rng.randn(B, R, H), att_h=rng.randn(B, H),
             pool=rng.randn(B, R, D), alpha_w=rng.randn(H, 1) * 0.1,
             alpha_b=np.array([0.05]))
    x = {k: v.astype(np.float32) for k, v in x.items()}
    att = rng.rand(B, R) < 0.2
    pnt = att | (rng.rand(B, R) < 0.2)
    if full_row:
        att[0] = pnt[0] = True
    if masked_split is not None:
        row, lo, hi = masked_split
        att[row, lo:hi] = pnt[row, lo:hi] = True
    return x, att, pnt


def _torch_args(x, att, pnt):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    return (t["p_pool"], t["att_h"], t["pool"], t["alpha_w"], t["alpha_b"],
            torch.from_numpy(att), torch.from_numpy(pnt))


# (B, R, plan overrides, full_row, masked split): R = 300 and 1000 at
# narrow widths; a fully masked row; a fully masked split inside a live
# row (split 1 of row 2); empty splits and groups (R = 10 over 4 splits);
# groups of two warps.  At these widths a slot holds two ROIs.
CASES = [(3, 300, dict(resident=12), True, (2, 1)),
         (3, 1000, dict(resident=9), False, (2, 1)),
         (2, 1000, dict(resident=528), True, None),
         (3, 10, dict(resident=12, _splits=4), True, None),
         (4, 256, dict(resident=12, _group_warps=2), True, (1, 2)),
         (3, 333, dict(resident=12), False, (0, 1))]


def _plan(B, R, H, D, kw):
    return region_attention_plan(B, R, H, D, torch.float32, **kw)


@pytest.mark.parametrize("B,R,kw,full_row,masked", CASES)
def test_split_emulation_matches_plain(B, R, kw, full_row, masked):
    H, D = 32, 64
    plan = _plan(B, R, H, D, kw)
    ms = None
    if masked is not None:
        row, s = masked
        ms = (row, *plan.ranges()[s])
        assert ms[2] > ms[1]
    x, att, pnt = _inputs(B, R, H, D, 0, full_row=full_row, masked_split=ms)
    if R == 10:
        assert plan.ranges()[-1] == (10, 10)     # an empty split
    args = _torch_args(x, att, pnt)
    res, grd = region_attention_split_plain(*args, plan)
    ref_res, ref_grd = fused_region_attention_plain(*args)
    np.testing.assert_allclose(res.numpy(), ref_res.numpy(), atol=1e-5)
    np.testing.assert_allclose(grd.numpy(), ref_grd.numpy(), atol=1e-5)
    assert np.all(np.isfinite(res.numpy()))
    if full_row:          # uniform over the row's R ROIs
        np.testing.assert_allclose(res[0].numpy(),
                                   x["pool"][0].mean(axis=0), atol=1e-5)


@pytest.mark.parametrize("B,R,kw,full_row,masked", CASES)
def test_split_emulation_matches_pallas(B, R, kw, full_row, masked):
    """The Pallas kernel pads R to its tile with masked ROIs, which join a
    fully masked row's uniform weights: such rows are compared only where
    R is a multiple of the tile."""
    H, D = 32, 64
    full_row = full_row and R % PALLAS_RT == 0
    plan = _plan(B, R, H, D, kw)
    ms = None if masked is None else (masked[0], *plan.ranges()[masked[1]])
    x, att, pnt = _inputs(B, R, H, D, 1, full_row=full_row, masked_split=ms)
    ref_res, ref_grd = pallas_region_attention(
        jnp.asarray(x["p_pool"]), jnp.asarray(x["att_h"]),
        jnp.asarray(x["pool"]), jnp.asarray(x["alpha_w"]),
        jnp.asarray(x["alpha_b"]), jnp.asarray(att), jnp.asarray(pnt),
        interpret=True)
    res, grd = region_attention_split_plain(*_torch_args(x, att, pnt), plan)
    np.testing.assert_allclose(res.numpy(), np.asarray(ref_res), atol=1e-5)
    np.testing.assert_allclose(grd.numpy(), np.asarray(ref_grd), atol=1e-3)


def test_split_emulation_one_roi_slots():
    """f32 rows of H + D = 800 elements: a slot holds one ROI (the
    flagship f32 plan's slots), a fully masked row and a fully masked
    split in a live row."""
    B, R, H, D = 3, 300, 32, 768
    plan = region_attention_plan(B, R, H, D, torch.float32, resident=12)
    _check_plan(plan)
    assert plan.slot_rois == 1 and plan.splits > 1
    x, att, pnt = _inputs(B, R, H, D, 3, full_row=True,
                          masked_split=(2, *plan.ranges()[1]))
    args = _torch_args(x, att, pnt)
    res, grd = region_attention_split_plain(*args, plan)
    ref_res, ref_grd = fused_region_attention_plain(*args)
    np.testing.assert_allclose(res.numpy(), ref_res.numpy(), atol=1e-5)
    np.testing.assert_allclose(grd.numpy(), ref_grd.numpy(), atol=1e-5)


def test_split_emulation_returns_input_dtype():
    x, att, pnt = _inputs(2, 40, 8, 8, 2)
    plan = region_attention_plan(2, 40, 8, 8, torch.bfloat16, resident=8)
    args = _torch_args(x, att, pnt)
    bf = [a.to(torch.bfloat16) if i < 3 else a for i, a in enumerate(args)]
    res, grd = region_attention_split_plain(*bf, plan)
    assert res.dtype == grd.dtype == torch.bfloat16


def test_mask_views_pass_by_their_row_stride():
    """The model's [:, 1:] mask views reach the kernel as they are (no
    copy); a mask whose ROIs are not one byte apart is copied."""
    m = torch.zeros(3, 11, dtype=torch.bool)
    view = m[:, 1:]
    assert ra._mask_rows(view) is view and view.stride(0) == 11
    t = torch.zeros(10, 3, dtype=torch.bool).t()
    got = ra._mask_rows(t)
    assert got.is_contiguous() and torch.equal(got, t)
