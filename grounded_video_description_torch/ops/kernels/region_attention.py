"""K3: per-token additive region attention, one fused kernel.

Replaces ``grounded_video_description_tpu/ops/pallas/region_attention.py
::fused_region_attention`` and keeps its public layout.  The CUDA source
is ``csrc/region_attention.cu``: each batch row's ROIs are split over the
blocks of one thread-block cluster; in each block, groups of warps (one
warp at D <= 1024) stream their share of the split's bank rows through
rings of asynchronous copies under an online softmax; the cluster's first
block merges the row's partial softmaxes in a fixed order.
``region_attention_plan`` is the launch plan, computed here so that the
CPU tests reach it: the splits per row and their ROI ranges, the warps of
a block and of a group, the ROIs of a ring slot, the ring's slots, the
copy route and the shared memory a block takes.
``region_attention_split_plain`` follows that plan in plain PyTorch (its
splits and groups, the online rescaling and the merge order), for the CPU
tests.

``fused_region_attention_plain`` is the same function in plain PyTorch
(f32 arithmetic, outputs in the input dtype), used for CPU tensors and as
the reference on the card.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, List, Optional, Tuple, Union

import torch

from grounded_video_description_torch.ops import MIN_VALUE
from grounded_video_description_torch.ops.kernels import _build

# csrc/region_attention.cu: the warps a block may have, the most blocks in
# a cluster (one row's splits; above 8 a non-portable size), the warps a
# group may have (each group a stream of its own), the columns of the
# weighted sum a thread may hold in groups of four, the ROIs a ring slot
# may hold, the bytes a slot aims at, the slots of a group's ring
# (kRingSlots), and the shared memory a block may take
BLOCK_WARPS = (4, 8)
MAX_SPLITS = 16
GROUP_WARPS = (1, 2, 4, 8)
COL_GROUPS = (1, 2, 4, 8)
MAX_D = 128 * GROUP_WARPS[-1] * COL_GROUPS[-1]
SLOT_ROIS = (1, 2)
SLOT_BYTES = 6144
RING_SLOTS = 2
# the f32 streams (warps) the plan runs at once: on an H100 at the
# flagship shape (k3_plans.py reads it), 800 streams ran faster than 1600
# in f32, and 1600 faster than 800 in bf16, whose bytes carry twice the
# tanh work each, so bf16 takes twice as many
STREAM_WARPS = 800
SMEM_MAX = 232448
# copy routes: the 1-D bulk copy (TMA) of a slot's two runs of rows, or,
# for bf16 rows that are not whole 16 bytes, cp.async by every thread of the
# group in 8-byte pieces
COPY_ROUTES = {"bulk": 0, "cp8": 8}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _round16(n: int) -> int:
    return _ceil(n, 16) * 16


def smem_bytes(H: int, D: int, itemsize: int, block_warps: int,
               group_warps: int, slot_rois: int) -> int:
    """csrc/region_attention.cu layout: the groups' rings (block_warps /
    group_warps groups of ``RING_SLOTS`` slots, a slot ``slot_rois`` ROIs'
    p_pool rows then their pool rows, each part 16-byte aligned), att_h and
    alpha_w in f32, the warps' partial scores (two buffers, room for eight
    warps) and the rings' mbarriers."""
    slot = (_round16(slot_rois * H * itemsize)
            + _round16(slot_rois * D * itemsize))
    rings = block_warps // group_warps * RING_SLOTS
    return (rings * slot + 2 * _round16(4 * H)
            + 2 * BLOCK_WARPS[-1] * SLOT_ROIS[-1] * 4 + _round16(8 * rings))


@dataclasses.dataclass(frozen=True)
class RegionPlan:
    """How ``csrc/region_attention.cu`` runs one call: one cluster of
    ``splits`` blocks per batch row, block s taking ROIs ``ranges()[s]``
    (``rois_per_split`` of them, fewer or none at the end); in a block of
    ``block_warps`` warps, ``groups`` groups of ``group_warps`` warps,
    group g taking every ``groups``-th run of ``slot_rois`` ROIs of the
    split from the g-th through its own ring of ``ring_slots`` slots (a
    run a slot), filled by the ``copy`` route (``bulk`` where rows are
    whole 16 bytes, else ``cp8``); each thread holds
    ``col_groups`` groups of four columns of the weighted sum.
    ``resident`` is how many blocks of the kernel the card holds at
    once."""
    B: int
    R: int
    H: int
    D: int
    itemsize: int
    block_warps: int
    group_warps: int
    slot_rois: int
    copy: str
    col_groups: int
    smem: int
    resident: int
    splits: int
    rois_per_split: int

    @property
    def ring_slots(self) -> int:
        return RING_SLOTS

    @property
    def groups(self) -> int:
        return self.block_warps // self.group_warps

    def ranges(self) -> List[Tuple[int, int]]:
        """Each split's ROI range [lo, hi); they cover [0, R) once, in
        order, and a split past the end holds no ROI."""
        rps = self.rois_per_split
        return [(min(self.R, s * rps), min(self.R, (s + 1) * rps))
                for s in range(self.splits)]

    def group_slots(self, split: int, group: int) -> List[range]:
        """The runs of ROIs (a ring slot each) that group ``group`` of
        block ``split`` streams, in order."""
        lo, hi = self.ranges()[split]
        k = self.slot_rois
        return [range(r, min(r + k, hi))
                for r in range(lo + k * group, hi, k * self.groups)]

    @property
    def blocks(self) -> int:
        return self.B * self.splits

    @property
    def waves(self) -> int:
        return _ceil(self.blocks, self.resident)


def region_attention_plan(B: int, R: int, H: int, D: int,
                          dtype: torch.dtype, *,
                          resident: Union[int, Callable[[int, int], int]],
                          max_clusters: Optional[
                              Callable[[int, int, int], int]] = None,
                          _group_warps: Optional[int] = None,
                          _splits: Optional[int] = None) -> RegionPlan:
    """The launch plan for banks p_pool (B, R, H) and pool (B, R, D) on a
    card that holds ``resident(block_warps, smem)`` blocks of the kernel
    at once and ``max_clusters(block_warps, smem, S)`` clusters of S of
    them (``card_plan`` reads both on the card; an int ``resident`` is the
    count for blocks of 8 warps, twice it for blocks of 4, and without
    ``max_clusters`` the card holds ``resident // S`` clusters).

    Groups are of one warp where a lane's 32 columns cover D (D <= 1024),
    else of as few warps as cover it; each keeps ``RING_SLOTS`` slots of as
    many ROIs as fit ``SLOT_BYTES`` (at least one).  The block size and the
    splits of a row then set how many warps stream at once: all B x S
    blocks resident in one wave (at most ``MAX_SPLITS`` splits, and no
    more than give every group of a split a slot), with the total of warps
    nearest ``STREAM_WARPS`` (f32; bf16 twice as many), ties to the larger
    block and then to fewer splits.  Each split holds a whole number of
    slots per group but the last.  ``_group_warps`` and ``_splits`` force
    those choices, for the tests of groups of several warps and of empty
    splits."""
    req = _build.require
    req(dtype in (torch.float32, torch.bfloat16),
        f"kernels take float32 or bfloat16, not {dtype}")
    req(1 <= B <= 65535 and R >= 1,
        f"B {B} must be in 1..65535 and R {R} at least 1")
    req(H >= 4 and D >= 4 and H % 4 == 0 and D % 4 == 0,
        "the kernel reads 4 elements at a time: "
        f"H={H} and D={D} must be positive multiples of 4")
    req(D <= MAX_D, f"D={D}: a block holds at most {MAX_D} columns of the "
        "weighted sum (32 a thread)")
    itemsize = 4 if dtype == torch.float32 else 2
    aligned = (H * itemsize) % 16 == 0 and (D * itemsize) % 16 == 0
    copy = "bulk" if aligned else "cp8"
    group_warps = _group_warps
    if group_warps is None:
        group_warps = next(g for g in GROUP_WARPS
                           if 128 * g * COL_GROUPS[-1] >= D)
    req(group_warps in GROUP_WARPS,
        f"group_warps {group_warps} not in {GROUP_WARPS}")
    col_groups = next((v for v in COL_GROUPS if 128 * group_warps * v >= D),
                      None)
    req(col_groups is not None, f"groups of {group_warps} warps cover at "
        f"most {128 * group_warps * COL_GROUPS[-1]} columns, not D={D}")
    slot_rois = max(k for k in SLOT_ROIS
                    if k == 1 or k * (H + D) * itemsize <= SLOT_BYTES)
    if isinstance(resident, int):
        per_8 = resident

        def resident(wb, smem):
            return per_8 * BLOCK_WARPS[-1] // wb
    if max_clusters is None:
        def max_clusters(wb, smem, s):
            return resident(wb, smem) // s
    target = STREAM_WARPS * 4 // itemsize
    best = None
    for wb in (wb for wb in BLOCK_WARPS if wb >= group_warps):
        smem = smem_bytes(H, D, itemsize, wb, group_warps, slot_rois)
        if smem > SMEM_MAX or resident(wb, smem) < 1:
            continue
        run = wb // group_warps * slot_rois  # a slot for every group
        if _splits is None:
            top = max(1, min(MAX_SPLITS, resident(wb, smem) // B,
                             _ceil(R, run)))
            options = [s for s in range(1, top + 1)
                       if s == 1 or max_clusters(wb, smem, s) >= B]
        else:
            options = [_splits]
        for s in options:
            # nearest the target warps; then the larger block, fewer splits
            key = (abs(math.log(B * s * wb / target)), -wb, s)
            if best is None or key < best[0]:
                best = (key, wb, s, smem, run)
    req(best is not None,
        f"rings of {RING_SLOTS} slots at H={H}, D={D} take more shared "
        f"memory than a block may have ({SMEM_MAX} bytes) or the card holds")
    _, block_warps, splits, smem, run = best
    req(1 <= splits <= MAX_SPLITS, f"splits {splits}")
    rps = _ceil(_ceil(R, splits), run) * run
    return RegionPlan(B=B, R=R, H=H, D=D, itemsize=itemsize,
                      block_warps=block_warps, group_warps=group_warps,
                      slot_rois=slot_rois, copy=copy,
                      col_groups=col_groups, smem=smem,
                      resident=resident(block_warps, smem), splits=splits,
                      rois_per_split=rps)


def _plan_args(p: RegionPlan) -> tuple:
    return (p.splits, p.rois_per_split, p.block_warps, p.group_warps,
            p.slot_rois, COPY_ROUTES[p.copy], p.col_groups, p.smem)


@functools.lru_cache(maxsize=None)
def _max_clusters(device: int, code: int, copy: int, slot_rois: int,
                  col_groups: int, block_warps: int, splits: int,
                  smem: int) -> int:
    """The occupancy query on the current device, ``device``."""
    n = _build.lib().gvd_region_attention_max_clusters(
        code, copy, slot_rois, col_groups, block_warps, splits, smem)
    if n < 0:
        raise RuntimeError(f"the occupancy query of region_attention failed: "
                           f"cudaError {-n}")
    return n


def card_plan(B: int, R: int, H: int, D: int,
              dtype: torch.dtype) -> RegionPlan:
    """``region_attention_plan`` with the current card's own numbers: the
    blocks it holds at once (one occupancy query for the plan's kernel and
    shared memory) and, for each cluster size tried, the clusters of it
    (cudaOccupancyMaxActiveClusters).  The plan of a shape is made once
    for each card and kept."""
    return _card_plan_of(B, R, H, D, dtype, torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _card_plan_of(B, R, H, D, dtype, device) -> RegionPlan:
    return _card_plan(B, R, H, D, dtype)


def _card_plan(B, R, H, D, dtype) -> RegionPlan:
    """``card_plan``, made anew from the module's constants."""
    probe = region_attention_plan(B, R, H, D, dtype, resident=1)
    key = (torch.cuda.current_device(), _build.DTYPE_CODES[dtype],
           COPY_ROUTES[probe.copy], probe.slot_rois, probe.col_groups)
    return region_attention_plan(
        B, R, H, D, dtype,
        resident=lambda wb, smem: _max_clusters(*key, wb, 1, smem),
        max_clusters=lambda wb, smem, s: _max_clusters(*key, wb, s, smem))


def fused_region_attention_plain(p_pool_feats, att_h, pool_feats, alpha_w,
                                 alpha_b, att_mask, pnt_mask
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p_pool_feats (B, R, H); att_h (B, H); pool_feats (B, R, D);
    alpha_w with H elements; alpha_b with one; masks (B, R) bool, True =
    masked.  Returns (att_res (B, D), grd_logits (B, R)) in
    p_pool_feats' dtype."""
    f32 = torch.float32
    H = p_pool_feats.shape[-1]
    dot = torch.tanh(p_pool_feats.to(f32) + att_h.to(f32)[:, None, :])
    scores = dot @ alpha_w.to(f32).reshape(H) + alpha_b.to(f32).reshape(())
    scores = scores.masked_fill(att_mask, MIN_VALUE)
    grd = scores.masked_fill(pnt_mask, MIN_VALUE)
    weight = torch.softmax(scores, dim=1)
    att_res = torch.einsum("br,brd->bd", weight, pool_feats.to(f32))
    out_dtype = p_pool_feats.dtype
    return att_res.to(out_dtype), grd.to(out_dtype)


def region_attention_split_plain(p_pool_feats, att_h, pool_feats, alpha_w,
                                 alpha_b, att_mask, pnt_mask,
                                 plan: RegionPlan
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_region_attention_plain`` computed as the planned kernel
    computes it: per split and group, its slots in order, each whose max
    raises the running max rescaling the running normalizer and weighted
    sum (the max starts at -inf; a group or split with no ROI keeps it
    there and adds nothing); then the row's partials merged under their
    common max, split by split and group by group."""
    f32 = torch.float32
    B, R, H = p_pool_feats.shape
    D = pool_feats.shape[-1]
    _build.require((B, R, H, D) == (plan.B, plan.R, plan.H, plan.D),
                   "the plan's shapes")
    pp, pool = p_pool_feats.to(f32), pool_feats.to(f32)
    ah = att_h.to(f32)
    w, b0 = alpha_w.to(f32).reshape(H), alpha_b.to(f32).reshape(())
    dev = pp.device
    scores = (torch.tanh(pp + ah[:, None, :]) @ w) + b0
    scores = scores.masked_fill(att_mask, MIN_VALUE)
    grd = scores.masked_fill(pnt_mask, MIN_VALUE)
    parts = []
    for split in range(plan.splits):
        for group in range(plan.groups):
            m = torch.full((B,), float("-inf"), dtype=f32, device=dev)
            l = torch.zeros((B,), dtype=f32, device=dev)
            acc = torch.zeros((B, D), dtype=f32, device=dev)
            for rois in plan.group_slots(split, group):
                s = scores[:, rois.start:rois.stop]
                mx = s.max(dim=1).values
                up = mx > m
                scale = torch.exp(m - mx)
                l = torch.where(up, l * scale, l)
                acc = torch.where(up[:, None], acc * scale[:, None], acc)
                m = torch.maximum(m, mx)
                p = torch.exp(s - m[:, None])
                for k in range(len(rois)):
                    l = l + p[:, k]
                for k, r in enumerate(rois):
                    acc = acc + p[:, k, None] * pool[:, r]
            parts.append((m, l, acc))
    top = torch.stack([m for m, _, _ in parts]).max(dim=0).values
    total = torch.zeros((B,), dtype=f32, device=dev)
    out = torch.zeros((B, D), dtype=f32, device=dev)
    for m, l, acc in parts:
        weight = torch.exp(m - top)
        total = total + l * weight
        out = out + acc * weight[:, None]
    dt = p_pool_feats.dtype
    return (out / total[:, None]).to(dt), grd.to(dt)


def _mask_rows(mask: torch.Tensor) -> torch.Tensor:
    """The mask itself where its ROIs lie one byte apart (the model's
    ``[:, 1:]`` views do), else a contiguous copy; the kernel takes the
    row stride."""
    return mask if mask.stride(-1) == 1 else mask.contiguous()


def fused_region_attention(p_pool_feats, att_h, pool_feats, alpha_w,
                           alpha_b, att_mask, pnt_mask
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``fused_region_attention_plain``.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel on
    ``card_plan``'s plan.  No backward: an input that requires grad raises
    under grad mode."""
    _build.refuse_grad("region_attention", p_pool_feats, att_h, pool_feats,
                       alpha_w, alpha_b)
    if not p_pool_feats.is_cuda:
        return fused_region_attention_plain(
            p_pool_feats, att_h, pool_feats, alpha_w, alpha_b, att_mask,
            pnt_mask)
    B, R, H = p_pool_feats.shape
    D = pool_feats.shape[-1]
    dt = p_pool_feats.dtype
    req = _build.require
    req(att_h.shape == (B, H), f"att_h {tuple(att_h.shape)} != {(B, H)}")
    req(pool_feats.shape[:2] == (B, R), "pool_feats batch/ROI shape")
    req(att_mask.shape == (B, R) and pnt_mask.shape == (B, R), "mask shape")
    req(att_mask.dtype == torch.bool and pnt_mask.dtype == torch.bool,
        "masks must be bool")
    req(att_h.dtype == dt and pool_feats.dtype == dt,
        "p_pool_feats, att_h and pool_feats must share one dtype")
    req(alpha_w.numel() == H and alpha_b.numel() == 1, "alpha shapes")
    dev = p_pool_feats.device
    for t in (att_h, pool_feats, alpha_w, alpha_b, att_mask, pnt_mask):
        req(t.device == dev, "all inputs must be on one device")
    return _launch(p_pool_feats, att_h, pool_feats, alpha_w, alpha_b,
                   att_mask, pnt_mask, card_plan(B, R, H, D, dt))


def _launch(p_pool_feats, att_h, pool_feats, alpha_w, alpha_b, att_mask,
            pnt_mask, plan: RegionPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on ``plan``, for CUDA inputs that
    ``fused_region_attention`` has checked (k3_plans.py times other plans
    through it)."""
    B, R, H = p_pool_feats.shape
    D = pool_feats.shape[-1]
    dt, dev = p_pool_feats.dtype, p_pool_feats.device
    _build.require((plan.B, plan.R, plan.H, plan.D) == (B, R, H, D)
                   and plan.itemsize == p_pool_feats.element_size(),
                   "the plan was made for other shapes or another dtype")
    p_pool_feats = _build.aligned16(p_pool_feats)
    att_h = att_h.contiguous()
    pool_feats = _build.aligned16(pool_feats)
    aw = alpha_w.to(torch.float32).reshape(H).contiguous()
    ab = alpha_b.to(torch.float32).reshape(1).contiguous()
    am, pm = _mask_rows(att_mask), _mask_rows(pnt_mask)
    att_res = torch.empty((B, D), dtype=dt, device=dev)
    grd = torch.empty((B, R), dtype=dt, device=dev)
    code = _build.lib().gvd_region_attention(
        _build.dtype_code(p_pool_feats), p_pool_feats.data_ptr(),
        att_h.data_ptr(), pool_feats.data_ptr(), aw.data_ptr(),
        ab.data_ptr(), am.data_ptr(), pm.data_ptr(), att_res.data_ptr(),
        grd.data_ptr(), B, R, H, D, am.stride(0), pm.stride(0),
        *_plan_args(plan), _build.stream_of(p_pool_feats))
    _build.check(code, "region_attention")
    _build.launches["region_attention"] += 1
    return att_res, grd
