"""K2: the bidirectional GRU / LSTM recurrence, one kernel for all T steps.

Replaces ``grounded_video_description_tpu/ops/pallas/birnn.py
::birnn_recurrence`` and keeps its public layout.  The CUDA source is
``csrc/birnn.cu``: one thread-block cluster per (direction, batch tile),
W_hh resident in the cluster's shared memory, h pushed to every block
through distributed shared memory; the product on the tensor cores in
bf16 (route "mma"), on the SIMT units in f32 (route "simt").
``birnn_plan`` is the launch plan, computed here so that the CPU tests
reach it: the route, the cluster size, the batch tile, the units per
block, the K-split widths, the resident rows of W_hh and the shared
memory a block takes.

``birnn_recurrence_plain`` is the same recurrence as a Python loop over
time (f32 gate math and f32 carry, outputs in the input dtype), used for
CPU tensors, on the model's plain path, under autograd in training (the
kernel has no backward) and as the reference on the card.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from grounded_video_description_torch.ops.kernels import _build

MODE_CODES = {"bigru": 0, "bilstm": 1}

# csrc/birnn.cu: the shared memory a block may take, the instantiated
# rows per thread (SIMT route), the most hidden units a block takes, the
# threads of a block and the (row, unit) pairs a thread carries through
# the gates (tensor-core route), and the route codes
SMEM_MAX = 232448
ROWS_PER_THREAD = (4, 8, 13, 17, 25)
MAX_UNITS = 64
THREADS, MAX_PAIRS = 256, 8
ROUTES = {"simt": 0, "mma": 1}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def k_splits(Up: int) -> int:
    """K-splits of a block of ``Up`` units (csrc/birnn.cu k_splits): its 8
    warps are the unit groups of 32 lanes x 2 row groups x the K-splits."""
    return 4 // _ceil(Up, 32)


def _round_up(a: int, b: int) -> int:
    return _ceil(a, b) * b


@dataclasses.dataclass(frozen=True)
class BirnnPlan:
    """How ``csrc/birnn.cu`` runs one call.  ``route`` "mma" (bf16, when
    W_hh and the tile's h fit whole): the product on the tensor cores, W_hh
    (NP, KW) n-major with KW = KR the units padded to 64, ``rpt`` the m16
    tiles of a batch tile.  ``route`` "simt": ``clusters`` clusters of
    ``C`` blocks (2 directions x ``n_tiles`` batch tiles of ``tile``
    rows); block c owns hidden units [c Up, c Up + Up) (the last ones
    past H are padding); each of the KS K-splits covers ``KW`` rows of
    W_hh, of which the first ``KR`` stay in shared memory and the rest
    stream from L2 at every step; every block holds the whole h of its
    tile, (tile, KS KW) f32, into which each block pushes its slice."""
    B: int
    H: int
    route: str
    n_gates: int
    itemsize: int
    C: int
    tile: int
    n_tiles: int
    Up: int
    KW: int
    KR: int
    rpt: int
    smem: int
    max_clusters: int

    @property
    def KS(self) -> int:
        return k_splits(self.Up)

    @property
    def clusters(self) -> int:
        return 2 * self.n_tiles

    @property
    def waves(self) -> int:
        """Rounds of clusters the card runs one after another (1 when
        every cluster is resident at once)."""
        return _ceil(self.clusters, max(self.max_clusters, 1))

    @property
    def resident_bytes(self) -> int:
        """W_hh a block holds in shared memory."""
        if self.route == "mma":
            return _mma_np(self.n_gates, self.Up) * self.KW * 2
        return self.KS * self.KR * self.n_gates * self.Up * self.itemsize

    def units(self, c: int) -> range:
        return range(min(c * self.Up, self.H), min((c + 1) * self.Up, self.H))

    def rows(self, tile: int) -> range:
        return range(min(tile * self.tile, self.B),
                     min((tile + 1) * self.tile, self.B))

    @property
    def streamed_rows(self) -> int:
        """Rows of W_hh (of H) read from L2 at every step."""
        if self.route == "mma":
            return 0
        return sum(max(0, min(s * self.KW + self.KW, self.H)
                       - (s * self.KW + self.KR))
                   for s in range(self.KS))

    @property
    def stream_share(self) -> float:
        return self.streamed_rows / self.H

    def describe(self) -> str:
        return (f"{self.route}, C {self.C}, tile {self.tile} x "
                f"{self.n_tiles}, clusters "
                f"{self.clusters} (max {self.max_clusters}, waves "
                f"{self.waves}), units/block {self.Up}, resident "
                f"{self.resident_bytes / 1024:.1f} KB/block of "
                f"{self.smem / 1024:.1f} KB, streamed rows "
                f"{self.streamed_rows}/{self.H}, "
                + ("m16 tiles" if self.route == "mma" else "rows/thread")
                + f" {self.rpt}")


def cluster_size(H: int) -> int:
    """Blocks per cluster: 16 (the most a Hopper cluster takes, non-
    portable) above 256 units, else the fewest that give a block at most
    32 units (one lane per unit)."""
    if H > 256:
        return 16
    C = 1
    while _ceil(H, C) > 32:
        C *= 2
    return C


def _smem_bytes(bt, rpt, Up, KW, KR, n_gates, lstm, itemsize) -> int:
    """csrc/birnn.cu smem_bytes: resident W, the tile's whole h (with the
    zero rows that the row groups' last reads reach), the new slice, c
    (LSTM), gi, and the K-split partials."""
    KS = k_splits(Up)
    w = KS * KR * n_gates * Up * itemsize
    hfull = (_ceil(bt, 2) + rpt) * KS * KW * 4
    slice_ = bt * Up * 4
    cell = slice_ if lstm else 0
    gbuf = _round_up(bt * n_gates * Up * itemsize, 16)
    red = KS * bt * Up * 4
    return w + hfull + slice_ + cell + gbuf + red


def _mma_np(n_gates: int, Up: int) -> int:
    return _round_up(n_gates * Up, 16)


def _mma_smem_bytes(bt, C, Up, n_gates, gru) -> int:
    """csrc/birnn.cu mma_smem_bytes: W_hh (NP, KP) bf16, the tile's h (bt,
    KP + 8) f32, pre (bt, NP) f32, the new slice, gi, the GRU's b_hh."""
    NP, KP = _mma_np(n_gates, Up), _round_up(C * Up, 64)
    return (NP * KP * 2 + bt * (KP + 8) * 4 + bt * NP * 4 + bt * Up * 4
            + _round_up(bt * n_gates * Up * 2, 16)
            + (n_gates * Up * 4 if gru else 0))


def birnn_plan(B: int, H: int, mode: str, dtype: torch.dtype,
               max_clusters: int) -> BirnnPlan:
    """The launch plan for gi (T, 2, B, nH) on a card that holds
    ``max_clusters`` clusters of it at once (``card_plan`` reads that
    number on the card).  The batch is cut into as many tiles as fit
    resident (at most max_clusters / 2 per direction), each at most 2 x 25
    rows.  bf16 takes the tensor cores where W_hh and the tile's h fit in
    shared memory whole; otherwise (and in f32) the SIMT route, W_hh
    resident as far as shared memory allows."""
    if mode not in MODE_CODES:
        raise ValueError(f"unknown mode {mode!r}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")
    if dtype == torch.bfloat16 and H % 2:
        raise ValueError("the bf16 kernel takes an even hidden size")
    if B < 1 or H < 1:
        raise ValueError(f"B {B}, H {H}")
    n_gates = 3 if mode == "bigru" else 4
    itemsize = 4 if dtype == torch.float32 else 2
    C = cluster_size(H)
    Up = _round_up(_ceil(H, C), 4)
    if Up > MAX_UNITS:
        raise ValueError(f"hidden size {H} over {16 * MAX_UNITS}")
    KS = k_splits(Up)
    bt_max = 2 * ROWS_PER_THREAD[-1]
    n_tiles = max(_ceil(B, bt_max), min(max_clusters // 2, B))
    bt = _ceil(B, n_tiles)
    n_tiles = _ceil(B, bt)
    common = dict(B=B, H=H, n_gates=n_gates, itemsize=itemsize, C=C,
                  tile=bt, n_tiles=n_tiles, Up=Up,
                  max_clusters=max_clusters)
    if dtype == torch.bfloat16 and bt <= 64 and bt * Up <= (
            THREADS * MAX_PAIRS):
        smem = _mma_smem_bytes(bt, C, Up, n_gates, mode == "bigru")
        if smem <= SMEM_MAX:
            KP = _round_up(C * Up, 64)
            return BirnnPlan(route="mma", KW=KP, KR=KP, rpt=_ceil(bt, 16),
                             smem=smem, **common)
    rpt = min(r for r in ROWS_PER_THREAD if r >= _ceil(bt, 2))
    KW = _round_up(_ceil(C * Up, KS), 4)
    lstm = mode == "bilstm"
    fixed = _smem_bytes(bt, rpt, Up, KW, 0, n_gates, lstm, itemsize)
    per_row = KS * n_gates * Up * itemsize
    if fixed > SMEM_MAX:
        raise ValueError(f"no plan fits B {B}, H {H}, {mode}, {dtype}")
    KR = min(KW, (SMEM_MAX - fixed) // per_row // 4 * 4)
    return BirnnPlan(route="simt", KW=KW, KR=KR, rpt=rpt,
                     smem=fixed + KR * per_row, **common)


def _plan_args(p: BirnnPlan):
    return (ROUTES[p.route], p.C, p.tile, p.Up, p.KW, p.KR, p.rpt, p.smem)


@functools.lru_cache(maxsize=None)
def _max_clusters(device: int, code: int, mode: int, H: int,
                  args: tuple) -> int:
    """The occupancy query on the current device, ``device``."""
    n = _build.lib().gvd_birnn_max_clusters(code, mode, H, *args)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                           f"cudaError {-n}")
    return n


def card_plan(B: int, H: int, mode: str, dtype: torch.dtype) -> BirnnPlan:
    """``birnn_plan`` with ``max_clusters`` read on the card
    (cudaOccupancyMaxActiveClusters for the plan's own kernel and shared
    memory): from the finest tiling, replanned with the count the card
    gives until every cluster of the plan is resident at once.  The
    answers are kept per card."""
    code, m = _build.DTYPE_CODES[dtype], MODE_CODES[mode]
    n = 2 * B
    for _ in range(4):
        plan = birnn_plan(B, H, mode, dtype, max_clusters=n)
        got = _max_clusters(torch.cuda.current_device(), code, m, H,
                            _plan_args(plan))
        if plan.clusters <= got:
            return dataclasses.replace(plan, max_clusters=got)
        n = got
    return plan


def birnn_recurrence_plain(gi: torch.Tensor, wh: torch.Tensor,
                           bh: Optional[torch.Tensor], *, mode: str,
                           hidden: int) -> torch.Tensor:
    """gi (T, 2, B, G) input projections (+bias), lane 1 time-reversed;
    wh (2, H, G); bh (2, G) for the GRU, None for the LSTM.
    Returns ys (T, 2, B, H), lane 1 still in reversed time."""
    K, B = gi.shape[1:3]
    f32 = torch.float32
    whf = wh.to(f32)
    bhf = bh.to(f32)[:, None, :] if mode == "bigru" else None
    h = torch.zeros((K, B, hidden), dtype=f32, device=gi.device)
    c = torch.zeros_like(h)
    ys = []
    # one cast and one unbind for all steps: under autograd, gi[t] per
    # step would give back a zero-filled gradient of all of gi, summed T
    # times, and a cast per step doubles the small launches
    for g_in in gi.to(f32).unbind(0):
        gh = torch.bmm(h, whf)                                 # (2, B, G)
        if mode == "bigru":
            gh = gh + bhf
            ir, iz, in_ = g_in.chunk(3, dim=-1)
            hr, hz, hn = gh.chunk(3, dim=-1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            n = torch.tanh(in_ + r * hn)
            h = (1.0 - z) * n + z * h
        else:
            i, f, g, o = (g_in + gh).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys).to(gi.dtype)


def _launch(gi, wh, bh, mode, hidden, exchange_only) -> torch.Tensor:
    req = _build.require
    req(mode in MODE_CODES, f"unknown mode {mode!r}")
    T, K, B, G = gi.shape
    n_gates = 3 if mode == "bigru" else 4
    req(K == 2 and G == n_gates * hidden, f"gi {tuple(gi.shape)}")
    req(wh.shape == (2, hidden, G), f"wh {tuple(wh.shape)}")
    req(wh.dtype == gi.dtype and wh.device == gi.device, "wh dtype/device")
    if mode == "bigru":
        req(bh is not None and bh.shape == (2, G), "GRU needs bh (2, G)")
        req(bh.dtype == gi.dtype and bh.device == gi.device,
            "bh dtype/device")
    code = _build.dtype_code(gi)
    plan = card_plan(B, hidden, mode, gi.dtype)
    gi = gi.contiguous()
    wh = wh.contiguous()
    bh_c = bh.contiguous() if mode == "bigru" else None
    out = torch.empty((T, 2, B, hidden), dtype=gi.dtype, device=gi.device)
    err = _build.lib().gvd_birnn_recurrence(
        code, MODE_CODES[mode], gi.data_ptr(), wh.data_ptr(),
        _build.ptr(bh_c), out.data_ptr(), T, B, hidden, *_plan_args(plan),
        int(exchange_only), _build.stream_of(gi))
    _build.check(err, "birnn_recurrence")
    return out


def birnn_recurrence(gi: torch.Tensor, wh: torch.Tensor,
                     bh: Optional[torch.Tensor], *, mode: str,
                     hidden: int) -> torch.Tensor:
    """Same contract as ``birnn_recurrence_plain``.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel on
    ``card_plan``'s clusters.  No backward: an input that requires grad
    raises under grad mode."""
    _build.refuse_grad("birnn_recurrence", gi, wh, bh)
    if not gi.is_cuda:
        return birnn_recurrence_plain(gi, wh, bh, mode=mode, hidden=hidden)
    out = _launch(gi, wh, bh, mode, hidden, exchange_only=False)
    _build.launches["birnn_recurrence"] += 1
    return out


def birnn_exchange(gi: torch.Tensor, wh: torch.Tensor,
                   bh: Optional[torch.Tensor], *, mode: str,
                   hidden: int) -> None:
    """The kernel of ``birnn_recurrence`` on the same plan, running only
    its per-step exchange of h through distributed shared memory and the
    cluster barrier (no product, no gates, its output unwritten): for
    timing what the T dependent steps cost by themselves.  CUDA tensors
    only; counts no launch."""
    _build.require(gi.is_cuda, "birnn_exchange runs on the card only")
    with torch.no_grad():
        _launch(gi, wh, bh, mode, hidden, exchange_only=True)
