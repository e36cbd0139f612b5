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
CPU tensors, on the model's plain path, under autograd on the CPU in
training, and as the reference on the card.

``birnn_recurrence_train`` is the training route, an autograd Function in
f32 whose forward and backward are each one launch a layer: the forward is
the SIMT cluster kernel on ``card_plan``'s plan, storing each step's gates
besides; the backward (``birnn_backward_kernel``) runs the steps in
reverse on the same plan, each block forming the gate gradients of its
own units and reduce-scattering its share of dh W_hh^T through DSMEM;
dW_hh and db_hh are one product and one sum over all T B rows after it.
Its plain twins, ``birnn_forward_train_plain`` and
``birnn_backward_plain``, take CPU tensors.  There is no TPU kernel of it:
the JAX package trains this recurrence with an XLA scan.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from grounded_video_description_torch.ops.kernels import _build

MODE_CODES = {"bigru": 0, "bilstm": 1}
# gate values a step saves for the backward (csrc/birnn.cu saved_gates):
# the GRU's r, z, n and W_hn h + b_hn; the LSTM's i, f, g, o and c
SAVED_GATES = {"bigru": 4, "bilstm": 5}
# the backward's inputs per (row, unit) of a step (bwd_inputs): dy, the
# saved gates, h_{t-1} and the LSTM's c_{t-1}
BWD_INPUTS = {"bigru": 6, "bilstm": 8}

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


def _bwd_smem_bytes(p: BirnnPlan, mode: str, KB: int) -> int:
    """csrc/birnn.cu bwd_smem_bytes: KB resident rows of W_hh^T (C Up
    columns), the step's dgh of the block (zero-padded rows, as the
    forward's h), the C slots of dh partials, the prefetched inputs."""
    K, CU = p.n_gates * p.Up, p.C * p.Up
    h_rows = _ceil(p.tile, 2) + p.rpt
    return 4 * (KB * CU + h_rows * K + p.C * p.tile * p.Up
                + p.tile * BWD_INPUTS[mode] * p.Up)


def birnn_backward_plan(p: BirnnPlan, mode: str) -> tuple:
    """(KB, smem) of the backward kernel on the forward's f32 plan ``p``:
    as many of the block's K = NG Up rows of W_hh^T resident as shared
    memory holds beside the rest (a multiple of 4; the others stream from
    L2 at every step), and the block's shared memory."""
    if p.route != "simt" or p.itemsize != 4:
        raise ValueError("the backward runs on the f32 SIMT plan")
    K, CU = p.n_gates * p.Up, p.C * p.Up
    fixed = _bwd_smem_bytes(p, mode, 0)
    if fixed > SMEM_MAX:
        raise ValueError(f"no backward plan fits B {p.B}, H {p.H}, {mode}")
    KB = min(K, (SMEM_MAX - fixed) // (CU * 4) // 4 * 4)
    return KB, _bwd_smem_bytes(p, mode, KB)


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


def _plain_steps(gi: torch.Tensor, wh: torch.Tensor,
                 bh: Optional[torch.Tensor], mode: str, hidden: int):
    """The recurrence step by step in f32: yields each step's h (2, B, H)
    and the gate values the training route saves (the GRU's r, z, n and
    W_hn h + b_hn; the LSTM's i, f, g, o and c)."""
    K, B = gi.shape[1:3]
    f32 = torch.float32
    whf = wh.to(f32)
    bhf = bh.to(f32)[:, None, :] if mode == "bigru" else None
    h = torch.zeros((K, B, hidden), dtype=f32, device=gi.device)
    c = torch.zeros_like(h)
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
            yield h, (r, z, n, hn)
        else:
            i, f, g, o = (g_in + gh).chunk(4, dim=-1)
            i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                          torch.sigmoid(o))
            c = f * c + i * g
            h = o * torch.tanh(c)
            yield h, (i, f, g, o, c)


def birnn_recurrence_plain(gi: torch.Tensor, wh: torch.Tensor,
                           bh: Optional[torch.Tensor], *, mode: str,
                           hidden: int) -> torch.Tensor:
    """gi (T, 2, B, G) input projections (+bias), lane 1 time-reversed;
    wh (2, H, G); bh (2, G) for the GRU, None for the LSTM.
    Returns ys (T, 2, B, H), lane 1 still in reversed time."""
    ys = [h for h, _ in _plain_steps(gi, wh, bh, mode, hidden)]
    return torch.stack(ys).to(gi.dtype)


def _launch(gi, wh, bh, mode, hidden, exchange_only, save_gates=False):
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
    gates = (torch.empty((T, 2, B, SAVED_GATES[mode], hidden),
                         dtype=torch.float32, device=gi.device)
             if save_gates else None)
    err = _build.lib().gvd_birnn_recurrence(
        code, MODE_CODES[mode], gi.data_ptr(), wh.data_ptr(),
        _build.ptr(bh_c), out.data_ptr(), _build.ptr(gates), T, B, hidden,
        *_plan_args(plan), int(exchange_only), _build.stream_of(gi))
    _build.check(err, "birnn_recurrence")
    return out, gates


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
    out, _ = _launch(gi, wh, bh, mode, hidden, exchange_only=False)
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


# --------------------------------------------------------------------- #
# training: forward with saved gates, the reverse-time backward
# --------------------------------------------------------------------- #

def birnn_forward_train_plain(gi: torch.Tensor, wh: torch.Tensor,
                              bh: Optional[torch.Tensor], *, mode: str,
                              hidden: int):
    """The training route's forward in plain PyTorch (f32): ys (T, 2, B,
    H) as ``birnn_recurrence_plain``'s, and the saved gates (T, 2, B, NS,
    H): the GRU's r, z, n, W_hn h + b_hn; the LSTM's i, f, g, o, c."""
    steps = list(_plain_steps(gi, wh, bh, mode, hidden))
    return (torch.stack([h for h, _ in steps]),
            torch.stack([torch.stack(g, dim=2) for _, g in steps]))


def birnn_backward_plain(dys: torch.Tensor, ys: torch.Tensor,
                         gates: torch.Tensor, wh: torch.Tensor, *,
                         mode: str):
    """The training route's backward in plain PyTorch (f32): the reverse
    recurrence written out, step by step, as the kernel runs it (the
    carried dh = the local z dh term (GRU) + dgh W_hh^T), then dW_hh as
    one product of h_{t-1} and dgh over all T B rows and db_hh as dgh's
    sum.  Returns (dgi (T, 2, B, G), dwh (2, H, G), dbh (2, G) or None)."""
    T, K, B, H = ys.shape
    whT = wh.transpose(1, 2)
    hp = torch.cat([ys.new_zeros((1, K, B, H)), ys[:-1]])
    dh = ys.new_zeros((K, B, H))
    dc = torch.zeros_like(dh)
    dgi, dgh = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        dh = dys[t] + dh
        if mode == "bigru":
            r, z, n, hn = gates[t].unbind(2)
            dn = dh * (1.0 - z) * (1.0 - n * n)
            dr = dn * hn * r * (1.0 - r)
            dz = dh * (hp[t] - n) * z * (1.0 - z)
            dgi[t] = torch.cat([dr, dz, dn], dim=-1)
            dgh[t] = torch.cat([dr, dz, dn * r], dim=-1)
            dh = dh * z + torch.bmm(dgh[t], whT)
        else:
            i, f, g, o, c = gates[t].unbind(2)
            c_old = gates[t - 1][:, :, 4] if t > 0 else torch.zeros_like(c)
            tc = torch.tanh(c)
            dc = dc + dh * o * (1.0 - tc * tc)
            dgi[t] = dgh[t] = torch.cat(
                [dc * g * i * (1.0 - i), dc * c_old * f * (1.0 - f),
                 dc * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=-1)
            dc = dc * f
            dh = torch.bmm(dgh[t], whT)
    dgh = torch.stack(dgh, dim=1)                        # (2, T, B, G)
    rows = hp.transpose(0, 1).reshape(K, T * B, H)
    dwh = torch.bmm(rows.transpose(1, 2), dgh.reshape(K, T * B, -1))
    dbh = dgh.sum(dim=(1, 2)) if mode == "bigru" else None
    return torch.stack(dgi), dwh, dbh


def _launch_backward(dys, ys, gates, wh, mode, hidden):
    """The backward kernel on the forward's plan, then dW_hh and db_hh."""
    T, K, B, H = ys.shape
    G = wh.shape[-1]
    plan = card_plan(B, hidden, mode, torch.float32)
    KB, smem = birnn_backward_plan(plan, mode)
    dys = dys.contiguous()
    whT = wh.transpose(1, 2).contiguous()                # (2, G, H)
    dgi = torch.empty((T, K, B, G), dtype=torch.float32, device=ys.device)
    dgh = torch.empty((K, T, B, G), dtype=torch.float32, device=ys.device)
    hp = torch.empty((K, T, B, H), dtype=torch.float32, device=ys.device)
    err = _build.lib().gvd_birnn_backward(
        MODE_CODES[mode], dys.data_ptr(), ys.data_ptr(), gates.data_ptr(),
        whT.data_ptr(), dgi.data_ptr(), dgh.data_ptr(), hp.data_ptr(), T, B,
        hidden, plan.C, plan.tile, plan.Up, plan.rpt, KB, smem,
        _build.stream_of(ys))
    _build.check(err, "birnn_backward")
    _build.launches["birnn_train_bwd"] += 1
    dgh = dgh.view(K, T * B, G)
    dwh = torch.bmm(hp.view(K, T * B, H).transpose(1, 2), dgh)
    dbh = dgh.sum(dim=1) if mode == "bigru" else None
    return dgi, dwh, dbh


class _BirnnTrain(torch.autograd.Function):
    """ys = the recurrence of gi over wh (and bh), all f32; the forward
    saves ys and the gates, the backward returns the gradients of gi, wh
    and bh.  CUDA tensors launch the kernels, CPU tensors take the plain
    twins."""

    @staticmethod
    def forward(ctx, gi, wh, bh, mode, hidden):
        if gi.is_cuda:
            ys, gates = _launch(gi, wh, bh, mode, hidden,
                                exchange_only=False, save_gates=True)
            _build.launches["birnn_train_fwd"] += 1
        else:
            ys, gates = birnn_forward_train_plain(gi, wh, bh, mode=mode,
                                                  hidden=hidden)
        ctx.save_for_backward(ys, gates, wh)
        ctx.mode, ctx.hidden, ctx.has_bh = mode, hidden, bh is not None
        return ys

    @staticmethod
    def backward(ctx, dys):
        from grounded_video_description_torch.utils.logging import span
        ys, gates, wh = ctx.saved_tensors
        with span("birnn_bwd"):
            if ys.is_cuda:
                dgi, dwh, dbh = _launch_backward(dys, ys, gates, wh,
                                                 ctx.mode, ctx.hidden)
            else:
                dgi, dwh, dbh = birnn_backward_plain(dys, ys, gates, wh,
                                                     mode=ctx.mode)
        return dgi, dwh, dbh if ctx.has_bh else None, None, None


def birnn_recurrence_train(gi: torch.Tensor, wh: torch.Tensor,
                           bh: Optional[torch.Tensor], *, mode: str,
                           hidden: int) -> torch.Tensor:
    """Same contract as ``birnn_recurrence_plain``, differentiable: the
    inputs cast to f32 once (as the twin computes), one forward and one
    backward launch a call on a CUDA tensor (``card_plan``'s f32 plan;
    ``birnn_train_fwd`` and ``birnn_train_bwd`` in ``_build.launches``),
    the plain twins on a CPU tensor.  Outputs in gi's dtype."""
    f32 = torch.float32
    if mode not in MODE_CODES:
        raise ValueError(f"unknown mode {mode!r}")
    ys = _BirnnTrain.apply(gi.to(f32).contiguous(), wh.to(f32).contiguous(),
                           bh.to(f32).contiguous() if mode == "bigru"
                           else None, mode, hidden)
    return ys.to(gi.dtype)
