"""K2: the bidirectional GRU / LSTM recurrence, one kernel for all T steps.

Replaces ``grounded_video_description_tpu/ops/pallas/birnn.py
::birnn_recurrence`` and keeps its public layout.  The CUDA source is
``csrc/birnn.cu``; ``birnn_recurrence_plain`` is the same recurrence as a
Python loop over time (f32 gate math and f32 carry, outputs in the input
dtype), used for CPU tensors, on the model's plain path, under autograd
in training (the kernel has no backward) and as the reference on the
card.
"""

from __future__ import annotations

from typing import Optional

import torch

from grounded_video_description_torch.ops.kernels import _build

MODE_CODES = {"bigru": 0, "bilstm": 1}


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


def birnn_recurrence(gi: torch.Tensor, wh: torch.Tensor,
                     bh: Optional[torch.Tensor], *, mode: str,
                     hidden: int) -> torch.Tensor:
    """Same contract as ``birnn_recurrence_plain``.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel, one block per
    (direction, 4 batch rows).  No backward: an input that requires grad
    raises under grad mode."""
    _build.refuse_grad("birnn_recurrence", gi, wh, bh)
    if not gi.is_cuda:
        return birnn_recurrence_plain(gi, wh, bh, mode=mode, hidden=hidden)
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

    gi = gi.contiguous()
    wh = wh.contiguous()
    bh_c = bh.contiguous() if mode == "bigru" else None
    out = torch.empty((T, 2, B, hidden), dtype=gi.dtype, device=gi.device)
    code = _build.lib().gvd_birnn_recurrence(
        _build.dtype_code(gi), MODE_CODES[mode], gi.data_ptr(),
        wh.data_ptr(), bh_c.data_ptr() if bh_c is not None else None,
        out.data_ptr(), T, B, hidden, _build.stream_of(gi))
    _build.check(code, "birnn_recurrence")
    _build.launches["birnn_recurrence"] += 1
    return out
