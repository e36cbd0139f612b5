"""Neural-net ops of the port: plain functions on tensors, plus the two
parameter containers whose names follow the reference state dict.

Counterpart of ``grounded_video_description_tpu/nn/core.py``.  Weights
keep PyTorch's layout: a linear weight is (out, in), where the JAX
package stores (in, out).  Parameters stay float32, as in the JAX
package, and are cast to the activation dtype where they are used.

Initializers take an explicit ``torch.Generator`` and draw from the
distributions of the JAX package (Linear: U(+-1/sqrt(fan_in)) for weight
and bias; Embedding: N(0, 1); recurrent cells: U(+-1/sqrt(hidden))).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from grounded_video_description_torch.parallel.mesh import (
    RowShard, all_reduce_sum)
from grounded_video_description_torch.utils.logging import span, span_count


# --------------------------------------------------------------------- #
# initializers
# --------------------------------------------------------------------- #

def uniform_fan_in_(t: torch.Tensor, fan_in: int,
                    generator: torch.Generator) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def init_linear_(m: nn.Linear, generator: torch.Generator) -> nn.Linear:
    fan_in = m.weight.shape[1]
    uniform_fan_in_(m.weight, fan_in, generator)
    if m.bias is not None:
        uniform_fan_in_(m.bias, fan_in, generator)
    return m


def init_embedding_(m: nn.Embedding, generator: torch.Generator):
    with torch.no_grad():
        m.weight.normal_(0.0, 1.0, generator=generator)
    return m


# --------------------------------------------------------------------- #
# linear / embedding
# --------------------------------------------------------------------- #

def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x W^T + b, with W (out, in) cast to x's dtype."""
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def embedding(weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return weight[ids]


# --------------------------------------------------------------------- #
# recurrent cells (torch gate orders: LSTM i, f, g, o; GRU r, z, n)
# --------------------------------------------------------------------- #

class LSTMCellParams(nn.Module):
    """weight_ih (4H, in), weight_hh (4H, H), bias_ih, bias_hh — the
    reference's nn.LSTMCell names.  The JAX cell has one fused bias;
    this port keeps it in ``bias_ih`` and leaves ``bias_hh`` at zero.
    ``bias_hh`` stays in the state dict but is frozen: were it trained,
    it would get the same gradient as ``bias_ih``, so the fused bias
    would move by twice the JAX step and count twice in the clip norm."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_dim))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_ih = nn.Parameter(torch.empty(4 * hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden),
                                    requires_grad=False)

    def reset_parameters(self, generator: torch.Generator):
        hidden = self.weight_hh.shape[1]
        for p in (self.weight_ih, self.weight_hh, self.bias_ih):
            uniform_fan_in_(p, hidden, generator)
        with torch.no_grad():
            self.bias_hh.zero_()


def lstm_cell(cell: LSTMCellParams, x: torch.Tensor,
              state: Tuple[torch.Tensor, torch.Tensor]):
    h, c = state
    gates = (linear(x, cell.weight_ih) + linear(h, cell.weight_hh)
             + (cell.bias_ih + cell.bias_hh).to(x.dtype))
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, (h_new, c_new)


def _gru_cell(x: torch.Tensor, h: torch.Tensor, w_ih: torch.Tensor,
              w_hh: torch.Tensor, b_ih: torch.Tensor,
              b_hh: torch.Tensor) -> torch.Tensor:
    gi = linear(x, w_ih, b_ih)
    gh = linear(h, w_hh, b_hh)
    ir, iz, in_ = gi.chunk(3, dim=-1)
    hr, hz, hn = gh.chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    return (1.0 - z) * n + z * h


# --------------------------------------------------------------------- #
# multi-layer bidirectional RNN over time (the temporal context encoder,
# reference model.py:145-156).  Layout: (B, T, D) batch-first.
# --------------------------------------------------------------------- #

class BiRNNParams(nn.Module):
    """Parameters of a bidirectional nn.GRU / nn.LSTM under the names
    torch gives them (``weight_ih_l{k}[_reverse]`` and so on).  The GRU
    trains both biases, as the JAX cell does; the LSTM's ``bias_hh_*``
    are frozen at zero, as in ``LSTMCellParams``."""

    def __init__(self, in_dim: int, hidden: int, num_layers: int,
                 mode: str):
        super().__init__()
        if mode not in ("bigru", "bilstm"):
            raise ValueError(f"unknown t_attn_mode {mode!r}")
        self.mode, self.hidden, self.num_layers = mode, hidden, num_layers
        G = (3 if mode == "bigru" else 4) * hidden
        d = in_dim
        for li in range(num_layers):
            for sfx in ("", "_reverse"):
                self.register_parameter(
                    f"weight_ih_l{li}{sfx}", nn.Parameter(torch.empty(G, d)))
                self.register_parameter(
                    f"weight_hh_l{li}{sfx}",
                    nn.Parameter(torch.empty(G, hidden)))
                self.register_parameter(
                    f"bias_ih_l{li}{sfx}", nn.Parameter(torch.empty(G)))
                self.register_parameter(
                    f"bias_hh_l{li}{sfx}",
                    nn.Parameter(torch.zeros(G),
                                 requires_grad=mode == "bigru"))
            d = 2 * hidden

    def reset_parameters(self, generator: torch.Generator):
        """GRU: all four tensors U(+-1/sqrt(H)).  LSTM: the JAX cell's
        single bias goes to bias_ih, bias_hh stays zero."""
        for li in range(self.num_layers):
            for sfx in ("", "_reverse"):
                names = ["weight_ih", "weight_hh", "bias_ih"]
                if self.mode == "bigru":
                    names.append("bias_hh")
                for n in names:
                    uniform_fan_in_(getattr(self, f"{n}_l{li}{sfx}"),
                                    self.hidden, generator)
                if self.mode == "bilstm":
                    with torch.no_grad():
                        getattr(self, f"bias_hh_l{li}{sfx}").zero_()

    def layer(self, li: int):
        """Layer li with both directions stacked on a leading axis:
        (w_ih (2,G,D), w_hh (2,G,H), b_ih (2,G), b_hh (2,G))."""
        def both(n):
            return torch.stack([getattr(self, f"{n}_l{li}"),
                                getattr(self, f"{n}_l{li}_reverse")])
        return (both("weight_ih"), both("weight_hh"), both("bias_ih"),
                both("bias_hh"))


def _scan_bidir(mode: str, w_ih, w_hh, b_ih, b_hh, xs: torch.Tensor,
                hidden: int, use_kernel: bool = False) -> torch.Tensor:
    """Both directions of one layer in one T-step recurrence: the
    backward lane consumes time-reversed inputs.  The input projection
    has no sequential dependency and is hoisted out as one product.

    use_kernel: run the recurrence through K2 on a CUDA tensor: where
    autograd needs its gradient, the training route
    (``birnn_recurrence_train``), else ``birnn_recurrence``; a CPU tensor
    that needs the gradient takes the plain version under autograd.
    Without use_kernel, the plain version.  Where the gradient is needed
    the recurrence is the span ``birnn``, whose count ``kernel`` is 1 when
    the training route ran it and 0 for the plain version."""
    from grounded_video_description_torch.ops.kernels.birnn import (
        birnn_recurrence, birnn_recurrence_plain, birnn_recurrence_train)

    dt = xs.dtype
    bias = b_ih if mode == "bigru" else b_ih + b_hh     # LSTM: one bias
    gi = torch.einsum("btd,kgd->tkbg", xs, w_ih.to(dt))  # (T, 2, B, G)
    gi = gi + bias.to(dt)[None, :, None, :]
    gi = torch.stack([gi[:, 0], gi[:, 1].flip(0)], dim=1)  # reverse lane 1
    wh = w_hh.to(dt).transpose(1, 2).contiguous()          # (2, H, G)
    bh = b_hh.to(dt).contiguous() if mode == "bigru" else None
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (gi, wh, bh)):
        run = (birnn_recurrence_train if use_kernel and gi.is_cuda
               else birnn_recurrence_plain)
        with span("birnn"):
            ys = run(gi.contiguous(), wh, bh, mode=mode, hidden=hidden)
            span_count(kernel=int(run is birnn_recurrence_train))
    else:
        run = birnn_recurrence if use_kernel else birnn_recurrence_plain
        ys = run(gi.contiguous(), wh, bh, mode=mode, hidden=hidden)
    out = torch.cat([ys[:, 0], ys[:, 1].flip(0)], dim=-1)  # (T, B, 2H)
    return out.transpose(0, 1)


def birnn(rnn: BiRNNParams, x: torch.Tensor, *, use_kernel: bool = False,
          train: bool = False, drop: float = 0.0,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The stacked bidirectional RNN: (B, T, D) -> (B, T, 2H).

    ``use_kernel`` runs each layer's recurrence through K2, at eval and
    in training (its training route, forward and backward; the JAX package
    trains with an XLA scan).  In training dropout at ``drop`` falls
    between the layers."""
    out = x
    for li in range(rnn.num_layers):
        out = _scan_bidir(rnn.mode, *rnn.layer(li), out, rnn.hidden,
                          use_kernel=use_kernel)
        if train and li < rnn.num_layers - 1:
            out = dropout(out, drop, train=True, generator=generator)
    return out


# --------------------------------------------------------------------- #
# normalization
# --------------------------------------------------------------------- #

def layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free layer norm over the last axis (biased variance,
    eps on the variance); statistics in f32."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def layer_norm_affine(gamma: torch.Tensor, beta: torch.Tensor,
                      x: torch.Tensor, eps: float = 1e-6,
                      use_std: bool = False) -> torch.Tensor:
    """Affine layer norm.  ``use_std=True`` is the transformer variant
    that divides by (unbiased std + eps) (misc/transformer.py:66-77);
    ``torch.nn.LayerNorm`` computes something else."""
    mean = x.mean(-1, keepdim=True)
    if use_std:
        n = x.shape[-1]
        var = x.var(-1, unbiased=False, keepdim=True) * (n / max(n - 1, 1))
        normed = (x - mean) / (torch.sqrt(var) + eps)
    else:
        var = x.var(-1, unbiased=False, keepdim=True)
        normed = (x - mean) * torch.rsqrt(var + eps)
    return gamma.to(x.dtype) * normed + beta.to(x.dtype)


def batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over the channels of a (B, T, C) tensor at eval, with
    the running statistics (model.py:114-115, 396-398)."""
    mean = bn.running_mean.to(x.dtype)
    var = bn.running_var.to(x.dtype)
    y = (x - mean) * torch.rsqrt(var + eps)
    return bn.weight.to(x.dtype) * y + bn.bias.to(x.dtype)


def batch_norm_train(bn: nn.BatchNorm1d, x: torch.Tensor, *,
                     momentum: float = 0.1, eps: float = 1e-5,
                     group=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """BatchNorm of a (B, T, C) tensor in training: statistics of the
    batch over (B, T) in f32.  Returns (y, new_state); new_state holds
    the running statistics after this batch under ``bn``'s buffer names
    (momentum 0.1, unbiased variance, count + 1), for the caller to
    carry to the next batch.  ``bn`` itself is left as it is.

    With a process ``group`` the batch is the rows of every rank: the
    sums, the count and the squared deviations are summed over the ranks
    by a differentiable all-reduce, so every rank normalizes by the whole
    microbatch's statistics (as the JAX mesh step does) and carries the
    same running statistics."""
    x32 = x.float()
    if group is None:
        mean = x32.mean(dim=(0, 1))
        var = x32.var(dim=(0, 1), unbiased=False)
        n = x.shape[0] * x.shape[1]
        unbias = n / max(n - 1, 1)
    else:
        s = all_reduce_sum(torch.cat([x32.sum(dim=(0, 1)), x32.new_tensor(
            [x.shape[0] * x.shape[1]])]), group)
        n = s[-1]
        mean = s[:-1] / n
        var = all_reduce_sum(((x32 - mean) ** 2).sum(dim=(0, 1)), group) / n
        unbias = n / (n - 1).clamp_min(1.0)
    with torch.no_grad():
        new_state = {
            "running_mean": (1 - momentum) * bn.running_mean
            + momentum * mean,
            "running_var": (1 - momentum) * bn.running_var
            + momentum * (var * unbias),
            "num_batches_tracked": bn.num_batches_tracked + 1,
        }
    y = (x - mean.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + eps)
    return bn.weight.to(x.dtype) * y + bn.bias.to(x.dtype), new_state


# --------------------------------------------------------------------- #
# dropout
# --------------------------------------------------------------------- #

def dropout(x: torch.Tensor, rate: float, *, train: bool,
            generator=None) -> torch.Tensor:
    """JAX ``nn/core.py::dropout``: the identity at eval, at rate 0 or
    without a generator; else each element is kept with probability
    1 - rate, scaled by 1 / (1 - rate), and the result is in x's dtype.
    The mask comes from ``generator``, which lives on x's device.

    Under a ``RowShard`` (a data-parallel rank) x's leading axis holds the
    rank's rows: the mask of the whole microbatch is drawn, as one device
    draws it, and the rank keeps its rows, so D ranks drop what one device
    drops."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    if isinstance(generator, RowShard):
        row0, total = generator.span(x)
        u = torch.rand((total,) + tuple(x.shape[1:]),
                       generator=generator.generator, device=x.device)
        mask = u[row0:row0 + x.shape[0]] < keep
    else:
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)
