"""Jumping-knowledge layer attention (reference ``DenseJK``,
model/network.py:11-55), LSTM mode.

A bidirectional LSTM runs over the layer axis (length 3: the three conv
outputs of a GNN block), a linear head scores each layer, and the
softmax-weighted sum collapses [B, N, 3C] -> [B, N, C]. Same math as
``cgcnet_tpu/nn/jk.py: bilstm_attend_2d``: torch gate order (i, f, g, o),
both biases, zero initial state, and the layer-attention softmax in f32.
Parameters carry ``torch.nn.LSTM``'s names and [4H, in] layouts.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from cgcnet_tpu_torch.nn.layers import TorchLinear

_DIRS = ("_l0", "_l0_reverse")


class BiLSTMParams(nn.Module):
    """Parameter container with ``torch.nn.LSTM``'s names (single layer,
    bidirectional): weight_ih_l0 [4H, C], weight_hh_l0 [4H, H], bias_ih_l0,
    bias_hh_l0 [4H], and the ``_reverse`` set."""

    def __init__(self, c_in: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for sfx in _DIRS:
            self.register_parameter(
                f"weight_ih{sfx}", nn.Parameter(torch.empty(4 * hidden, c_in))
            )
            self.register_parameter(
                f"weight_hh{sfx}", nn.Parameter(torch.empty(4 * hidden, hidden))
            )
            self.register_parameter(
                f"bias_ih{sfx}", nn.Parameter(torch.empty(4 * hidden))
            )
            self.register_parameter(
                f"bias_hh{sfx}", nn.Parameter(torch.empty(4 * hidden))
            )

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.hidden)
        with torch.no_grad():
            for prm in self.parameters():
                prm.uniform_(-bound, bound, generator=generator)


def _run_direction(
    lp: BiLSTMParams, xs: list[torch.Tensor], sfx: str
) -> list[torch.Tensor]:
    """One LSTM direction over the steps ``xs`` ([n, C] each); returns the
    hidden state after every step."""
    dt = xs[0].dtype
    w_ih = getattr(lp, f"weight_ih{sfx}").t().to(dt)
    w_hh = getattr(lp, f"weight_hh{sfx}").t().to(dt)
    bias = (getattr(lp, f"bias_ih{sfx}") + getattr(lp, f"bias_hh{sfx}")).to(dt)
    hdim = lp.hidden
    h_t = c_t = None
    out = []
    for x in xs:
        gates = x @ w_ih + bias
        if h_t is not None:  # step 0: h_0 = c_0 = 0, no recurrent term
            gates = gates + h_t @ w_hh
        i, f, g, o = torch.split(gates, hdim, dim=-1)
        c_new = torch.sigmoid(i) * torch.tanh(g)
        if c_t is not None:
            c_new = torch.sigmoid(f) * c_t + c_new
        c_t = c_new
        h_t = torch.sigmoid(o) * torch.tanh(c_t)
        out.append(h_t)
    return out


class DenseJK(nn.Module):
    """[B, N, num_layers*C] -> [B, N, C] by biLSTM layer attention."""

    def __init__(self, channels: int, num_layers: int = 3):
        super().__init__()
        self.channels, self.num_layers = channels, num_layers
        hidden = channels * num_layers // 2   # torch reference sizing
        self.lstm = BiLSTMParams(channels, hidden)
        self.att = TorchLinear(2 * hidden, 1)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        b, n, total = xs.shape
        c, t = self.channels, self.num_layers
        if total != c * t:
            raise ValueError(f"DenseJK: width {total} != {t} x {c}")
        steps = list(torch.split(xs.reshape(b * n, total), c, dim=-1))
        fwd = _run_direction(self.lstm, steps, "_l0")
        bwd = _run_direction(self.lstm, steps[::-1], "_l0_reverse")[::-1]
        # score of layer j: att([h_fwd_j | h_bwd_j]); the bias is added once
        # to the [n, T] scores, as the JAX package's one attention product
        # does, so its gradient — zero in theory (a shared score offset) —
        # is one reduction over all layers, not three rounded apart in bf16
        w = self.att.weight.t()
        alpha = torch.cat(
            [torch.cat([fwd[j], bwd[j]], dim=-1) @ w.to(xs.dtype)
             for j in range(t)],
            dim=-1,
        )
        if self.att.bias is not None:
            alpha = alpha + self.att.bias.to(xs.dtype)
        alpha = torch.softmax(alpha.float(), dim=-1).to(xs.dtype)
        out = torch.zeros_like(steps[0])
        for j in range(t):
            out = out + alpha[:, j : j + 1] * steps[j]
        return out.reshape(b, n, c)
