"""Graph convolution, linear and normalization layers.

Port of ``cgcnet_tpu/nn/layers.py`` with the same numerical contracts
(PyG 1.2.1 ``DenseSAGEConv`` with normalize=True, torch ``BatchNorm1d``
over the flattened [B*N, C] rows). Parameters use PyTorch's layouts:
linear weights are [out, in] (the JAX package keeps [in, out] kernels —
``train/checkpoint.state_dict_from_flax`` transposes).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from cgcnet_tpu_torch.nn.adjacency import Adjacency


class TorchLinear(nn.Module):
    """y = x @ W^T + b with W [out, in] and torch's default init
    U(-1/sqrt(in), 1/sqrt(in)) for both W and b. The product runs in x's
    dtype (the parameters are cast, as in the JAX package)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=generator)

    def kernel(self) -> torch.Tensor:
        """[in, out] view of the weight (the JAX package's kernel layout)."""
        return self.weight.t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight.t().to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class SAGEConv(nn.Module):
    """GraphSAGE convolution, PyG-1.2.1 ``DenseSAGEConv`` semantics:
    out = lin((A @ x) / clamp(rowsum(A), min=1)); l2-normalize; mask."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.lin = TorchLinear(in_features, features, use_bias)

    def forward(
        self,
        x: torch.Tensor,
        adj: Adjacency,
        mask: Optional[torch.Tensor] = None,
        *,
        agg: Optional[torch.Tensor] = None,
        pre_normalize: bool = False,
    ) -> torch.Tensor:
        out = adj.matvec(x) if agg is None else agg
        denom = torch.clamp_min(adj.rowsum(), 1.0)[..., None].to(out.dtype)
        out = self.lin(out / denom)
        if pre_normalize:
            # raw lin output for the fused normalize+relu of the assign
            # head (ops/assign_head.py) — the caller owns masking too
            return out
        out = l2_normalize(out)
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return out


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """F.normalize(p=2, dim=-1, eps=1e-12) with the sum of squares in f32
    (the precision rule of the JAX package, also under bf16 compute)."""
    x32 = x.float()
    norm = torch.sqrt(torch.sum(x32 * x32, dim=-1, keepdim=True))
    return (x32 / torch.clamp_min(norm, 1e-12)).to(x.dtype)


def batch_moments(
    x: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean[C], biased var[C], n) of ``x`` [..., C] over its rows in f32,
    two-pass; with ``mask`` (row weights) over the masked rows, n clamped
    to at least 1."""
    xf = x.float()
    axes = tuple(range(x.dim() - 1))
    if mask is None:
        n = torch.tensor(float(xf[..., 0].numel()), device=x.device)
        mean = torch.mean(xf, dim=axes)
        return mean, torch.mean(torch.square(xf - mean), dim=axes), n
    m = torch.broadcast_to(mask.float(), x.shape[:-1])
    n = torch.clamp_min(torch.sum(m), 1.0)
    m = m[..., None]
    mean = torch.sum(xf * m, dim=axes) / n
    return mean, torch.sum(torch.square(xf - mean) * m, dim=axes) / n, n


class TorchBatchNorm(nn.Module):
    """BatchNorm1d with torch semantics over [..., C] rows: biased variance
    for normalizing, unbiased (by n/(n-1)) for the running update, momentum
    0.1, eps 1e-5 (torch buffers ``running_mean``/``running_var``).

    ``mask`` (row weights, broadcastable to the row axes) restricts the
    batch statistics to real nodes (``model.masked_bn``); without it the
    statistics run over every row, padded ones included (the reference's
    quirk). ``moments``/``affine`` expose the statistics without applying
    them, so a following linear can fold the affine into its kernel; in
    training every caller of ``moments`` feeds them to ``update_running``."""

    momentum = 0.1

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def moments(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """(mean[C], var[C], n) that normalize ``x``: the running moments and
        n None in eval mode; in training the batch moments (f32, two-pass
        biased variance) over n rows. Changes no state."""
        if not self.training:
            return self.running_mean, self.running_var, None
        return batch_moments(x, mask)

    def update_running(
        self, mean: torch.Tensor, var: torch.Tensor, n: torch.Tensor
    ) -> None:
        """Running-moment update from batch moments over ``n`` rows (also
        fed by the fused assign tail, which computes its own moments)."""
        with torch.no_grad():
            n = torch.clamp_min(torch.as_tensor(n, dtype=torch.float32), 1.0)
            unbiased = var * n / torch.clamp_min(n - 1.0, 1.0)
            m = self.momentum
            self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1.0 - m) * self.running_var + m * unbiased)

    def affine(
        self, mean: torch.Tensor, var: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """BN as x*inv + shift (f32): inv = rsqrt(var+eps)*scale,
        shift = bias - mean*inv."""
        inv = torch.rsqrt(var + self.eps) * self.weight
        return inv, self.bias - mean * inv

    def forward(
        self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        mean, var, n = self.moments(x, mask)
        if self.training:
            self.update_running(mean, var, n)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * inv + self.bias).to(x.dtype)
