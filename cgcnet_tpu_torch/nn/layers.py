"""Graph convolution, linear and normalization layers (eval mode).

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


class TorchBatchNorm(nn.Module):
    """BatchNorm1d over [..., C] rows, eval mode: normalizes with the
    running moments (torch buffers ``running_mean``/``running_var``, eps
    1e-5). Batch statistics and running updates come with training."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def folded_affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """BN as x*inv + shift (f32): inv = rsqrt(var+eps)*scale,
        shift = bias - mean*inv."""
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return inv, self.bias - self.running_mean * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean) * inv + self.bias).to(x.dtype)
