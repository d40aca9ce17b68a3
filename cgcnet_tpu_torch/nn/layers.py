"""Graph convolution, linear and normalization layers.

Port of ``cgcnet_tpu/nn/layers.py`` with the same numerical contracts
(PyG 1.2.1 ``DenseSAGEConv`` with normalize=True and ``DenseGINConv`` with
add_loop=False, the JAX package's dot-product attention ``GATConv``, torch
``BatchNorm1d`` over the flattened [B*N, C] rows). Parameters use PyTorch's
layouts:
linear weights are [out, in] (the JAX package keeps [in, out] kernels —
``train/checkpoint.state_dict_from_flax`` transposes).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cgcnet_tpu_torch.nn.adjacency import Adjacency, DenseAdj, EllAdjFactored
from cgcnet_tpu_torch.parallel.mega_graph import psum
from cgcnet_tpu_torch.parallel.mesh import GraphAxis


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation by name (reference model/network.py:84-91)."""
    if name == "relu":
        return torch.relu
    if name == "elu":
        return F.elu
    if name == "leakyrelu":
        # torch nn.LeakyReLU's default negative_slope
        return lambda x: F.leaky_relu(x, negative_slope=0.01)
    raise ValueError(f"unknown activation {name!r}")


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


class GINConv(nn.Module):
    """GIN convolution, PyG-1.2.1 ``DenseGINConv`` with add_loop=False:
    out = mlp(A @ x), mlp = Linear(in->out), act, Linear(out->out); mask
    (reference model/network.py:96-99)."""

    def __init__(self, in_features: int, features: int, act: str = "relu"):
        super().__init__()
        self.act = act
        self.mlp_0 = TorchLinear(in_features, features)
        self.mlp_1 = TorchLinear(features, features)

    def forward(
        self,
        x: torch.Tensor,
        adj: Adjacency,
        mask: Optional[torch.Tensor] = None,
        *,
        agg: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        out = adj.matvec(x) if agg is None else agg
        out = self.mlp_1(activation(self.act)(self.mlp_0(out)))
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return out


class GATConv(nn.Module):
    """Dot-product (multi-head) attention over the adjacency's support (the
    JAX package's extension, ``gcn_name='GAT'``). Per head h: out_i =
    sum_j alpha^h_ij (W_v x_j)^h, alpha^h = softmax_j(<(W_q x_i)^h,
    (W_k x_j)^h> / sqrt(D)) over {i} and the neighbours of i; heads
    concatenate back to ``features``. Scores and softmax in f32. On the ELL
    layouts the neighbours' k and v rows are gathered once for all heads;
    on a dense adjacency the full score matrix is masked by its support."""

    def __init__(
        self, in_features: int, features: int, heads: int = 1,
        use_bias: bool = True,
    ):
        super().__init__()
        if features % heads:
            raise ValueError(f"GAT width {features} is not divisible by "
                             f"{heads} heads")
        self.features, self.heads = features, heads
        self.q = TorchLinear(in_features, features, use_bias)
        self.k = TorchLinear(in_features, features, use_bias)
        self.v = TorchLinear(in_features, features, use_bias)

    def forward(
        self,
        x: torch.Tensor,
        adj: Adjacency,
        mask: Optional[torch.Tensor] = None,
        *,
        agg: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        del agg  # attention cannot share a precomputed aggregation
        h, d = self.heads, self.features // self.heads
        q, k, v = self.q(x), self.k(x), self.v(x)
        scale = 1.0 / math.sqrt(d)
        b, n = x.shape[0], x.shape[1]
        neg = torch.finfo(torch.float32).min
        qh = q.reshape(b, n, h, d)
        if isinstance(adj, DenseAdj):
            logits = torch.einsum(
                "bihd,bjhd->bhij", qh.float(), k.reshape(b, n, h, d).float()
            ) * scale
            logits = torch.where((adj.adj > 0)[:, None], logits, neg)
            alpha = torch.softmax(logits, dim=-1).to(x.dtype)
            # rows with no support would softmax to a uniform row
            alpha = alpha * (adj.rowsum() > 0)[:, None, :, None].to(x.dtype)
            out = torch.einsum(
                "bhij,bjhd->bihd", alpha, v.reshape(b, n, h, d)
            ).reshape(b, n, self.features)
        else:
            if isinstance(adj, EllAdjFactored):
                nbr, slot_mask = adj.nbr, adj.off_mask
            else:
                row = torch.arange(n, device=x.device, dtype=adj.nbr.dtype)
                slot_mask = (adj.w > 0).to(x.dtype) * (adj.nbr != row[None, :, None])
                nbr = adj.nbr
            kk = nbr.shape[2]
            bidx = torch.arange(b, device=x.device)[:, None, None]
            gk = k[bidx, nbr.long()].reshape(b, n, kk, h, d)   # [B, N, K, H, D]
            gv = v[bidx, nbr.long()].reshape(b, n, kk, h, d)
            e_nbr = torch.einsum("bnhd,bnkhd->bnkh", qh.float(), gk.float())
            e_self = torch.einsum(
                "bnhd,bnhd->bnh", qh.float(), k.reshape(b, n, h, d).float()
            )[:, :, None]
            # scores over [self ++ K off-diagonal slots], softmax in f32
            scores = torch.cat([e_self, e_nbr], dim=2) * scale
            smask = torch.cat(
                [torch.ones((b, n, 1), device=x.device), slot_mask.float()], -1
            )[..., None]
            scores = torch.where(smask > 0, scores, neg)
            m = torch.amax(scores, dim=2, keepdim=True)
            ex = torch.exp(scores - m.detach()) * smask
            alpha = (ex / torch.sum(ex, dim=2, keepdim=True)).to(x.dtype)
            out = (
                alpha[:, :, 0, :, None] * v.reshape(b, n, h, d)
                + torch.einsum("bnkh,bnkhd->bnhd", alpha[:, :, 1:], gv)
            ).reshape(b, n, self.features)
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
    x: torch.Tensor, mask: Optional[torch.Tensor] = None,
    axis: Optional[GraphAxis] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean[C], biased var[C], n) of ``x`` [..., C] over its rows in f32,
    two-pass; with ``mask`` (row weights) over the masked rows, n clamped
    to at least 1. Over a data ``axis`` of D > 1 ranks, over the rows of
    every rank (:func:`axis_moments`)."""
    if axis is not None and axis.size > 1:
        return axis_moments(x, mask, axis)
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


def axis_moments(
    x: torch.Tensor, mask: Optional[torch.Tensor], axis: GraphAxis
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`batch_moments` over the rows of every rank of ``axis``, in the
    same two passes: the row count and the column sums summed over the
    axis (one psum), then the squared deviations from the global mean (a
    second). The psums are differentiable (their VJP sums the cotangents
    over the axis), so each rank's backward routes the global statistics'
    cotangents onto its own rows."""
    xf = x.float()
    axes = tuple(range(x.dim() - 1))
    if mask is None:
        m = None
        n_local = torch.tensor(float(xf[..., 0].numel()), device=x.device)
        col = torch.sum(xf, dim=axes)
    else:
        m = torch.broadcast_to(mask.float(), x.shape[:-1])
        n_local = torch.sum(m)
        m = m[..., None]
        col = torch.sum(xf * m, dim=axes)
    sums = psum(torch.cat([col, n_local[None]]), axis)
    n = sums[-1].detach()
    if m is not None:
        n = torch.clamp_min(n, 1.0)
    mean = sums[:-1] / n
    dev = torch.square(xf - mean)
    if m is not None:
        dev = dev * m
    return mean, psum(torch.sum(dev, dim=axes), axis) / n, n


class TorchBatchNorm(nn.Module):
    """BatchNorm1d with torch semantics over [..., C] rows: biased variance
    for normalizing, unbiased (by n/(n-1)) for the running update, momentum
    0.1, eps 1e-5 (torch buffers ``running_mean``/``running_var``).

    ``mask`` (row weights, broadcastable to the row axes) restricts the
    batch statistics to real nodes (``model.masked_bn``); without it the
    statistics run over every row, padded ones included (the reference's
    quirk). ``moments``/``affine`` expose the statistics without applying
    them, so a following linear can fold the affine into its kernel; in
    training every caller of ``moments`` feeds them to ``update_running``.
    ``axis``: a data axis whose ranks' rows the batch statistics run over
    (``CGCNet.set_data_axis``); None for this process's rows alone."""

    momentum = 0.1
    axis: Optional[GraphAxis] = None

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
        biased variance) over n rows, of every rank of ``axis``. Changes no
        state."""
        if not self.training:
            return self.running_mean, self.running_var, None
        return batch_moments(x, mask, self.axis)

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
