"""GNN block and DiffPool (reference ``GNN_Module`` model/network.py:57-125
and ``_diff_pool`` model/network.py:194-208).

Port of ``cgcnet_tpu/nn/blocks.py`` for SAGE + relu + BN: the per-block
conv steps and tails, the paired (embed, pool) blocks that share one
aggregation per layer, the dual-stream tail, the BN-folded assign tails
(``finish_folded`` and the fused ``finish_folded_pre``: B4 in eval mode,
B3 + B4 forward and B5 backward in training) and the DiffPool
contractions. Training mode follows the modules' ``training`` flag: BN
normalizes with batch moments and updates its running moments.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cgcnet_tpu_torch.nn.adjacency import Adjacency
from cgcnet_tpu_torch.nn.layers import (
    SAGEConv,
    TorchBatchNorm,
    TorchLinear,
    batch_moments,
)
from cgcnet_tpu_torch.ops.assign_head import (
    AssignHeadSoftmaxPre,
    AssignTailTrain,
)


class GNNBlock(nn.Module):
    """Three stacked SAGE convolutions, each relu + BN, concat of the three
    outputs; ``use_lin`` (pooling blocks) maps the concat to
    ``embedding_dim`` with bn3's affine folded into that lin.

    The ported configuration fixes relu, BN and the folded tail (``CGCNet``
    refuses the others). ``masked_bn``: BN batch statistics over real rows
    only."""

    def __init__(
        self,
        input_dim: int,
        hidden_dim: int,
        embedding_dim: int,
        *,
        use_bias: bool = True,
        use_lin: bool = True,
        masked_bn: bool = True,
    ):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.masked_bn = masked_bn
        self.gcn1 = SAGEConv(input_dim, hidden_dim, use_bias)
        self.gcn2 = SAGEConv(hidden_dim, hidden_dim, use_bias)
        self.gcn3 = SAGEConv(hidden_dim, embedding_dim, use_bias)
        self.bn1 = TorchBatchNorm(hidden_dim)
        self.bn2 = TorchBatchNorm(hidden_dim)
        self.bn3 = TorchBatchNorm(embedding_dim)
        if use_lin:
            self.lin = TorchLinear(2 * hidden_dim + embedding_dim, embedding_dim)

    def conv(self, i: int) -> SAGEConv:
        return (self.gcn1, self.gcn2, self.gcn3)[i - 1]

    def bn(self, i: int) -> TorchBatchNorm:
        return (self.bn1, self.bn2, self.bn3)[i - 1]

    def conv_step(
        self,
        i: int,
        x: torch.Tensor,
        adj: Adjacency,
        mask: Optional[torch.Tensor],
        *,
        agg: Optional[torch.Tensor] = None,
        apply_bn: bool = True,
        raw: bool = False,
    ) -> torch.Tensor:
        """conv_i -> relu -> bn_i. ``agg`` optionally supplies A @ x;
        ``apply_bn=False`` returns the pre-BN activation; ``raw`` returns
        the conv's raw lin output (the fused tail does the rest)."""
        conv = self.conv(i)
        if raw:
            return conv(x, adj, mask, agg=agg, pre_normalize=True)
        h = torch.relu(conv(x, adj, mask, agg=agg))
        if not apply_bn:
            return h
        return self.bn(i)(h, mask if self.masked_bn else None)

    def finish_folded_pre(
        self,
        x1: torch.Tensor,
        x2: torch.Tensor,
        p: torch.Tensor,
        n_nodes: torch.Tensor,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Fused assign tail: ``p`` is conv3's raw lin output. L2-normalize,
        relu, the BN-folded lin and the masked softmax are one B4 launch; in
        training B3 computes bn3's batch statistics first and the backward
        is one B5 launch. Returns (S, S^T), S^T a view. relu's positive
        homogeneity makes this exact: relu(l2norm(p)) == rnorm * relu(p)."""
        split = x1.shape[-1] + x2.shape[-1]
        k = self.lin.kernel()
        k12, k3 = k[:split], k[split:]
        lin_bias = (
            self.lin.bias if self.lin.bias is not None
            else torch.zeros(k.shape[1], device=k.device)
        )
        x12 = torch.cat([x1, x2], dim=-1)
        if self.training:
            # masked_bn: statistics over real rows; otherwise every row
            # counts (padded rows of h are zero, only the divisor changes)
            n = (
                torch.sum(n_nodes).float() if self.masked_bn
                else torch.tensor(float(p.shape[0] * p.shape[1]), device=p.device)
            )
            s, mean, var = AssignTailTrain.apply(
                x12, p, k12, k3, lin_bias, self.bn3.weight, self.bn3.bias,
                n_nodes, n, self.bn3.eps,
            )
            self.bn3.update_running(mean, var, n)
            return s, s.transpose(1, 2)
        inv, shift = self.bn3.affine(self.bn3.running_mean, self.bn3.running_var)
        k3f = inv[:, None] * k3
        const = shift @ k3 + lin_bias
        s = AssignHeadSoftmaxPre.apply(x12, p, k12, k3f, const, n_nodes)
        return s, s.transpose(1, 2)

    def finish_folded(
        self,
        x1: torch.Tensor,
        x2: torch.Tensor,
        h3a: torch.Tensor,
        mask: Optional[torch.Tensor],
    ) -> torch.Tensor:
        """``bn3 -> concat -> mask -> lin -> mask`` with bn3's affine folded
        into the lin kernel: concat(x1, x2) @ K12 + h3a @ (inv*K3) + const
        (bn3's batch moments of ``h3a`` in training)."""
        mean, var, n = self.bn3.moments(h3a, mask if self.masked_bn else None)
        if self.training:
            self.bn3.update_running(mean, var, n)
        inv, shift = self.bn3.affine(mean, var)
        split = x1.shape[-1] + x2.shape[-1]
        k = self.lin.kernel()
        k12, k3 = k[:split], k[split:]
        k3f = inv[:, None] * k3
        const = shift @ k3
        if self.lin.bias is not None:
            const = const + self.lin.bias
        dt = h3a.dtype
        x12 = torch.cat([x1, x2], dim=-1)
        out = x12 @ k12.to(dt) + h3a @ k3f.to(dt) + const.to(dt)
        if mask is not None:
            out = out * mask[..., None].to(dt)
        return out

    def finish(
        self, xs: list[torch.Tensor], mask: Optional[torch.Tensor]
    ) -> torch.Tensor:
        """Concat of the three conv outputs (embedding blocks, no lin)."""
        out = torch.cat(xs, dim=-1)
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return out

    def forward(
        self,
        x: torch.Tensor,
        adj: Adjacency,
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """A lone embedding block (stage 3); pooling blocks always run
        paired (``paired_blocks``)."""
        x1 = self.conv_step(1, x, adj, mask)
        x2 = self.conv_step(2, x1, adj, mask)
        return self.finish([x1, x2, self.conv_step(3, x2, adj, mask)], mask)


def _dual_lin(
    e_blk: GNNBlock,
    p_blk: GNNBlock,
    i: int,
    agg: torch.Tensor,    # [B, N, in] shared (layer 1) or [B, N, 2F] concat
    denom: torch.Tensor,  # [B, N, 1] clamped rowsum
    *,
    shared_input: bool,
) -> torch.Tensor:
    """Both streams' conv_i lins as one matmul on the concatenated stream:
    kernels side by side for the shared layer-1 input, block-diagonal for
    layers 2+ (the zero blocks add exact +0.0 terms). Returns the RAW lin
    outputs (pre-normalize, pre-mask)."""
    ke, kp = e_blk.conv(i).lin.kernel(), p_blk.conv(i).lin.kernel()
    be, bp = e_blk.conv(i).lin.bias, p_blk.conv(i).lin.bias
    h = agg / denom
    if shared_input:
        k = torch.cat([ke, kp], dim=1)
    else:
        k = torch.cat(
            [
                torch.cat([ke, ke.new_zeros(ke.shape[0], kp.shape[1])], dim=1),
                torch.cat([kp.new_zeros(kp.shape[0], ke.shape[1]), kp], dim=1),
            ],
            dim=0,
        )
    out = h @ k.to(h.dtype)
    if be is not None or bp is not None:
        be = be if be is not None else ke.new_zeros(ke.shape[1])
        bp = bp if bp is not None else kp.new_zeros(kp.shape[1])
        out = out + torch.cat([be, bp]).to(out.dtype)
    return out


def _half_norms(c32: torch.Tensor, f: int):
    a, b = c32[..., :f], c32[..., f:]
    na = torch.clamp_min(torch.sqrt(torch.sum(a * a, dim=-1, keepdim=True)), 1e-12)
    nb = torch.clamp_min(torch.sqrt(torch.sum(b * b, dim=-1, keepdim=True)), 1e-12)
    return a, b, na, nb


class DualL2Norm(torch.autograd.Function):
    """Row L2-normalize each half of a [..., 2F] dual-stream concat with f32
    sums of squares, and the JAX package's hand-written backward
    d(a/na) = g/na - a * (a.g)/na^3 per half. On a row whose norm is
    clamped at 1e-12 (padded rows are all zero) the second term is zeroed:
    the clamp has zero derivative there, where autograd of sqrt gives NaN."""

    @staticmethod
    def forward(ctx, cat, f):
        a, b, na, nb = _half_norms(cat.float(), f)
        ctx.save_for_backward(cat)
        ctx.f = f
        return torch.cat([a / na, b / nb], dim=-1).to(cat.dtype)

    @staticmethod
    def backward(ctx, g):
        (cat,) = ctx.saved_tensors
        f = ctx.f
        a, b, na, nb = _half_norms(cat.float(), f)
        g32 = g.float()
        ga, gb = g32[..., :f], g32[..., f:]
        zero = torch.zeros((), device=g.device)
        ra = torch.where(
            na > 1e-12, torch.sum(a * ga, dim=-1, keepdim=True) / (na * na * na), zero
        )
        rb = torch.where(
            nb > 1e-12, torch.sum(b * gb, dim=-1, keepdim=True) / (nb * nb * nb), zero
        )
        d = torch.cat([ga / na - a * ra, gb / nb - b * rb], dim=-1)
        return d.to(cat.dtype), None


def dual_l2norm_2d(cat: torch.Tensor, f: int) -> torch.Tensor:
    """Row L2-normalize each half of a [..., 2F] dual-stream concat
    (:class:`DualL2Norm`)."""
    return DualL2Norm.apply(cat, f)


def _dual_tail(
    e_blk: GNNBlock,
    p_blk: GNNBlock,
    i: int,
    cat: torch.Tensor,  # [B, N, 2F] RAW lin outputs (e ++ p)
    mask: Optional[torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """l2norm -> mask -> relu -> BN for an equal-width (embed, pool) conv pair
    on the concatenated stream; the per-stream math is that of the solo
    ``conv_step`` chains. In training one two-pass moments computation over
    the concatenated channels normalizes both streams and each block's BN
    gets its half as the running update. Returns (cat, e_half, p_half)."""
    f = cat.shape[-1] // 2
    dt = cat.dtype
    h = dual_l2norm_2d(cat, f)
    if mask is not None:
        h = h * mask[..., None].to(dt)
    h = torch.relu(h)
    be, bp = e_blk.bn(i), p_blk.bn(i)
    if e_blk.training:
        mean, var, n = batch_moments(h, mask if e_blk.masked_bn else None)
        be.update_running(mean[:f], var[:f], n)
        bp.update_running(mean[f:], var[f:], n)
    else:
        mean = torch.cat([be.running_mean, bp.running_mean])
        var = torch.cat([be.running_var, bp.running_var])
    scale = torch.cat([be.weight, bp.weight])
    bias = torch.cat([be.bias, bp.bias])
    inv = torch.rsqrt(var + be.eps) * scale
    out = ((h - mean) * inv + bias).to(dt)
    return out, out[..., :f], out[..., f:]


def paired_blocks(
    embed_blk: GNNBlock,
    pool_blk: GNNBlock,
    x: torch.Tensor,
    adj: Adjacency,
    mask: Optional[torch.Tensor],
    *,
    n_nodes: Optional[torch.Tensor] = None,
    pool_pre: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | tuple[torch.Tensor, torch.Tensor]]:
    """Run an (embed, pool) block pair over one shared aggregation stream:
    layer 1 reads the same A @ x, layers 2-3 aggregate the concatenated
    streams in one matvec and split.

    ``pool_pre``: the pool block ends in the fused assign head (B4, needs
    ``n_nodes``) and returns (S, S^T); otherwise it returns assign logits.
    """
    # equal conv widths: both streams' tails run as one (_dual_tail)
    can_dual = embed_blk.hidden_dim == pool_blk.hidden_dim
    agg1 = adj.matvec(x)
    if can_dual:
        denom = torch.clamp_min(adj.rowsum(), 1.0)[..., None].to(agg1.dtype)
        r1 = _dual_lin(embed_blk, pool_blk, 1, agg1, denom, shared_input=True)
        cat, e1, p1 = _dual_tail(embed_blk, pool_blk, 1, r1, mask)
        e_outs, p_outs = [e1], [p1]
        f = embed_blk.hidden_dim
        agg = adj.matvec(cat)
        r2 = _dual_lin(embed_blk, pool_blk, 2, agg, denom, shared_input=False)
        cat, e2, p2 = _dual_tail(embed_blk, pool_blk, 2, r2, mask)
        e_outs.append(e2)
        p_outs.append(p2)
        # layer 3: the output widths differ — each stream runs its own tail
        agg = adj.matvec(cat)
        agg_e, agg_p = agg[..., :f], agg[..., f:]
        e_outs.append(embed_blk.conv_step(3, e2, adj, mask, agg=agg_e))
        p_outs.append(
            pool_blk.conv_step(
                3, p2, adj, mask, agg=agg_p, apply_bn=False, raw=pool_pre
            )
        )
    else:
        e = embed_blk.conv_step(1, x, adj, mask, agg=agg1)
        p = pool_blk.conv_step(1, x, adj, mask, agg=agg1)
        e_outs, p_outs = [e], [p]
        for i in (2, 3):
            he, hp = e_outs[-1], p_outs[-1]
            agg = adj.matvec(torch.cat([he, hp], dim=-1))
            agg_e, agg_p = agg[..., : he.shape[-1]], agg[..., he.shape[-1]:]
            e_outs.append(embed_blk.conv_step(i, he, adj, mask, agg=agg_e))
            p_outs.append(
                pool_blk.conv_step(
                    i, hp, adj, mask, agg=agg_p,
                    apply_bn=i != 3,
                    raw=(i == 3 and pool_pre),
                )
            )
    if pool_pre:
        pool_out = pool_blk.finish_folded_pre(*p_outs, n_nodes)
    else:
        pool_out = pool_blk.finish_folded(*p_outs, mask)
    return embed_blk.finish(e_outs, mask), pool_out


def diff_pool(
    x: torch.Tensor,
    adj: Adjacency,
    assign_logits: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DiffPool: S = softmax(logits) (f32); x' = S^T x; adj' = S^T A S.
    Returns (pooled_x [B,C,F], pooled_adj [B,C,C], S [B,N,C])."""
    s = torch.softmax(assign_logits.float(), dim=-1).to(assign_logits.dtype)
    if mask is not None:
        s = s * mask[..., None].to(s.dtype)
    pooled_x = torch.bmm(s.transpose(1, 2), x)
    return pooled_x, adj.quadform(s), s


def contract_dual_pair(
    s_t: torch.Tensor,  # [B, C, N] (a transposed view of s)
    x: torch.Tensor,    # [B, N, F]
    a_s: torch.Tensor,  # [B, N, C]
) -> tuple[torch.Tensor, torch.Tensor]:
    """(S^T x, S^T (A S)) as one contraction against [x | A S] (forward of
    the JAX package's ``_contract_dual_pair``)."""
    out = torch.bmm(s_t, torch.cat([x, a_s], dim=-1))
    f = x.shape[-1]
    return out[..., :f], out[..., f:]


def diff_pool_from_s(
    x: torch.Tensor,
    adj: Adjacency,
    s: torch.Tensor,    # [B, N, C]
    s_t: torch.Tensor,  # [B, C, N] (same values)
) -> tuple[torch.Tensor, torch.Tensor]:
    """DiffPool contractions for the fused head's dual-layout S. The
    backward is autograd's: the S^T view routes d(S^T) onto S, which gives
    ``_contract_dual_pair``'s ds = [x | A S] @ [ct_x | ct_adj]^T."""
    return contract_dual_pair(s_t, x, adj.matvec(s))
