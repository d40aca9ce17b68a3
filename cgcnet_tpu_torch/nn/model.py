"""CGCNet — the hierarchical soft-pooling graph classifier.

Port of ``cgcnet_tpu/nn/model.py`` (reference ``SoftPoolingGcnEncoder``,
model/network.py:127-291): 3 embedding GNN blocks + 2 pooling GNN blocks +
2 DiffPool stages + per-stage max readout + MLP head. Stage 1 runs on the
sparse cell graph through the BSR kernels (B1 builds A's blocks once per
batch, B2 runs every matvec) and the fused assign head (B4; in training
B3 and B5 too); stages 2-3 are dense batched matmuls.

The path is the JAX package's canonical one (SAGE, relu, BN, JK,
``fold_assign_tail`` and the fused "pre" assign head, which needs a batch
with BSR metadata), in eval and training mode (``model.train()``: BN batch
statistics, head dropout). GIN/GAT and the gather path for batches without
metadata are not ported yet and raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cgcnet_tpu_torch.config import ModelConfig
from cgcnet_tpu_torch.core.graph import CellGraph
from cgcnet_tpu_torch.nn.adjacency import DenseAdj, EllAdjFactored
from cgcnet_tpu_torch.nn.blocks import (
    GNNBlock,
    diff_pool,
    diff_pool_from_s,
    paired_blocks,
)
from cgcnet_tpu_torch.nn.jk import BiLSTMParams, DenseJK
from cgcnet_tpu_torch.nn.layers import TorchLinear
from cgcnet_tpu_torch.ops.bsr import bsr_build_blocks
from cgcnet_tpu_torch.ops.ell import EPS, renorm_dense

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tri_state(v, auto: bool) -> bool:
    # 'auto'/'always'/'never' or a real bool — never bool() a string
    if isinstance(v, str):
        return {"auto": auto, "always": True, "never": False}[v]
    return bool(v)


def make_stage1_adj(
    graph: CellGraph, cfg: ModelConfig, dtype: torch.dtype
) -> EllAdjFactored:
    """Stage-1 adjacency A = diag(scale)·B_off + diag(self_w) with its BSR
    blocks built once (B1); the self weight folds into ELL slot 0. With
    gradients enabled a second B1 launch builds the binary blocks of
    B_off^T from the transpose tables, for the backward."""
    if graph.blk_cols is None:
        raise ValueError(
            "batch carries no BSR block metadata (blk_cols): the gather path "
            "for such batches is not ported yet — raise data.bsr_blocks or "
            "keep data.spatial_sort on"
        )
    n = graph.capacity
    row = torch.arange(n, device=graph.device, dtype=graph.nbr.dtype)[None, :, None]
    is_slot_self = graph.nbr == row
    off = graph.nbr_mask * (~is_slot_self)
    deg = torch.sum(off, dim=-1)
    valid = graph.mask(dtype)
    if cfg.norm_adj:
        scale = (1.0 - cfg.self_weight) / (deg + EPS) * valid
        self_w = cfg.self_weight * valid
        # renormalized rows sum to <= 1: SAGE's clamp(min=1) divisor is 1
        rowsum = torch.ones_like(valid)
    else:
        has_self = torch.amax(graph.nbr_mask * is_slot_self, dim=-1)
        scale = valid
        self_w = has_self * valid
        rowsum = (deg + has_self) * valid
    is_self = graph.nbr_mask * is_slot_self
    w_fwd = scale[..., None] * off + self_w[..., None] * is_self
    vals = bsr_build_blocks(
        graph.nbr, w_fwd, graph.blk_cols, graph.blk_mask, dtype
    )
    vals_t = None
    if torch.is_grad_enabled():
        if graph.nbr_t is None or graph.blk_cols_t is None:
            raise ValueError(
                "a backward through stage 1 needs the transpose tables "
                "(nbr_t, blk_cols_t) the loader builds"
            )
        off_t = graph.nbr_t_mask * (graph.nbr_t != row)
        vals_t = bsr_build_blocks(
            graph.nbr_t, off_t, graph.blk_cols_t, graph.blk_mask_t, dtype
        )
    return EllAdjFactored(
        rowsum_=rowsum.to(dtype), blk_cols=graph.blk_cols, vals=vals,
        scale=scale.to(dtype), self_w=self_w.to(dtype),
        blk_cols_t=graph.blk_cols_t, vals_t=vals_t,
    )


def masked_max_readout(
    x: torch.Tensor, mask: Optional[torch.Tensor], masked: bool
) -> torch.Tensor:
    """Max over the node axis; ``masked`` sets padded rows to the dtype's
    lowest value first (``masked=False`` keeps the reference's plain max
    over zero-padded rows)."""
    if masked and mask is not None:
        x = x.masked_fill(mask[..., None] <= 0, torch.finfo(x.dtype).min)
    return torch.amax(x, dim=1)


class CGCNet(nn.Module):
    """Hierarchical cell-graph classifier; ``forward(graph)`` returns f32
    logits [B, num_classes]. In training mode BN uses batch statistics and
    updates its running moments, and the head applies dropout with keep
    masks drawn from ``generator`` (a generator on the batch's device)."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        unported = {
            "gcn_name": cfg.gcn_name != "SAGE",
            "activation": cfg.activation != "relu",
            "bn": not cfg.bn,
            "fold_assign_tail": not cfg.fold_assign_tail,
            "fused_assign_softmax": not _tri_state(cfg.fused_assign_softmax, True),
            "fused_assign_norm": not _tri_state(cfg.fused_assign_norm, True),
            "use_pallas": not _tri_state(cfg.use_pallas, True),
        }
        if any(unported.values()):
            raise NotImplementedError(
                "not ported yet: "
                + ", ".join(f"model.{k}={getattr(cfg, k)!r}"
                            for k, bad in unported.items() if bad)
                + " (the port runs SAGE, relu, BN and the fused 'pre' "
                "assign head on the BSR path)"
            )
        self.cfg = cfg
        c = cfg
        assign1, assign2 = c.assign_dims
        in1, in2, in3 = c.stage_input_dims

        def block(in_dim, hidden, emb, lin):
            return GNNBlock(in_dim, hidden, emb, use_bias=c.bias, use_lin=lin,
                            masked_bn=c.masked_bn)

        self.embed1 = block(in1, c.hidden_dim, c.embedding_dim, False)
        self.pool1 = block(in1, c.assign_hidden_dim, assign1, True)
        self.embed2 = block(in2, c.hidden_dim, c.embedding_dim, False)
        self.pool2 = block(in2, c.assign_hidden_dim, assign2, True)
        self.embed3 = block(in3, c.hidden_dim, c.embedding_dim, False)
        if c.jk:
            self.jk1 = DenseJK(c.hidden_dim, 3)
            self.jk2 = DenseJK(c.hidden_dim, 3)
            self.jk3 = DenseJK(c.hidden_dim, 3)
        # head layers keep the JAX package's names (pred_0.., pred_out)
        dims = (c.pred_input_dim, *c.pred_hidden_dims)
        self.pred_names = [f"pred_{i}" for i in range(len(dims) - 1)]
        for name, a, b in zip(self.pred_names, dims[:-1], dims[1:]):
            self.add_module(name, TorchLinear(a, b))
        self.pred_out = TorchLinear(dims[-1], c.num_classes)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch-default uniform init (fan-in bounds) of every linear and
        LSTM weight in module order; BN keeps scale 1, shift 0."""
        for mod in self.modules():
            if isinstance(mod, (TorchLinear, BiLSTMParams)):
                mod.reset_parameters(generator)

    def forward(
        self, graph: CellGraph, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        c = self.cfg
        if graph.capacity % 128:
            raise ValueError(
                f"node capacity {graph.capacity} must tile by 128 (the BSR "
                "blocks and the fused assign head)"
            )
        dtype = DTYPES[c.compute_dtype]
        x = graph.x.to(dtype)
        mask = graph.mask(dtype)

        # ---- stage 1: sparse, BSR blocks ----
        adj = make_stage1_adj(graph, c, dtype)
        outs = []
        embed, (s, s_t) = paired_blocks(
            self.embed1, self.pool1, x, adj, mask,
            n_nodes=graph.n_nodes, pool_pre=True,
        )
        if c.jk:
            embed = self.jk1(embed)
        outs.append(masked_max_readout(embed, mask, c.masked_readout))
        x, pooled_adj = diff_pool_from_s(embed, adj, s, s_t)

        # ---- stage 2: dense clusters ----
        if c.norm_adj:
            pooled_adj = renorm_dense(pooled_adj, c.self_weight)
        adj2 = DenseAdj(pooled_adj.to(dtype))
        embed, assign_logits = paired_blocks(
            self.embed2, self.pool2, x, adj2, None
        )
        if c.jk:
            embed = self.jk2(embed)
        outs.append(torch.amax(embed, dim=1))
        x, pooled_adj, _ = diff_pool(embed, adj2, assign_logits, None)

        # ---- stage 3 ----
        if c.norm_adj:
            pooled_adj = renorm_dense(pooled_adj, c.self_weight)
        adj3 = DenseAdj(pooled_adj.to(dtype))
        embed = self.embed3(x, adj3, None)
        if c.jk:
            embed = self.jk3(embed)
        outs.append(torch.amax(embed, dim=1))

        # ---- head (f32 whatever the compute dtype) ----
        h = torch.cat(outs, dim=-1).float()
        for name in self.pred_names:
            h = torch.relu(getattr(self, name)(h))
            if self.training and c.drop_out > 0:
                h = dropout(h, c.drop_out, generator)
        return self.pred_out(h).float()


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Inverted dropout (flax ``Dropout``): keep with probability 1-rate and
    scale kept values by 1/(1-rate). The keep mask is drawn from
    ``generator`` (F.dropout takes none)."""
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy (reference F.cross_entropy,
    model/network.py:289)."""
    return F.cross_entropy(logits.float(), labels.long())
