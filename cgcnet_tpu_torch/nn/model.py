"""CGCNet — the hierarchical soft-pooling graph classifier.

Port of ``cgcnet_tpu/nn/model.py`` (reference ``SoftPoolingGcnEncoder``,
model/network.py:127-291): 3 embedding GNN blocks + 2 pooling GNN blocks +
2 DiffPool stages + per-stage max readout + MLP head, with SAGE, GIN or GAT
convolutions, any of the reference's activations, BN optional. Stage 1
runs on the sparse cell graph: through the BSR kernels when the batch
carries block metadata (B1 builds A's blocks once per batch, B2 runs every
matvec) and the fused assign head (B4 for SAGE + relu, B6 otherwise; in
training B3 and B5 with B4), or through ELL gathers in plain PyTorch when
it does not; stages 2-3 are dense batched matmuls. Eval and training mode
(``model.train()``: BN batch statistics, head dropout); in training over a
data axis (``set_data_axis``) the batch statistics span every rank's graphs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cgcnet_tpu_torch.config import ModelConfig
from cgcnet_tpu_torch.core.graph import CellGraph
from cgcnet_tpu_torch.nn.adjacency import DenseAdj, EllAdj, EllAdjFactored
from cgcnet_tpu_torch.nn.blocks import (
    GNNBlock,
    diff_pool,
    diff_pool_from_s,
    paired_blocks,
)
from cgcnet_tpu_torch.nn.jk import BiLSTMParams, DenseJK
from cgcnet_tpu_torch.nn.layers import TorchBatchNorm, TorchLinear, activation
from cgcnet_tpu_torch.ops.bsr import bsr_build_blocks, live_slot_counts
from cgcnet_tpu_torch.ops.ell import EPS, renorm_dense, renorm_ell
from cgcnet_tpu_torch.parallel.mesh import GraphAxis

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tri_state(v, auto: bool) -> bool:
    # 'auto'/'always'/'never' or a real bool — never bool() a string
    if isinstance(v, str):
        return {"auto": auto, "always": True, "never": False}[v]
    return bool(v)


def make_stage1_adj(
    graph: CellGraph, cfg: ModelConfig, dtype: torch.dtype
) -> EllAdj | EllAdjFactored:
    """The stage-1 adjacency, in the JAX package's branch order:

    - no transpose tables (``nbr_t``): ``EllAdj`` with the ``renorm_ell``
      weights (``norm_adj``) or the graph's own, autograd's backward;
    - no block metadata (``blk_cols``) or ``use_pallas='never'``: the
      factored A = diag(scale)·B_off + diag(self_w) over ELL gathers;
    - otherwise the factored A with its BSR blocks built once (B1; the self
      weight folds into ELL slot 0). With gradients enabled a second B1
      launch builds the binary blocks of B_off^T for the backward. Beside
      each B1 launch, the live slot counts of its blocks (B2's
      ``live_slots``), once per batch and direction.

    ``use_pallas='auto'`` means the kernel path here: the CUDA kernels on a
    CUDA batch, their plain versions on a CPU batch."""
    if graph.nbr_t is None:
        if cfg.norm_adj:
            w = renorm_ell(graph.nbr, graph.nbr_mask, graph.n_nodes,
                           cfg.self_weight)
        else:
            w = graph.weights()
        return EllAdj(nbr=graph.nbr, w=w.to(dtype))
    bsr = _tri_state(cfg.use_pallas, True) and graph.blk_cols is not None
    n = graph.capacity
    row = torch.arange(n, device=graph.device, dtype=graph.nbr.dtype)[None, :, None]
    is_slot_self = graph.nbr == row
    off = graph.nbr_mask * (~is_slot_self)
    off_t = graph.nbr_t_mask * (graph.nbr_t != row)
    deg = torch.sum(off, dim=-1)
    valid = graph.mask(dtype)
    if cfg.norm_adj:
        scale = (1.0 - cfg.self_weight) / (deg + EPS) * valid
        self_w = cfg.self_weight * valid
        # renormalized rows sum to <= 1: SAGE's clamp(min=1) divisor is 1
        rowsum = torch.ones_like(valid)
    else:
        # binary adjacency: a self loop only where the graph carries one
        has_self = torch.amax(graph.nbr_mask * is_slot_self, dim=-1)
        scale = valid
        self_w = has_self * valid
        rowsum = (deg + has_self) * valid
    vals = vals_t = slots = slots_t = None
    if bsr:
        is_self = graph.nbr_mask * is_slot_self
        w_fwd = scale[..., None] * off + self_w[..., None] * is_self
        vals = bsr_build_blocks(
            graph.nbr, w_fwd, graph.blk_cols, graph.blk_mask, dtype
        )
        # made here, beside B1, and not by the loader: every batch with block
        # metadata reaches B1 through this function, also one built outside
        # GraphLoader (a converted JAX batch, a test's), so one place serves
        # all; it costs a few small launches per batch and direction, none
        # per B2 call
        slots = live_slot_counts(graph.blk_mask)
        if torch.is_grad_enabled():
            if graph.blk_cols_t is None:
                raise ValueError(
                    "a backward through stage 1 needs the transpose block "
                    "metadata (blk_cols_t) the loader builds"
                )
            vals_t = bsr_build_blocks(
                graph.nbr_t, off_t, graph.blk_cols_t, graph.blk_mask_t, dtype
            )
            slots_t = live_slot_counts(graph.blk_mask_t)
    return EllAdjFactored(
        nbr=graph.nbr, off_mask=off.to(dtype), nbr_t=graph.nbr_t,
        off_mask_t=off_t.to(dtype), scale=scale.to(dtype),
        self_w=self_w.to(dtype), rowsum_=rowsum.to(dtype),
        blk_cols=graph.blk_cols, blk_mask=graph.blk_mask,
        blk_cols_t=graph.blk_cols_t, blk_mask_t=graph.blk_mask_t,
        vals=vals, vals_t=vals_t, slots=slots, slots_t=slots_t,
        impl="bsr" if bsr else "gather",
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
        self.cfg = cfg
        c = cfg
        assign1, assign2 = c.assign_dims
        in1, in2, in3 = c.stage_input_dims

        def block(in_dim, hidden, emb, lin):
            return GNNBlock(
                in_dim, hidden, emb, use_bias=c.bias, use_lin=lin,
                masked_bn=c.masked_bn, gcn_name=c.gcn_name, act=c.activation,
                use_bn=c.bn, fold_tail=c.fold_assign_tail,
                gat_heads=c.gat_heads,
            )

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

    def set_data_axis(self, axis: Optional[GraphAxis]) -> None:
        """Take the training statistics (every BN's batch moments and the
        fused tail's B3 sums) over the rows of every rank of the data
        ``axis`` (None: this process's rows alone). Eval mode reads the
        running statistics and never the axis."""
        for mod in self.modules():
            if isinstance(mod, TorchBatchNorm):
                mod.axis = axis

    def reset_parameters(self, generator: torch.Generator) -> None:
        """torch-default uniform init (fan-in bounds) of every linear and
        LSTM weight in module order; BN keeps scale 1, shift 0."""
        for mod in self.modules():
            if isinstance(mod, (TorchLinear, BiLSTMParams)):
                mod.reset_parameters(generator)

    def forward(
        self,
        graph: CellGraph,
        generator: Optional[torch.Generator] = None,
        collect_assign: bool = False,
    ) -> torch.Tensor | tuple[torch.Tensor, list[torch.Tensor]]:
        """Logits, or with ``collect_assign`` (logits, [S1, S2]): the
        soft assignments of the two DiffPool stages, S1 [B, N, C1] (B4's or
        B6's output where the fused head runs) and S2 [B, C1, C2]."""
        c = self.cfg
        dtype = DTYPES[c.compute_dtype]
        x = graph.x.to(dtype)
        mask = graph.mask(dtype)

        # ---- stage 1: sparse ----
        adj = make_stage1_adj(graph, c, dtype)
        # fused assign softmax (B6): with the block path ('auto') and a
        # capacity that tiles by 128; it folds BN into the lin, so it needs
        # the folded tail and BN
        fsm = _tri_state(
            c.fused_assign_softmax,
            isinstance(adj, EllAdjFactored) and adj.impl == "bsr",
        )
        fsm = fsm and c.fold_assign_tail and c.bn and graph.capacity % 128 == 0
        # the deeper fold (B4 with B3/B5 in training): SAGE + relu only
        fan = _tri_state(c.fused_assign_norm, fsm)
        fan = fan and fsm and c.gcn_name == "SAGE" and c.activation == "relu"
        outs = []
        embed, assign_out = paired_blocks(
            self.embed1, self.pool1, x, adj, mask,
            n_nodes=graph.n_nodes, pool_softmax="pre" if fan else fsm,
        )
        if c.jk:
            embed = self.jk1(embed)
        outs.append(masked_max_readout(embed, mask, c.masked_readout))
        if fsm:
            s1 = assign_out[0]
            x, pooled_adj = diff_pool_from_s(embed, adj, *assign_out)
        else:
            x, pooled_adj, s1 = diff_pool(embed, adj, assign_out, mask)

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
        x, pooled_adj, s2 = diff_pool(embed, adj2, assign_logits, None)

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
        act = activation(c.activation)
        for name in self.pred_names:
            h = act(getattr(self, name)(h))
            if self.training and c.drop_out > 0:
                h = dropout(h, c.drop_out, generator)
        logits = self.pred_out(h).float()
        if collect_assign:
            return logits, [s1, s2]
        return logits


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
