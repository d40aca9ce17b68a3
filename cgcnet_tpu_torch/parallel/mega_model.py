"""Whole-slide CGCNet: the patch-trained model over an unsampled slide graph.

Port of ``cgcnet_tpu/parallel/mega_model.py`` (BASELINE.json configs 4-5).
The same ``CGCNet`` parameters that grade patches run over a 100k+-nuclei
slide: stage 1 aggregates over the node-partitioned slide (the halo
exchange of ``parallel/mega_graph.py``), BatchNorm sums its statistics over
the graph axis, DiffPool contracts to the cluster space with one sum over
the graph axis, and stages 2-3 and the head run on the pooled clusters.
``mega_forward`` reads its parameters from the port's ``CGCNet`` module by
the JAX package's parameter paths (``pool1.gcn3.lin`` ...), so a patch
checkpoint serves a slide unchanged.

Stage-1 aggregation follows the JAX package's branch order (``_ShardedAdj``):
with block tables, ``bsr_local_matmul`` over int8 blocks built once per
slide by B1 (B8 for the wide legs, B2 otherwise); without them ELL gathers,
split into interior and boundary rows under ``halo_overlap``. The pooling
block's assign tail is B4 in serving, B3 + B4 (``c_out``-padded) + B5 in
training, and B9a/B9b + B5 chunk by chunk on the capacity path
(``model.assign_tail_chunk``); ``_pool_aggregate`` takes the A @ S leg and
both DiffPool contractions under one autograd Function whose backward runs
the transpose leg through B8 with its row accumulator.

Statistics flow out of the forward as values (``return_stats``), never by
mutating the module inside it, so the segments that ``remat`` /
``remat_stage1`` recompute under ``torch.utils.checkpoint`` recompute
exactly; ``parallel/mega_train.py`` writes them back after the step.

Over D shards each process runs one shard (``MegaInputs.axis``, its rows
of the slide and its tables) and the collectives run over the group; the
pooled stages and the head compute the same values on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from cgcnet_tpu_torch.config import ModelConfig
from cgcnet_tpu_torch.nn.blocks import dual_l2norm_2d
from cgcnet_tpu_torch.nn.layers import activation, l2_normalize
from cgcnet_tpu_torch.nn.model import DTYPES, _tri_state, dropout
from cgcnet_tpu_torch.ops import assign_head as ah
from cgcnet_tpu_torch.ops.bsr import (
    BAND_MIN_F,
    TILE,
    bsr_build_blocks,
    bsr_matmul_banded,
    check_band_windows,
    live_slot_counts,
)
from cgcnet_tpu_torch.ops.ell import (
    EPS,
    bsr_local_matmul,
    ell_gather_sum,
    renorm_dense,
)
from cgcnet_tpu_torch.parallel.mega_graph import (
    ShardedBsrTables,
    ShardedGraphPartition,
    all_gather,
    halo_exchange,
    halo_exchange_vjp,
    psum,
)
from cgcnet_tpu_torch.parallel.mesh import ONE, GraphAxis


@dataclasses.dataclass
class MegaInputs:
    """Device-ready slide graph of one shard: shard ``axis.rank`` of
    ``axis.size``, whose collectives the forward runs over. The optional
    block fields (``parallel/mega_graph.build_bsr_tables``) switch stage 1
    to the block kernels; ``vals``/``vals_t`` are the int8 blocks of the
    binary local operator and its transpose, built once per slide."""

    x: torch.Tensor            # f32[Ns, F]
    nbr_remap: torch.Tensor    # i32[Ns, K]
    nbr_mask: torch.Tensor     # f32[Ns, K]
    req_idx: torch.Tensor      # i32[D, P]
    req_mask: torch.Tensor     # f32[D, P]
    valid: torch.Tensor        # f32[Ns] real-node mask (a prefix)
    blk_cols: Optional[torch.Tensor] = None    # i32[R, M]
    blk_mask: Optional[torch.Tensor] = None    # f32[R, M]
    nbr_t: Optional[torch.Tensor] = None       # i32[NC, KT]
    mask_t: Optional[torch.Tensor] = None      # f32[NC, KT]
    blk_cols_t: Optional[torch.Tensor] = None  # i32[RC, MT]
    blk_mask_t: Optional[torch.Tensor] = None  # f32[RC, MT]
    win_base: Optional[torch.Tensor] = None    # i32[1, S] (None: no band)
    win_base_t: Optional[torch.Tensor] = None  # i32[1, S_t]
    win_halo: Optional[torch.Tensor] = None    # i32[1, S, 2]
    vals: Optional[torch.Tensor] = None        # i8[1, R, M, T, T]
    vals_t: Optional[torch.Tensor] = None      # i8[1, RC, MT, T, T]
    slots: Optional[torch.Tensor] = None       # i32[R] live slot counts
    slots_t: Optional[torch.Tensor] = None     # i32[RC]
    axis: GraphAxis = ONE

    @property
    def device(self) -> torch.device:
        return self.x.device


def prepare_mega_inputs(
    x: np.ndarray,
    part: ShardedGraphPartition,
    device,
    n_real: Optional[int] = None,
    bsr: Optional[ShardedBsrTables] = None,
    axis: GraphAxis = ONE,
) -> MegaInputs:
    """Host tables of the whole slide (``x`` [N, F], ``n_real`` real rows
    first) -> shard ``axis.rank``'s :class:`MegaInputs` on ``device``: its
    rows, its tables, its send tables [D, P]. ValueError unless the tables
    were built for ``axis.size`` shards. With ``bsr`` the int8 blocks of
    the local operator (off-diagonal slots) and of its transpose are built
    here, once per slide (two B1 launches on a card); the transpose blocks
    cover the local rows only when the tables are a hybrid transpose."""
    axis.check(part.num_shards)
    r = axis.rank
    device = torch.device(device)
    put = lambda a, dt=None: torch.as_tensor(np.ascontiguousarray(a),
                                             dtype=dt, device=device)
    ns = part.nbr_remap.shape[1]
    total = part.num_shards * ns
    # the padding sits at the global end: each shard's real rows a prefix
    valid = np.zeros(ns, np.float32)
    valid[: min(max((n_real if n_real is not None else total) - r * ns, 0),
                ns)] = 1.0
    inp = MegaInputs(
        x=put(x[r * ns:(r + 1) * ns], torch.float32),
        nbr_remap=put(part.nbr_remap[r], torch.int32),
        nbr_mask=put(part.nbr_mask[r], torch.float32),
        req_idx=put(part.req_idx[r], torch.int32),
        req_mask=put(part.req_mask[r], torch.float32),
        valid=put(valid),
        axis=axis,
    )
    if bsr is None:
        return inp
    inp.blk_cols = put(bsr.blk_cols[r], torch.int32)
    inp.blk_mask = put(bsr.blk_mask[r], torch.float32)
    inp.nbr_t = put(bsr.nbr_t[r], torch.int32)
    inp.mask_t = put(bsr.mask_t[r], torch.float32)
    inp.blk_cols_t = put(bsr.blk_cols_t[r], torch.int32)
    inp.blk_mask_t = put(bsr.blk_mask_t[r], torch.float32)
    if bsr.win_base is not None:
        inp.win_base = put(bsr.win_base[r:r + 1], torch.int32)
    if bsr.win_base_t is not None:
        inp.win_base_t = put(bsr.win_base_t[r:r + 1], torch.int32)
    if bsr.win_halo is not None:
        inp.win_halo = put(bsr.win_halo[r:r + 1], torch.int32)
    build_vals(inp)
    return inp


def check_windows(inp: MegaInputs) -> None:
    """B8's window contract, held once per slide on the tables it will
    read (its launches skip the per-call check): the forward operator over
    [x ++ halo], the transpose over the local rows alone."""
    ns, nc = inp.nbr_remap.shape[0], inp.nbr_t.shape[0]
    if inp.win_base is not None:
        check_band_windows(inp.blk_cols[None], inp.blk_mask[None] > 0,
                           inp.win_base.reshape(1, -1), ns, (nc - ns) // TILE,
                           None if inp.win_halo is None
                           else inp.win_halo.reshape(1, -1))
    if inp.win_base_t is not None:
        check_band_windows(inp.blk_cols_t[None], inp.blk_mask_t[None] > 0,
                           inp.win_base_t.reshape(1, -1), ns, 0)


def build_vals(inp: MegaInputs) -> None:
    """The int8 blocks of the binary local operator (self slots excluded:
    the self weight applies outside the block product) and of its
    transpose, over the rows its blocks cover; then the window contract of
    the tables (:func:`check_windows`) and each row tile's live slot count
    (B2's and B8's ``live_slots``), once per set of blocks."""
    row = torch.arange(inp.nbr_remap.shape[0], device=inp.device)
    off = inp.nbr_mask * (inp.nbr_remap != row[:, None]).to(inp.nbr_mask.dtype)
    inp.vals = bsr_build_blocks(
        inp.nbr_remap[None], off[None], inp.blk_cols[None],
        inp.blk_mask[None], torch.int8,
    )
    tr = inp.blk_cols_t.shape[0] * TILE
    inp.vals_t = bsr_build_blocks(
        inp.nbr_t[None, :tr], inp.mask_t[None, :tr], inp.blk_cols_t[None],
        inp.blk_mask_t[None], torch.int8,
    )
    check_windows(inp)
    inp.slots = live_slot_counts(inp.blk_mask)
    inp.slots_t = live_slot_counts(inp.blk_mask_t)


# ---------------------------------------------------------------------------
# autograd Functions of the pool-1 contraction
# ---------------------------------------------------------------------------

class ChunkedPoolContract(torch.autograd.Function):
    """(S^T pembed, S^T A S) with the JAX package's hand-chunked backward:
    d(A S) = S ct_adj and d pembed = S ct_x as one product each, dS
    assembled per static row chunk as pembed_c ct_x^T + (AS)_c ct_adj^T."""

    @staticmethod
    def forward(ctx, s, pembed, a_s, chunk):
        ctx.save_for_backward(s, pembed, a_s)
        ctx.chunk = chunk
        return s.t() @ pembed, s.t() @ a_s

    @staticmethod
    def backward(ctx, ct_x, ct_adj):
        s, pembed, a_s = ctx.saved_tensors
        dt = s.dtype
        ctx_, cta = ct_x.to(dt), ct_adj.to(dt)
        d_a_s = s @ cta
        d_pembed = s @ ctx_
        n = s.shape[0]
        ch = min(ctx.chunk, n)
        ctx_t, cta_t = ctx_.t(), cta.t()
        parts = [
            (pembed[lo:lo + ch] @ ctx_t + a_s[lo:lo + ch] @ cta_t).to(dt)
            for lo in range(0, n, ch)
        ]
        ds = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        return ds, d_pembed, d_a_s, None


def _pad_halo(halo: torch.Tensor, nc: int, ns: int) -> torch.Tensor:
    hp = nc - ns - halo.shape[0]
    if hp:
        halo = torch.cat([halo, halo.new_zeros((hp, halo.shape[1]))], dim=0)
    return halo


class PoolAggregate(torch.autograd.Function):
    """(S^T pembed, S^T A S) with the aggregation A S inside the Function
    (the JAX package's ``_pool_aggregate``): the backward hands every dS
    contribution but the transpose leg's to B8 as its row accumulator
    (``acc``), so dS is written once, split from the halo rows' cotangent,
    which the halo exchange's transpose routes back."""

    @staticmethod
    def forward(ctx, tabs, scale, self_w, pool_ratio, s, pembed):
        (vals, blk_cols, win, vals_t, blk_cols_t, win_t, win_halo, nbr_t_h,
         mask_t_h, slots, slots_t, req_idx, req_mask, nc, axis) = tabs
        ns = s.shape[0]
        halo = _pad_halo(halo_exchange(s, req_idx, req_mask, axis), nc, ns)
        agg = bsr_local_matmul(vals, blk_cols, win, vals_t, blk_cols_t,
                               win_t, s, halo, win_halo, nbr_t_h, mask_t_h,
                               slots, slots_t)
        a_s = scale[:, None] * agg + self_w[:, None] * s
        ctx.tabs = tabs
        ctx.save_for_backward(scale, pool_ratio, s, pembed, a_s)
        return s.t() @ pembed, s.t() @ a_s

    @staticmethod
    def backward(ctx, ct_x, ct_adj):
        (_, _, _, vals_t, blk_cols_t, win_t, _, nbr_t_h, mask_t_h, _, slots_t,
         req_idx, req_mask, _, axis) = ctx.tabs
        scale, pool_ratio, s, pembed, a_s = ctx.saved_tensors
        dt = s.dtype
        ctx_, cta = ct_x.to(dt), ct_adj.to(dt)
        d_pembed = s @ ctx_
        d_a_s = s @ cta
        g = scale[:, None] * d_a_s
        # every dS term except the transpose leg's, summed once; the self
        # loop as pool_ratio * g == self_w * d_a_s
        acc = pembed @ ctx_.t() + a_s @ cta.t() + pool_ratio[:, None] * g
        res = bsr_matmul_banded(vals_t, blk_cols_t, win_t, g[None],
                                ns_rows=g.shape[0], acc=acc[None],
                                check_windows=False, live_slots=slots_t)
        if isinstance(res, tuple):
            ds, d_halo = res[0][0], res[1][0]
        else:
            ds, d_halo = res[0], None
        if nbr_t_h is not None and nbr_t_h.shape[0]:
            # hybrid transpose: the halo rows' in-edges as an ELL gather
            d_halo = ell_gather_sum(nbr_t_h[None], mask_t_h.to(dt)[None],
                                    g[None])[0]
        if d_halo is not None and d_halo.shape[0]:
            ds = ds + halo_exchange_vjp(
                d_halo[: req_idx.numel()].to(dt), req_idx, req_mask,
                s.shape[0], axis,
            )
        return None, None, None, None, ds, d_pembed


# ---------------------------------------------------------------------------
# functional layers over the CGCNet module
# ---------------------------------------------------------------------------

def _bn_moments(stats, h32, valid, train: bool, axis: GraphAxis,
                replicated: bool = False):
    """(mean, var, upd) of BatchNorm over the real rows of the whole graph
    (statistics summed over the graph axis); ``upd`` is the running update
    (momentum 0.1, unbiased variance) in training. ``replicated``: the
    pooled stages compute the same h on every shard, so the summed count is
    D x the rows, and Bessel's correction takes the true count."""
    upd = None
    if train:
        m = valid[:, None].float()
        cnt = psum(torch.sum(m), axis)
        mean = psum(torch.sum(h32 * m, dim=0), axis) / cnt
        var = psum(torch.sum((h32 - mean) ** 2 * m, dim=0), axis) / cnt
        true_cnt = (cnt / psum(torch.ones((), device=h32.device), axis)
                    if replicated else cnt)
        unbiased = var * true_cnt / torch.clamp_min(true_cnt - 1.0, 1.0)
        old_mean = stats["mean"] if stats else torch.zeros_like(mean)
        old_var = stats["var"] if stats else torch.ones_like(var)
        upd = {"mean": (0.9 * old_mean + 0.1 * mean).detach(),
               "var": (0.9 * old_var + 0.1 * unbiased).detach()}
    else:
        mean, var = stats["mean"], stats["var"]
    return mean, var, upd


def _bn(bn, stats, h, valid, train: bool, axis: GraphAxis,
        replicated: bool = False):
    """BatchNorm in f32 over the real rows of the whole graph."""
    h32 = h.float()
    mean, var, upd = _bn_moments(stats, h32, valid, train, axis, replicated)
    out = (h32 - mean) * torch.rsqrt(var + 1e-5) * bn.weight + bn.bias
    return out.to(h.dtype), upd


def _stats_of(model, name: str, i) -> Optional[dict]:
    """Running statistics of ``name``.bn{i} as {'mean', 'var'}."""
    blk = getattr(model, name)
    if not blk.use_bn:
        return None
    bn = blk.bn(i)
    return {"mean": bn.running_mean, "var": bn.running_var}


def _gat_conv(conv, h, agg, valid, cfg: ModelConfig):
    """Dot-product attention conv: over the slide (``agg`` a
    :class:`ShardedAdj`: k/v halo-exchanged, neighbours gathered through
    the remapped ELL lists) or over dense clusters (``agg.dense_adj``)."""
    heads = cfg.gat_heads
    q, k, v = conv.q(h), conv.k(h), conv.v(h)
    feats = q.shape[-1]
    d = feats // heads
    scale = 1.0 / (d ** 0.5)
    n = h.shape[0]
    neg = torch.finfo(torch.float32).min
    if hasattr(agg, "concat_halo"):
        nbr = agg.inp.nbr_remap.long()
        kk = nbr.shape[1]
        gk = agg.concat_halo(k)[nbr]
        gv = agg.concat_halo(v)[nbr]
        qh = q.reshape(n, heads, d)
        e_nbr = torch.einsum("nhd,nkhd->nkh", qh.float(),
                             gk.reshape(n, kk, heads, d).float())
        e_self = torch.einsum("nhd,nhd->nh", qh.float(),
                              k.reshape(n, heads, d).float())[:, None]
        scores = torch.cat([e_self, e_nbr], dim=1) * scale
        smask = torch.cat(
            [torch.ones((n, 1), device=h.device), agg.off_mask.float()], -1
        )[..., None]
        scores = torch.where(smask > 0, scores, neg)
        m = torch.amax(scores, dim=1, keepdim=True)
        ex = torch.exp(scores - m.detach()) * smask
        alpha = (ex / torch.sum(ex, dim=1, keepdim=True)).to(h.dtype)
        out = (
            alpha[:, 0, :, None] * v.reshape(n, heads, d)
            + torch.einsum("nkh,nkhd->nhd", alpha[:, 1:],
                           gv.reshape(n, kk, heads, d))
        ).reshape(n, feats)
    else:
        aa = agg.dense_adj
        logits = torch.einsum(
            "ihd,jhd->hij", q.reshape(n, heads, d).float(),
            k.reshape(n, heads, d).float(),
        ) * scale
        logits = torch.where((aa > 0)[None], logits, neg)
        alpha = torch.softmax(logits, dim=-1).to(h.dtype)
        alpha = alpha * (torch.sum(aa, -1) > 0)[None, :, None].to(h.dtype)
        out = torch.einsum(
            "hij,jhd->ihd", alpha, v.reshape(n, heads, d)
        ).reshape(n, feats)
    return out * valid[:, None]


def _paired_layers12(model, name_e, name_p, x, agg, valid, cfg, train,
                     stats_out: Optional[dict], replicated: bool = False):
    """Layers 1-2 of an (embed, pool) SAGE pair over one shared aggregation
    stream (one matvec per layer on [h_e | h_p], merged lins, one
    l2norm/mask/act/BN chain over the concatenated channels). Returns
    ([e1, e2], [p1, p2], agg3_e, agg3_p): the slices of A @ [e2 | p2] the
    two conv3's consume."""
    be, bp = getattr(model, name_e), getattr(model, name_p)
    act = activation(cfg.activation)
    f = be.gcn1.lin.features

    def dual_lin(i, ah_, shared):
        dt = ah_.dtype
        denom = torch.clamp_min(agg.rowsum(), 1.0)[:, None].to(dt)
        le, lp = be.conv(i).lin, bp.conv(i).lin
        ke, kp = le.kernel(), lp.kernel()
        if shared:
            k = torch.cat([ke, kp], dim=1)
        else:
            k = torch.cat([
                torch.cat([ke, ke.new_zeros((ke.shape[0], kp.shape[1]))], 1),
                torch.cat([kp.new_zeros((kp.shape[0], ke.shape[1])), kp], 1),
            ], 0)
        out = (ah_ / denom) @ k.to(dt)
        if le.bias is not None or lp.bias is not None:
            bias_e = le.bias if le.bias is not None else ke.new_zeros(f)
            bias_p = lp.bias if lp.bias is not None else kp.new_zeros(f)
            out = out + torch.cat([bias_e, bias_p]).to(dt)
        return out

    def dual_tail(i, cat):
        h = dual_l2norm_2d(cat, f).to(cat.dtype)
        h = h * valid[:, None].to(cat.dtype)
        h = act(h)
        st_e, st_p = _stats_of(model, name_e, i), _stats_of(model, name_p, i)
        st = {key: torch.cat([st_e[key], st_p[key]]) for key in ("mean", "var")}
        mean, var, upd = _bn_moments(st, h.float(), valid, train, agg.axis,
                                     replicated)
        scale = torch.cat([be.bn(i).weight, bp.bn(i).weight])
        bias = torch.cat([be.bn(i).bias, bp.bn(i).bias])
        out = ((h.float() - mean) * torch.rsqrt(var + 1e-5) * scale
               + bias).to(h.dtype)
        if upd is not None and stats_out is not None:
            stats_out.setdefault(name_e, {})[f"bn{i}"] = {
                key: val[:f] for key, val in upd.items()}
            stats_out.setdefault(name_p, {})[f"bn{i}"] = {
                key: val[f:] for key, val in upd.items()}
        return out

    cat1 = dual_tail(1, dual_lin(1, agg(x), shared=True))
    cat2 = dual_tail(2, dual_lin(2, agg(cat1), shared=False))
    agg3 = agg(cat2)
    return ([cat1[:, :f], cat2[:, :f]], [cat1[:, f:], cat2[:, f:]],
            agg3[:, :f], agg3[:, f:])


def _stage1_block(model, name, x, agg, valid, cfg: ModelConfig, train,
                  lin: bool, stats_out: Optional[dict] = None,
                  replicated: bool = False, pre12=None, pre_agg3=None):
    """A GNN block over the slide's nodes (or dense clusters); ``agg`` maps
    h -> A @ h. ``pre12``/``pre_agg3``: layers 1-2 and conv3's aggregation
    from :func:`_paired_layers12`. Pooling blocks with the folded tail fold
    bn3's affine into the lin kernel."""
    blk = getattr(model, name)
    act = activation(cfg.activation)
    fold3 = lin and cfg.bn and cfg.fold_assign_tail
    outs = []
    h = x
    for i in (1, 2, 3):
        if pre12 is not None and i <= 2:
            h = pre12[i - 1]
            outs.append(h)
            continue
        conv = blk.conv(i)
        if cfg.gcn_name == "GAT":
            out = _gat_conv(conv, h, agg, valid, cfg)
        elif cfg.gcn_name == "SAGE":
            ah_ = pre_agg3 if (i == 3 and pre_agg3 is not None) else agg(h)
            denom = torch.clamp_min(agg.rowsum(), 1.0)[:, None].to(h.dtype)
            out = l2_normalize(conv.lin(ah_ / denom))
        else:
            ah_ = pre_agg3 if (i == 3 and pre_agg3 is not None) else agg(h)
            out = conv.mlp_1(act(conv.mlp_0(ah_)))
        out = out * valid[:, None]
        out = act(out)
        if cfg.bn and not (fold3 and i == 3):
            out, upd = _bn(blk.bn(i), _stats_of(model, name, i), out, valid,
                           train, agg.axis, replicated)
            if upd is not None and stats_out is not None:
                stats_out.setdefault(name, {})[f"bn{i}"] = upd
        h = out
        outs.append(out)
    if fold3:
        h3a = outs[2]
        dt = h3a.dtype
        mean, var, upd = _bn_moments(_stats_of(model, name, 3), h3a.float(),
                                     valid, train, agg.axis, replicated)
        if upd is not None and stats_out is not None:
            stats_out.setdefault(name, {})["bn3"] = upd
        bn3 = blk.bn3
        inv = torch.rsqrt(var + 1e-5) * bn3.weight
        shift = bn3.bias - mean * inv
        k = blk.lin.kernel()
        split = outs[0].shape[-1] + outs[1].shape[-1]
        k12, k3 = k[:split], k[split:]
        const = shift @ k3
        if blk.lin.bias is not None:
            const = const + blk.lin.bias
        cat12 = torch.cat(outs[:2], dim=-1)
        out = (cat12 @ k12.to(dt) + h3a @ (inv[:, None] * k3).to(dt)
               + const.to(dt))
        return out * valid[:, None]
    cat = torch.cat(outs, dim=-1) * valid[:, None]
    if lin:
        cat = blk.lin(cat) * valid[:, None]
    return cat


def _jk(jk, h):
    """DenseJK over the nodes — per node, no communication."""
    return jk(h[None])[0]


class ShardedAdj:
    """A = diag(scale) · B_off + diag(self_w) over one shard's rows: the
    block kernels over int8 blocks when the inputs carry tables, else ELL
    gathers over [local ++ halo] rows (interior and boundary rows apart
    under ``overlap``, as the JAX package splits them to hide its
    all-to-all)."""

    def __init__(self, inputs: MegaInputs, cfg: ModelConfig, overlap=False,
                 dtype=torch.float32):
        self.inp = inputs
        self.axis = inputs.axis
        self.overlap = overlap
        row = torch.arange(inputs.nbr_remap.shape[0], device=inputs.device)
        off32 = inputs.nbr_mask * (
            inputs.nbr_remap != row[:, None]).to(inputs.nbr_mask.dtype)
        self.off_mask = off32.to(dtype)
        deg = torch.sum(off32, dim=-1)
        self.bsr = inputs.blk_cols is not None
        if self.bsr and inputs.vals is None:
            build_vals(inputs)
        valid = inputs.valid
        if cfg.norm_adj:
            p = cfg.self_weight
            self.scale = ((1.0 - p) / (deg + EPS) * valid).to(dtype)
            self.self_w = (p * valid).to(dtype)
            # self_w / scale from deg: the pool backward writes the self
            # loop as pool_ratio * (scale * dA S)
            self.pool_ratio = (p / (1.0 - p) * (deg + EPS) * valid).to(dtype)
            self._rowsum = torch.ones_like(deg)
        else:
            has_self = torch.amax(
                inputs.nbr_mask
                * (inputs.nbr_remap == row[:, None]).to(inputs.nbr_mask.dtype),
                dim=-1,
            )
            self.scale = valid.to(dtype)
            self.self_w = (has_self * valid).to(dtype)
            self.pool_ratio = self.self_w
            self._rowsum = (deg + has_self) * valid

    def concat_halo(self, h):
        """[Ns, F] -> [Ns + halo, F], the index space of ``nbr_remap``."""
        return torch.cat(
            [h, halo_exchange(h, self.inp.req_idx, self.inp.req_mask,
                              self.axis)], 0
        )

    def _tables(self):
        inp = self.inp
        empty = torch.zeros((1, 0), dtype=torch.int32, device=inp.device)
        win = inp.win_base.reshape(1, -1) if inp.win_base is not None else empty
        win_t = (inp.win_base_t.reshape(1, -1) if inp.win_base_t is not None
                 else empty)
        win_halo = (inp.win_halo.reshape(1, -1) if inp.win_halo is not None
                    else empty)
        tr = inp.blk_cols_t.shape[0] * TILE
        if tr < inp.nbr_t.shape[0]:
            nbr_t_h, mask_t_h = inp.nbr_t[tr:], inp.mask_t[tr:]
        else:
            nbr_t_h = mask_t_h = None
        return (inp.vals, inp.blk_cols[None], win, inp.vals_t,
                inp.blk_cols_t[None], win_t, win_halo, nbr_t_h, mask_t_h,
                inp.slots[None], inp.slots_t[None])

    def __call__(self, h):
        inp = self.inp
        if self.bsr:
            halo = _pad_halo(halo_exchange(h, inp.req_idx, inp.req_mask,
                                           self.axis),
                             inp.nbr_t.shape[0], h.shape[0])
            tabs = self._tables()
            agg = bsr_local_matmul(*tabs[:6], h, halo, *tabs[6:])
            return self.scale[:, None] * agg + self.self_w[:, None] * h
        nbr, w = inp.nbr_remap, self.off_mask
        if self.overlap:
            ns = h.shape[0]
            slot_local = torch.where(inp.nbr_mask > 0, nbr,
                                     torch.zeros_like(nbr)) < ns
            interior = torch.all(slot_local, dim=-1)
            out_int = ell_gather_sum(
                torch.clamp_max(nbr, ns - 1)[None],
                (w * interior[:, None])[None], h[None],
            )[0]
            out_bnd = ell_gather_sum(
                nbr[None], (w * (~interior)[:, None])[None],
                self.concat_halo(h)[None],
            )[0]
            agg = out_int + out_bnd
        else:
            agg = ell_gather_sum(nbr[None], w[None],
                                 self.concat_halo(h)[None])[0]
        return self.scale[:, None] * agg + self.self_w[:, None] * h

    def rowsum(self):
        return self._rowsum

    def pool_aggregate_args(self):
        """The tables of :class:`PoolAggregate`, or None when its banded
        transpose backward cannot engage (no blocks, no transpose window
        table)."""
        if not self.bsr or self.inp.win_base_t is None:
            return None
        return (*self._tables(), self.inp.req_idx, self.inp.req_mask,
                self.inp.nbr_t.shape[0], self.axis)


class _DenseAgg:
    """A @ h over the dense pooled adjacency of stages 2-3 (the same on
    every shard; their BatchNorm sums over ``axis`` all the same)."""

    def __init__(self, aa, axis: GraphAxis):
        self.dense_adj = aa
        self.axis = axis

    def __call__(self, h):
        return self.dense_adj @ h

    def rowsum(self):
        return torch.sum(self.dense_adj, dim=-1)


def _merge(stats_out: dict, part: dict) -> None:
    for name, d in part.items():
        stats_out.setdefault(name, {}).update(d)


def mega_forward(
    model,
    cfg: ModelConfig,
    inputs: MegaInputs,
    *,
    train: bool = False,
    halo_overlap: bool = False,
    remat: bool = False,
    remat_stage1: bool = False,
    return_stats: bool = False,
    generator: Optional[torch.Generator] = None,
):
    """Logits [num_classes] (f32) of one slide through ``model``'s
    parameters. ``train``: BN batch statistics over the whole graph and, with
    ``generator``, head dropout (keep masks drawn from it); ``return_stats``
    (train) also returns the running-statistics update {block: {bn_i:
    {mean, var}}} — the caller writes it into the model. ``remat`` /
    ``remat_stage1`` recompute the pool-1 segment / the paired stage-1
    layers in the backward (``torch.utils.checkpoint``)."""
    d1, _ = cfg.assign_dims
    dtype = DTYPES[cfg.compute_dtype]
    use_dropout = train and cfg.drop_out > 0 and generator is not None
    x = inputs.x.to(dtype)
    valid = inputs.valid.to(dtype)
    adj = ShardedAdj(inputs, cfg, overlap=halo_overlap, dtype=dtype)
    axis = inputs.axis
    neg = torch.finfo(dtype).min
    stats_out: dict = {}
    ckpt = lambda fn, *a: checkpoint(fn, *a, use_reentrant=False)
    # recompute only matters with a backward to come
    remat = remat and torch.is_grad_enabled()
    remat_stage1 = remat_stage1 and torch.is_grad_enabled()

    # ---- stage 1 (over the slide's nodes) ----
    paired = (
        cfg.gcn_name == "SAGE" and cfg.bn
        and model.embed1.gcn1.lin.features == model.pool1.gcn1.lin.features
    )
    if paired:
        def stage1_paired(xx):
            so1: dict = {}
            e12_, p12_, agg3_e_, agg3_p_ = _paired_layers12(
                model, "embed1", "pool1", xx, adj, valid, cfg, train, so1)
            emb = _stage1_block(model, "embed1", xx, adj, valid, cfg, train,
                                lin=False, stats_out=so1, pre12=e12_,
                                pre_agg3=agg3_e_)
            return emb, p12_, agg3_p_, so1

        embed, p12, agg3_p, so1 = (ckpt(stage1_paired, x) if remat_stage1
                                   else stage1_paired(x))
        _merge(stats_out, so1)
    else:
        p12 = agg3_p = None
        embed = _stage1_block(model, "embed1", x, adj, valid, cfg, train,
                              lin=False, stats_out=stats_out)
    if cfg.jk:
        embed = _jk(model.jk1, embed) * valid[:, None]
    local_max = torch.amax(
        torch.where(valid[:, None] > 0, embed, torch.full_like(embed, neg)), 0)
    read1 = torch.amax(all_gather(local_max, axis), 0)

    fused_tail = (
        paired and cfg.fold_assign_tail and cfg.activation == "relu"
        and inputs.nbr_remap.shape[0] % TILE == 0
        and _tri_state(cfg.fused_assign_softmax, True)
        and _tri_state(cfg.fused_assign_norm, True)
    )
    n_nodes = valid.float().sum().to(torch.int32).reshape(1)

    def pool1_segment(px, pembed, p12_, agg3_p_):
        so: dict = {}
        pool = model.pool1
        if fused_tail:
            dt = pembed.dtype
            denom = torch.clamp_min(adj.rowsum(), 1.0)[:, None].to(dt)
            x3 = agg3_p_ / denom
            ch = (ah.pick_chunk(x3.shape[0], cfg.assign_tail_chunk)
                  if cfg.assign_tail_chunk else 0)
            if not (train and ch):
                p_raw = pool.gcn3.lin(x3)   # conv3's raw lin output
            x12 = torch.cat(p12_, dim=-1)
            k = pool.lin.kernel()
            split = x12.shape[-1]
            k12, k3 = k[:split], k[split:]
            lin_bias = (pool.lin.bias if pool.lin.bias is not None
                        else k.new_zeros(k.shape[1]))
            bn3 = pool.bn3
            if train:
                n_glob = psum(valid.float().sum(), axis)
                if ch:
                    gl = pool.gcn3.lin
                    b3 = (gl.bias if gl.bias is not None
                          else k.new_zeros(gl.features))
                    s, mean, var = ah.assign_tail_train_chunked_lin(
                        x12[None], x3[None], gl.kernel(), b3, k12, k3,
                        lin_bias, bn3.weight, bn3.bias, n_nodes, n_glob, 1e-5,
                        ch, axis,
                    )
                else:
                    # S lane-padded when B8 takes the A @ S leg: its pad
                    # columns are exact zeros born in the kernel
                    d1c = k3.shape[1]
                    band_on = (inputs.win_base is not None
                               and inputs.win_base.shape[-1] > 0
                               and torch.finfo(dt).bits <= 16)
                    c_pad = -(-d1c // 128) * 128
                    co = c_pad if (band_on and c_pad != d1c) else None
                    s, mean, var = ah.assign_tail_train_psum(
                        x12[None], p_raw[None], k12, k3, lin_bias,
                        bn3.weight, bn3.bias, n_nodes, n_glob, 1e-5, co, axis,
                    )
                unbiased = var * n_glob / torch.clamp_min(n_glob - 1.0, 1.0)
                so["bn3"] = {
                    "mean": (0.9 * bn3.running_mean + 0.1 * mean).detach(),
                    "var": (0.9 * bn3.running_var + 0.1 * unbiased).detach(),
                }
            else:
                inv = torch.rsqrt(bn3.running_var + 1e-5) * bn3.weight
                shift = bn3.bias - bn3.running_mean * inv
                s, _ = ah.assign_head_softmax_pre(
                    x12[None], p_raw[None], k12, inv[:, None] * k3,
                    shift @ k3 + lin_bias, n_nodes,
                )
            s = s[0]
        else:
            so_all: dict = {}
            assign = _stage1_block(model, "pool1", px, adj, valid, cfg, train,
                                   lin=True, stats_out=so_all, pre12=p12_,
                                   pre_agg3=agg3_p_)
            so = so_all.get("pool1", {})
            s = (torch.softmax(assign.float(), dim=-1).to(dtype)
                 * valid[:, None])
        ch_seg = (ah.pick_chunk(s.shape[0], cfg.assign_tail_chunk)
                  if (train and cfg.assign_tail_chunk) else 0)
        pa = adj.pool_aggregate_args() if not ch_seg else None
        if (pa is not None and s.element_size() <= 2
                and s.shape[1] % 128 == 0 and s.shape[1] >= BAND_MIN_F):
            x_pool, adj_pool = PoolAggregate.apply(
                pa, adj.scale, adj.self_w, adj.pool_ratio, s, pembed)
        else:
            a_s = adj(s)
            x_pool, adj_pool = ChunkedPoolContract.apply(
                s, pembed, a_s, ch_seg if ch_seg else s.shape[0])
        x_pool, adj_pool = psum(x_pool, axis), psum(adj_pool, axis)
        if x_pool.shape[0] != d1:
            # lane-padded S: the pooled rows/cols past d1 are exact zeros
            x_pool, adj_pool = x_pool[:d1], adj_pool[:d1, :d1]
        return x_pool, adj_pool, so

    if remat:
        x_pool, adj_pool, pool1_stats = ckpt(pool1_segment, x, embed, p12,
                                             agg3_p)
    else:
        x_pool, adj_pool, pool1_stats = pool1_segment(x, embed, p12, agg3_p)
    if pool1_stats:
        stats_out.setdefault("pool1", {}).update(pool1_stats)

    # ---- stages 2-3 (pooled clusters, the same on every shard) ----
    def dense_stage(name, jk, xx, aa, pre12=None, pre_agg3=None):
        ones = torch.ones(xx.shape[0], dtype=xx.dtype, device=xx.device)
        emb = _stage1_block(model, name, xx, _DenseAgg(aa, axis), ones, cfg,
                            train, lin=False, stats_out=stats_out,
                            replicated=True, pre12=pre12, pre_agg3=pre_agg3)
        return _jk(jk, emb) if cfg.jk else emb

    if cfg.norm_adj:
        adj_pool = renorm_dense(adj_pool[None], cfg.self_weight)[0]
    ones = torch.ones(x_pool.shape[0], dtype=x_pool.dtype, device=x.device)
    if paired:
        e12_2, p12_2, agg3_e2, agg3_p2 = _paired_layers12(
            model, "embed2", "pool2", x_pool, _DenseAgg(adj_pool, axis), ones,
            cfg, train, stats_out, replicated=True)
    else:
        e12_2 = p12_2 = agg3_e2 = agg3_p2 = None
    embed2 = dense_stage("embed2", getattr(model, "jk2", None), x_pool,
                         adj_pool, pre12=e12_2, pre_agg3=agg3_e2)
    read2 = torch.amax(embed2, 0)
    assign2 = _stage1_block(model, "pool2", x_pool, _DenseAgg(adj_pool, axis),
                            ones, cfg, train, lin=True, stats_out=stats_out,
                            replicated=True, pre12=p12_2, pre_agg3=agg3_p2)
    s2 = torch.softmax(assign2.float(), dim=-1).to(dtype)
    x3 = s2.t() @ embed2
    adj3 = s2.t() @ (adj_pool @ s2)
    if cfg.norm_adj:
        adj3 = renorm_dense(adj3[None], cfg.self_weight)[0]
    embed3 = dense_stage("embed3", getattr(model, "jk3", None), x3, adj3)
    read3 = torch.amax(embed3, 0)

    # ---- head (f32 whatever the compute dtype) ----
    h = torch.cat([read1, read2, read3], dim=-1).float()
    act = activation(cfg.activation)
    for name in model.pred_names:
        h = act(getattr(model, name)(h))
        if use_dropout:
            h = dropout(h, cfg.drop_out, generator)
    logits = model.pred_out(h).float()
    if return_stats:
        return logits, stats_out
    return logits


def apply_stats(model, stats: dict) -> None:
    """Write a running-statistics update ({block: {bn_i: {mean, var}}} from
    :func:`mega_forward`) into the model's BN buffers."""
    with torch.no_grad():
        for name, bns in stats.items():
            blk = getattr(model, name)
            for key, st in bns.items():
                bn = getattr(blk, key)
                bn.running_mean.copy_(st["mean"])
                bn.running_var.copy_(st["var"])
