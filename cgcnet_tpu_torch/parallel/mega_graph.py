"""Node-partitioned whole-slide graphs: routing tables, block tables and the
collectives of the graph axis.

Port of ``cgcnet_tpu/parallel/mega_graph.py``. A slide graph (nodes already
spatially sorted) is split into D contiguous shards; each shard aggregates
over [its rows ++ the halo rows its neighbours live on]. The host builds
the static tables (:func:`partition_graph`, :func:`build_bsr_tables`); the
device moves halo rows between shards and sums statistics across them
(:func:`halo_exchange`, :func:`halo_exchange_vjp`, :func:`psum`,
:func:`all_gather`), one process per shard over the ``torch.distributed``
group of a :class:`~cgcnet_tpu_torch.parallel.mesh.GraphAxis`; for one
shard each is the identity of a one-member group (the halo exchange still
forms the send buffer ``x[req_idx] * req_mask``). Tables built for D shards
run only in an axis of D ranks. :func:`sharded_gather_sum` and its
``_overlap`` and ``_allgather`` forms are the JAX package's reference
aggregations over the same collectives.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from cgcnet_tpu_torch.ops.bsr import (
    G_BAND,
    H_BAND_MAX,
    TILE,
    band_window_table,
    band_window_table_halo,
    bsr_block_meta,
)
from cgcnet_tpu_torch.ops.ell import ell_gather_sum
from cgcnet_tpu_torch.parallel.mesh import ONE, GraphAxis


@dataclasses.dataclass
class ShardedGraphPartition:
    """Static routing tables of one slide on D shards (Ns rows per shard, K
    ELL slots, P halo slots per shard pair):

      nbr_remap i32[D, Ns, K]  neighbours in [local ++ halo] space (j < Ns
                               local, j >= Ns halo slot j - Ns)
      nbr_mask  f32[D, Ns, K]
      req_idx   i32[D, D, P]   rows shard d sends to shard e
      req_mask  f32[D, D, P]
      n_nodes   i32[D]
    """

    nbr_remap: np.ndarray
    nbr_mask: np.ndarray
    req_idx: np.ndarray
    req_mask: np.ndarray
    n_nodes: np.ndarray

    @property
    def num_shards(self) -> int:
        return self.nbr_remap.shape[0]

    @property
    def halo_capacity(self) -> int:
        return self.req_idx.shape[2]


def partition_graph(
    nbr: np.ndarray,
    mask: np.ndarray,
    num_shards: int,
    halo_capacity: int | None = None,
) -> ShardedGraphPartition:
    """Split a global ELL graph into ``num_shards`` contiguous shards and
    build the halo routing tables; global node j lives on shard j // Ns at
    local row j % Ns. ValueError when ``halo_capacity`` is too small."""
    n, k = nbr.shape
    if n % num_shards:
        raise ValueError(f"{n} nodes do not split into {num_shards} shards")
    ns = n // num_shards
    nbr = np.ascontiguousarray(nbr, np.int32)
    mask3 = mask.reshape(num_shards, ns, k) > 0
    nbr3 = nbr.reshape(num_shards, ns, k)
    owner3 = nbr3 // np.int32(ns)
    is_local = owner3 == np.arange(num_shards, dtype=np.int32)[:, None, None]

    # halo sets in one sort: key = requesting shard * n + wanted global node
    remote = (~is_local) & mask3
    d_of = np.repeat(
        np.arange(num_shards, dtype=np.int64), int(ns) * k
    ).reshape(num_shards, ns, k)
    keys = np.unique(d_of[remote] * n + nbr3[remote].astype(np.int64))
    key_d = (keys // n).astype(np.int32)
    key_node = (keys % n).astype(np.int32)
    key_e = key_node // np.int32(ns)
    de_counts = np.zeros((num_shards, num_shards), np.int64)
    np.add.at(de_counts, (key_d, key_e), 1)
    need = int(de_counts.max()) if keys.size else 0
    p = halo_capacity if halo_capacity is not None else max(need, 1)
    if need > p:
        raise ValueError(f"halo capacity {p} < required {need}")

    req_idx = np.zeros((num_shards, num_shards, p), np.int32)
    req_mask = np.zeros((num_shards, num_shards, p), np.float32)
    # slot of each key within its (d, e) run (keys sorted: runs contiguous)
    run_key = key_d.astype(np.int64) * num_shards + key_e
    run_start = np.searchsorted(run_key, run_key, side="left")
    slot = (np.arange(len(keys)) - run_start).astype(np.int32)
    req_idx[key_e, key_d, slot] = key_node % np.int32(ns)
    req_mask[key_e, key_d, slot] = 1.0
    halo_slot = np.zeros((num_shards, n), np.int32)
    halo_slot[key_d, key_node] = key_e * np.int32(p) + slot

    own_row = np.broadcast_to(
        np.arange(ns, dtype=np.int32)[None, :, None], nbr3.shape
    )
    remap_halo = np.int32(ns) + np.take_along_axis(
        halo_slot, nbr3.reshape(num_shards, -1), axis=1
    ).reshape(num_shards, ns, k)
    nbr_remap = np.where(
        ~mask3, own_row, np.where(is_local, nbr3 % np.int32(ns), remap_halo)
    )
    return ShardedGraphPartition(
        nbr_remap=nbr_remap,
        nbr_mask=mask3.astype(np.float32),
        req_idx=req_idx,
        req_mask=req_mask,
        n_nodes=np.full(num_shards, ns, np.int32),
    )


@dataclasses.dataclass
class ShardedBsrTables:
    """Per-shard block tables of the local [Ns x NC] operator (NC = Ns + halo
    slots, padded to G_BAND*128) and of its transpose, for the B1/B2/B8
    aggregation. ``win_base``/``win_base_t``: band window bases per
    direction, None when a shard's band is too wide (B2 then serves that
    direction); ``win_halo``: halo sub-window bases of the forward direction
    when the halo outgrows the resident tail (more than one shard)."""

    blk_cols: np.ndarray    # i32[D, R, M]
    blk_mask: np.ndarray    # f32[D, R, M]
    nbr_t: np.ndarray       # i32[D, NC, KT] in-edge lists
    mask_t: np.ndarray      # f32[D, NC, KT]
    blk_cols_t: np.ndarray  # i32[D, RC, MT]
    blk_mask_t: np.ndarray  # f32[D, RC, MT]
    nc: int
    win_base: np.ndarray | None = None    # i32[D, R // G_BAND]
    win_base_t: np.ndarray | None = None  # i32[D, RC // G_BAND]
    win_halo: np.ndarray | None = None    # i32[D, R // G_BAND, 2]


def build_bsr_tables(
    part: ShardedGraphPartition,
    max_blocks: int = 16,
    tile: int = TILE,
    kt_cap: int | None = None,
    m_cap: int | None = None,
    mt_cap: int | None = None,
) -> ShardedBsrTables | None:
    """Block tables of every shard's local operator and its transpose, or
    None when Ns does not tile or a row tile touches more than
    ``max_blocks`` column tiles. ``kt_cap``/``m_cap``/``mt_cap`` fix the
    transpose ELL width and blocks per row tile (sticky caps of a slide
    stream); ValueError when one is too small. When the transpose's halo
    rows do not tile, its blocks cover the local rows only (the hybrid
    transpose) and the backward gathers the halo rows over the ELL lists."""
    d, ns, k = part.nbr_remap.shape
    if ns % tile != 0:
        return None
    h = d * part.halo_capacity
    nc = -(-(ns + h) // (tile * G_BAND)) * (tile * G_BAND)

    # rectangular transpose of the OFF-diagonal operator (self slots excluded:
    # the self weight is applied outside the block product)
    nbr_ts = []
    kt = 0
    for di in range(d):
        nbr_s = part.nbr_remap[di]
        ok = (part.nbr_mask[di] > 0) & (
            nbr_s != np.arange(ns, dtype=nbr_s.dtype)[:, None]
        )
        src = np.repeat(np.arange(ns, dtype=np.int64), k)[ok.ravel()]
        dst = nbr_s.ravel().astype(np.int64)[ok.ravel()]
        counts = np.bincount(dst, minlength=nc)
        kt = max(kt, int(counts.max()) if len(dst) else 1)
        nbr_ts.append((src, dst, counts))
    kt = max(kt, 1)
    if kt_cap is not None:
        if kt > kt_cap:
            raise ValueError(f"kt_cap {kt_cap} < required {kt}")
        kt = kt_cap
    t_idx = np.zeros((d, nc, kt), np.int32)
    t_mask = np.zeros((d, nc, kt), np.float32)
    for di, (src, dst, counts) in enumerate(nbr_ts):
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        starts = np.concatenate([[0], np.cumsum(counts)])
        slot = np.arange(len(src)) - starts[dst]
        t_idx[di, dst, slot] = src.astype(np.int32)
        t_mask[di, dst, slot] = 1.0

    try:
        metas = [
            bsr_block_meta(part.nbr_remap[di], part.nbr_mask[di], max_blocks)
            for di in range(d)
        ]
    except ValueError:
        return None
    try:
        metas_t = [
            bsr_block_meta(t_idx[di], t_mask[di], max_blocks)
            for di in range(d)
        ]
    except ValueError:
        # hybrid transpose: blocks over the local rows only
        try:
            metas_t = [
                bsr_block_meta(t_idx[di, :ns], t_mask[di, :ns], max_blocks)
                for di in range(d)
            ]
        except ValueError:
            return None
    m = max(max(mm[2] for mm in metas), 1)
    mt = max(max(mm[2] for mm in metas_t), 1)
    if m_cap is not None:
        if m > m_cap:
            raise ValueError(f"m_cap {m_cap} < required {m}")
        assert m_cap <= max_blocks, (m_cap, max_blocks)
        m = m_cap
    if mt_cap is not None:
        if mt > mt_cap:
            raise ValueError(f"mt_cap {mt_cap} < required {mt}")
        assert mt_cap <= max_blocks, (mt_cap, max_blocks)
        mt = mt_cap
    blk_cols = np.stack([mm[0][:, :m] for mm in metas])
    blk_mask = np.stack([mm[1][:, :m] for mm in metas])
    blk_cols_t = np.stack([mm[0][:, :mt] for mm in metas_t])
    blk_mask_t = np.stack([mm[1][:, :mt] for mm in metas_t])

    ns_tiles = ns // tile

    def _wins(cols, masks):
        outs = []
        for di in range(d):
            w = band_window_table(cols[di], masks[di], ns_tiles)
            if w is None:
                return None
            outs.append(w)
        return np.stack(outs)

    h_tiles_total = nc // tile - ns_tiles
    win_halo = None
    if h_tiles_total <= H_BAND_MAX:
        win_base = _wins(blk_cols, blk_mask)
    else:
        locs, halos = [], []
        for di in range(d):
            tabs = band_window_table_halo(
                blk_cols[di], blk_mask[di], ns_tiles, h_tiles_total
            )
            if tabs is None:
                locs = None
                break
            locs.append(tabs[0])
            halos.append(tabs[1])
        win_base = np.stack(locs) if locs is not None else None
        win_halo = np.stack(halos) if locs is not None else None
    # the transpose's x is the forward's row space (no halo columns)
    win_base_t = _wins(blk_cols_t, blk_mask_t)

    return ShardedBsrTables(
        blk_cols=blk_cols, blk_mask=blk_mask, nbr_t=t_idx, mask_t=t_mask,
        blk_cols_t=blk_cols_t, blk_mask_t=blk_mask_t, nc=nc,
        win_base=win_base, win_base_t=win_base_t, win_halo=win_halo,
    )


# ---------------------------------------------------------------------------
# collectives of the graph axis
# ---------------------------------------------------------------------------
#
# Each collective moves bits only: the tensor travels as a uint8 view (a
# dtype every backend carries, bf16 included), and a sum over the axis is
# an all-gather followed by a sum of the D parts in rank order at the
# tensor's dtype. So a sum is exact to the dtype's rounding, fixed in order,
# and bit-identical on every rank, which keeps the replicated stages (and
# the parameters a training step writes) equal on every rank. On gloo with
# ranks on a card, every collective stages its bytes through pinned host
# memory (``GraphAxis.staged``); nothing switches path on a caught error.

def _host(flat: torch.Tensor, axis: GraphAxis) -> torch.Tensor:
    if not axis.staged:
        return flat
    buf = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    return buf.copy_(flat)


def _gather_raw(x: torch.Tensor, axis: GraphAxis) -> torch.Tensor:
    """[D, *x.shape]: every rank's x, in rank order."""
    flat = _host(x.detach().contiguous().reshape(-1).view(torch.uint8), axis)
    parts = [torch.empty_like(flat) for _ in range(axis.size)]
    dist.all_gather(parts, flat, group=axis.group)
    out = torch.stack(parts).to(x.device)
    return out.view(x.dtype).reshape(axis.size, *x.shape)


def _all_to_all_raw(x: torch.Tensor, axis: GraphAxis) -> torch.Tensor:
    """x [D, ...] -> [D, ...]: slot e of the result is slot r (this rank)
    of rank e's x."""
    flat = _host(x.detach().contiguous().reshape(axis.size, -1)
                 .view(torch.uint8), axis)
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat, group=axis.group)
    return out.to(x.device).view(x.dtype).reshape(x.shape)


def _sum_parts(parts: torch.Tensor) -> torch.Tensor:
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


class _PSum(torch.autograd.Function):
    """Sum over the axis; its VJP is the sum of the cotangents."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _sum_parts(_gather_raw(x, axis))

    @staticmethod
    def backward(ctx, g):
        return _sum_parts(_gather_raw(g, ctx.axis)), None


class _AllGather(torch.autograd.Function):
    """[D, ...] stack of every rank's x; its VJP gives each rank the sum
    over ranks of its own slice of the cotangent (a reduce-scatter, as an
    all-to-all and a sum in rank order)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather_raw(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _sum_parts(_all_to_all_raw(g, ctx.axis)), None


class _AllToAll(torch.autograd.Function):
    """The halo exchange's all-to-all over [D, P, F]; an involution, so its
    VJP is the same all-to-all (the reverse exchange)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_to_all_raw(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_raw(g, ctx.axis), None


def halo_exchange(
    x_local: torch.Tensor,   # [Ns, F]
    req_idx: torch.Tensor,   # i32[D, P] rows this shard sends to each peer
    req_mask: torch.Tensor,  # f32[D, P]
    axis: GraphAxis = ONE,
) -> torch.Tensor:
    """[D*P, F] halo rows of this shard, ordered by source shard: the send
    buffer x[req_idx] * req_mask (the mask multiplied at x's dtype: an f32
    mask would promote bf16 halo rows, and with them every stage-1
    aggregation, to f32), then the all-to-all over the graph axis — the
    identity for one shard. Differentiable (autograd's backward is
    :func:`halo_exchange_vjp`)."""
    axis.check(req_idx.shape[0])
    send = x_local[req_idx.long()] * req_mask[..., None].to(x_local.dtype)
    if axis.size > 1:
        send = _AllToAll.apply(send, axis)
    return send.reshape(-1, x_local.shape[-1])


def halo_exchange_vjp(
    d_halo: torch.Tensor,    # [D*P, F] cotangent of the halo rows
    req_idx: torch.Tensor,
    req_mask: torch.Tensor,
    ns: int,
    axis: GraphAxis = ONE,
) -> torch.Tensor:
    """[Ns, F] cotangent of x_local: the reverse all-to-all (identity for
    one shard), then the masked rows scatter-added to the rows they came
    from."""
    axis.check(req_idx.shape[0])
    g = d_halo.reshape(*req_idx.shape, -1)
    if axis.size > 1:
        g = _all_to_all_raw(g, axis)
    g = g * req_mask[..., None].to(d_halo.dtype)
    out = d_halo.new_zeros((ns, d_halo.shape[-1]))
    return out.index_add_(0, req_idx.reshape(-1).long(),
                          g.reshape(-1, d_halo.shape[-1]))


def psum(x: torch.Tensor, axis: GraphAxis = ONE) -> torch.Tensor:
    """Sum over the graph axis (SyncBatchNorm statistics, the DiffPool
    contraction): ``x`` itself for one shard. Differentiable."""
    if axis.size == 1:
        return x
    return _PSum.apply(x, axis)


def all_gather(x: torch.Tensor, axis: GraphAxis = ONE) -> torch.Tensor:
    """[D, ...] stack of every shard's ``x`` (the readout's max): ``x[None]``
    for one shard. Differentiable."""
    if axis.size == 1:
        return x[None]
    return _AllGather.apply(x, axis)


def broadcast_(tensors, axis: GraphAxis = ONE) -> None:
    """Overwrite each tensor with rank 0's (a model's weights made the same
    on every rank); nothing for one shard."""
    if axis.size == 1:
        return
    with torch.no_grad():
        for t in tensors:
            t.copy_(_gather_raw(t, axis)[0])


# ---------------------------------------------------------------------------
# reference aggregations over the collectives (one shard's tensors)
# ---------------------------------------------------------------------------

def sharded_gather_sum(
    x: torch.Tensor,          # [Ns, F] this shard's rows
    nbr_remap: torch.Tensor,  # i32[Ns, K] in [local ++ halo] space
    nbr_mask: torch.Tensor,   # f32[Ns, K]; unused (w folds the mask): the
    w: torch.Tensor,          #   signature of the _overlap form
    req_idx: torch.Tensor,    # i32[D, P]
    req_mask: torch.Tensor,   # f32[D, P]
    axis: GraphAxis = ONE,
) -> torch.Tensor:
    """This shard's rows of A @ x over the halo exchange."""
    halo = halo_exchange(x, req_idx, req_mask, axis)
    xx = torch.cat([x, halo], dim=0)
    return ell_gather_sum(nbr_remap[None], w[None], xx[None])[0]


def sharded_gather_sum_overlap(x, nbr_remap, nbr_mask, w, req_idx, req_mask,
                               axis: GraphAxis = ONE) -> torch.Tensor:
    """:func:`sharded_gather_sum` split into interior rows (every real slot
    local: no dependency on the exchange) and boundary rows."""
    ns = x.shape[0]
    slot_local = torch.where(nbr_mask > 0, nbr_remap,
                             torch.zeros_like(nbr_remap)) < ns
    interior = torch.all(slot_local, dim=-1)
    halo = halo_exchange(x, req_idx, req_mask, axis)
    out_int = ell_gather_sum(torch.clamp_max(nbr_remap, ns - 1)[None],
                             (w * interior[:, None])[None], x[None])[0]
    xx = torch.cat([x, halo], dim=0)
    out_bnd = ell_gather_sum(nbr_remap[None], (w * (~interior)[:, None])[None],
                             xx[None])[0]
    return out_int + out_bnd


def sharded_gather_sum_allgather(x, nbr, w,
                                 axis: GraphAxis = ONE) -> torch.Tensor:
    """The oracle: every shard's rows gathered, then this shard's rows of
    A @ x over the global neighbour ids ``nbr`` [Ns, K]."""
    x_full = all_gather(x, axis).reshape(-1, x.shape[-1])
    return ell_gather_sum(nbr[None], w[None], x_full[None])[0]
