"""Node-partitioned whole-slide graphs: routing tables, block tables and the
collectives of the graph axis.

Port of ``cgcnet_tpu/parallel/mega_graph.py``. A slide graph (nodes already
spatially sorted) is split into D contiguous shards; each shard aggregates
over [its rows ++ the halo rows its neighbours live on]. The host builds
the static tables (:func:`partition_graph`, :func:`build_bsr_tables`); the
device moves halo rows between shards and sums statistics across them
(:func:`halo_exchange`, :func:`halo_exchange_vjp`, :func:`psum`,
:func:`all_gather`).

This package runs one shard: every collective below is the identity of a
one-member group (the halo exchange still forms the send buffer
``x[req_idx] * req_mask`` exactly as the JAX package does). A graph axis
above 1 raises ``NotImplementedError``; its ``torch.distributed`` forms are
the multi-shard item of ``ROADMAP.md``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cgcnet_tpu_torch.ops.bsr import (
    G_BAND,
    H_BAND_MAX,
    TILE,
    band_window_table,
    band_window_table_halo,
    bsr_block_meta,
)

MULTI_SHARD = (
    "more than one shard needs the torch.distributed collectives of "
    "ROADMAP.md queue 1, item 7 (multi-shard whole-slide path)"
)


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
# collectives of the graph axis (one shard)
# ---------------------------------------------------------------------------

def _one_shard(shards: int) -> None:
    if shards != 1:
        raise NotImplementedError(MULTI_SHARD)


def halo_exchange(
    x_local: torch.Tensor,   # [Ns, F]
    req_idx: torch.Tensor,   # i32[D, P] rows this shard sends to each peer
    req_mask: torch.Tensor,  # f32[D, P]
) -> torch.Tensor:
    """[D*P, F] halo rows: this shard's send buffer x[req_idx] * req_mask
    (the mask multiplied at x's dtype), then the all-to-all over the graph
    axis — the identity for one shard. Differentiable (autograd's backward
    is :func:`halo_exchange_vjp`)."""
    _one_shard(req_idx.shape[0])
    send = x_local[req_idx.long()] * req_mask[..., None].to(x_local.dtype)
    return send.reshape(-1, x_local.shape[-1])


def halo_exchange_vjp(
    d_halo: torch.Tensor,    # [D*P, F] cotangent of the halo rows
    req_idx: torch.Tensor,
    req_mask: torch.Tensor,
    ns: int,
) -> torch.Tensor:
    """[Ns, F] cotangent of x_local: the reverse all-to-all (identity for
    one shard), then the masked rows scatter-added to the rows they came
    from."""
    _one_shard(req_idx.shape[0])
    g = d_halo.reshape(*req_idx.shape, -1) * req_mask[..., None].to(d_halo.dtype)
    out = d_halo.new_zeros((ns, d_halo.shape[-1]))
    return out.index_add_(0, req_idx.reshape(-1).long(),
                          g.reshape(-1, d_halo.shape[-1]))


def psum(x: torch.Tensor, shards: int = 1) -> torch.Tensor:
    """Sum over the graph axis (SyncBatchNorm statistics, the DiffPool
    contraction): the identity for one shard."""
    _one_shard(shards)
    return x


def all_gather(x: torch.Tensor, shards: int = 1) -> torch.Tensor:
    """[D, ...] stack of every shard's ``x`` (the readout's max): ``x[None]``
    for one shard."""
    _one_shard(shards)
    return x[None]
