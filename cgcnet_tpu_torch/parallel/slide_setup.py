"""Whole-slide input construction for the slide path.

Port of ``cgcnet_tpu/parallel/slide_setup.py``: normalize with the
reference's per-fold statistics, sort the nuclei into spatial bands, pad to
the shard multiple (G_BAND row tiles per shard, so the band windows apply),
build the radius graph (the native grid hash when it is built), partition,
and — on a CUDA device, where B1/B2/B8 run — build the block tables, the
int8 blocks once per slide. ``SlideCaps`` pads every table dimension that
varies with a slide's structure to sticky caps across a stream of slides.
Over D shards every rank builds the same host tables from the same input
(deterministic, as the JAX package's single controller builds them once),
so the sticky caps of a stream agree across ranks, and keeps its own
shard's rows of them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from cgcnet_tpu_torch.dataflow import native
from cgcnet_tpu_torch.dataflow.stats import reference_stats
from cgcnet_tpu_torch.ops.bsr import G_BAND, TILE
from cgcnet_tpu_torch.ops.knn import radius_knn_np
from cgcnet_tpu_torch.parallel.mega_graph import (
    build_bsr_tables,
    partition_graph,
)
from cgcnet_tpu_torch.parallel.mega_model import MegaInputs, prepare_mega_inputs
from cgcnet_tpu_torch.parallel.mesh import ONE, GraphAxis


@dataclass
class SlideCaps:
    """Sticky table caps of a slide stream: halo capacity P, transpose ELL
    width KT, blocks per row tile M / MT. ``grown`` quantizes a slide's
    needs up (P to 64, KT to 4, M/MT to 2) so one slightly denser slide
    does not change the stream's shapes; a grown cap is carried forward."""

    halo_p: int = 0
    kt: int = 0
    m: int = 0
    mt: int = 0

    @staticmethod
    def _q(v: int, q: int) -> int:
        return -(-max(v, 1) // q) * q

    def grown(self, halo_p: int, kt: int, m: int, mt: int) -> "SlideCaps":
        return SlideCaps(
            halo_p=max(self.halo_p, self._q(halo_p, 64)),
            kt=max(self.kt, self._q(kt, 4)),
            m=max(self.m, self._q(m, 2)),
            mt=max(self.mt, self._q(mt, 2)),
        )


@dataclass
class SlideBuild:
    """Device-ready slide inputs plus the construction facts callers
    report."""

    inputs: MegaInputs      # this rank's shard
    part: object            # mega_graph.ShardedGraphPartition
    n: int                  # real nuclei
    cap: int                # padded node capacity (multiple of 512*shards)
    input_dim: int
    edges: int              # real (masked) ELL edges
    bsr: bool               # block tables built
    t_graph_s: float        # radius-graph build time
    t_part_s: float         # partition (+ block table) time
    caps: SlideCaps | None = None


def synthetic_slide(nuclei: int, seed: int = 0):
    """Synthetic slide at the reference's ~5000 nuclei per 3584 px tile:
    (feats f32[N, 16], coords f32[N, 2])."""
    rng = np.random.default_rng(seed)
    side = 3584.0 * max(1.0, np.sqrt(nuclei / 5000.0))
    coords = rng.uniform(0, side, (nuclei, 2)).astype(np.float32)
    feats = (rng.normal(size=(nuclei, 16)) * 10 + 40).astype(np.float32)
    return feats, coords


def _build_part_tables(nbrp, maskp, shards, caps, want_bsr):
    """(partition, tables, caps used), padded to sticky ``caps`` when
    given; a slide that outgrows them is built plainly, the caps grow
    (quantized) and it is rebuilt padded."""
    if caps is not None and caps.halo_p:
        try:
            part = partition_graph(nbrp, maskp, shards,
                                   halo_capacity=caps.halo_p)
            tables = (build_bsr_tables(part, kt_cap=caps.kt, m_cap=caps.m,
                                       mt_cap=caps.mt)
                      if want_bsr else None)
            return part, tables, caps
        except ValueError:
            pass  # outgrown: learn this slide's needs below
    part = partition_graph(nbrp, maskp, shards)
    tables = build_bsr_tables(part) if want_bsr else None
    if caps is None:
        return part, tables, None
    grown = caps.grown(
        part.halo_capacity,
        tables.nbr_t.shape[-1] if tables is not None else 1,
        tables.blk_cols.shape[-1] if tables is not None else 1,
        tables.blk_cols_t.shape[-1] if tables is not None else 1,
    )
    part = partition_graph(nbrp, maskp, shards, halo_capacity=grown.halo_p)
    tables = (build_bsr_tables(part, kt_cap=grown.kt, m_cap=grown.m,
                               mt_cap=grown.mt)
              if want_bsr else None)
    return part, tables, grown


def spatial_sort_order(
    coords: np.ndarray, band_px: float, stripes: int = 1,
    shard_rows: int | None = None,
) -> np.ndarray:
    """Band-sort order (x bands of ``band_px``, y within a band); with
    ``stripes`` > 1 the nuclei first split into equal-count y-stripes at
    exact shard row counts, so each shard's band length shrinks by the
    stripe factor and cross-stripe edges become halo slots."""
    n = len(coords)
    band = np.floor(coords[:, 0] / band_px)
    if stripes <= 1:
        return np.lexsort((coords[:, 1], band))
    y_order = np.argsort(coords[:, 1], kind="stable")
    per = shard_rows if shard_rows is not None else n // stripes
    bounds = np.minimum(np.arange(1, stripes) * per, n)
    stripe_id = np.empty(n, np.int32)
    stripe_id[y_order] = np.searchsorted(
        bounds, np.arange(n), side="right"
    ).astype(np.int32)
    return np.lexsort((coords[:, 1], band, stripe_id))


def wants_tables(device: torch.device) -> bool:
    """Block tables are built where the block kernels run: on a card."""
    return device.type == "cuda"


def build_slide_inputs(cfg, feats, coords, shards: int, device,
                       caps: SlideCaps | None = None,
                       axis: GraphAxis = ONE) -> SlideBuild:
    """feats [N, F_raw], coords [N, 2] -> :class:`SlideBuild` of shard
    ``axis.rank`` of ``shards`` on ``device`` (ValueError unless the axis
    has ``shards`` ranks). Block tables are built only for a CUDA device,
    where the kernels run (the JAX package builds them only on a TPU); a
    CPU build takes the gather path. ``caps`` pads the tables to a stream's
    sticky caps — pass the previous slide's ``SlideBuild.caps`` forward."""
    axis.check(shards)
    device = torch.device(device)
    n = len(coords)
    mean, std = reference_stats(cfg.data.cross_val, cfg.data.feature_type)
    q = TILE * G_BAND * shards
    cap = -(-n // q) * q
    order = spatial_sort_order(coords, cfg.data.max_edge_distance,
                               stripes=shards, shard_rows=cap // shards)
    feats, coords = feats[order], coords[order]
    x = (np.concatenate([feats, coords], -1) - mean) / std
    xp = np.zeros((cap, x.shape[1]), np.float32)
    xp[:n] = x

    t0 = time.perf_counter()
    if native.available():
        nbr, mask = native.radius_knn(coords, cfg.data.max_edge_distance,
                                      cfg.data.max_neighbours)
    else:
        nbr, mask = radius_knn_np(coords, cfg.data.max_edge_distance,
                                  cfg.data.max_neighbours)
    # pad rows point at themselves with zero mask (no phantom edges)
    nbrp = np.tile(np.arange(cap, dtype=np.int32)[:, None], (1, nbr.shape[1]))
    maskp = np.zeros((cap, nbr.shape[1]), np.float32)
    nbrp[:n], maskp[:n] = nbr, mask
    t_graph = time.perf_counter() - t0

    t0 = time.perf_counter()
    part, tables, caps_used = _build_part_tables(
        nbrp, maskp, shards, caps, wants_tables(device)
    )
    t_part = time.perf_counter() - t0
    inputs = prepare_mega_inputs(xp, part, device, n_real=n, bsr=tables,
                                 axis=axis)
    return SlideBuild(
        inputs=inputs, part=part, n=n, cap=cap, input_dim=x.shape[1],
        edges=int(maskp.sum()), bsr=tables is not None,
        t_graph_s=t_graph, t_part_s=t_part, caps=caps_used,
    )
