"""Runtime graph dataset: proto -> subsample -> kNN -> normalized padded ELL.

Host-side numpy pipeline, the same as ``cgcnet_tpu/dataflow/dataset.py`` so
that both packages build bit-equal batches for the same (seed, patch,
epoch). Re-design of the reference L3 dataflow (dataflow/data.py):

- The reference pre-bakes 30 epochs of subsampled graphs to disk
  (prepare_cv_dataset.py:75-109) because its global-RNG sampling is not
  reproducible online. Here sampling is a pure function of
  (seed, patch, epoch) — the "fixed epoch" protocol falls out for free, with
  no proto duplication on disk, and --dynamic_graph becomes the same code
  path with a per-call epoch.
- Output is the static-shape padded ELL layout (core/graph.py) instead of a
  [Nmax, Nmax] dense adjacency (data.py:234): node capacity is rounded up to
  a multiple of 128, the BSR tile.

Offline fixed-epoch replay (``data.use_fixed``) and the random graph sampler
are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

import numpy as np

from cgcnet_tpu_torch.config import DataConfig
from cgcnet_tpu_torch.core.convert import transpose_ell_np
from cgcnet_tpu_torch.dataflow import native
from cgcnet_tpu_torch.dataflow.proto import load_proto, list_protos
from cgcnet_tpu_torch.dataflow.rng import patch_rng
from cgcnet_tpu_torch.dataflow import stats as stats_mod
from cgcnet_tpu_torch.ops.bsr import bsr_block_meta as bsr_block_meta_np
from cgcnet_tpu_torch.ops.fps import farthest_point_sample_np, fuse_sample_np
from cgcnet_tpu_torch.ops.knn import radius_knn_np


def _radius_knn(pos, radius, k, scan_order=False):
    """Native grid-hash when available; NumPy oracle otherwise. The
    torch-cluster-compat scan-order mode only exists in the NumPy builder."""
    if native.available() and not scan_order:
        return native.radius_knn(pos, radius, k)
    return radius_knn_np(pos, radius, k, scan_order=scan_order)


def _transpose(nbr, mask, width):
    """Transpose with adaptive width: dense nuclei clusters can push the
    in-degree past the nominal width (out-degree is capped at K-nearest but
    nothing bounds how many nodes pick the same in-neighbour) — double the
    width until it fits; collate() later re-pads a batch to one width."""
    while True:
        try:
            if native.available():
                return native.transpose_ell(nbr, mask, width)
            return transpose_ell_np(nbr, mask, width)
        except ValueError:
            if width >= 1024:
                raise
            width *= 2

# 3-fold cross-validation split table (reference dataflow/data.py:15-19)
CROSS_VAL_FOLDS = {
    1: {"train": ["fold_1", "fold_2"], "valid": ["fold_3"]},
    2: {"train": ["fold_1", "fold_3"], "valid": ["fold_2"]},
    3: {"train": ["fold_2", "fold_3"], "valid": ["fold_1"]},
}


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class GraphSample:
    """One patch as unpadded numpy arrays (the loader pads at collate time,
    to the dataset capacity or a smaller batch bucket)."""

    x: np.ndarray          # [n, F] f32, z-scored
    nbr: np.ndarray        # [n, K] i32
    nbr_mask: np.ndarray   # [n, K] f32
    nbr_t: np.ndarray      # [n, KT] i32 (transpose graph)
    nbr_t_mask: np.ndarray # [n, KT] f32
    n_nodes: int
    label: int
    patch_idx: int
    name: str


class NucleiGraphDataset:
    """Index + per-item pipeline over a proto tree.

    Equivalent of ``NucleiDataset``/``NucleiDatasetBatchOutput``
    (dataflow/data.py:111-354) with deterministic seeding.
    """

    def __init__(
        self,
        cfg: DataConfig,
        split: str = "train",
        *,
        transpose_width: int = 24,
        full_graph: bool = False,
    ):
        if cfg.use_fixed or cfg.graph_sampler != "knn":
            raise NotImplementedError(
                "data.use_fixed and data.graph_sampler='random' are not "
                "ported yet"
            )
        self.cfg = cfg
        self.split = split
        # full-graph mode: no subsampling, capacity covers the unsampled
        # dataset maximum (reference NucleiDatasetTest, dataflow/data.py:281-316)
        self.full_graph = full_graph
        folds = CROSS_VAL_FOLDS[cfg.cross_val][split]
        self.names = list_protos(cfg.root, folds, cfg.dataset)
        if not self.names:
            raise FileNotFoundError(
                f"no protos for folds {folds} under {cfg.root}/proto/feature/{cfg.dataset}"
            )
        self.capacity = round_up(
            cfg.max_num_nodes if full_graph else cfg.padded_nodes, 128
        )
        self.transpose_width = transpose_width
        # in-RAM proto cache: protos are immutable and a full CRC fold is
        # ~1.4 GB — caching removes npz/zip parsing from the hot loop
        # (cfg.cache_protos; thread-safe via setdefault's atomicity)
        self._proto_cache: dict[str, object] = {}
        # steady-state built-graph cache (cfg.graph_cache_mb): key ->
        # GraphSample (slow path) or filled-buffer tuple (fast path).
        # Thread-safe under worker threads: inserts are setdefault-atomic,
        # byte accounting under the lock, entries immutable once stored.
        self._graph_cache: dict = {}
        self._graph_cache_bytes = 0
        self._graph_cache_lock = threading.Lock()
        self.graph_cache_hits = 0
        self.mean, self.std = self._compute_stats()

    # ------------------------------------------------------------------
    def _compute_stats(self) -> tuple[np.ndarray, np.ndarray]:
        feats = []
        for name in self.names:
            proto = load_proto(self.cfg.root, name, self.cfg.dataset)
            feats.append(self._slice_features(proto.full_features()))
        return stats_mod.compute_stats(feats)

    def _slice_features(self, feats: np.ndarray) -> np.ndarray:
        # feature-type slicing 'c'/'a'/'ca' (reference dataflow/data.py:151-156)
        if self.cfg.feature_type == "c":
            return feats[:, -2:]
        if self.cfg.feature_type == "a":
            return feats[:, :-2]
        return feats

    def __len__(self) -> int:
        return len(self.names)

    # ------------------------------------------------------------------
    def _subsample_sorted(
        self, n: int, coords: np.ndarray, rng: np.random.Generator
    ) -> np.ndarray | None:
        """Fused subsample + spatial band sort (one GIL-free native call);
        None when unavailable for the configured method."""
        cfg = self.cfg
        if (
            not native.available()
            or not cfg.spatial_sort
            or cfg.sampling_method not in ("fuse", "farthest", "random")
        ):
            return None
        num_sub = int(n * cfg.sample_ratio)
        if n < cfg.min_nodes_no_subsample:
            return None
        num_sub = min(num_sub, self.capacity)
        far_num = {
            "fuse": int(cfg.fuse_far_fraction * num_sub),
            "farthest": num_sub,
            "random": 0,
        }[cfg.sampling_method]
        return native.sample_and_sort(
            coords, num_sub, far_num, cfg.max_edge_distance, rng
        )

    def _subsample(
        self, n: int, coords: np.ndarray, rng: np.random.Generator
    ) -> np.ndarray | None:
        cfg = self.cfg
        num_sub = int(n * cfg.sample_ratio)
        if n < cfg.min_nodes_no_subsample:
            return None  # keep whole patch (reference data.py:199-201)
        num_sub = min(num_sub, self.capacity)
        if cfg.sampling_method == "random":
            return rng.choice(n, size=num_sub, replace=False).astype(np.int32)
        if cfg.sampling_method == "farthest" and native.available():
            return native.fps_coords(coords, num_sub, rng)
        if cfg.sampling_method == "fuse" and native.available():
            # FPS prefix + uniform remainder; the FPS leg takes the native
            # coords path (identical argmax sequence — squared vs euclidean
            # distances share the argmax). Never materialize the N x N table.
            far_num = int(cfg.fuse_far_fraction * num_sub)
            far_idx = native.fps_coords(coords, far_num, rng)
            remain = np.setdiff1d(np.arange(n), far_idx)
            rand_idx = rng.choice(
                remain, size=min(num_sub - far_num, len(remain)), replace=False
            ).astype(np.int32)
            return np.concatenate([far_idx, rand_idx])
        # NumPy fallbacks (no native lib): distance-table based, O(N^2) memory
        dist = np.sqrt(
            ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1)
        ).astype(np.float32)
        if cfg.sampling_method == "farthest":
            return farthest_point_sample_np(dist, num_sub, rng)
        if cfg.sampling_method == "fuse":
            return fuse_sample_np(dist, num_sub, rng, cfg.fuse_far_fraction)
        raise ValueError(f"unknown sampling_method {cfg.sampling_method!r}")

    def _load_proto(self, name: str):
        if not self.cfg.cache_protos:
            return load_proto(self.cfg.root, name, self.cfg.dataset)
        proto = self._proto_cache.get(name)
        if proto is None:
            proto = self._proto_cache.setdefault(
                name, load_proto(self.cfg.root, name, self.cfg.dataset)
            )
        return proto

    # ------------------------------------------------------------------
    def _cache_key(self, idx: int, epoch: int):
        """Built-graph cache key, or None when the sample's content is not
        epoch-periodic (then caching would be wrong, not just wasteful).

        Sample content is a pure function of (seed, patch, epoch)
        (dataflow/rng.py). A full-graph kNN dataset samples nothing, so its
        content repeats every epoch; dynamic subsampling draws fresh
        per-epoch randomness — never cached.
        """
        if self.cfg.graph_cache_mb > 0 and self.full_graph:
            return (idx, 0)
        return None

    def _cache_put(self, key, value, nbytes: int) -> None:
        with self._graph_cache_lock:
            if (
                self._graph_cache_bytes + nbytes
                > self.cfg.graph_cache_mb * (1 << 20)
            ):
                return  # budget reached: later keys stay uncached (cyclic
                # access makes LRU pointless — the resident set is stable)
            if key not in self._graph_cache:
                self._graph_cache[key] = value
                self._graph_cache_bytes += nbytes

    def supports_fast_path(self) -> bool:
        """One-call native batch building (loader fast path): knn graphs with
        fuse/farthest/random sampling and spatial sort."""
        cfg = self.cfg
        return (
            native.available()
            and cfg.spatial_sort
            and cfg.sampling_method in ("fuse", "farthest", "random")
        )

    def fill_into(
        self,
        idx: int,
        epoch: int,
        out_x: np.ndarray,
        out_nbr: np.ndarray,
        out_mask: np.ndarray,
        out_nbr_t: np.ndarray,
        out_mask_t: np.ndarray,
    ) -> tuple[int, int]:
        """Write one padded patch directly into (batch-buffer) views via the
        single GIL-free native call. Returns (n_nodes, label); n_nodes -1
        signals transpose-width overflow (caller falls back to get())."""
        cfg = self.cfg
        key = self._cache_key(idx, epoch)
        if key is not None:
            # buffer shapes are part of the key: dynamic buckets / widened
            # transpose tables must never replay a mismatched entry
            key = key + (out_x.shape[0], out_nbr_t.shape[1])
            hit = self._graph_cache.get(key)
            if hit is not None:
                cx, cn, cm, cnt, cmt, n_nodes, label = hit
                np.copyto(out_x, cx)
                np.copyto(out_nbr, cn)
                np.copyto(out_mask, cm)
                np.copyto(out_nbr_t, cnt)
                np.copyto(out_mask_t, cmt)
                self.graph_cache_hits += 1
                return n_nodes, label
        name = self.names[idx]
        proto = self._load_proto(name)
        n = proto.num_nodes
        rng = patch_rng(
            cfg.seed, name, epoch, "train" if self.split == "train" else "val"
        )
        choice = None
        if self.full_graph:
            num_sub, far_num = n, 0
        elif cfg.sample_ratio < 1.0 and n >= cfg.min_nodes_no_subsample:
            num_sub = min(int(n * cfg.sample_ratio), self.capacity)
            far_num = {
                "fuse": int(cfg.fuse_far_fraction * num_sub),
                "farthest": num_sub,
                "random": 0,
            }[cfg.sampling_method]
        else:
            num_sub, far_num = n, 0
        n_nodes = native.build_patch(
            proto.features, proto.coords,
            choice=choice, num_sub=num_sub, far_num=far_num, rng=rng,
            band=cfg.max_edge_distance, radius=cfg.max_edge_distance,
            k=cfg.max_neighbours, kt_cap=out_nbr_t.shape[1],
            feat_mode=cfg.feature_type, mean=self.mean, std=self.std,
            out_x=out_x, out_nbr=out_nbr, out_mask=out_mask,
            out_nbr_t=out_nbr_t, out_mask_t=out_mask_t,
        )
        if key is not None and n_nodes >= 0:
            entry = (
                out_x.copy(), out_nbr.copy(), out_mask.copy(),
                out_nbr_t.copy(), out_mask_t.copy(), n_nodes, proto.label,
            )
            self._cache_put(key, entry, sum(a.nbytes for a in entry[:5]))
        return n_nodes, proto.label

    def get(self, idx: int, epoch: int = 0) -> GraphSample:
        cfg = self.cfg
        key = self._cache_key(idx, epoch)
        if key is not None:
            hit = self._graph_cache.get(key)
            if hit is not None:
                self.graph_cache_hits += 1
                return hit  # immutable by convention (collate only reads)
        name = self.names[idx]
        proto = self._load_proto(name)
        feats = proto.full_features()
        coords = proto.coords
        n = proto.num_nodes

        purpose = "train" if self.split == "train" else "val"
        rng = patch_rng(cfg.seed, name, epoch, purpose)
        presorted = False
        if self.full_graph:
            pass  # full unsampled graph (NucleiDatasetTest mode)
        elif cfg.sample_ratio < 1.0:
            choice = self._subsample_sorted(n, coords, rng)
            presorted = choice is not None
            if choice is None:
                choice = self._subsample(n, coords, rng)
            if choice is not None:
                feats, coords = feats[choice], coords[choice]
                n = len(choice)
        n = min(n, self.capacity)
        feats, coords = feats[:n], coords[:n]

        if cfg.spatial_sort and not presorted and n > 1:
            # band sort (y-band of one radius, then x): keeps radius-graph
            # neighbours close in index space -> block-limited adjacency for
            # the BSR kernel; model output is permutation-invariant
            band = np.floor(coords[:, 0] / max(cfg.max_edge_distance, 1.0))
            order = np.lexsort((coords[:, 1], band))
            feats, coords = feats[order], coords[order]

        nbr, mask = _radius_knn(
            coords, cfg.max_edge_distance, cfg.max_neighbours,
            scan_order=cfg.knn_scan_order,
        )
        nbr_t, mask_t, _ = _transpose(nbr, mask, self.transpose_width)

        x = (self._slice_features(feats) - self.mean) / self.std

        sample = GraphSample(
            x=np.asarray(x, np.float32), nbr=nbr, nbr_mask=mask,
            nbr_t=nbr_t, nbr_t_mask=mask_t,
            n_nodes=n, label=proto.label, patch_idx=idx, name=name,
        )
        if key is not None:
            self._cache_put(
                key, sample,
                sum(a.nbytes for a in (sample.x, sample.nbr, sample.nbr_mask,
                                       sample.nbr_t, sample.nbr_t_mask)),
            )
        return sample


def collate(
    samples: Sequence[GraphSample],
    capacity: int | None = None,
    bsr_blocks: int = 0,
) -> dict[str, np.ndarray]:
    """Pad samples to ``capacity`` nodes and stack into batched arrays.

    Padding convention: features/masks zero; neighbour indices point at the
    row itself (in-bounds gathers). ``bsr_blocks > 0`` additionally emits
    block-sparse metadata for the BSR kernels (forward + transpose).
    """
    if capacity is None:
        # quantized bucket: 128 * next power of two — bounds the number of
        # distinct compiled shapes while shrinking padding for small batches
        need = max(s.n_nodes for s in samples)
        capacity = 128
        while capacity < need:
            capacity *= 2

    def pad_idx(a, width=None):
        width = a.shape[1] if width is None else width
        out = np.tile(
            np.arange(capacity, dtype=np.int32)[:, None], (1, width)
        )
        out[: a.shape[0], : a.shape[1]] = a
        return out

    def pad_zero(a, width=None):
        shape = (capacity,) + (
            a.shape[1:] if width is None else (width,) + a.shape[2:]
        )
        out = np.zeros(shape, a.dtype)
        out[: a.shape[0], : a.shape[1]] = a
        return out

    # transpose widths are adaptive per sample (dense clusters) — unify to
    # the batch maximum (extra slots: self index, mask 0)
    wt = max(s.nbr_t.shape[1] for s in samples)
    batch = {
        "x": np.stack([pad_zero(s.x) for s in samples]),
        "nbr": np.stack([pad_idx(s.nbr) for s in samples]),
        "nbr_mask": np.stack([pad_zero(s.nbr_mask) for s in samples]),
        "nbr_t": np.stack([pad_idx(s.nbr_t, wt) for s in samples]),
        "nbr_t_mask": np.stack([pad_zero(s.nbr_t_mask, wt) for s in samples]),
        "n_nodes": np.asarray([s.n_nodes for s in samples], np.int32),
        "y": np.asarray([s.label for s in samples], np.int32),
        "patch_idx": np.asarray([s.patch_idx for s in samples], np.int32),
    }
    if bsr_blocks > 0:
        attach_bsr_meta(batch, bsr_blocks)
    return batch


_STICKY_LOCK = threading.Lock()


def attach_bsr_meta(
    batch: dict, bsr_blocks: int, quantize: bool = True,
    sticky_caps: dict | None = None,
) -> None:
    """Add block-sparse metadata to a collated batch, in place.

    Quantized per-batch block capacity — PER DIRECTION: the transpose
    (in-edge) lists typically touch more column tiles than the forward
    lists, and kernel DMA cost scales with the cap. Tight metadata with a
    bounded set of compiled shapes; ``bsr_blocks`` is the ceiling — beyond
    it, the batch carries no metadata (the model then raises: the gather
    path for such batches is not ported yet).

    ``sticky_caps``: mutable {direction: cap} floor shared across batches —
    caps only GROW, so a run converges to ONE compiled train-step shape per
    direction after the first few batches. Without it, batch-to-batch cap
    wobble means new shapes batch after batch.

    ``quantize=False`` uses exactly ``bsr_blocks`` slots and RAISES on
    overflow — required when multiple processes each build a shard of one
    global batch and must agree on every shape (multi-host loading)."""
    bsr_block_meta = (
        native.bsr_block_meta if native.available() else bsr_block_meta_np
    )

    nb = batch["x"].shape[0]
    caps = (4, 6, 8, 12, 16)
    for di, (src, msk, cname, mname) in enumerate((
        ("nbr", "nbr_mask", "blk_cols", "blk_mask"),
        ("nbr_t", "nbr_t_mask", "blk_cols_t", "blk_mask_t"),
    )):
        # ONE scan per element: build meta at the widest usable cap and read
        # the need off the same pass, then slice down to the quantized cap
        # (the extra slots are zero-padding by construction)
        cap_max = bsr_blocks if not quantize else max(caps[-1], 1)
        cols, masks, need = [], [], 0
        for bi in range(nb):
            c, m, nd = bsr_block_meta(
                batch[src][bi], batch[msk][bi], cap_max, strict=False
            )
            cols.append(c)
            masks.append(m)
            need = max(need, nd)
        if quantize:
            floor = sticky_caps.get(di, 0) if sticky_caps is not None else 0
            cap = next((c for c in caps if c >= max(need, floor)), None)
            usable = cap is not None and cap <= max(bsr_blocks, 4)
            if sticky_caps is not None and usable:
                # record only USABLE caps (an oversized batch must not poison
                # the floor and push every later batch past the ceiling); the
                # read-max-write must be atomic or a stale read from a
                # concurrent loader worker could SHRINK the floor (= a fresh
                # shape)
                with _STICKY_LOCK:
                    sticky_caps[di] = max(sticky_caps.get(di, 0), cap)
        else:
            cap = bsr_blocks
            if need > cap:
                raise ValueError(
                    f"BSR needs {need} blocks/row-tile > fixed cap {cap} "
                    "(raise data.bsr_blocks for multi-host loading)"
                )
        if cap is None or cap > max(bsr_blocks, 4):
            import warnings

            warnings.warn(
                f"graph needs {need} BSR blocks/row-tile > cap "
                f"{bsr_blocks}; batch carries no BSR metadata (raise "
                "data.bsr_blocks or enable data.spatial_sort)",
                stacklevel=2,
            )
            for k in ("blk_cols", "blk_mask", "blk_cols_t", "blk_mask_t"):
                batch.pop(k, None)
            return
        batch[cname] = np.ascontiguousarray(np.stack(cols)[:, :, :cap])
        batch[mname] = np.ascontiguousarray(np.stack(masks)[:, :, :cap])
