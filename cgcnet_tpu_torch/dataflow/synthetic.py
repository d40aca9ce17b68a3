"""Synthetic cell-graph dataset with planted class structure.

The CRC histology data behind the reference is not distributable with the
repo (its GROUND_TRUTH image list is redacted, common/metric.py:6-19), so the
framework ships a generator that produces protos in the same layout with the
same shapes (16-dim appearance + 2-dim centroid, 3 grades, 3 folds) and a
*learnable* signal: grade controls nuclear clustering (normal = regular
lattice-ish spacing, high grade = dense irregular clumps) and shifts a few
appearance channels — so integration tests can train to high accuracy quickly
(SURVEY.md §4.5).
"""

from __future__ import annotations

import numpy as np

from cgcnet_tpu_torch.dataflow.proto import PatchProto, save_proto

GRADE_DIRS = ["1_normal", "2_low_grade", "3_high_grade"]


def make_patch(
    rng: np.random.Generator,
    grade: int,
    n_nodes: int = 400,
    tile: float = 3584.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (features [N,16], coords [N,2]) for one synthetic patch."""
    if grade == 0:
        # near-regular spread: jittered grid
        side = int(np.ceil(np.sqrt(n_nodes)))
        gx, gy = np.meshgrid(np.arange(side), np.arange(side))
        pts = np.stack([gx.ravel(), gy.ravel()], -1)[:n_nodes].astype(np.float64)
        pts = pts / side * tile + rng.normal(0, tile / side * 0.25, (n_nodes, 2))
    else:
        # clumps: fewer, tighter centres for higher grade
        n_clusters = 24 if grade == 1 else 8
        spread = tile * (0.05 if grade == 1 else 0.02)
        centers = rng.uniform(0, tile, (n_clusters, 2))
        which = rng.integers(0, n_clusters, n_nodes)
        pts = centers[which] + rng.normal(0, spread, (n_nodes, 2))
    pts = np.clip(pts, 0, tile - 1)

    feats = rng.normal(0, 1, (n_nodes, 16))
    # grade-dependent appearance shift on a few channels (area, intensity var)
    feats[:, 2] += 0.8 * grade
    feats[:, 10] += 0.5 * grade * rng.uniform(0.5, 1.5, n_nodes)
    # scale roughly into the reference feature ranges so the published
    # normalization tables stay sane
    feats = feats * 10.0 + 40.0
    return feats.astype(np.float32), pts.astype(np.float32)


def generate_dataset(
    root: str,
    *,
    patches_per_image: int = 4,
    images_per_grade: int = 2,
    n_nodes: tuple[int, int] = (250, 500),
    folds: tuple[str, ...] = ("fold_1", "fold_2", "fold_3"),
    seed: int = 0,
    dataset: str = "colorectal",
) -> list[str]:
    """Write a full synthetic proto tree; returns patch names.

    Patch naming mirrors the reference convention the image-level metric
    parses: ``<img>_grade_<g>_<i>`` with the image stem before '_grade'
    (common/metric.py:29-36).
    """
    rng = np.random.default_rng(seed)
    names = []
    for fold in folds:
        for grade, gdir in enumerate(GRADE_DIRS):
            for img in range(images_per_grade):
                # image stem (the part before '_grade') must be unique per
                # image — include the grade in it
                stem = f"{fold}_g{grade + 1}_img{img}_grade_{grade + 1}"
                for p in range(patches_per_image):
                    n = int(rng.integers(*n_nodes))
                    feats, pts = make_patch(rng, grade, n)
                    name = f"{fold}/{gdir}/{stem}_{p}"
                    save_proto(
                        root,
                        PatchProto(name=name, features=feats, coords=pts, label=grade),
                        dataset=dataset,
                    )
                    names.append(name)
    return names
