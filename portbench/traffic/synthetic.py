"""The benchmark's traffic generator: synthetic patches.

A frozen copy of ``cgcnet_tpu_torch/dataflow/synthetic.py: make_patch`` as
of commit 73dfc14147ad9fa0d95116a4f462ff45e63a3144, so that no later change
to the program changes the benchmark's inputs. Everything is a function of the
seed it is given; the harness derives every seed from ``--seed``.
"""

from __future__ import annotations

import numpy as np

GRADE_DIRS = ["1_normal", "2_low_grade", "3_high_grade"]


def rng_of(seed: int, *keys: int) -> np.random.Generator:
    """A generator of its own for each (seed, keys): any whole seed."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), *keys])


def make_patch(rng: np.random.Generator, grade: int, n_nodes: int = 400,
               tile: float = 3584.0) -> tuple[np.ndarray, np.ndarray]:
    """(features [N, 16], coords [N, 2]) of one patch: grade 0 a jittered
    grid, grades 1 and 2 ever fewer and tighter clumps; grade-dependent
    shifts of two appearance channels."""
    if grade == 0:
        side = int(np.ceil(np.sqrt(n_nodes)))
        gx, gy = np.meshgrid(np.arange(side), np.arange(side))
        pts = np.stack([gx.ravel(), gy.ravel()], -1)[:n_nodes].astype(np.float64)
        pts = pts / side * tile + rng.normal(0, tile / side * 0.25, (n_nodes, 2))
    else:
        n_clusters = 24 if grade == 1 else 8
        spread = tile * (0.05 if grade == 1 else 0.02)
        centers = rng.uniform(0, tile, (n_clusters, 2))
        which = rng.integers(0, n_clusters, n_nodes)
        pts = centers[which] + rng.normal(0, spread, (n_nodes, 2))
    pts = np.clip(pts, 0, tile - 1)
    return patch_features(rng, grade, n_nodes), pts.astype(np.float32)


def patch_features(rng: np.random.Generator, grade: int,
                   n_nodes: int) -> np.ndarray:
    """Features [N, 16] of one patch's nuclei (``make_patch``'s draws)."""
    feats = rng.normal(0, 1, (n_nodes, 16))
    feats[:, 2] += 0.8 * grade
    feats[:, 10] += 0.5 * grade * rng.uniform(0.5, 1.5, n_nodes)
    feats = feats * 10.0 + 40.0
    return feats.astype(np.float32)


def patch_set(layout_seed: int, feature_seed: int, folds: list,
              images_per_grade: int, patches_per_image: int,
              n_nodes: tuple) -> list:
    """Every patch of a cross-validation tree: (name, features, coords,
    label), named ``<fold>/<grade dir>/<image stem>_<i>`` as the reference's
    image-level metric parses them. ``layout_seed`` draws each patch's
    nuclei count and positions, ``feature_seed`` its features (a generator
    of their own for each patch)."""
    rng = rng_of(layout_seed, 1)
    out = []
    for fold in folds:
        for grade, gdir in enumerate(GRADE_DIRS):
            for img in range(images_per_grade):
                stem = f"{fold}_g{grade + 1}_img{img}_grade_{grade + 1}"
                for p in range(patches_per_image):
                    n = int(rng.integers(*n_nodes))
                    _, pts = make_patch(rng, grade, n)
                    feats = patch_features(
                        rng_of(feature_seed, 2, len(out)), grade, n)
                    out.append((f"{fold}/{gdir}/{stem}_{p}", feats, pts, grade))
    return out

