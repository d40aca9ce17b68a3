"""Farthest-point and fused node subsampling (host NumPy path).

Copies of ``cgcnet_tpu.ops.fps.farthest_point_sample_np`` and
``fuse_sample_np``. Every draw comes from an explicit
``np.random.Generator`` keyed by (seed, patch, epoch) — dataflow/rng.py.
"""

from __future__ import annotations

import numpy as np


def farthest_point_sample_np(
    dist: np.ndarray, k: int, rng: np.random.Generator
) -> np.ndarray:
    """Greedy max-min FPS over a dense [N, N] distance table: random start,
    then argmax (first on ties) of the running min distance."""
    n = dist.shape[0]
    k = min(k, n)
    out = np.zeros(k, dtype=np.int32)
    out[0] = rng.integers(n)
    running = dist[out[0]].copy()
    for i in range(1, k):
        out[i] = int(np.argmax(running))
        running = np.minimum(running, dist[out[i]])
    return out


def fuse_sample_np(
    dist: np.ndarray,
    num_subsample: int,
    rng: np.random.Generator,
    far_fraction: float = 0.7,
) -> np.ndarray:
    """'fuse' sampling: ``far_fraction`` FPS + the rest uniform from the
    complement."""
    n = dist.shape[0]
    num_subsample = min(num_subsample, n)
    far_num = int(far_fraction * num_subsample)
    rand_num = num_subsample - far_num
    far_idx = (
        farthest_point_sample_np(dist, far_num, rng)
        if far_num > 0 else np.zeros(0, np.int32)
    )
    remain = np.setdiff1d(np.arange(n), far_idx, assume_unique=False)
    rand_idx = rng.choice(
        remain, size=min(rand_num, len(remain)), replace=False
    ).astype(np.int32)
    return np.concatenate([far_idx, rand_idx], axis=0)
