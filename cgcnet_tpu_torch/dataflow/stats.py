"""Per-dataset feature normalization statistics (mean/std over every node
feature of a split; reference common/utils.py:154-164)."""

from __future__ import annotations

import numpy as np


def compute_stats(feature_arrays) -> tuple[np.ndarray, np.ndarray]:
    """Mean/std over a dataset's node features, accumulated in f64."""
    allins = np.vstack([np.asarray(a, np.float64) for a in feature_arrays])
    return allins.mean(0).astype(np.float32), allins.std(0).astype(np.float32)
