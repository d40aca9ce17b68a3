"""Feature normalization statistics: the reference's published per-fold
tables (dataflow/data.py:21-45) and mean/std over a dataset's node features
(common/utils.py:154-164). Copy of ``cgcnet_tpu/dataflow/stats.py``."""

from __future__ import annotations

import numpy as np

# Reference constants (dataflow/data.py:21-45): 16 appearance dims + 2 coord
# dims (mean = std = 3584: coords map to (c - 3584) / 3584).
_REF_MEAN = {
    1: [1.44855589e2, 1.50849152e1, 4.16993829e2, -9.89115031e-2,
        4.29073361e0, 7.03308534e0, 1.50311764e-1, 1.20372119e-1,
        1.99874447e-2, 7.24825770e-1, 1.28062193e2, 1.71914904e1,
        9.00313323e0, 4.29522533e1, 8.76540101e-1, 8.06801284e1, 3584, 3584],
    2: [1.45949547e2, 1.53704952e1, 4.39127922e2, -1.10080479e-1,
        4.30617772e0, 7.27624697e0, 1.45825849e-1, 1.21214980e-1,
        2.03645262e-2, 7.28225987e-1, 1.27914898e2, 1.72524907e1,
        8.96012595e0, 4.30067152e1, 8.76016742e-1, 8.09466370e1, 3584, 3584],
    3: [1.45649518e2, 1.52438912e1, 4.30302592e2, -1.07054163e-1,
        4.29877990e0, 7.13800092e0, 1.47971754e-1, 1.20517868e-1,
        2.00830612e-2, 7.24701226e-1, 1.26430193e2, 1.71710396e1,
        8.94070628e0, 4.27421136e1, 8.74665450e-1, 8.02611304e1, 3584, 3584],
}
_REF_STD = {
    1: [3.83891570e1, 1.23159786e1, 3.74384781e2, 5.05079918e-1,
        1.91811771e-1, 2.95460595e0, 7.31040425e-2, 7.41484835e-2,
        2.84762625e-2, 2.47544275e-1, 1.51846534e2, 5.96200235e1,
        6.00087195e0, 2.85961395e1, 1.95532620e-1, 5.49411936e1, 3584, 3584],
    2: [3.86514982e1, 1.25207234e1, 3.87362858e2, 5.02515226e-1,
        1.89045551e-1, 3.05856764e0, 7.22404102e-2, 7.53090608e-2,
        2.90460236e-2, 2.46734916e-1, 1.53743958e2, 6.34661492e1,
        6.02575043e0, 2.88403590e1, 1.94214810e-1, 5.49984596e1, 3584, 3584],
    3: [3.72861596e1, 1.23840868e1, 3.87834784e2, 5.02444847e-1,
        1.86722327e-1, 2.99248449e0, 7.20327363e-2, 7.45553798e-2,
        2.87285660e-2, 2.49195190e-1, 1.50986869e2, 6.56370060e1,
        6.00008814e0, 2.86376250e1, 1.97764021e-1, 5.54134874e1, 3584, 3584],
}


def reference_stats(cross_val: int, feature_type: str) -> tuple[np.ndarray, np.ndarray]:
    """Published per-fold stats, sliced for the feature type (data.py:151-156):
    'c' -> the last 2 (coords), 'a' -> the first 16, 'ca' -> all 18."""
    mean = np.asarray(_REF_MEAN[cross_val], np.float32)
    std = np.asarray(_REF_STD[cross_val], np.float32)
    if feature_type == "c":
        return mean[-2:], std[-2:]
    if feature_type == "a":
        return mean[:-2], std[:-2]
    return mean, std


def compute_stats(feature_arrays) -> tuple[np.ndarray, np.ndarray]:
    """Mean/std over a dataset's node features, accumulated in f64."""
    allins = np.vstack([np.asarray(a, np.float64) for a in feature_arrays])
    return allins.mean(0).astype(np.float32), allins.std(0).astype(np.float32)
