"""Radius-bounded kNN graph construction (host NumPy path).

Copy of ``cgcnet_tpu.ops.knn.radius_knn_np``: the K nearest points within
the radius, ties broken by lower index, self first (always), with a
``scan_order=True`` mode reproducing torch-cluster's first-K-found order.
The native grid-hash builder (dataflow/native.py) has the same contract.
"""

from __future__ import annotations

import numpy as np


def radius_knn_np(
    pos: np.ndarray,
    radius: float,
    k: int,
    *,
    scan_order: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Build an ELL neighbour list from 2-D points.

    Returns (nbr i32[N, k], mask f32[N, k]).
    """
    n = pos.shape[0]
    nbr = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k))
    mask = np.zeros((n, k), dtype=np.float32)
    if n == 0:
        return nbr, mask
    d2 = np.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    r2 = float(radius) ** 2
    within = d2 <= r2
    # self sorts strictly first even among coincident points — the BSR
    # path folds the self weight into ELL slot 0 and relies on this
    np.fill_diagonal(d2, -1.0)
    for i in range(n):
        (cand,) = np.nonzero(within[i])
        if scan_order:
            sel = cand[:k]
        else:
            order = np.lexsort((cand, d2[i, cand]))  # distance, then index
            sel = cand[order][:k]
        nbr[i, : len(sel)] = sel.astype(np.int32)
        mask[i, : len(sel)] = 1.0
    return nbr, mask
