"""Host-side ELL transpose (the loader's in-edge tables).

NumPy copy of ``cgcnet_tpu.core.convert.transpose_ell_np``, kept here so the
PyTorch package needs nothing from the JAX package.
"""

from __future__ import annotations

import numpy as np


def transpose_ell_np(
    nbr: np.ndarray, mask: np.ndarray, width_t: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Transpose a padded-ELL adjacency: rows of the output list in-edges.

    For edge i -> j (slot (i, k) with nbr[i,k]=j), the transpose places i in
    row j. Returns (nbr_t i32[N, width_t], mask_t f32[N, width_t],
    max_indegree). Raises if any in-degree exceeds ``width_t``.
    """
    n, k = nbr.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    flat_dst = nbr.reshape(-1).astype(np.int64)
    flat_ok = mask.reshape(-1) > 0
    src, dst = rows[flat_ok], flat_dst[flat_ok]
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(dst, minlength=n)
    max_indeg = int(counts.max()) if len(counts) else 0
    if max_indeg > width_t:
        raise ValueError(
            f"max in-degree {max_indeg} exceeds transpose ELL width {width_t}"
        )
    nbr_t = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, width_t))
    mask_t = np.zeros((n, width_t), dtype=np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(src)) - starts[dst]
    nbr_t[dst, slot] = src.astype(np.int32)
    mask_t[dst, slot] = 1.0
    return nbr_t, mask_t, max_indeg
