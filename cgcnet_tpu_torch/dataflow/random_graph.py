"""Distance-thresholded random graph builder (reference
``random_sample_graph2``, dataflow/graph_sampler.py:5-45). Copy of
``cgcnet_tpu/dataflow/random_graph.py``: both packages draw the same graph
from the same generator.

Reference semantics: binarize the distance table at ``max_edge_distance``
(zero distances count as in-radius), draw ``n_sample`` neighbours per node
uniformly from the in-radius candidates by inverse-CDF sampling (with
replacement, so duplicates collapse), then symmetrize. The result is ELL of
width ``2 * n_sample + 1`` (sampled, symmetrized, self), which the BSR
metadata and block build take like the kNN graph's.
"""

from __future__ import annotations

import numpy as np


def random_distance_graph_ell(
    coords: np.ndarray,
    max_edge_distance: float,
    n_sample: int,
    rng: np.random.Generator,
    width: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (nbr i32[N, width], mask f32[N, width]); width defaults to
    2*n_sample + 1 (sampled + symmetrized + self)."""
    n = coords.shape[0]
    width = width or (2 * n_sample + 1)
    d = np.sqrt(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1))
    within = d <= max_edge_distance  # includes self (d=0), graph_sampler.py:19-21
    adj = np.zeros((n, n), dtype=bool)
    for i in range(n):
        (cand,) = np.nonzero(within[i])
        if len(cand) == 0:
            continue
        picks = rng.choice(cand, size=min(n_sample, len(cand)), replace=True)
        adj[i, picks] = True
        adj[picks, i] = True  # symmetrize (graph_sampler.py:31-32)
    np.fill_diagonal(adj, True)  # self-edge first, as the kNN builder does

    nbr = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, width))
    mask = np.zeros((n, width), np.float32)
    for i in range(n):
        cols = np.nonzero(adj[i])[0]
        # self first, then ascending index; truncate at width
        cols = np.concatenate([[i], cols[cols != i]])[:width]
        nbr[i, : len(cols)] = cols.astype(np.int32)
        mask[i, : len(cols)] = 1.0
    return nbr, mask
