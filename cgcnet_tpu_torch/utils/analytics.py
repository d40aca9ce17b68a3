"""Dataset analytics (reference dev tools, common/utils.py:131-164): the
max-node scan and the feature statistics over a proto tree. Copy of
``cgcnet_tpu/utils/analytics.py``."""

from __future__ import annotations

import numpy as np

from cgcnet_tpu_torch.dataflow.proto import list_protos, load_proto
from cgcnet_tpu_torch.dataflow.stats import compute_stats


def max_nodes_in_dataset(
    root: str, folds: list[str], dataset: str = "colorectal"
) -> tuple[list[int], int]:
    counts = [
        load_proto(root, n, dataset).num_nodes
        for n in list_protos(root, folds, dataset)
    ]
    return counts, max(counts) if counts else 0


def dataset_feature_stats(
    root: str, folds: list[str], dataset: str = "colorectal"
) -> tuple[np.ndarray, np.ndarray]:
    feats = [
        load_proto(root, n, dataset).full_features()
        for n in list_protos(root, folds, dataset)
    ]
    return compute_stats(feats)
