from cgcnet_tpu_torch.utils.gexf import graph_to_gexf, assignments_to_gexf
from cgcnet_tpu_torch.utils.profiling import StepTimer, trace_context
from cgcnet_tpu_torch.utils.analytics import (
    max_nodes_in_dataset,
    dataset_feature_stats,
)

__all__ = [
    "graph_to_gexf",
    "assignments_to_gexf",
    "StepTimer",
    "trace_context",
    "max_nodes_in_dataset",
    "dataset_feature_stats",
]
