"""Segment ops — COO-side equivalents of torch-scatter.

The ELL path (``ops/ell.py``) is the hot path; these are the generic COO
utilities (the reference used torch-scatter ``scatter_('add', ...)`` at
model/utils.py:19). Port of ``cgcnet_tpu/ops/segment.py`` (plain PyTorch).
"""

from __future__ import annotations

import torch


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add(0, segment_ids.long(), data)


def segment_max(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Per-segment maximum; an empty segment holds -inf (as
    ``jax.ops.segment_max``)."""
    out = data.new_full((num_segments, *data.shape[1:]), float("-inf"))
    idx = segment_ids.long().reshape(-1, *([1] * (data.dim() - 1)))
    return out.scatter_reduce(0, idx.expand_as(data), data, reduce="amax")


def segment_softmax(
    logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Numerically stable softmax within segments (edge-wise attention)."""
    maxes = segment_max(logits, segment_ids, num_segments)
    exp = torch.exp(logits - maxes[segment_ids.long()])
    denom = segment_sum(exp, segment_ids, num_segments)
    return exp / (denom[segment_ids.long()] + 1e-16)


def coo_spmm(
    src: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
    x: torch.Tensor,
    num_nodes: int,
) -> torch.Tensor:
    """COO aggregation: out[d] += w_e * x[s] for each edge e = (s, d)."""
    msgs = x[src.long()] * w[:, None]
    return segment_sum(msgs, dst, num_nodes)
