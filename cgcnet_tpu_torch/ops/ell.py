"""Stage-1 sparse aggregation over precomputed blocks, and the dense
adaptive renormalization of the pooled stages.

Port of the forward parts of ``cgcnet_tpu/ops/ell.py`` that the serving path
runs: ``bsr_matmul_precomp`` (A @ x with A's block values, weights folded
in, built once per batch by B1) and ``renorm_dense``. The backward of
``bsr_matmul_precomp`` (B_off^T (scale*g) + self_w*g over the binary
transpose blocks) comes with training.
"""

from __future__ import annotations

import torch

from cgcnet_tpu_torch.ops.bsr import bsr_matmul

EPS = 1e-15  # reference model/network.py:8


def bsr_matmul_precomp(
    vals: torch.Tensor,      # [B, R, M, T, T] blocks of A (weights folded in)
    blk_cols: torch.Tensor,  # i32[B, R, M]
    x: torch.Tensor,         # [B, N, F]
) -> torch.Tensor:
    """A @ x: forward blocks fold A completely (row scale + self weight),
    so the matvec is one B2 launch with no epilogue."""
    return bsr_matmul(vals, blk_cols, x)


def renorm_dense(adj: torch.Tensor, p: float) -> torch.Tensor:
    """Dense adaptive renormalization (reference ``_re_norm_adj``,
    model/network.py:183-191): zero the diagonal, row-normalize with
    +1e-15, scale by (1-p), set the diagonal to p."""
    n = adj.shape[-1]
    idx = torch.arange(n, device=adj.device)
    eye = (idx[:, None] == idx[None, :])[None]
    zero = torch.zeros((), dtype=adj.dtype, device=adj.device)
    adj = torch.where(eye, zero, adj)
    new_adj = adj / (torch.sum(adj, dim=-1, keepdim=True) + EPS) * (1.0 - p)
    return torch.where(eye, torch.full_like(zero, p), new_adj)
