"""Stage-1 sparse aggregation over precomputed blocks, and the dense
adaptive renormalization of the pooled stages.

Port of the parts of ``cgcnet_tpu/ops/ell.py`` that the canonical path
runs: ``bsr_matmul_precomp`` (A @ x with A's block values, weights folded
in, built once per batch by B1; its backward B_off^T (scale*g) + self_w*g
over the binary transpose blocks) and ``renorm_dense``.
"""

from __future__ import annotations

import torch

from cgcnet_tpu_torch.ops.bsr import bsr_matmul

EPS = 1e-15  # reference model/network.py:8


class BsrMatmulPrecomp(torch.autograd.Function):
    """A @ x over precomputed blocks, A = diag(scale)·B_off + diag(self_w).

    Forward blocks fold A completely (row scale + self weight), so the
    matvec is one B2 launch with no epilogue. Backward: A^T g =
    B_off^T (scale*g) + self_w*g, one B2 launch over the BINARY transpose
    blocks ``vals_t`` (folding scale into them would need each in-edge's row
    scale). When x needs no gradient autograd skips the backward."""

    @staticmethod
    def forward(ctx, vals, blk_cols, vals_t, blk_cols_t, scale, self_w, x):
        ctx.save_for_backward(vals_t, blk_cols_t, scale, self_w)
        return bsr_matmul(vals, blk_cols, x)

    @staticmethod
    def backward(ctx, g):
        vals_t, blk_cols_t, scale, self_w = ctx.saved_tensors
        if vals_t is None:
            raise RuntimeError(
                "bsr_matmul_precomp: no transpose blocks (vals_t) — the "
                "stage-1 adjacency was built with gradients disabled"
            )
        sg = scale[..., None].to(g.dtype) * g
        dx = bsr_matmul(vals_t, blk_cols_t, sg) + self_w[..., None].to(g.dtype) * g
        return None, None, None, None, None, None, dx


def bsr_matmul_precomp(
    vals: torch.Tensor,        # [B, R, M, T, T] blocks of A (weights folded in)
    blk_cols: torch.Tensor,    # i32[B, R, M]
    vals_t,                    # [B, R, MT, T, T] binary blocks of B_off^T, or None
    blk_cols_t,                # i32[B, R, MT], or None
    scale: torch.Tensor,       # [B, N] row scales of A
    self_w: torch.Tensor,      # [B, N] diagonal weights of A
    x: torch.Tensor,           # [B, N, F]
) -> torch.Tensor:
    """A @ x with A's backward through the transpose blocks (B2 both ways)."""
    return BsrMatmulPrecomp.apply(vals, blk_cols, vals_t, blk_cols_t, scale,
                                  self_w, x)


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
