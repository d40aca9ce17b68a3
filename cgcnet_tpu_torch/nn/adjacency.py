"""Adjacency abstraction: one interface, two layouts.

Stage 1 runs on the sparse cell graph (BSR blocks built from the padded
ELL); the pooled stages run on small dense cluster graphs. Layers call
``matvec`` / ``rowsum`` / ``quadform`` and never look at the layout.
Port of ``cgcnet_tpu/nn/adjacency.py`` (EllAdjFactored's block path and
DenseAdj); the ELL gather path comes with the GIN/GAT slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from cgcnet_tpu_torch.ops.ell import bsr_matmul_precomp


@dataclasses.dataclass
class EllAdjFactored:
    """Stage-1 adjacency A = diag(scale)·B_off + diag(self_w) with its
    128x128 block values ``vals`` precomputed by B1 (both factors folded
    in), so every matvec is one B2 launch. The backward runs B2 over the
    binary transpose blocks ``vals_t`` (a second B1 launch) with the
    factors applied to the cotangent; ``vals_t`` is None when no backward
    can run (gradients disabled)."""

    rowsum_: torch.Tensor                  # [B, N]
    blk_cols: torch.Tensor                 # i32[B, R, M]
    vals: torch.Tensor                     # [B, R, M, T, T]
    scale: torch.Tensor                    # [B, N]
    self_w: torch.Tensor                   # [B, N]
    blk_cols_t: Optional[torch.Tensor] = None  # i32[B, R, MT]
    vals_t: Optional[torch.Tensor] = None      # [B, R, MT, T, T] binary

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return bsr_matmul_precomp(
            self.vals, self.blk_cols, self.vals_t, self.blk_cols_t,
            self.scale, self.self_w, x,
        )

    def rowsum(self) -> torch.Tensor:
        return self.rowsum_

    def quadform(self, s: torch.Tensor) -> torch.Tensor:
        return torch.bmm(s.transpose(1, 2), self.matvec(s))


@dataclasses.dataclass
class DenseAdj:
    adj: torch.Tensor        # [B, N, N]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return torch.bmm(self.adj.to(x.dtype), x)

    def rowsum(self) -> torch.Tensor:
        return torch.sum(self.adj, dim=-1)

    def quadform(self, s: torch.Tensor) -> torch.Tensor:
        return torch.bmm(s.transpose(1, 2), self.matvec(s))


Adjacency = Union[EllAdjFactored, DenseAdj]
