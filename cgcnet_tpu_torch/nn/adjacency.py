"""Adjacency abstraction: one interface, three layouts.

Stage 1 runs on the sparse cell graph (padded ELL; BSR blocks where the
batch carries block metadata); the pooled stages run on small dense cluster
graphs. Layers call ``matvec`` / ``rowsum`` / ``quadform`` and never look
at the layout. Port of ``cgcnet_tpu/nn/adjacency.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from cgcnet_tpu_torch.ops.ell import (
    bsr_matmul_precomp,
    bsr_spmm_factored,
    ell_gather_sum,
    ell_spmm_factored,
)


@dataclasses.dataclass
class EllAdjFactored:
    """Stage-1 adjacency A = diag(scale)·B_off + diag(self_w), with the
    transposed graph carried for a scatter-free backward. ``matvec`` takes
    the JAX package's branches in its order:

    1. ``impl == "bsr"`` with the block values ``vals`` built by B1 (both
       factors folded in): one B2 launch, backward B2 over the binary
       transpose blocks ``vals_t`` (None when gradients are disabled), each
       walking the live slots ``slots`` / ``slots_t``;
    2. ``impl == "bsr"`` with block metadata but no ``vals``: B7 builds
       each block from the ELL inside the kernel, both ways;
    3. otherwise ELL gathers both ways (``ell_spmm_factored``)."""

    nbr: torch.Tensor                      # i32[B, N, K]
    off_mask: torch.Tensor                 # [B, N, K] (self slots zeroed)
    nbr_t: torch.Tensor                    # i32[B, N, KT]
    off_mask_t: torch.Tensor               # [B, N, KT]
    scale: torch.Tensor                    # [B, N]
    self_w: torch.Tensor                   # [B, N]
    rowsum_: torch.Tensor                  # [B, N]
    blk_cols: Optional[torch.Tensor] = None    # i32[B, R, M]
    blk_mask: Optional[torch.Tensor] = None
    blk_cols_t: Optional[torch.Tensor] = None  # i32[B, R, MT]
    blk_mask_t: Optional[torch.Tensor] = None
    vals: Optional[torch.Tensor] = None        # [B, R, M, T, T]
    vals_t: Optional[torch.Tensor] = None      # [B, R, MT, T, T] binary
    slots: Optional[torch.Tensor] = None       # i32[B, R] live slot counts
    slots_t: Optional[torch.Tensor] = None     # i32[B, R] of blk_cols_t
    impl: str = "gather"                       # "bsr" | "gather"

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl == "bsr" and self.vals is not None:
            return bsr_matmul_precomp(
                self.vals, self.blk_cols, self.vals_t, self.blk_cols_t,
                self.scale, self.self_w, x, self.slots, self.slots_t,
            )
        dt = x.dtype
        if self.impl == "bsr" and self.blk_cols is not None:
            return bsr_spmm_factored(
                self.nbr, self.off_mask.to(dt), self.blk_cols, self.blk_mask,
                self.nbr_t, self.off_mask_t.to(dt), self.blk_cols_t,
                self.blk_mask_t, self.scale.to(dt), self.self_w.to(dt), x,
            )
        return ell_spmm_factored(
            self.nbr, self.off_mask.to(dt), self.nbr_t, self.off_mask_t.to(dt),
            self.scale.to(dt), self.self_w.to(dt), x,
        )

    def rowsum(self) -> torch.Tensor:
        return self.rowsum_

    def quadform(self, s: torch.Tensor) -> torch.Tensor:
        return torch.bmm(s.transpose(1, 2), self.matvec(s))


@dataclasses.dataclass
class EllAdj:
    """Padded-ELL adjacency; ``w`` carries the edge weights with the slot
    mask folded in (0 on padding). Gathers forward, autograd's scatter-add
    backward: the path of a batch without transpose tables."""

    nbr: torch.Tensor        # i32[B, N, K]
    w: torch.Tensor          # [B, N, K]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return ell_gather_sum(self.nbr, self.w.to(x.dtype), x)

    def rowsum(self) -> torch.Tensor:
        return torch.sum(self.w, dim=-1)

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


Adjacency = Union[EllAdj, EllAdjFactored, DenseAdj]
