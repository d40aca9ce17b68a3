"""Static-shape graph container.

A batch of cell graphs in the padded ELL layout of ``cgcnet_tpu.core.graph``:
each node stores up to K neighbour slots, padded rows and slots point at the
row itself with mask 0, and the block-sparse metadata of the BSR kernels
rides along. Here the fields are ``torch.Tensor``s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def node_mask(
    n_nodes: torch.Tensor, capacity: int, dtype=torch.float32
) -> torch.Tensor:
    """[B] node counts -> [B, capacity] prefix validity mask."""
    idx = torch.arange(capacity, device=n_nodes.device, dtype=torch.int32)
    return (idx[None, :] < n_nodes[:, None]).to(dtype)


@dataclasses.dataclass
class CellGraph:
    """A batch of padded cell graphs in ELL (fixed-width neighbour-list) form.

    Attributes:
      x:        f32[B, N, F]   node features, zero past ``n_nodes``.
      nbr:      i32[B, N, K]   neighbour indices; invalid slots hold the
                               node's own index.
      nbr_mask: f32[B, N, K]   1.0 for real neighbour slots.
      n_nodes:  i32[B]         real node count per graph.
      y, patch_idx:            optional i32[B] labels / dataset indices.
      nbr_t, nbr_t_mask:       transposed (in-edge) lists, [B, N, KT].
      blk_cols, blk_mask:      i32/f32[B, N/128, M] nonzero 128x128 block
                               columns of A per row tile (BSR metadata);
      blk_cols_t, blk_mask_t:  the same for the transpose.

    Row i aggregates from ``nbr[b, i, k]``: the implied adjacency is
    ``adj[b, i, nbr[b, i, k]] += 1`` over real slots.
    """

    x: torch.Tensor
    nbr: torch.Tensor
    nbr_mask: torch.Tensor
    n_nodes: torch.Tensor
    y: Optional[torch.Tensor] = None
    patch_idx: Optional[torch.Tensor] = None
    nbr_t: Optional[torch.Tensor] = None
    nbr_t_mask: Optional[torch.Tensor] = None
    blk_cols: Optional[torch.Tensor] = None
    blk_mask: Optional[torch.Tensor] = None
    blk_cols_t: Optional[torch.Tensor] = None
    blk_mask_t: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.x.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def mask(self, dtype=torch.float32) -> torch.Tensor:
        """[B, N] node validity mask."""
        return node_mask(self.n_nodes, self.capacity, dtype)

    def num_edges(self) -> torch.Tensor:
        """Total real edge count in the batch (i32 scalar on the device)."""
        return torch.sum(self.nbr_mask).to(torch.int32)

    def to(self, device, non_blocking: bool = False) -> "CellGraph":
        """Copy every tensor field to ``device``."""
        return CellGraph(
            **{
                f.name: (
                    None if v is None
                    else v.to(device, non_blocking=non_blocking)
                )
                for f in dataclasses.fields(self)
                for v in (getattr(self, f.name),)
            }
        )

    @classmethod
    def from_numpy(cls, batch: dict, pin: bool = False) -> "CellGraph":
        """Wrap a collated numpy batch (``dataflow.dataset.collate``) as CPU
        tensors, pinned when ``pin`` (for a later non-blocking device copy)."""
        names = {f.name for f in dataclasses.fields(cls)}

        def wrap(a):
            t = torch.from_numpy(a)
            return t.pin_memory() if pin else t

        return cls(**{k: wrap(v) for k, v in batch.items() if k in names})
