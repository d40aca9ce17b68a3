"""SDDMM — sampled dense-dense matmul over the padded ELL structure.

Per ELL slot (i, k): ``out[b, i, k] = <a[b, i, :], c[b, nbr[b, i, k], :]>``,
the sparse dual of ``ops.ell.ell_gather_sum``, and a masked softmax over
the K slots of a row. Port of ``cgcnet_tpu/ops/sddmm.py`` (plain PyTorch;
the JAX package has no kernel for it). The model's attention layer
(``nn.layers.GATConv``) fuses the same pattern over all heads; these are the
building blocks for single-head or precomputed-score message passing.
"""

from __future__ import annotations

import torch


def ell_sddmm(
    nbr: torch.Tensor, mask: torch.Tensor, a: torch.Tensor, c: torch.Tensor
) -> torch.Tensor:
    """[B, N, K] scores: dot(a_i, c_j) per edge slot; 0 on padding."""
    bidx = torch.arange(nbr.shape[0], device=nbr.device)[:, None, None]
    gathered = c[bidx, nbr.long()]                       # [B, N, K, F]
    return torch.einsum("bnf,bnkf->bnk", a, gathered) * mask


def ell_edge_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row-wise masked softmax over the K neighbour slots: padding slots get
    0 and rows renormalize over their real slots."""
    neg = torch.finfo(scores.dtype).min
    masked = torch.where(mask > 0, scores, neg)
    m = torch.amax(masked, dim=-1, keepdim=True)
    e = torch.exp(masked - m.detach()) * (mask > 0)
    denom = torch.sum(e, dim=-1, keepdim=True)
    return e / torch.clamp_min(denom, 1e-16)
