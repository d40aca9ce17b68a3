"""Sparse neighbourhood aggregation over padded ELL graphs, and the
adaptive renormalization of the adjacency.

    out[b, i, :] = sum_k w[b, i, k] * x[b, nbr[b, i, k], :]

Port of ``cgcnet_tpu/ops/ell.py``:

- ``ell_gather_sum`` and ``ell_spmm_factored``: an index gather per slot
  and a weighted sum over the K slots — the path of a batch without BSR
  metadata. The JAX package computes it with XLA gathers, outside any
  Pallas kernel, so it is plain PyTorch here on every device. The factored
  form's backward is a gather over the transpose tables, not a scatter;
- ``bsr_spmm_factored``: the same operator through B7 (blocks built from
  the ELL inside the kernel), both directions;
- ``bsr_matmul_precomp``: A @ x with A's block values, weights folded in,
  built once per batch by B1; its backward B_off^T (scale*g) + self_w*g
  over the binary transpose blocks (B2 both ways, each walking its blocks'
  live slots);
- ``bsr_local_matmul``: the whole-slide path's per-shard A_loc @ [h ++
  halo] over int8 blocks — B8 for the wide (F >= BAND_MIN_F) legs at
  2-byte activations when the window tables exist, B2 otherwise — and its
  backward over the transpose blocks, the halo rows of a hybrid transpose
  as an ELL gather;
- ``renorm_ell``, ``renorm_dense`` (reference ``_re_norm_adj``,
  model/network.py:183-191) and ``ell_rowsum``.
"""

from __future__ import annotations

import torch

from cgcnet_tpu_torch.ops.bsr import (
    BAND_MIN_F,
    bsr_gather_sum,
    bsr_matmul,
    bsr_matmul_banded,
)

EPS = 1e-15  # reference model/network.py:8


def ell_gather_sum(
    nbr: torch.Tensor,  # i32[B, N, K] (padded slots point in bounds)
    w: torch.Tensor,    # [B, N, K] edge weights, 0 on padded slots
    x: torch.Tensor,    # [B, N, F]
) -> torch.Tensor:
    """Weighted neighbour sum out[b, i] = sum_k w[b, i, k] x[b, nbr[b, i, k]]:
    one gather of x per slot, summed in slot order in f32 and stored in x's
    dtype. Autograd's backward is a scatter-add over ``nbr``."""
    b, _, k = nbr.shape
    bidx = torch.arange(b, device=x.device)[:, None]
    idx = nbr.long()
    out = None
    for kk in range(k):
        term = w[..., kk, None].float() * x[bidx, idx[..., kk]].float()
        out = term if out is None else out + term
    return out.to(x.dtype)


def _factored(gathered, scale, self_w, x):
    return scale[..., None] * gathered + self_w[..., None] * x


class EllSpmmFactored(torch.autograd.Function):
    """A @ x for A = diag(scale)·B_off + diag(self_w) by ELL gathers; the
    backward A^T g = B_off^T (scale*g) + self_w*g gathers over the
    transpose tables (``nbr_t``, ``off_mask_t``) instead of scattering."""

    @staticmethod
    def forward(ctx, nbr, off_mask, nbr_t, off_mask_t, scale, self_w, x):
        ctx.save_for_backward(nbr_t, off_mask_t, scale, self_w)
        return _factored(ell_gather_sum(nbr, off_mask, x), scale, self_w, x)

    @staticmethod
    def backward(ctx, g):
        nbr_t, off_mask_t, scale, self_w = ctx.saved_tensors
        sg = scale[..., None] * g
        dx = ell_gather_sum(nbr_t, off_mask_t, sg) + self_w[..., None] * g
        return None, None, None, None, None, None, dx


def ell_spmm_factored(
    nbr: torch.Tensor,         # i32[B, N, K]
    off_mask: torch.Tensor,    # [B, N, K] binary, self slots zeroed
    nbr_t: torch.Tensor,       # i32[B, N, KT] in-edge lists
    off_mask_t: torch.Tensor,  # [B, N, KT]
    scale: torch.Tensor,       # [B, N] row scales
    self_w: torch.Tensor,      # [B, N] diagonal weights
    x: torch.Tensor,           # [B, N, F]
) -> torch.Tensor:
    """A @ x for A = diag(scale)·B_off + diag(self_w), gathers both ways
    (:class:`EllSpmmFactored`)."""
    return EllSpmmFactored.apply(nbr, off_mask, nbr_t, off_mask_t, scale,
                                 self_w, x)


class BsrSpmmFactored(torch.autograd.Function):
    """:class:`EllSpmmFactored`'s operator through B7: one launch forward
    on (nbr, off_mask, blk_cols), one backward on the transpose tables."""

    @staticmethod
    def forward(ctx, nbr, off_mask, blk_cols, blk_mask, nbr_t, off_mask_t,
                blk_cols_t, blk_mask_t, scale, self_w, x):
        ctx.save_for_backward(nbr_t, off_mask_t, blk_cols_t, blk_mask_t, scale,
                              self_w)
        gathered = bsr_gather_sum(nbr, off_mask, blk_cols, blk_mask, x)
        return _factored(gathered, scale, self_w, x)

    @staticmethod
    def backward(ctx, g):
        nbr_t, off_mask_t, blk_cols_t, blk_mask_t, scale, self_w = ctx.saved_tensors
        sg = scale[..., None] * g
        dx = (bsr_gather_sum(nbr_t, off_mask_t, blk_cols_t, blk_mask_t, sg)
              + self_w[..., None] * g)
        return (None,) * 10 + (dx,)


def bsr_spmm_factored(
    nbr, off_mask, blk_cols, blk_mask, nbr_t, off_mask_t, blk_cols_t,
    blk_mask_t, scale, self_w, x,
) -> torch.Tensor:
    """Same contract as :func:`ell_spmm_factored` with the block metadata of
    both directions; B7 both ways (:class:`BsrSpmmFactored`)."""
    return BsrSpmmFactored.apply(nbr, off_mask, blk_cols, blk_mask, nbr_t,
                                 off_mask_t, blk_cols_t, blk_mask_t, scale,
                                 self_w, x)


class BsrMatmulPrecomp(torch.autograd.Function):
    """A @ x over precomputed blocks, A = diag(scale)·B_off + diag(self_w).

    Forward blocks fold A completely (row scale + self weight), so the
    matvec is one B2 launch with no epilogue. Backward: A^T g =
    B_off^T (scale*g) + self_w*g, one B2 launch over the BINARY transpose
    blocks ``vals_t`` (folding scale into them would need each in-edge's row
    scale). ``slots`` / ``slots_t`` are the live slot counts of ``blk_cols``
    / ``blk_cols_t`` (B2's ``live_slots``). When x needs no gradient
    autograd skips the backward."""

    @staticmethod
    def forward(ctx, vals, blk_cols, vals_t, blk_cols_t, scale, self_w, x,
                slots, slots_t):
        ctx.save_for_backward(vals_t, blk_cols_t, scale, self_w, slots_t)
        return bsr_matmul(vals, blk_cols, x, slots)

    @staticmethod
    def backward(ctx, g):
        vals_t, blk_cols_t, scale, self_w, slots_t = ctx.saved_tensors
        if vals_t is None:
            raise RuntimeError(
                "bsr_matmul_precomp: no transpose blocks (vals_t) — the "
                "stage-1 adjacency was built with gradients disabled"
            )
        sg = scale[..., None].to(g.dtype) * g
        dx = (bsr_matmul(vals_t, blk_cols_t, sg, slots_t)
              + self_w[..., None].to(g.dtype) * g)
        return (None,) * 6 + (dx, None, None)


def bsr_matmul_precomp(
    vals: torch.Tensor,        # [B, R, M, T, T] blocks of A (weights folded in)
    blk_cols: torch.Tensor,    # i32[B, R, M]
    vals_t,                    # [B, R, MT, T, T] binary blocks of B_off^T, or None
    blk_cols_t,                # i32[B, R, MT], or None
    scale: torch.Tensor,       # [B, N] row scales of A
    self_w: torch.Tensor,      # [B, N] diagonal weights of A
    x: torch.Tensor,           # [B, N, F]
    slots: torch.Tensor,       # i32[B, R] live slot counts of blk_cols
    slots_t,                   # i32[B, R] of blk_cols_t, or None
) -> torch.Tensor:
    """A @ x with A's backward through the transpose blocks (B2 both ways)."""
    return BsrMatmulPrecomp.apply(vals, blk_cols, vals_t, blk_cols_t, scale,
                                  self_w, x, slots, slots_t)


def _banded_on(win, x: torch.Tensor) -> bool:
    """B8 serves a leg when its window table exists, the leg is at least
    BAND_MIN_F wide and activations take at most 2 bytes (ops/ell.py:259 of
    the JAX package: the TPU window is sized for bf16)."""
    return bool(win.shape[-1]) and x.shape[-1] >= BAND_MIN_F \
        and x.element_size() <= 2


class BsrLocalMatmul(torch.autograd.Function):
    """out [Ns, F] = A_loc @ [h ++ halo] of one shard; the backward runs the
    transpose blocks over the cotangent and splits the result into the
    local rows and the halo rows (the caller's halo exchange routes the
    latter back to their shards). B8's window contract is the tables'
    (``bsr.check_band_windows``, once per slide), not checked per launch."""

    @staticmethod
    def forward(ctx, vals, blk_cols, win, vals_t, blk_cols_t, win_t, h, halo,
                win_halo, nbr_t_h, mask_t_h, slots, slots_t):
        ctx.save_for_backward(vals_t, blk_cols_t, win_t, nbr_t_h, mask_t_h,
                              slots_t)
        ctx.ns = h.shape[0]
        if _banded_on(win, h):
            hw = (win_halo if win_halo is not None and win_halo.shape[-1]
                  else None)
            return bsr_matmul_banded(
                vals, blk_cols, win, h[None], ns_rows=h.shape[0],
                halo=halo[None], halo_win=hw, check_windows=False,
                live_slots=slots,
            )[0]
        return bsr_matmul(vals, blk_cols, torch.cat([h, halo], dim=0)[None],
                          slots)[0]

    @staticmethod
    def backward(ctx, g):
        vals_t, blk_cols_t, win_t, nbr_t_h, mask_t_h, slots_t = \
            ctx.saved_tensors
        ns = ctx.ns
        g = g.contiguous()
        if _banded_on(win_t, g):
            # the transpose's x is the forward's row space: no halo tiles
            d_xx = bsr_matmul_banded(
                vals_t, blk_cols_t, win_t, g[None], ns_rows=ns,
                check_windows=False, live_slots=slots_t,
            )[0]
        else:
            d_xx = bsr_matmul(vals_t, blk_cols_t, g[None], slots_t)[0]
        if nbr_t_h is not None and nbr_t_h.shape[0]:
            # hybrid transpose: the halo rows' in-edges as an ELL gather
            d_halo = ell_gather_sum(
                nbr_t_h[None], mask_t_h.to(g.dtype)[None], g[None]
            )[0]
        else:
            d_halo = d_xx[ns:]
        return (None,) * 6 + (d_xx[:ns], d_halo) + (None,) * 5


def bsr_local_matmul(
    vals: torch.Tensor,        # [1, R, M, T, T] blocks of A_loc (int8)
    blk_cols: torch.Tensor,    # i32[1, R, M]
    win: torch.Tensor,         # i32[1, S] window bases, or [1, 0]
    vals_t: torch.Tensor,      # [1, RC, MT, T, T] blocks of A_loc^T
    blk_cols_t: torch.Tensor,  # i32[1, RC, MT]
    win_t: torch.Tensor,       # i32[1, S_t] or [1, 0]
    h: torch.Tensor,           # [Ns, F] local rows
    halo: torch.Tensor,        # [NC - Ns, F] halo rows, zero-padded
    win_halo=None,             # halo sub-window bases or None / [1, 0]
    nbr_t_h=None,              # i32[H, KT] in-edge lists of the halo rows
                               #   (hybrid transpose)
    mask_t_h=None,             # f32[H, KT]
    slots=None,                # i32[1, R] live slot counts of blk_cols
    slots_t=None,              # i32[1, RC] of blk_cols_t (B2's and B8's
                               #   live_slots)
) -> torch.Tensor:
    """[Ns, F] = A_loc @ [h ++ halo] (:class:`BsrLocalMatmul`)."""
    return BsrLocalMatmul.apply(vals, blk_cols, win, vals_t, blk_cols_t,
                                win_t, h, halo, win_halo, nbr_t_h, mask_t_h,
                                slots, slots_t)


def renorm_ell(
    nbr: torch.Tensor,       # i32[B, N, K]
    nbr_mask: torch.Tensor,  # [B, N, K]
    n_nodes: torch.Tensor,   # i32[B]
    p: float,
) -> torch.Tensor:
    """Adaptive-GraphSAGE edge weights over ELL (``_re_norm_adj`` on a
    binary adjacency): ``p`` on self slots, ``(1-p)/deg_offdiag`` on real
    off-diagonal slots, 0 on padding and on rows past ``n_nodes``."""
    n = nbr.shape[1]
    row = torch.arange(n, device=nbr.device, dtype=nbr.dtype)[None, :, None]
    is_self = (nbr == row).to(nbr_mask.dtype) * nbr_mask
    off = nbr_mask * (1.0 - is_self)
    deg = torch.sum(off, dim=-1, keepdim=True)
    w = off * (1.0 - p) / (deg + EPS) + is_self * p
    node_ok = (
        torch.arange(n, device=nbr.device)[None, :] < n_nodes[:, None]
    ).to(w.dtype)
    return w * node_ok[:, :, None]


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


def ell_rowsum(w: torch.Tensor) -> torch.Tensor:
    """[B, N, K] -> [B, N] row sums (the degree for binary weights)."""
    return torch.sum(w, dim=-1)
