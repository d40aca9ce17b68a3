"""Block-sparse (BSR) stage-1 aggregation: host metadata, B1 and B2.

Nuclei are spatially sorted by the loader, so each 128-row tile of the
radius graph touches only a few 128-column tiles. The host lists those
column tiles per row tile (``bsr_block_meta``); on the device the dense
128x128 blocks of A are built once per batch (B1, ``bsr_build_blocks``) and
every stage-1 matvec is then a block-sparse matmul over them (B2,
``bsr_matmul``).

Each device function has a plain PyTorch version of the same signature
(``*_plain``). The wrapper takes the plain version only for tensors that lie
on the CPU; for CUDA tensors it launches the hand-written kernel in
``csrc/`` or raises. ``launches`` on each wrapper counts kernel launches.

Replaces ``cgcnet_tpu/ops/pallas/bsr_kernel.py`` (bsr_blocks_needed,
bsr_block_meta, bsr_build_blocks, bsr_matmul).
"""

from __future__ import annotations

import numpy as np
import torch

from cgcnet_tpu_torch.ops import _cuda

TILE = 128


# ---------------------------------------------------------------------------
# host-side metadata
# ---------------------------------------------------------------------------

def bsr_blocks_needed(nbr: np.ndarray, mask: np.ndarray, tile: int = TILE) -> int:
    """Max column tiles touched by any row tile (the minimal viable
    ``max_blocks`` for :func:`bsr_block_meta`)."""
    n = nbr.shape[0]
    if n % tile != 0:
        return 1 << 30  # not tileable
    need = 0
    for ri in range(n // tile):
        rows = slice(ri * tile, (ri + 1) * tile)
        sel = nbr[rows][mask[rows] > 0]
        if sel.size:
            need = max(need, len(np.unique(sel // tile)))
    return max(need, 1)


def bsr_block_meta(
    nbr: np.ndarray,
    mask: np.ndarray,
    max_blocks: int,
    tile: int = TILE,
    strict: bool = True,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Per-row-tile nonzero block-column lists of a padded ELL [N, K].

    Returns (blk_cols i32[R, max_blocks], blk_mask f32[R, max_blocks],
    max_needed). Raises if a row tile touches more than ``max_blocks``
    column tiles, unless ``strict=False`` (over-cap row tiles are then left
    zero and the caller checks ``max_needed``).
    """
    n, _ = nbr.shape
    if n % tile != 0:
        raise ValueError(f"N={n} not a multiple of {tile}")
    r = n // tile
    blk_cols = np.zeros((r, max_blocks), np.int32)
    blk_mask = np.zeros((r, max_blocks), np.float32)
    max_needed = 0
    for ri in range(r):
        rows = slice(ri * tile, (ri + 1) * tile)
        cols = np.unique((nbr[rows][mask[rows] > 0]) // tile)
        max_needed = max(max_needed, len(cols))
        if len(cols) > max_blocks:
            if strict:
                raise ValueError(
                    f"row tile {ri} touches {len(cols)} column tiles > cap "
                    f"{max_blocks}; spatially sort nodes or raise bsr "
                    "max_blocks"
                )
            continue
        blk_cols[ri, : len(cols)] = cols
        blk_mask[ri, : len(cols)] = 1.0
    return blk_cols, blk_mask, max_needed


# ---------------------------------------------------------------------------
# B1: block build
# ---------------------------------------------------------------------------

def bsr_build_blocks_plain(
    nbr: torch.Tensor,       # i32[B, N, K]
    w: torch.Tensor,         # f32[B, N, K] edge weights (mask folded in)
    blk_cols: torch.Tensor,  # i32[B, R, M]
    blk_mask: torch.Tensor,  # i32/f32[B, R, M]
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """vals[b, r, m] = dense 128x128 block of A at row tile r, column tile
    blk_cols[b, r, m] (zero for padded slots), A[i, nbr[i, k]] += w[i, k].
    Slots are summed in k order from zero, as the kernel does."""
    b, n, k = nbr.shape
    r, m = blk_cols.shape[1], blk_cols.shape[2]
    nbr_t = nbr.reshape(b, r, 1, TILE, k).long()
    base = (blk_cols.long() * TILE).reshape(b, r, m, 1, 1)
    col = nbr_t - base                                   # [B, R, M, T, K]
    inside = (col >= 0) & (col < TILE)
    src = torch.where(inside, w.float().reshape(b, r, 1, TILE, k), 0.0)
    src = src.expand(b, r, m, TILE, k)
    vals = torch.zeros((b, r, m, TILE, TILE), dtype=torch.float32, device=w.device)
    vals.scatter_add_(-1, col.clamp(0, TILE - 1), src)
    bm = blk_mask.to(torch.int32).to(torch.float32).reshape(b, r, m, 1, 1)
    return (bm * vals).to(dtype)


def bsr_build_blocks(
    nbr: torch.Tensor,
    w: torch.Tensor,
    blk_cols: torch.Tensor,
    blk_mask: torch.Tensor,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """B1. Same contract as :func:`bsr_build_blocks_plain`; launches
    ``csrc/bsr_build.cu`` for CUDA tensors."""
    b, n, k = nbr.shape
    if n % TILE or blk_cols.shape[:2] != (b, n // TILE):
        raise ValueError(
            f"bsr_build_blocks: N={n} must tile by {TILE} and blk_cols "
            f"{tuple(blk_cols.shape)} must be [B, N/{TILE}, M]"
        )
    if nbr.device.type == "cpu":
        return bsr_build_blocks_plain(nbr, w, blk_cols, blk_mask, dtype)
    if dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"bsr_build_blocks: unsupported dtype {dtype}")
    r, m = blk_cols.shape[1], blk_cols.shape[2]
    nbr = nbr.to(torch.int32).contiguous()
    w = w.to(torch.float32).contiguous()
    blk_cols = blk_cols.to(torch.int32).contiguous()
    blk_mask = blk_mask.to(torch.int32).to(torch.float32).contiguous()
    _cuda.require_cuda("bsr_build_blocks", nbr, w, blk_cols, blk_mask)
    vals = torch.empty((b, r, m, TILE, TILE), dtype=dtype, device=nbr.device)
    _cuda.launch(
        "cgc_bsr_build_blocks",
        nbr.data_ptr(), w.data_ptr(), blk_cols.data_ptr(), blk_mask.data_ptr(),
        vals.data_ptr(), b, n, k, r, m, _cuda.DTYPE_CODES[dtype],
        nbr.device.index, _cuda.stream_of(nbr),
    )
    bsr_build_blocks.launches += 1
    return vals


bsr_build_blocks.launches = 0


# ---------------------------------------------------------------------------
# B2: block-sparse matmul over precomputed blocks
# ---------------------------------------------------------------------------

def bsr_matmul_plain(
    vals: torch.Tensor,      # [B, R, M, T, T] from bsr_build_blocks
    blk_cols: torch.Tensor,  # i32[B, R, M]
    x: torch.Tensor,         # [B, NC, F]
) -> torch.Tensor:
    """out[B, R*T, F] = sum_m vals[:, r, m] @ x[:, blk_cols*T : +T], f32
    accumulation, stored in x's dtype; x rows past NC read as zero."""
    b, r, m = blk_cols.shape
    nc, f = x.shape[1], x.shape[2]
    tiles = -(-nc // TILE)
    xf = x.float()
    if tiles * TILE != nc:
        xf = torch.cat(
            [xf, xf.new_zeros((b, tiles * TILE - nc, f))], dim=1
        )
    xt = xf.reshape(b, tiles, TILE, f)
    bidx = torch.arange(b, device=x.device).reshape(b, 1, 1)
    gathered = xt[bidx, blk_cols.long()]                 # [B, R, M, T, F]
    out = torch.einsum("brmij,brmjf->brif", vals.float(), gathered)
    return out.reshape(b, r * TILE, f).to(x.dtype)


def bsr_matmul(
    vals: torch.Tensor, blk_cols: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """B2. Same contract as :func:`bsr_matmul_plain`; launches
    ``csrc/bsr_matmul.cu`` for CUDA tensors. ``vals`` must be in x's dtype."""
    b, r, m = blk_cols.shape
    if vals.shape != (b, r, m, TILE, TILE) or x.shape[0] != b:
        raise ValueError(
            f"bsr_matmul: vals {tuple(vals.shape)}, blk_cols "
            f"{tuple(blk_cols.shape)} and x {tuple(x.shape)} disagree"
        )
    if vals.dtype != x.dtype:
        raise ValueError(
            f"bsr_matmul: vals dtype {vals.dtype} != x dtype {x.dtype}"
        )
    if x.device.type == "cpu":
        return bsr_matmul_plain(vals, blk_cols, x)
    if x.dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"bsr_matmul: unsupported dtype {x.dtype}")
    nc, f = x.shape[1], x.shape[2]
    blk_cols = blk_cols.to(torch.int32).contiguous()
    x = x.contiguous()
    _cuda.require_cuda("bsr_matmul", vals, blk_cols, x)
    out = torch.empty((b, r * TILE, f), dtype=x.dtype, device=x.device)
    _cuda.launch(
        "cgc_bsr_matmul",
        vals.data_ptr(), blk_cols.data_ptr(), x.data_ptr(), out.data_ptr(),
        b, r, m, nc, f, _cuda.DTYPE_CODES[x.dtype],
        x.device.index, _cuda.stream_of(x),
    )
    bsr_matmul.launches += 1
    return out


bsr_matmul.launches = 0
