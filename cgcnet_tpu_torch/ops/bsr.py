"""Block-sparse (BSR) stage-1 aggregation: host metadata, B1, B2, B7 and B8.

Nuclei are spatially sorted by the loader, so each 128-row tile of the
radius graph touches only a few 128-column tiles. The host lists those
column tiles per row tile (``bsr_block_meta``); on the device the dense
128x128 blocks of A are built once per batch (B1, ``bsr_build_blocks``) and
every stage-1 matvec is then a block-sparse matmul over them (B2,
``bsr_matmul``). B7 (``bsr_gather_sum``) builds each block from the ELL
inside the kernel and multiplies it at once, for an operator whose blocks
were not built beforehand. B8 (``bsr_matmul_banded``) is the whole-slide
path's A_loc @ [x ++ halo]: x's local column tiles and the halo rows come
as two arrays, with an optional row accumulator (``acc``, split outputs)
or a ``scale*(A@x) + self_w*x`` epilogue. The slide path stores its binary
blocks in int8: B1 writes them and B2 and B8 convert them to x's type where
they are used. B2 and B8 stop each row tile's walk at its last live slot
(``live_slot_counts``, made once per set of blocks); bf16 B2 and bf16 B8
legs at least 128 wide run on the tensor cores, B7 and the other B8 legs
gather over the nonzeros.

Each device function has a plain PyTorch version of the same signature
(``*_plain``). The wrapper takes the plain version only for tensors that lie
on the CPU; for CUDA tensors it launches the hand-written kernel in
``csrc/`` or raises. ``launches`` on each wrapper counts kernel launches;
``variants`` on B2 and B8, which pick a kernel by dtype and width, counts
them by the ``__global__`` kernel the launch runs.

Replaces ``cgcnet_tpu/ops/pallas/bsr_kernel.py`` (bsr_blocks_needed,
bsr_block_meta, bsr_build_blocks, bsr_matmul, bsr_gather_sum,
bsr_matmul_banded and its window tables).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from cgcnet_tpu_torch.ops import _cuda

TILE = 128

# Window constants of the TPU's banded kernel (bsr_kernel.py:535-585). The
# tables they define decide which x tiles that kernel keeps in fast memory;
# B8 here reads every tile from device memory, but it refuses operators that
# break the window contract, so both packages accept the same inputs.
G_BAND = 4        # row tiles per super tile (slide capacities pad to 4*128)
W_BAND = 16       # contiguous column tiles per super tile's window
H_BAND_MAX = 4    # halo column tiles a resident tail may hold
H_SUB = H_BAND_MAX // 2  # tiles per halo sub-window (two of them)
BAND_MIN_F = 512  # the banded kernel serves only legs at least this wide
# The plain block product gathers x's column tile for every slot, [B, R', M,
# T, F] in f32; it takes the row tiles R' at a time so that gather stays
# under PLAIN_GATHER_BYTES (at 1M nuclei, F = 1140, all row tiles at once
# are 38 GiB). Each output row is the same sum either way.
PLAIN_GATHER_BYTES = 1 << 30


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


def band_window_table(
    blk_cols: np.ndarray,   # i32[R, M] one shard
    blk_mask: np.ndarray,   # [R, M]
    ns_tiles: int,          # local column tiles (halo tiles start here)
) -> np.ndarray | None:
    """Per-super-row-tile window bases i32[R // G_BAND], or None when a super
    tile's local columns span more than W_BAND tiles (the caller then keeps
    the plain block matmul B2). Needs R % G_BAND == 0 and ns_tiles >=
    W_BAND; halo columns (>= ns_tiles) ride in the resident tail."""
    r = blk_cols.shape[0]
    if r % G_BAND or r < G_BAND or ns_tiles < W_BAND:
        return None
    base = np.zeros(r // G_BAND, np.int32)
    for si in range(r // G_BAND):
        rows = slice(si * G_BAND, (si + 1) * G_BAND)
        cols = blk_cols[rows][blk_mask[rows] > 0]
        cols = cols[cols < ns_tiles]
        if len(cols) == 0:
            continue
        lo, hi = int(cols.min()), int(cols.max())
        b0 = min(lo, ns_tiles - W_BAND)
        if hi >= b0 + W_BAND:
            return None
        base[si] = b0
    return base


def band_window_table_halo(
    blk_cols: np.ndarray,   # i32[R, M] one shard
    blk_mask: np.ndarray,   # [R, M]
    ns_tiles: int,          # local column tiles (halo tiles start here)
    h_tiles_total: int,     # halo column tiles in the halo array
) -> tuple[np.ndarray, np.ndarray] | None:
    """(local bases i32[S], halo sub-window bases i32[S, 2]) for a halo too
    large for the resident tail (more than one shard), or None when some
    super tile's band does not fit. A super tile's halo columns split at
    their largest gap into two clusters, each within an H_SUB-tile
    sub-window; a lone cluster gets the contiguous pair (hb, hb + H_SUB).
    Contract: halo column h maps through sub-window 1 iff h < hb1 + H_SUB."""
    r = blk_cols.shape[0]
    if r % G_BAND or r < G_BAND or ns_tiles < W_BAND:
        return None
    if h_tiles_total < H_BAND_MAX:
        return None  # the tail fits resident: use band_window_table
    s_count = r // G_BAND
    base = np.zeros(s_count, np.int32)
    hbase = np.zeros((s_count, 2), np.int32)
    hmax = h_tiles_total - H_SUB
    for si in range(s_count):
        rows = slice(si * G_BAND, (si + 1) * G_BAND)
        cols = blk_cols[rows][blk_mask[rows] > 0]
        loc = cols[cols < ns_tiles]
        hal = np.unique(cols[cols >= ns_tiles] - ns_tiles)
        if len(loc):
            lo, hi = int(loc.min()), int(loc.max())
            b0 = min(lo, ns_tiles - W_BAND)
            if hi >= b0 + W_BAND:
                return None
            base[si] = b0
        if len(hal):
            if len(hal) > 1:
                gi = int(np.argmax(np.diff(hal)))
                a, b = hal[:gi + 1], hal[gi + 1:]
            else:
                a, b = hal, hal[:0]
            hb1 = min(int(a.min()), hmax)
            if len(b) == 0 or int(b.min()) < hb1 + H_SUB:
                span_hi = int(hal.max())
                hb1 = min(int(hal.min()), h_tiles_total - 2 * H_SUB)
                if span_hi >= hb1 + 2 * H_SUB:
                    return None
                hbase[si] = (hb1, hb1 + H_SUB)
            else:
                if int(a.max()) >= hb1 + H_SUB:
                    return None
                hb2 = min(int(b.min()), hmax)
                if int(b.max()) >= hb2 + H_SUB:
                    return None
                hbase[si] = (hb1, hb2)
    return base, hbase


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
    Slots are summed in k order from zero, as the kernel does; int8 output
    truncates the f32 sums (the slide path's binary operator)."""
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
    if torch.compiler.is_compiling():
        return bsr_build_blocks_op(nbr, w, blk_cols, blk_mask, dtype)
    if dtype not in _cuda.VALS_CODES:
        raise ValueError(f"bsr_build_blocks: unsupported dtype {dtype}")
    r, m = blk_cols.shape[1], blk_cols.shape[2]
    nbr = nbr.to(torch.int32).contiguous()
    w = w.to(torch.float32).contiguous()
    blk_cols = blk_cols.to(torch.int32).contiguous()
    # the kernel truncates the mask to an integer, as the plain version does
    blk_mask = blk_mask.to(torch.float32).contiguous()
    _cuda.require_cuda("bsr_build_blocks", nbr, w, blk_cols, blk_mask)
    vals = torch.empty((b, r, m, TILE, TILE), dtype=dtype, device=nbr.device)
    _cuda.launch(
        "cgc_bsr_build_blocks",
        nbr.data_ptr(), w.data_ptr(), blk_cols.data_ptr(), blk_mask.data_ptr(),
        vals.data_ptr(), b, n, k, r, m, _cuda.VALS_CODES[dtype],
        nbr.device.index, _cuda.stream_of(nbr),
    )
    bsr_build_blocks.launches += 1
    return vals


bsr_build_blocks.launches = 0


@torch.library.custom_op("cgcnet_tpu_torch::bsr_build_blocks", mutates_args=())
def bsr_build_blocks_op(
    nbr: torch.Tensor, w: torch.Tensor, blk_cols: torch.Tensor,
    blk_mask: torch.Tensor, dtype: torch.dtype,
) -> torch.Tensor:
    """B1 as ``torch.ops.cgcnet_tpu_torch.bsr_build_blocks``: what a traced
    program (``torch.export``) records where the wrapper meets a CUDA
    tensor; running it calls the wrapper, which launches the kernel."""
    return bsr_build_blocks(nbr, w, blk_cols, blk_mask, dtype)


@bsr_build_blocks_op.register_fake
def _(nbr, w, blk_cols, blk_mask, dtype):
    b, r, m = blk_cols.shape
    return nbr.new_empty((b, r, m, TILE, TILE), dtype=dtype)


# ---------------------------------------------------------------------------
# B2: block-sparse matmul over precomputed blocks
# ---------------------------------------------------------------------------

def _check_vals_dtype(name: str, vals: torch.Tensor, x: torch.Tensor) -> None:
    if vals.dtype not in (x.dtype, torch.int8):
        raise ValueError(
            f"{name}: vals dtype {vals.dtype} is neither x's ({x.dtype}) "
            "nor int8"
        )


def bsr_matmul_plain(
    vals: torch.Tensor,      # [B, R, M, T, T] from bsr_build_blocks
    blk_cols: torch.Tensor,  # i32[B, R, M]
    x: torch.Tensor,         # [B, NC, F]
    live_slots=None,         # i32[B, R] (live_slot_counts); not read here
) -> torch.Tensor:
    """out[B, R*T, F] = sum_m vals[:, r, m] @ x[:, blk_cols*T : +T], f32
    accumulation, stored in x's dtype; x rows past NC read as zero. int8
    ``vals`` convert to x's dtype where they are used. ``live_slots``
    changes no value (the slots past it hold zero blocks) and is ignored."""
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
    step = max(1, PLAIN_GATHER_BYTES // (b * m * TILE * max(f, 1) * 4))
    out = x.new_empty((b, r, TILE, f))
    for lo in range(0, r, step):
        rows = slice(lo, lo + step)
        gathered = xt[bidx, blk_cols[:, rows].long()]    # [B, R', M, T, F]
        out[:, rows] = torch.einsum(
            "brmij,brmjf->brif", vals[:, rows].to(x.dtype).float(), gathered
        )
    return out.reshape(b, r * TILE, f)


def bsr_matmul(
    vals: torch.Tensor, blk_cols: torch.Tensor, x: torch.Tensor,
    live_slots: torch.Tensor,
) -> torch.Tensor:
    """B2. Same contract as :func:`bsr_matmul_plain`; launches
    ``csrc/bsr_matmul.cu`` for CUDA tensors, which walks each row tile's
    slots only up to ``live_slots`` (i32[B, R], :func:`live_slot_counts` of
    the blocks' ``blk_mask``, made once per set of blocks): bf16 x on the
    tensor cores, f32 x on the CUDA cores. ``vals`` must be in x's dtype or
    int8."""
    b, r, m = blk_cols.shape
    if vals.shape != (b, r, m, TILE, TILE) or x.shape[0] != b:
        raise ValueError(
            f"bsr_matmul: vals {tuple(vals.shape)}, blk_cols "
            f"{tuple(blk_cols.shape)} and x {tuple(x.shape)} disagree"
        )
    if not isinstance(live_slots, torch.Tensor) \
            or tuple(live_slots.shape) != (b, r) \
            or live_slots.dtype != torch.int32:
        got = (f"{tuple(live_slots.shape)} {live_slots.dtype}"
               if isinstance(live_slots, torch.Tensor) else repr(live_slots))
        raise ValueError(f"bsr_matmul: live_slots {got} must be "
                         f"i32[{b}, {r}] (live_slot_counts of the blocks)")
    _check_vals_dtype("bsr_matmul", vals, x)
    if x.device.type == "cpu":
        return bsr_matmul_plain(vals, blk_cols, x, live_slots)
    if torch.compiler.is_compiling():
        return bsr_matmul_op(vals, blk_cols, x, live_slots)
    if x.dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"bsr_matmul: unsupported dtype {x.dtype}")
    nc, f = x.shape[1], x.shape[2]
    blk_cols = blk_cols.to(torch.int32).contiguous()
    live_slots = live_slots.contiguous()
    x = x.contiguous()
    _cuda.require_cuda("bsr_matmul", vals, blk_cols, live_slots, x)
    out = torch.empty((b, r * TILE, f), dtype=x.dtype, device=x.device)
    _cuda.launch(
        "cgc_bsr_matmul",
        vals.data_ptr(), blk_cols.data_ptr(), live_slots.data_ptr(),
        x.data_ptr(), out.data_ptr(), b, r, m, nc, f,
        _cuda.VALS_CODES[vals.dtype], _cuda.DTYPE_CODES[x.dtype],
        x.device.index, _cuda.stream_of(x),
    )
    bsr_matmul.launches += 1
    _B2_VARIANTS[bsr_matmul_variant(x.dtype)] += 1
    return out


bsr_matmul.launches = 0
# a module object, not looked up through the wrapper's name: a shim in the
# wrapper's place records nothing
bsr_matmul.variants = _B2_VARIANTS = Counter()


def bsr_matmul_variant(dtype: torch.dtype) -> str:
    """The kernel B2 runs for x of ``dtype`` (``csrc/bsr_matmul.cu``)."""
    return ("bsr_matmul_tc_kernel" if dtype == torch.bfloat16
            else "bsr_matmul_f32_kernel")


@torch.library.custom_op("cgcnet_tpu_torch::bsr_matmul", mutates_args=())
def bsr_matmul_op(
    vals: torch.Tensor, blk_cols: torch.Tensor, x: torch.Tensor,
    live_slots: torch.Tensor,
) -> torch.Tensor:
    """B2 as ``torch.ops.cgcnet_tpu_torch.bsr_matmul`` (see
    :func:`bsr_build_blocks_op`)."""
    return bsr_matmul(vals, blk_cols, x, live_slots)


@bsr_matmul_op.register_fake
def _(vals, blk_cols, x, live_slots):
    b, r, _ = blk_cols.shape
    return x.new_empty((b, r * TILE, x.shape[2]))


# ---------------------------------------------------------------------------
# B7: block-sparse gather-sum, blocks built on the fly
# ---------------------------------------------------------------------------

def bsr_gather_sum_plain(
    nbr: torch.Tensor,       # i32[B, N, K]
    w: torch.Tensor,         # [B, N, K] edge weights (mask folded in)
    blk_cols: torch.Tensor,  # i32[B, R, M]
    blk_mask: torch.Tensor,  # i32/f32[B, R, M]
    x: torch.Tensor,         # [B, NC, F]
) -> torch.Tensor:
    """out[b, i] = sum_k w[b, i, k] * x[b, nbr[b, i, k]] through the blocks:
    each block's f32 entries (slots summed in order, as B1 builds them) are
    rounded to x's dtype, the products accumulate in f32 and the sum is
    rounded once to x's dtype (the TPU's resident variant; its streamed
    variant rounds after every slot in bf16). Needs every edge's column
    tile listed in ``blk_cols`` for its row tile."""
    vals = bsr_build_blocks_plain(nbr, w, blk_cols, blk_mask, x.dtype)
    return bsr_matmul_plain(vals, blk_cols, x)


def bsr_gather_sum(
    nbr: torch.Tensor,
    w: torch.Tensor,
    blk_cols: torch.Tensor,
    blk_mask: torch.Tensor,
    x: torch.Tensor,
) -> torch.Tensor:
    """B7. Same contract as :func:`bsr_gather_sum_plain`; launches
    ``csrc/bsr_gather.cu`` for CUDA tensors."""
    b, n, k = nbr.shape
    if n % TILE or blk_cols.shape[:2] != (b, n // TILE) or x.shape[0] != b:
        raise ValueError(
            f"bsr_gather_sum: N={n} must tile by {TILE}, blk_cols "
            f"{tuple(blk_cols.shape)} must be [B, N/{TILE}, M] and x "
            f"{tuple(x.shape)} [B, NC, F]"
        )
    if x.device.type == "cpu":
        return bsr_gather_sum_plain(nbr, w, blk_cols, blk_mask, x)
    if x.dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"bsr_gather_sum: unsupported dtype {x.dtype}")
    r, m = blk_cols.shape[1], blk_cols.shape[2]
    nc, f = x.shape[1], x.shape[2]
    nbr = nbr.to(torch.int32).contiguous()
    w = w.to(torch.float32).contiguous()
    blk_cols = blk_cols.to(torch.int32).contiguous()
    blk_mask = blk_mask.to(torch.int32).contiguous()
    x = x.contiguous()
    _cuda.require_cuda("bsr_gather_sum", nbr, w, blk_cols, blk_mask, x)
    out = torch.empty((b, n, f), dtype=x.dtype, device=x.device)
    _cuda.launch(
        "cgc_bsr_gather_sum",
        nbr.data_ptr(), w.data_ptr(), blk_cols.data_ptr(), blk_mask.data_ptr(),
        x.data_ptr(), out.data_ptr(), b, n, k, r, m, nc, f,
        _cuda.DTYPE_CODES[x.dtype], x.device.index, _cuda.stream_of(x),
    )
    bsr_gather_sum.launches += 1
    return out


bsr_gather_sum.launches = 0


# ---------------------------------------------------------------------------
# B8: banded block-sparse matmul, A_loc @ [x ++ halo]
# ---------------------------------------------------------------------------

def _banded_shapes(vals, blk_cols, win_base, x, ns_rows, halo, halo_win, acc,
                   epilogue_sw):
    """Check B8's arguments as the TPU wrapper asserts them; returns
    (h_tiles, na) — the halo column tiles and the rows ``acc`` covers."""
    b, r, m = blk_cols.shape
    n, f = x.shape[1], x.shape[2]
    if vals.shape != (b, r, m, TILE, TILE) or x.shape[0] != b:
        raise ValueError(
            f"bsr_matmul_banded: vals {tuple(vals.shape)}, blk_cols "
            f"{tuple(blk_cols.shape)} and x {tuple(x.shape)} disagree"
        )
    _check_vals_dtype("bsr_matmul_banded", vals, x)
    if r % G_BAND or ns_rows % TILE or n % TILE:
        raise ValueError(
            f"bsr_matmul_banded: R={r} must tile by {G_BAND}, ns_rows="
            f"{ns_rows} and x rows {n} by {TILE}"
        )
    if win_base.numel() != b * (r // G_BAND):
        raise ValueError(
            f"bsr_matmul_banded: win_base {tuple(win_base.shape)} needs "
            f"{b} x {r // G_BAND} bases"
        )
    ns_tiles = ns_rows // TILE
    if halo is None:
        h_tiles = n // TILE - ns_tiles
    else:
        if n != ns_rows or halo.shape[1] % TILE or halo.shape[0] != b \
                or halo.shape[2] != f or halo.dtype != x.dtype:
            raise ValueError(
                f"bsr_matmul_banded: x {tuple(x.shape)} must hold exactly "
                f"ns_rows={ns_rows} rows beside halo {tuple(halo.shape)} "
                f"[B, H*{TILE}, F] of x's dtype"
            )
        h_tiles = halo.shape[1] // TILE
    if halo_win is not None:
        if halo is None or h_tiles < H_BAND_MAX \
                or halo_win.numel() != b * (r // G_BAND) * 2:
            raise ValueError(
                "bsr_matmul_banded: halo windows need a separate halo of at "
                f"least {H_BAND_MAX} tiles and {b} x {r // G_BAND} x 2 bases"
            )
    elif not 0 <= h_tiles <= H_BAND_MAX:
        raise ValueError(
            f"bsr_matmul_banded: {h_tiles} halo tiles exceed the resident "
            f"tail ({H_BAND_MAX}); pass halo windows"
        )
    na = 0
    if acc is not None:
        if epilogue_sw is not None:
            raise ValueError("bsr_matmul_banded: acc and epilogue_sw are "
                             "mutually exclusive")
        if b != 1 or f % 128 or acc.shape[0] != 1 or acc.shape[2] != f \
                or acc.shape[1] % (G_BAND * TILE) or acc.shape[1] > r * TILE:
            raise ValueError(
                f"bsr_matmul_banded: acc {tuple(acc.shape)} must be "
                f"[1, NA, F] with F={f} a multiple of 128, NA a multiple of "
                f"{G_BAND * TILE} and at most {r * TILE}"
            )
        if halo_win is not None and acc.shape[1] != r * TILE:
            raise ValueError("bsr_matmul_banded: with halo windows acc must "
                             "cover every output row")
        na = acc.shape[1]
    if epilogue_sw is not None and (
        b != 1 or tuple(epilogue_sw.shape) != (1, r * TILE, 128)
        or r * TILE > n
    ):
        raise ValueError(
            f"bsr_matmul_banded: epilogue_sw {tuple(epilogue_sw.shape)} must "
            f"be [1, {r * TILE}, 128] over x's own rows"
        )
    return h_tiles, na


def band_window_violations(
    blk_cols: torch.Tensor,   # i32[B, R, M]
    live: torch.Tensor,       # bool[B, R, M] slots with a nonzero block
    win_base: torch.Tensor,   # i32[B, S]
    ns_tiles: int,
    h_tiles: int,
    halo_win=None,            # i32[B, S, 2] or None
) -> torch.Tensor:
    """bool[B, R, M]: live block slots outside their super tile's window —
    the local band [base, base + W_BAND), the resident halo tail
    [0, h_tiles) or, with ``halo_win``, the two H_SUB-tile sub-windows
    (sub-window 1 iff h < hb1 + H_SUB). The TPU kernel clips such a slot's
    tile offset and multiplies the wrong x tile."""
    b, r, m = blk_cols.shape
    col = blk_cols.long()
    base = win_base.reshape(b, -1).long().repeat_interleave(G_BAND, dim=1)
    local = col < ns_tiles
    in_band = (col >= base[..., None]) & (col < base[..., None] + W_BAND)
    h = col - ns_tiles
    if halo_win is None:
        in_halo = (h >= 0) & (h < h_tiles)
    else:
        hw = halo_win.reshape(b, -1, 2).long().repeat_interleave(G_BAND, dim=1)
        hb1, hb2 = hw[..., 0:1], hw[..., 1:2]
        first = h < hb1 + H_SUB
        in_halo = torch.where(first, h >= hb1, (h >= hb2) & (h < hb2 + H_SUB))
        in_halo = in_halo & (h < h_tiles)
    ok = torch.where(local, in_band, in_halo)
    return live & ~ok


def check_band_windows(blk_cols, live, win_base, ns_rows: int,
                       h_tiles: int, halo_win=None) -> None:
    """Refuse an operator that breaks the window contract (one host sync):
    ``band_window_violations`` over ``live`` (bool[B, R, M]) must be empty.
    The whole-slide path checks its tables once per slide, when their
    blocks are built (``parallel.mega_model.check_windows``)."""
    bad = band_window_violations(
        blk_cols, live, win_base.to(blk_cols.device), ns_rows // TILE,
        h_tiles, None if halo_win is None else halo_win.to(blk_cols.device),
    )
    n_bad = int(bad.sum())
    if n_bad:
        raise ValueError(
            f"bsr_matmul_banded: {n_bad} live block slots lie outside their "
            "super tile's window (the TPU kernel would read the wrong x tile)"
        )


def _check_windows(vals, blk_cols, win_base, ns_rows, h_tiles, halo_win,
                   blk_mask) -> None:
    """:func:`check_band_windows` with the live slots from ``blk_mask``
    when given, else from the blocks."""
    b, r, m = blk_cols.shape
    if blk_mask is not None:
        live = blk_mask.reshape(b, r, m) > 0
    else:
        live = vals.reshape(b, r, m, -1).ne(0).any(dim=-1)
    check_band_windows(blk_cols, live, win_base, ns_rows, h_tiles, halo_win)


def live_slot_counts(blk_mask: torch.Tensor) -> torch.Tensor:
    """i32[..., R]: for each row tile of a ``blk_mask`` [..., R, M], the
    number of its block slots up to and including its last live one (0 for
    a row tile without one) — B2's and B8's ``live_slots``: the slots past
    it hold exact-zero blocks, and the kernels stop their walk there."""
    m = blk_mask.shape[-1]
    pos = torch.arange(1, m + 1, dtype=torch.int32, device=blk_mask.device)
    return torch.amax((blk_mask > 0).to(torch.int32) * pos, dim=-1).to(
        torch.int32)


def bsr_matmul_banded_plain(
    vals: torch.Tensor,       # [B, R, M, T, T] (int8 on the slide path)
    blk_cols: torch.Tensor,   # i32[B, R, M]
    win_base: torch.Tensor,   # i32[B, S], S = R // G_BAND
    x: torch.Tensor,          # [B, NX, F] local columns (+ the halo tail
                              #   when ``halo`` is None)
    ns_rows: int,             # local rows: column tiles below ns_rows/T
    halo=None,                # [B, H*T, F] halo columns as their own array
    halo_win=None,            # i32[B, S, 2] halo sub-window bases
    acc=None,                 # [1, NA, F] added to the first NA rows
    epilogue_sw=None,         # [1, R*T, 128]: lane 0 scale, lane 1 self_w
    blk_mask=None,            # [B, R, M] live slots for the window check
    check_windows=True,       # False: the caller checked the tables once
    live_slots=None,          # i32[B, R] (live_slot_counts); not read here
):
    """out = A_loc @ [x ++ halo]: column tile c < ns_rows/T reads x, tile c
    >= ns_rows/T reads the halo at c - ns_rows/T (or x's tail rows). int8
    blocks convert to x's dtype; sums in f32; ``acc`` added in f32 before the
    one rounding to x's dtype. With ``acc`` over NA < R*T rows it returns
    (rows < NA, rows >= NA) as two tensors. ``epilogue_sw`` gives
    scale*out + self_w*x_row in f32. The window tables change no value: a
    live block outside its window raises, unless ``check_windows`` is False
    (tables already held by :func:`check_band_windows`). ``live_slots``
    changes no value (the slots past it hold zero blocks) and is ignored."""
    h_tiles, na = _banded_shapes(vals, blk_cols, win_base, x, ns_rows, halo,
                                 halo_win, acc, epilogue_sw)
    if check_windows:
        _check_windows(vals, blk_cols, win_base, ns_rows, h_tiles, halo_win,
                       blk_mask)
    b, r, m = blk_cols.shape
    f = x.shape[2]
    dt = x.dtype
    xx = x if halo is None else torch.cat([x, halo], dim=1)
    tiles = xx.shape[1] // TILE
    xt = xx.float().reshape(b, tiles, TILE, f)
    bidx = torch.arange(b, device=x.device).reshape(b, 1, 1)
    gathered = xt[bidx, blk_cols.long().clamp(0, tiles - 1)]
    out = torch.einsum(
        "brmij,brmjf->brif", vals.to(dt).float(), gathered
    ).reshape(b, r * TILE, f)
    if epilogue_sw is not None:
        sw = epilogue_sw.float()
        out = sw[..., 0:1] * out + sw[..., 1:2] * x[:, : r * TILE].float()
    if acc is None:
        return out.to(dt)
    head = (out[:, :na] + acc.float()).to(dt)
    if na == r * TILE:
        return head
    return head, out[:, na:].to(dt)


def bsr_matmul_banded(
    vals: torch.Tensor,
    blk_cols: torch.Tensor,
    win_base: torch.Tensor,
    x: torch.Tensor,
    ns_rows: int,
    halo=None,
    halo_win=None,
    acc=None,
    epilogue_sw=None,
    blk_mask=None,
    check_windows=True,
    live_slots=None,
):
    """B8. Same contract as :func:`bsr_matmul_banded_plain`; launches
    ``csrc/bsr_banded.cu`` for CUDA tensors (one kernel for the TPU's
    resident-tail and halo-window variants): bf16 x at F >= 128 on the
    tensor cores, f32 or narrower legs on the gather over the blocks'
    nonzeros; both stop each row tile's walk at ``live_slots`` when
    given."""
    h_tiles, na = _banded_shapes(vals, blk_cols, win_base, x, ns_rows, halo,
                                 halo_win, acc, epilogue_sw)
    b, r, m = blk_cols.shape
    if live_slots is not None and (tuple(live_slots.shape) != (b, r)
                                   or live_slots.dtype != torch.int32):
        raise ValueError(
            f"bsr_matmul_banded: live_slots {tuple(live_slots.shape)} "
            f"{live_slots.dtype} must be i32[{b}, {r}]"
        )
    if x.device.type == "cpu":
        return bsr_matmul_banded_plain(
            vals, blk_cols, win_base, x, ns_rows, halo, halo_win, acc,
            epilogue_sw, blk_mask, check_windows, live_slots,
        )
    if x.dtype not in _cuda.DTYPE_CODES:
        raise ValueError(f"bsr_matmul_banded: unsupported dtype {x.dtype}")
    if x.dtype == torch.bfloat16 and x.shape[2] >= TILE and x.shape[2] % 2:
        raise ValueError(
            f"bsr_matmul_banded: the bf16 tensor-core kernel takes even "
            f"widths, got F={x.shape[2]}"
        )
    if check_windows:
        _check_windows(vals, blk_cols, win_base, ns_rows, h_tiles, halo_win,
                       blk_mask)
    nx, f = x.shape[1], x.shape[2]
    blk_cols = blk_cols.to(torch.int32).contiguous()
    x = x.contiguous()
    # without a separate halo the kernel reads the halo tiles from x's tail
    halo = halo.contiguous() if halo is not None else None
    tensors = [vals, blk_cols, x] + ([halo] if halo is not None else [])
    if live_slots is not None:
        live_slots = live_slots.contiguous()
        tensors.append(live_slots)
    if acc is not None:
        if acc.dtype != x.dtype:
            raise ValueError(f"bsr_matmul_banded: acc {acc.dtype} != x "
                             f"{x.dtype}")
        acc = acc.contiguous()
        tensors.append(acc)
    if epilogue_sw is not None:
        if epilogue_sw.dtype != x.dtype:
            raise ValueError(f"bsr_matmul_banded: epilogue_sw "
                             f"{epilogue_sw.dtype} != x {x.dtype}")
        epilogue_sw = epilogue_sw.contiguous()
        tensors.append(epilogue_sw)
    _cuda.require_cuda("bsr_matmul_banded", *tensors)
    rows = r * TILE
    split = acc is not None and na < rows
    out = torch.empty((b, na if split else rows, f), dtype=x.dtype,
                      device=x.device)
    tail = (torch.empty((b, rows - na, f), dtype=x.dtype, device=x.device)
            if split else None)
    _cuda.launch(
        "cgc_bsr_matmul_banded",
        vals.data_ptr(), blk_cols.data_ptr(), x.data_ptr(),
        halo.data_ptr() if halo is not None else None,
        acc.data_ptr() if acc is not None else None,
        epilogue_sw.data_ptr() if epilogue_sw is not None else None,
        out.data_ptr(), tail.data_ptr() if split else None,
        live_slots.data_ptr() if live_slots is not None else None,
        b, r, m, ns_rows // TILE, nx, halo.shape[1] if halo is not None else 0,
        f, na,
        _cuda.VALS_CODES[vals.dtype], _cuda.DTYPE_CODES[x.dtype],
        x.device.index, _cuda.stream_of(x),
    )
    bsr_matmul_banded.launches += 1
    _B8_VARIANTS[banded_variant(x.dtype, f)] += 1
    if halo_win is not None and halo_win.shape[-1]:
        # the TPU's halo-window variant (bsr_kernel.py:1097): the same
        # kernel, counted apart as well
        bsr_matmul_banded.halo_window_launches += 1
    return (out, tail) if split else out


bsr_matmul_banded.launches = 0
bsr_matmul_banded.halo_window_launches = 0
bsr_matmul_banded.variants = _B8_VARIANTS = Counter()


def banded_variant(dtype: torch.dtype, f: int) -> str:
    """The kernel B8 runs for x of ``dtype`` and ``f`` columns
    (``csrc/bsr_banded.cu``: the tensor cores for bf16 at F >= 128)."""
    return ("banded_tc_kernel" if dtype == torch.bfloat16 and f >= TILE
            else "banded_kernel")
