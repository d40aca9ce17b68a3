"""ctypes bindings for the native graph-construction library (native/cgraph.cpp).

The library is framework-neutral and shared with the JAX package: this is
the PyTorch package's own binding of the same ``native/libcgraph.so``.
Loads it if present (built by native/build.sh — attempted automatically
once per process), otherwise every entry point reports unavailable and
callers fall back to the NumPy implementations in cgcnet_tpu_torch.ops. The
native path matters for whole-slide graphs (100k+ nuclei): grid-hash radius
search is O(N·k) vs the O(N²) NumPy broadcast.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False
_SO = Path(__file__).resolve().parent.parent.parent / "native" / "libcgraph.so"
_LOAD_LOCK = threading.Lock()


def _load():
    # double-checked lock: GraphLoader worker threads may race on first use,
    # and the slow path can spawn a g++ build — run it exactly once
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOAD_LOCK:
        return _load_locked()


def _load_locked():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not _SO.exists():
        build = _SO.parent / "build.sh"
        if build.exists():
            try:
                subprocess.run(
                    ["sh", str(build)], capture_output=True, timeout=120, check=True
                )
            except (OSError, subprocess.SubprocessError):
                return None
    if not _SO.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    i64, i32p, f32p = (
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
    )
    lib.radius_knn.argtypes = [f32p, i64, ctypes.c_float, ctypes.c_int, i32p, f32p]
    lib.radius_knn.restype = ctypes.c_int
    lib.fps_coords.argtypes = [f32p, i64, i64, i64, i32p]
    lib.fps_coords.restype = ctypes.c_int
    lib.transpose_ell.argtypes = [i32p, f32p, i64, ctypes.c_int, ctypes.c_int, i32p, f32p]
    lib.transpose_ell.restype = i64
    lib.bsr_block_meta.argtypes = [
        i32p, f32p, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, f32p,
    ]
    lib.bsr_block_meta.restype = i64
    lib.sample_and_sort.argtypes = [
        f32p, i64, i64, i64, i64, ctypes.c_uint64, ctypes.c_float, i32p,
    ]
    lib.sample_and_sort.restype = i64
    lib.build_patch.argtypes = [
        f32p, f32p, i64, ctypes.c_int,            # feats, coords, n, fdim
        i32p, i64,                                 # choice_in, choice_len
        i64, i64, i64, ctypes.c_uint64,            # num_sub, far, start, seed
        ctypes.c_float, ctypes.c_float,            # band, radius
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # k, kt_cap, feat_mode
        f32p, f32p, i64,                           # mean, std, cap
        f32p, i32p, f32p, i32p, f32p,              # outputs
    ]
    lib.build_patch.restype = i64
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def radius_knn(pos: np.ndarray, radius: float, k: int):
    """Native grid-hash nearest-k-within-radius; same contract as
    ops.knn.radius_knn_np (nearest mode, self at slot 0)."""
    lib = _load()
    assert lib is not None
    pos = np.ascontiguousarray(pos, np.float32)
    n = pos.shape[0]
    nbr = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k)).copy()
    mask = np.zeros((n, k), np.float32)
    lib.radius_knn(_f32p(pos), n, radius, k, _i32p(nbr), _f32p(mask))
    return nbr, mask


def fps_coords(pos: np.ndarray, num_samples: int, rng: np.random.Generator):
    lib = _load()
    assert lib is not None
    pos = np.ascontiguousarray(pos, np.float32)
    n = pos.shape[0]
    num_samples = min(num_samples, n)
    out = np.zeros(num_samples, np.int32)
    lib.fps_coords(_f32p(pos), n, int(rng.integers(n)), num_samples, _i32p(out))
    return out


def transpose_ell(nbr: np.ndarray, mask: np.ndarray, width_t: int):
    lib = _load()
    assert lib is not None
    nbr = np.ascontiguousarray(nbr, np.int32)
    mask = np.ascontiguousarray(mask, np.float32)
    n, k = nbr.shape
    nbr_t = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, width_t)).copy()
    mask_t = np.zeros((n, width_t), np.float32)
    maxdeg = lib.transpose_ell(
        _i32p(nbr), _f32p(mask), n, k, width_t, _i32p(nbr_t), _f32p(mask_t)
    )
    if maxdeg < 0:
        raise ValueError(f"max in-degree exceeds transpose ELL width {width_t}")
    return nbr_t, mask_t, int(maxdeg)


def sample_and_sort(
    pos: np.ndarray,
    num_sub: int,
    far_num: int,
    band: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Fused fuse/farthest/random subsample + spatial band sort (GIL-free).
    Draws the FPS start and the remainder-shuffle seed from ``rng`` so the
    choice stays a pure function of (seed, patch, epoch)."""
    lib = _load()
    assert lib is not None
    pos = np.ascontiguousarray(pos, np.float32)
    n = pos.shape[0]
    num_sub = min(num_sub, n)
    out = np.zeros(num_sub, np.int32)
    total = lib.sample_and_sort(
        _f32p(pos), n, num_sub, min(far_num, num_sub),
        int(rng.integers(n)) if num_sub else 0,
        int(rng.integers(np.iinfo(np.uint64).max, dtype=np.uint64)),
        band, _i32p(out),
    )
    return out[: int(total)]


def bsr_block_meta(
    nbr: np.ndarray, mask: np.ndarray, max_blocks: int, tile: int = 128,
    strict: bool = True,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Native twin of ops.bsr.bsr_block_meta (sorted unique
    column tiles per row tile). Raises on overflow like the python builder
    unless ``strict=False`` (the caller then checks the returned need — lets
    attach_bsr_meta build meta and measure need in ONE scan)."""
    lib = _load()
    assert lib is not None
    n, k = nbr.shape
    assert n % tile == 0, f"N={n} not a multiple of {tile}"
    nbr = np.ascontiguousarray(nbr, np.int32)
    mask = np.ascontiguousarray(mask, np.float32)
    r = n // tile
    cols = np.zeros((r, max_blocks), np.int32)
    cmask = np.zeros((r, max_blocks), np.float32)
    need = int(
        lib.bsr_block_meta(
            _i32p(nbr), _f32p(mask), n, k, tile, max_blocks,
            _i32p(cols), _f32p(cmask),
        )
    )
    if strict and need > max_blocks:
        raise ValueError(
            f"row tile touches {need} column tiles > cap {max_blocks}; "
            "spatially sort nodes or raise bsr max_blocks"
        )
    return cols, cmask, need


_FEAT_MODE = {"ca": 0, "a": 1, "c": 2}


def build_patch(
    feats: np.ndarray,
    coords: np.ndarray,
    *,
    choice: np.ndarray | None,
    num_sub: int,
    far_num: int,
    rng: np.random.Generator,
    band: float,
    radius: float,
    k: int,
    kt_cap: int,
    feat_mode: str,
    mean: np.ndarray,
    std: np.ndarray,
    out_x: np.ndarray,
    out_nbr: np.ndarray,
    out_mask: np.ndarray,
    out_nbr_t: np.ndarray,
    out_mask_t: np.ndarray,
) -> int:
    """Whole per-item pipeline in one GIL-free call — writes padded arrays
    (typically views into the batch buffers). Returns the real node count,
    or -1 on transpose-width overflow (caller falls back to numpy)."""
    lib = _load()
    assert lib is not None
    feats = np.ascontiguousarray(feats, np.float32)
    coords = np.ascontiguousarray(coords, np.float32)
    n = coords.shape[0]
    if choice is not None:
        choice = np.ascontiguousarray(choice, np.int32)
        cp, clen = _i32p(choice), len(choice)
    else:
        cp = ctypes.cast(0, ctypes.POINTER(ctypes.c_int32))
        clen = 0
    sampling = choice is None and num_sub < n
    return int(
        lib.build_patch(
            _f32p(feats), _f32p(coords), n, feats.shape[1],
            cp, clen,
            num_sub, far_num,
            int(rng.integers(n)) if sampling else 0,
            int(rng.integers(np.iinfo(np.uint64).max, dtype=np.uint64))
            if sampling else 0,
            band, radius, k, out_nbr_t.shape[1], _FEAT_MODE[feat_mode],
            _f32p(np.ascontiguousarray(mean, np.float32)),
            _f32p(np.ascontiguousarray(std, np.float32)),
            out_x.shape[0],
            _f32p(out_x), _i32p(out_nbr), _f32p(out_mask),
            _i32p(out_nbr_t), _f32p(out_mask_t),
        )
    )
