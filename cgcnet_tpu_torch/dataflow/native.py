"""ctypes bindings for the native graph-construction library (native/cgraph.cpp).

The library is framework-neutral and shared with the JAX package: this is
the PyTorch package's own binding of the same ``native/libcgraph.so``.
Loads it, building it first by native/build.sh if it is missing (attempted
once per process); where that fails, it warns once with the reason and
every entry point reports unavailable, so callers fall back to the NumPy
implementations in cgcnet_tpu_torch.ops. The native path matters for
whole-slide graphs (100k+ nuclei): grid-hash radius search is O(N·k) vs
the O(N²) NumPy broadcast.

Ranks and test workers start together, so the build is shared between
processes: under a lock file in ``build/`` the first process builds the
library in a private directory there and moves it onto its path with
``os.replace``. No process, of either package, ever sees a half-written
``libcgraph.so``.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False
_SO = Path(__file__).resolve().parent.parent.parent / "native" / "libcgraph.so"
_LOAD_LOCK = threading.Lock()
BUILD_TIMEOUT = 120  # seconds for one run of build.sh


def _build(so: Path, work: Path) -> None:
    """Compile ``so`` from the build.sh and cgraph.cpp beside it in a
    private directory under ``work`` and move the result onto ``so``."""
    tmp = Path(tempfile.mkdtemp(prefix="native-", dir=work))
    try:
        for name in ("build.sh", "cgraph.cpp"):
            shutil.copy2(so.parent / name, tmp / name)
        proc = subprocess.run(
            ["sh", str(tmp / "build.sh")], capture_output=True, text=True,
            timeout=BUILD_TIMEOUT,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"build.sh exited with {proc.returncode}: "
                f"{proc.stderr.strip() or proc.stdout.strip()}"
            )
        os.replace(tmp / "libcgraph.so", so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build_and_load(so: Path) -> ctypes.CDLL:
    """Load the library at ``so`` (``<root>/native/libcgraph.so``), building
    it first if it is missing. The check and the build run under an
    exclusive lock on ``<root>/build/native.lock``, so concurrent processes
    build it once and load the same file. Raises on a failed build or
    load."""
    so = Path(so)
    work = so.parent.parent / "build"
    work.mkdir(parents=True, exist_ok=True)
    with open(work / "native.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            _build(so, work)
        lib = ctypes.CDLL(str(so))
    _declare(lib)
    return lib


def _load():
    # double-checked lock: GraphLoader worker threads may race on first use,
    # and the slow path can run a g++ build — try it exactly once
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
    try:
        _LIB = build_and_load(_SO)
    except (OSError, AttributeError, RuntimeError,
            subprocess.SubprocessError) as e:
        warnings.warn(
            f"native graph library {_SO} unavailable, the NumPy paths serve: "
            f"{e}", RuntimeWarning, stacklevel=4,
        )
    return _LIB


def _declare(lib: ctypes.CDLL) -> None:
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
    lib.local_entropy_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), i64, i64, ctypes.c_int, f32p,
    ]
    lib.local_entropy_u8.restype = ctypes.c_int


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


def local_entropy_u8(gray: np.ndarray, radius: int = 3) -> np.ndarray:
    """Sliding-histogram disk entropy (bits, reflect border), f32 [h, w]."""
    lib = _load()
    assert lib is not None
    gray = np.ascontiguousarray(gray, np.uint8)
    h, w = gray.shape
    out = np.zeros((h, w), np.float32)
    lib.local_entropy_u8(
        gray.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, radius,
        _f32p(out),
    )
    return out
