"""Build, load and call the package's hand-written CUDA kernels.

The sources under ``cgcnet_tpu_torch/csrc/`` expose a plain C interface. At
first use every source is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together), the objects are linked into one shared
library under ``build/cgcnet_tpu_torch/`` named by a hash of sources and
flags, and the library is loaded with ``ctypes``. Nothing here runs at
import time, and nothing falls back: a failed build or launch raises.

Each C entry point takes device pointers, sizes, a dtype code and the CUDA
stream, launches on that stream, allocates nothing, and returns
``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (
    Path(__file__).resolve().parent.parent.parent / "build" / "cgcnet_tpu_torch"
)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points -> argument types (every one returns a cudaError_t as int)
_SIGNATURES = {
    # nbr, w, blk_cols, blk_mask, vals, B, N, K, R, M, dtype, device, stream
    "cgc_bsr_build_blocks": [_P] * 5 + [_I] * 7 + [_P],
    # vals, blk_cols, live_slots, x, out, B, R, M, NC, F, vals_dtype, dtype,
    # device, stream
    "cgc_bsr_matmul": [_P] * 5 + [_I] * 8 + [_P],
    # vals, blk_cols, x, halo (null: x's tail), acc (null), epilogue_sw
    # (null), out, out_tail (null), live_slots (null: every slot), B, R, M,
    # ns_tiles, NX, NH, F, NA, vals_dtype, dtype, device, stream
    "cgc_bsr_matmul_banded": [_P] * 9 + [_I] * 11 + [_P],
    # nbr, w, blk_cols, blk_mask, x, out, B, N, K, R, M, NC, F, dtype,
    # device, stream
    "cgc_bsr_gather_sum": [_P] * 6 + [_I] * 9 + [_P],
    # p (B4; null for B9a), x3, kc3 (f32 B9a), kc3t (bf16 B9a), b3,
    # n_nodes, rnorm, B, N, F3, C, kc3t's rows and columns, dtype, device,
    # stream
    "cgc_assign_head_rnorm": [_P] * 7 + [_I] * 8 + [_P],
    # x12, p (B4) or h3a (B6), k12, k3f (f32; null in bf16), wpad (bf16:
    # the padded [k12 ; k3f]; null in f32), const, n_nodes, rnorm (B4's
    # scratch; null for B6), logits, s, B, N, F12, C, c_out, wpad's rows
    # and columns, dtype, device, stream
    "cgc_assign_head_pre": [_P] * 10 + [_I] * 9 + [_P],
    "cgc_assign_head": [_P] * 10 + [_I] * 9 + [_P],
    # x12, x3, kc3 (f32), b3, kc3t (bf16: kc3^T padded), k12, k3f (f32),
    # wpad (bf16), const, n_nodes, rnorm, logits, s, B, N, F12, F3, C,
    # wpad's rows and columns, kc3t's rows and columns, dtype, device,
    # stream
    "cgc_assign_head_pre_lin": [_P] * 13 + [_I] * 11 + [_P],
    # p, n_nodes, partial, out, B, N, C, tile_rows, dtype, device, stream
    "cgc_l2relu_stats": [_P] * 4 + [_I] * 6 + [_P],
    # x3, kc3 (f32), kc3t (bf16: kc3^T padded), b3, n_nodes, partial, out,
    # B, N, F3, C, kc3t's rows and columns, tile_rows, dtype, device, stream
    "cgc_l2relu_stats_lin": [_P] * 7 + [_I] * 9 + [_P],
    # test only: x3, kc3t, b3, p, rnorm, rows, F3, C, kc3t's rows and
    # columns, device, stream
    "cgc_lin_p_probe": [_P] * 5 + [_I] * 6 + [_P],
    # p, dh, u, w, n_nodes, dp, B, N, C, dtype, device, stream
    "cgc_assign_tail_bwd": [_P] * 6 + [_I] * 5 + [_P],
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# block values may also be int8 (the slide path's binary operator)
VALS_CODES = {**DTYPE_CODES, torch.int8: 2}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
        Path("/usr/local/cuda/bin/nvcc")
    ]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            f"{CSRC} at first use"
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernel library if it is not built yet; returns
    its path. The compiler's resource report (``-Xptxas -v``) is kept in
    ``build.log`` beside it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    lib_path = BUILD_DIR / f"libcgcnet_kernels_{digest}.so"
    if lib_path.is_file():
        return lib_path
    work = BUILD_DIR / f"tmp_{digest}_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for src in _sources():
        obj = work / (src.stem + ".o")
        cmd = [exe, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log, objs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(log[-1])
    (work / "build.log").write_text("\n".join(log))
    if failed:
        # the failing sources' own output, errors first (not the -v report
        # of the sources that built)
        msg = "\n".join(
            "\n".join([ln for ln in f.splitlines() if "error" in ln][:40]
                      + [f[:4000]]) for f in failed)
        raise RuntimeError(f"nvcc failed:\n{msg[:12000]}")
    tmp_lib = work / lib_path.name
    link = subprocess.run(
        [exe, "-shared", "-o", str(tmp_lib), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout[-8000:]}")
    shutil.copy(work / "build.log", BUILD_DIR / "build.log")
    os.replace(tmp_lib, lib_path)  # atomic: concurrent builders never see a partial file
    shutil.rmtree(work, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cgc_error_string.argtypes = [ctypes.c_int]
            lib.cgc_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def launch(name: str, *args) -> None:
    """Call C entry point ``name``; raise if it reports a CUDA error."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.cgc_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(
                f"{name}: every tensor must lie on one CUDA device "
                f"(got {[str(x.device) for x in tensors]})"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
