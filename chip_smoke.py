#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cgcnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each fatal on failure (exit code != 0):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build of the hand-written kernels from ``cgcnet_tpu_torch/csrc`` (nvcc);
3. kernels: B1 (block build, for A and for the binary transpose blocks),
   B2 (block-sparse matmul, at every width one training step gives it, on
   the forward and on the transpose blocks), B3 (BN statistics of the assign
   tail), B4 (fused assign head) and B5 (assign-tail backward) on the inputs
   that one canonical SAGE training step gives them, B6 (fused assign
   softmax) on those of one canonical GIN step, and B7 (block-sparse
   gather-sum, blocks built on the fly) at the B2 widths on the canonical
   batch's ELL and its transpose tables (captured), in f32 and bf16, each
   held against its plain PyTorch version on the same CUDA tensors (B7 also
   against B1 -> B2), with CUDA-event timings of kernel, plain version and
   (B2, B7) one PyTorch library call;
4. serving slice: a synthetic dataset whose sampled graphs fill the
   canonical capacity (B=4, N=5760, C=1140), a seeded canonical CGCNet saved
   in the port's checkpoint format, ``cli.predict.main`` on the card with
   ``--reps 2`` while the launch counters are read (B1 = 1, B2 = 4, B4 = 1
   per batch), one batch recomputed on the CPU through the plain versions,
   and the per-batch forward latency;
5. training slice: two epochs of optimizer steps through ``train.loop`` on
   the same data (B1 = 2, B2 = 7, B3 = 1, B4 = 1, B5 = 1 launches per step,
   finite loss, parameters and running statistics changed), the median
   train-step time, one ``cli.train.main`` epoch with mid-epoch and
   end-of-epoch validation and checkpoints, and one step's loss and
   gradients on the card against the CPU plain path;
6. GIN slice: phases 4 and 5 with ``model.gcn_name=GIN`` (B1/B2/B6 = 1/4/1
   per serving batch and 2/7/1 per step, no B3/B4/B5), its step's gradients
   also held against the plain versions on the card (see ``GRAD_REL``);
7. the rest of the slice: ``EllAdjFactored`` without block values (one B7
   launch forward, one backward, against the gather branch); SAGE with
   ``fused_assign_norm=never`` (B6) against the default (B4) on the same
   weights and batch; one forward and one train step each of GAT and
   SAGE+elu (B6 once each); the batch with its block metadata stripped,
   forward and backward with no kernel launched.

The second-to-last lines are one JSON object of per-kernel numbers and the
nvidia-smi line; the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

PEAK_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_OPS_PER_S = {"float32": 67e12,   # f32 outside the tensor cores
                  "bfloat16": 989e12}  # dense bf16 tensor cores
# stated tolerances on max|kernel - plain| over the same CUDA tensors, as a
# fraction of max|plain|: B1 sums the same f32 weights in the same slot
# order (exact); the others sum in another order — f32: B2 and B7 1e-4 (the
# JAX suite's), B3 1e-5 (column sums of 23040 rows), B4 and B6 1e-5
# (1180-term f32 dots, then exp), B5 1e-4 (1140-term row dot feeding a
# difference); bf16: the two roundings of a stored value may land one bf16
# step apart, and a step is up to 2^-7 of the value, so 2^-6
TOL = {
    ("B1", "float32"): 0.0, ("B1", "bfloat16"): 0.0,
    ("B2", "float32"): 1e-4, ("B2", "bfloat16"): 2.0 ** -6,
    ("B3", "float32"): 1e-5, ("B3", "bfloat16"): 2.0 ** -6,
    ("B4", "float32"): 1e-5, ("B4", "bfloat16"): 2.0 ** -6,
    ("B5", "float32"): 1e-4, ("B5", "bfloat16"): 2.0 ** -6,
    ("B6", "float32"): 1e-5, ("B6", "bfloat16"): 2.0 ** -6,
    ("B7", "float32"): 1e-4, ("B7", "bfloat16"): 2.0 ** -6,
}
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-3   # whole model, card vs CPU, f32
# one train step, card vs CPU plain path (f32, same weights and batch): the
# loss as the logits; each gradient tensor within 1e-3 of its own max|grad|
# (sums over 23040 rows and 1140 clusters in another order, through BN
# batch statistics and a softmax, then ~20 chained backward products), plus
# 1e-5 of the largest gradient entry of the model (a gradient that is zero
# in theory, as the JK attention bias's — one bias on every layer's score —
# is rounding noise on both sides)
GRAD_REL, GRAD_FLOOR = 1e-3, 1e-5
# GIN's step amplifies f32 rounding past that rule (a near one-hot assign
# softmax, max S 0.9987 on the canonical batch, feeding stages 2-3, whose
# BN runs over 4 x 114 rows): the same plain PyTorch step on the card and on
# the CPU parts by about twice it. So GIN holds its kernels against their
# plain versions on the same card at the rule, and the card against the CPU
# at the rule widened by that plain-vs-plain distance; the CPU's change
# under x moved by one rounding step (NUDGE_SEEDS) is logged beside it
NUDGE_SEEDS = (3, 4, 5)
# synthetic patches of 9000..11404 nuclei, sampled at ratio 0.5, fill the
# canonical capacity: batches of B=4 graphs padded to N=5760, C=1140 clusters
DATA_NODES = (9000, 11404)
CANONICAL = {"B": 4, "N": 5760, "C": 1140}
TRAIN_EPOCHS = 2        # of 6 batches each (24 training patches, drop_last)
KERNELS = ("B1", "B2", "B3", "B4", "B5", "B6", "B7")
# launches per train step and per serving batch, SAGE (canonical) and GIN;
# a kernel not named launches 0 times
TRAIN_PER_STEP = {"B1": 2, "B2": 7, "B3": 1, "B4": 1, "B5": 1}
SERVE_PER_BATCH = {"B1": 1, "B2": 4, "B4": 1}
GIN_TRAIN_PER_STEP = {"B1": 2, "B2": 7, "B6": 1}
GIN_SERVE_PER_BATCH = {"B1": 1, "B2": 4, "B6": 1}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 15, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after warmup)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wrappers() -> dict:
    """Kernel id -> wrapper (each has a ``launches`` count)."""
    from cgcnet_tpu_torch.ops import assign_head as ah
    from cgcnet_tpu_torch.ops import bsr

    return {"B1": bsr.bsr_build_blocks, "B2": bsr.bsr_matmul,
            "B3": ah.l2relu_stats, "B4": ah.assign_head_softmax_pre,
            "B5": ah.assign_tail_bwd, "B6": ah.assign_head_softmax,
            "B7": bsr.bsr_gather_sum}


def zero_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in wrappers().items()}


def expected(per: dict, times: int = 1) -> dict:
    """Launch counts of every kernel for ``times`` units of ``per``."""
    return {k: per.get(k, 0) * times for k in KERNELS}


def grads_of(model, graph) -> tuple[float, dict]:
    """(loss, {name: grad}) of one training-mode forward + backward."""
    from cgcnet_tpu_torch.nn.model import cross_entropy_loss

    model.train()
    model.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(model(graph), graph.y)
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}


@contextlib.contextmanager
def sites_replaced(replacement):
    """For the duration, each site where the model calls a kernel wrapper
    calls ``replacement(kernel id, wrapper, plain version)`` instead."""
    from cgcnet_tpu_torch.nn import model as model_mod
    from cgcnet_tpu_torch.ops import assign_head as ah
    from cgcnet_tpu_torch.ops import bsr, ell

    sites = [
        (model_mod, "bsr_build_blocks", "B1", bsr.bsr_build_blocks_plain),
        (ell, "bsr_matmul", "B2", bsr.bsr_matmul_plain),
        (ah, "l2relu_stats", "B3", ah.l2relu_stats_plain),
        (ah, "assign_head_softmax_pre", "B4", ah.assign_head_softmax_pre_plain),
        (ah, "assign_tail_bwd", "B5", ah.assign_tail_bwd_plain),
        (ah, "assign_head_softmax", "B6", ah.assign_head_softmax_plain),
        (ell, "bsr_gather_sum", "B7", bsr.bsr_gather_sum_plain),
    ]
    originals = [getattr(mod, name) for mod, name, _, _ in sites]
    for (mod, name, key, plain), orig in zip(sites, originals):
        setattr(mod, name, replacement(key, orig, plain))
    try:
        yield
    finally:
        for (mod, name, _, _), orig in zip(sites, originals):
            setattr(mod, name, orig)


def capture_inputs(model, graph) -> dict:
    """Run one training step's forward and backward with shims in front of
    the kernel wrappers and keep (clones of) the arguments each one is
    given, in call order."""
    import torch

    seen: dict[str, list] = {key: [] for key in KERNELS}

    def shim_for(key, wrapper, plain):
        def shim(*args):
            seen[key].append(
                [a.detach().clone() if isinstance(a, torch.Tensor) else a
                 for a in args]
            )
            return wrapper(*args)
        # a wrapper counts its launches through its module's global name,
        # which is the shim for the duration of the capture
        shim.launches = 0
        return shim

    with sites_replaced(shim_for):
        grads_of(model, graph)
    model.zero_grad(set_to_none=True)
    return seen


def kernel_phase(seen: dict, gin_seen: dict, graph) -> list[dict]:
    import torch
    from cgcnet_tpu_torch.ops import assign_head as ah
    from cgcnet_tpu_torch.ops import bsr

    t = bsr.TILE
    results = []
    rows_real = int(seen["B4"][0][5].sum().item())

    def record(name, key, dt, out, ref, kernel_fn, plain_fn, bytes_, ops,
               library=None, source="", replaces="", ops_dt=None):
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = TOL[(key, dt)] * scale
        ok = err <= tol
        ms = time_ms(kernel_fn)
        plain_ms = time_ms(plain_fn)
        lib_ms = None
        if library is not None:
            # the yardstick only: a library without this call is recorded
            # as null, it does not fail the run
            try:
                lib_ms = time_ms(library())
            except (RuntimeError, NotImplementedError) as e:
                log(f"  library call unavailable for {name}: {e}")
        t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S[ops_dt or dt] * 1e3
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "key": key,
        }
        log(f"  {name}: max_abs_err {err:.3e} (max|ref| {scale:.3e}, tol "
            f"{tol:.3e}) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library {lib_ms} ms, bound "
            f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})")
        if not ok:
            raise SystemExit(f"kernel {name} disagrees with its plain version")
        results.append(entry)

    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        isz = torch.empty((), dtype=dt).element_size()
        tag = "f32" if dt == torch.float32 else "bf16"
        # ---- B1, for A (weighted) and for B_off^T (binary) ----
        blocks = []
        for which, (nbr, w, blk_cols, blk_mask, _) in zip(("A", "A^T"), seen["B1"]):
            b, n, k = nbr.shape
            r, m = blk_cols.shape[1:]
            args = (nbr, w, blk_cols, blk_mask, dt)
            out = bsr.bsr_build_blocks(*args)
            ref = bsr.bsr_build_blocks_plain(*args)
            record(
                f"B1 bsr_build_blocks {which} {tag} B={b} N={n} K={k} M={m}",
                "B1", dt_name, out, ref,
                lambda args=args: bsr.bsr_build_blocks(*args),
                lambda args=args: bsr.bsr_build_blocks_plain(*args),
                bytes_=b * n * k * 8 + b * r * m * 8 + b * r * m * t * t * isz,
                # the function scatters K weights per row: one add each
                ops=b * n * k, ops_dt="float32",
                source="cgcnet_tpu_torch/csrc/bsr_build.cu",
                replaces="cgcnet_tpu/ops/pallas/bsr_kernel.py:275",
            )
            blocks.append((which, out, blk_cols, blk_mask))
        # ---- B2, at every width a training step gives it, on the forward
        # blocks (the first 4 calls) and the transpose blocks (the rest) ----
        done = set()
        for i, (_, _, x_) in enumerate(seen["B2"]):
            which, vals, blk_cols, blk_mask = blocks[
                0 if i < SERVE_PER_BATCH["B2"] else 1]
            if (which, x_.shape[-1]) in done:
                continue
            done.add((which, x_.shape[-1]))
            b, r, m = blk_cols.shape
            nnzb = int(blk_mask.sum().item())
            x = x_.to(dt)
            nc, f = x.shape[1], x.shape[2]
            out = bsr.bsr_matmul(vals, blk_cols, x)
            ref = bsr.bsr_matmul_plain(vals, blk_cols, x)
            record(
                f"B2 bsr_matmul {which} {tag} B={b} N={nc} M={m} F={f}", "B2",
                dt_name, out, ref,
                lambda x=x, v=vals, c=blk_cols: bsr.bsr_matmul(v, c, x),
                lambda x=x, v=vals, c=blk_cols: bsr.bsr_matmul_plain(v, c, x),
                bytes_=nnzb * t * t * isz + b * r * m * 4
                + b * nc * f * isz + b * r * t * f * isz,
                ops=2 * nnzb * t * t * f,
                library=lambda x=x, v=vals, c=blk_cols, bm=blk_mask:
                    _bsr_library_call(v, c, bm, x),
                source="cgcnet_tpu_torch/csrc/bsr_matmul.cu",
                replaces="cgcnet_tpu/ops/pallas/bsr_kernel.py:400",
            )
        # ---- B3 ----
        p, n_nodes = seen["B3"][0]
        p = p.to(dt)
        b, n, c = p.shape
        out = torch.stack(ah.l2relu_stats(p, n_nodes))
        ref = torch.stack(ah.l2relu_stats_plain(p, n_nodes))
        record(
            f"B3 l2relu_stats {tag} B={b} N={n} C={c}", "B3", dt_name, out, ref,
            lambda p=p: ah.l2relu_stats(p, n_nodes),
            lambda p=p: ah.l2relu_stats_plain(p, n_nodes),
            # rows past n_nodes are skipped: only real rows are read
            bytes_=rows_real * c * isz + b * 4 + 2 * c * 4,
            ops=6 * rows_real * c, ops_dt="float32",
            source="cgcnet_tpu_torch/csrc/assign_tail.cu",
            replaces="cgcnet_tpu/ops/pallas/assign_head.py:180",
        )
        # ---- B4 ----
        x12, p, k12, k3f, const, n_nodes = seen["B4"][0]
        hargs = (x12.to(dt), p.to(dt), k12, k3f, const, n_nodes)
        c, f12 = p.shape[-1], x12.shape[-1]
        out, out_t = ah.assign_head_softmax_pre(*hargs)
        if not (out_t.data_ptr() == out.data_ptr() and out_t.shape == (b, c, n)):
            raise SystemExit("B4: S^T is not a transposed view of S")
        ref, _ = ah.assign_head_softmax_pre_plain(*hargs)
        record(
            f"B4 assign_head_softmax_pre {tag} B={b} N={n} F12={f12} C={c}",
            "B4", dt_name, out, ref,
            lambda: ah.assign_head_softmax_pre(*hargs),
            lambda: ah.assign_head_softmax_pre_plain(*hargs),
            bytes_=rows_real * (f12 + c) * isz + (f12 + c) * c * isz + c * 4
            + b * n * c * isz,
            ops=2 * rows_real * (f12 + c) * c,
            source="cgcnet_tpu_torch/csrc/assign_head.cu",
            replaces="cgcnet_tpu/ops/pallas/assign_head.py:286",
        )
        # ---- B5 ----
        p, dh, u, w, n_nodes = seen["B5"][0]
        bargs = (p.to(dt), dh.to(dt), u, w, n_nodes)
        out = ah.assign_tail_bwd(*bargs)
        ref = ah.assign_tail_bwd_plain(*bargs)
        pad = torch.arange(n, device=p.device)[None, :] >= n_nodes.long()[:, None]
        if out[pad].any():
            raise SystemExit("B5: rows past n_nodes are not exactly 0")
        record(
            f"B5 assign_tail_bwd {tag} B={b} N={n} C={c}", "B5", dt_name,
            out, ref,
            lambda: ah.assign_tail_bwd(*bargs),
            lambda: ah.assign_tail_bwd_plain(*bargs),
            # dp is 0 on rows past n_nodes whatever p and dh hold: p and dh
            # are needed on real rows only, dp is written on every row
            bytes_=(2 * rows_real + b * n) * c * isz + 2 * c * 4 + b * 4,
            ops=10 * rows_real * c, ops_dt="float32",
            source="cgcnet_tpu_torch/csrc/assign_tail.cu",
            replaces="cgcnet_tpu/ops/pallas/assign_head.py:423",
        )
        # ---- B6, on the inputs of one GIN training step ----
        x12, h3a, k12, k3f, const, n_nodes = gin_seen["B6"][0]
        hargs = (x12.to(dt), h3a.to(dt), k12, k3f, const, n_nodes)
        c, f12 = h3a.shape[-1], x12.shape[-1]
        out = ah.assign_head_softmax(*hargs)
        pad = torch.arange(n, device=h3a.device)[None, :] >= n_nodes.long()[:, None]
        if out[pad].any():
            raise SystemExit("B6: rows past n_nodes are not exactly 0")
        record(
            f"B6 assign_head_softmax {tag} B={b} N={n} F12={f12} C={c}", "B6",
            dt_name, out, ah.assign_head_softmax_plain(*hargs),
            lambda: ah.assign_head_softmax(*hargs),
            lambda: ah.assign_head_softmax_plain(*hargs),
            bytes_=rows_real * (f12 + c) * isz + (f12 + c) * c * isz + c * 4
            + b * n * c * isz,
            ops=2 * rows_real * (f12 + c) * c,
            source="cgcnet_tpu_torch/csrc/assign_head.cu",
            replaces="cgcnet_tpu/ops/pallas/assign_head.py:85",
        )
        # ---- B7, on the batch's binary off-diagonal ELL (the operator of
        # bsr_spmm_factored) and its transpose tables, at the B2 widths ----
        row = torch.arange(n, device=graph.nbr.device)[None, :, None]
        ells = {
            "A": (graph.nbr, graph.nbr_mask * (graph.nbr != row),
                  graph.blk_cols, graph.blk_mask),
            "A^T": (graph.nbr_t, graph.nbr_t_mask * (graph.nbr_t != row),
                    graph.blk_cols_t, graph.blk_mask_t),
        }
        done = set()
        for i, (_, _, x_) in enumerate(seen["B2"]):
            which = "A" if i < SERVE_PER_BATCH["B2"] else "A^T"
            if (which, x_.shape[-1]) in done:
                continue
            done.add((which, x_.shape[-1]))
            nbr, w, blk_cols, blk_mask = ells[which]
            b, _, k = nbr.shape
            r, m = blk_cols.shape[1:]
            nnz = int((w != 0).sum().item())
            x = x_.to(dt)
            f = x.shape[2]
            args = (nbr, w, blk_cols, blk_mask, x)
            out = bsr.bsr_gather_sum(*args)
            # the same operator through B1 -> B2: the same f32 block sums,
            # rounded alike, multiplied in another kernel
            via = bsr.bsr_matmul(
                bsr.bsr_build_blocks(nbr, w, blk_cols, blk_mask, dt), blk_cols, x)
            err12 = (out.float() - via.float()).abs().max().item()
            tol12 = TOL[("B7", dt_name)] * via.float().abs().max().item()
            log(f"  B7 {which} {tag} F={f} vs B1 -> B2: max_abs_err "
                f"{err12:.3e} (tol {tol12:.3e})")
            if not err12 <= tol12:
                raise SystemExit(f"B7 {which} F={f} disagrees with B1 -> B2")
            record(
                f"B7 bsr_gather_sum {which} {tag} B={b} N={n} K={k} M={m} F={f}",
                "B7", dt_name, out, bsr.bsr_gather_sum_plain(*args),
                lambda args=args: bsr.bsr_gather_sum(*args),
                lambda args=args: bsr.bsr_gather_sum_plain(*args),
                # the ELL (nbr, w), the block slots, x read once, out
                # written once; no block values move through memory
                bytes_=b * n * k * 8 + b * r * m * 8 + 2 * b * n * f * isz,
                # the function is out = sum_k w * x[nbr]: one multiply-add
                # per real off-diagonal entry and column (the kernel's dense
                # block products are its algorithm, not the function's)
                ops=2 * nnz * f, ops_dt="float32",
                library=lambda args=args: _csr_library_call(*args),
                source="cgcnet_tpu_torch/csrc/bsr_gather.cu",
                replaces="cgcnet_tpu/ops/pallas/bsr_kernel.py:201 "
                         "(and :1204 bsr_gather_sum)",
            )
    return results


def _csr_library_call(nbr, w, blk_cols, blk_mask, x):
    """One PyTorch call computing B7's function: a block-diagonal
    ``torch.sparse_csr_tensor`` over the batch, built once from the same ELL
    (not timed), times x. A yardstick; the port never calls it."""
    import torch

    b, n, k = nbr.shape
    f = x.shape[-1]
    rows = torch.arange(b * n, device=x.device).repeat_interleave(k)
    cols = (nbr.long() + torch.arange(b, device=x.device).reshape(b, 1, 1) * n)
    vals = w.reshape(-1)
    keep = vals != 0
    rows, cols, vals = rows[keep], cols.reshape(-1)[keep], vals[keep]
    order = torch.argsort(rows * (b * n) + cols)
    crow = torch.zeros(b * n + 1, dtype=torch.int64, device=x.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=b * n), 0)
    a = torch.sparse_csr_tensor(crow, cols[order], vals[order].to(x.dtype),
                                size=(b * n, b * n))
    xs = x.reshape(b * n, f)
    return lambda: a @ xs


def _bsr_library_call(vals, blk_cols, blk_mask, x):
    """One PyTorch call computing B2's function on the same blocks: a
    block-diagonal ``torch.sparse_bsr_tensor`` (real block slots only) times
    x stacked over the batch. A yardstick; the port never calls it."""
    import torch

    b, r, m = blk_cols.shape
    nc, f = x.shape[1], x.shape[2]
    t = vals.shape[-1]
    keep = blk_mask.reshape(-1) > 0
    cols = (blk_cols + torch.arange(b, device=x.device).reshape(b, 1, 1)
            * (nc // t)).reshape(-1)[keep].to(torch.int64)
    counts = (blk_mask.reshape(b * r, m) > 0).sum(-1)
    crow = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(torch.int64)
    a = torch.sparse_bsr_tensor(
        crow, cols, vals.reshape(b * r * m, t, t)[keep],
        size=(b * r * t, b * nc),
    )
    xs = x.reshape(b * nc, f)
    return lambda: a @ xs


def make_data(tmp: Path):
    """The synthetic canonical dataset, its overrides and config."""
    from cgcnet_tpu_torch.cli import predict
    from cgcnet_tpu_torch.dataflow.synthetic import generate_dataset

    root = tmp / "data"
    generate_dataset(str(root), patches_per_image=2, images_per_grade=2,
                     n_nodes=DATA_NODES, seed=0)
    overrides = [f"data.root={root}", "data.num_workers=4",
                 f"data.max_num_nodes={DATA_NODES[1]}"]
    return overrides, predict.serving_config(overrides)


def serve_phase(tmp: Path, device, overrides, cfg, graph, n_patches: int,
                per_batch: dict) -> tuple[dict, float, float]:
    """cli.predict on the card with the launch counters read (``per_batch``
    launches per batch), one batch on the card against the CPU, and the
    forward latency."""
    import numpy as np
    import torch
    from cgcnet_tpu_torch.cli import predict
    from cgcnet_tpu_torch.nn.model import CGCNet
    from cgcnet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    ckpt = save_checkpoint(
        tmp / f"model_{cfg.model.gcn_name}.pt",
        CGCNet(cfg.model, torch.Generator().manual_seed(1234)).state_dict(),
        cfg, {"origin": "chip_smoke random init, seed 1234"},
    )
    state_dict = load_checkpoint(ckpt)[0]
    model = predict.build_model(cfg, state_dict, device)
    out_path = tmp / "pred.jsonl"
    zero_counts()
    t0 = time.time()
    cpu_flag = ["--cpu"] if device.type == "cpu" else []
    result = predict.main([*cpu_flag, "--ckpt", str(ckpt), "--reps", "2",
                           "--out", str(out_path), *overrides])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    n_batches = 2 * -(-n_patches // cfg.data.batch_size)
    log(f"  predict ({cfg.model.gcn_name}): {wall:.2f} s wall, {n_batches} "
        f"batches, result {result}, launches {counts}")
    if counts != expected(per_batch, n_batches):
        raise SystemExit(f"launch counts {counts} != {per_batch} x {n_batches} "
                         "batches")
    if not {"img_acc", "binary_acc", "patch_acc"} <= set(result):
        raise SystemExit(f"summary keys missing: {result}")
    recs = [json.loads(line) for line in out_path.read_text().splitlines()]
    patches = [r for r in recs if "patch" in r]
    if len(patches) != n_patches or not all(
        len(r["logits"]) == 3 and np.isfinite(r["logits"]).all() for r in patches
    ):
        raise SystemExit("predictions are missing or not finite")

    # one batch on the card and on the CPU (plain versions), same weights
    with torch.inference_mode():
        gpu_logits = model(graph).cpu().numpy()
        cpu_model = predict.build_model(cfg, state_dict, torch.device("cpu"))
        t0 = time.time()
        cpu_logits = cpu_model(graph.to("cpu")).numpy()
        cpu_s = time.time() - t0
        err = float(np.abs(gpu_logits - cpu_logits).max())
        log(f"  card vs CPU logits: max abs diff {err:.3e} (atol {LOGIT_ATOL}, "
            f"rtol {LOGIT_RTOL}); CPU forward {cpu_s:.1f} s")
        if not np.isfinite(gpu_logits).all() or not np.allclose(
            gpu_logits, cpu_logits, atol=LOGIT_ATOL, rtol=LOGIT_RTOL
        ):
            raise SystemExit(f"card logits {gpu_logits} != CPU {cpu_logits}")
        fwd_ms = time_ms(lambda: model(graph), reps=10, warmup=2)
    log(f"  forward latency per batch ({cfg.model.gcn_name}, x "
        f"{tuple(graph.x.shape)}, {cfg.model.compute_dtype}): {fwd_ms:.3f} ms "
        "(median of 10, CUDA events)")
    return counts, fwd_ms, wall


def nudged(graph, seed: int):
    """``graph`` with x moved by one f32 rounding step (relative 2^-23) with
    random signs from ``seed``."""
    import dataclasses

    import torch

    sign = torch.randint(0, 2, graph.x.shape,
                         generator=torch.Generator().manual_seed(seed))
    return dataclasses.replace(graph, x=graph.x * (
        1.0 + (2.0 * sign.to(graph.x) - 1.0) * 2.0 ** -23))


def grad_hold(cfg, device, graph, witnessed: bool) -> None:
    """One train step's loss and gradients on the card against the CPU plain
    path (same weights and batch, dropout off: CPU and CUDA generators
    differ). ``witnessed`` (GIN): the kernels against their plain versions
    on the same card at the rule, and the card against the CPU at the rule
    widened by the distance between the plain step on the card and on the
    CPU."""
    import numpy as np
    from cgcnet_tpu_torch.train.state import create_train_state

    cfg0 = cfg.apply_overrides(["model.drop_out=0.0"])
    gpu = create_train_state(cfg0, device, seed=7).model
    cpu = create_train_state(cfg0, "cpu", seed=7).model
    loss_gpu, g_gpu = grads_of(gpu, graph)
    cpu_graph = graph.to("cpu")
    t0 = time.time()
    loss_cpu, g_cpu = grads_of(cpu, cpu_graph)
    cpu_s = time.time() - t0
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in g_cpu.values())
    tol = {n: GRAD_REL * g.abs().max().item() + floor for n, g in g_cpu.items()}

    def ratios(a, b, widen=None):
        """max|a - b| per tensor over its tolerance (plus ``widen``)."""
        return {n: (a[n].cpu() - b[n].cpu()).abs().max().item()
                / (tol[n] + (widen[n] if widen else 0.0)) for n in tol}

    def worst(r):
        return max(r, key=r.get)

    card = ratios(g_gpu, g_cpu)
    w = worst(card)
    log(f"  card vs CPU train step: loss {loss_gpu:.7f} vs {loss_cpu:.7f}; "
        f"worst gradient {w} at {card[w]:.3f} of {GRAD_REL} x max|grad| + "
        f"{floor:.3e}; CPU step {cpu_s:.1f} s")
    if not np.isclose(loss_gpu, loss_cpu, atol=LOGIT_ATOL, rtol=LOGIT_RTOL):
        raise SystemExit(f"card loss {loss_gpu} != CPU {loss_cpu}")
    if witnessed:
        with sites_replaced(lambda key, wrapper, plain: plain):
            g_plain = grads_of(gpu, graph)[1]
        kernels = ratios(g_gpu, g_plain)
        wk = worst(kernels)
        spread = {n: r * tol[n] for n, r in ratios(g_plain, g_cpu).items()}
        card = ratios(g_gpu, g_cpu, widen=spread)
        nudge = [ratios(grads_of(cpu, nudged(cpu_graph, s))[1], g_cpu)[w]
                 for s in NUDGE_SEEDS]
        log(f"  kernels vs plain versions on the card: worst {wk} at "
            f"{kernels[wk]:.3f} of the rule; at {w}: plain card vs CPU "
            f"{spread[w] / tol[w]:.3f}, CPU vs itself with x moved by one "
            f"rounding step (seeds {NUDGE_SEEDS}) "
            f"{[round(r, 3) for r in nudge]}; card vs CPU against the rule "
            f"plus the plain card-vs-CPU distance: worst {worst(card)} at "
            f"{card[worst(card)]:.3f}")
        if not kernels[wk] <= 1.0:
            raise SystemExit(f"gradient {wk}: kernels vs plain versions on "
                             "the card out of tolerance")
        w = worst(card)
    if not card[w] <= 1.0:
        raise SystemExit(f"gradient {w} card vs CPU out of tolerance")


def train_phase(tmp: Path, device, overrides, cfg, graph, per_step: dict,
                per_batch: dict, witnessed: bool = False) -> dict:
    """Optimizer steps through train.loop with the launch counters read per
    step (``per_step``), one cli.train.main epoch (its validation batches
    at ``per_batch``), and :func:`grad_hold`."""
    import numpy as np
    import torch
    from cgcnet_tpu_torch.cli import train as train_cli
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.train.loop import make_train_step
    from cgcnet_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, device)
    loader = GraphLoader(
        NucleiGraphDataset(cfg.data, "train"), cfg.data.batch_size,
        device=device, shuffle=True, num_workers=4, seed=cfg.data.seed,
        drop_last=True,
    )
    step_fn = make_train_step()
    params0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    stats0 = {n: b.clone() for n, b in state.model.named_buffers()}
    step_ms, losses, totals = [], [], expected({})
    for epoch in range(TRAIN_EPOCHS):
        for g in loader.epoch(epoch):
            if tuple(g.x.shape[:2]) != (CANONICAL["B"], CANONICAL["N"]):
                raise SystemExit(f"train batch is not canonical: {g.x.shape}")
            zero_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step_fn(state, g)
            end.record()
            end.synchronize()
            counts = read_counts()
            if counts != expected(per_step):
                raise SystemExit(
                    f"step {state.step}: launches {counts} != {per_step}")
            for k, v in counts.items():
                totals[k] += v
            step_ms.append(start.elapsed_time(end))
            losses.append(float(metrics["loss"]))
        state.scheduler.step()
    if state.step < 5 or not np.isfinite(losses).all():
        raise SystemExit(f"{state.step} steps, losses {losses}")
    moved = [n for n, p in state.model.named_parameters()
             if not torch.equal(p.detach(), params0[n])]
    stats_moved = [n for n, b in state.model.named_buffers()
                   if not torch.equal(b, stats0[n])]
    if len(moved) != len(params0) or len(stats_moved) != len(stats0):
        raise SystemExit(
            f"parameters changed {len(moved)}/{len(params0)}, running "
            f"statistics {len(stats_moved)}/{len(stats0)}")
    # the first step pays one-time set-up (cuBLAS handles, allocator)
    median_ms = statistics.median(step_ms[1:])
    log(f"  {state.step} train steps ({cfg.model.gcn_name}, x "
        f"{tuple(graph.x.shape)}, {cfg.model.compute_dtype}): launches per "
        f"step {per_step}, "
        f"losses {[round(v, 4) for v in losses]}, step {median_ms:.3f} ms "
        f"(median of {len(step_ms) - 1} after the first, CUDA events; all "
        f"{[round(v, 2) for v in step_ms]})")

    # cli.train: one epoch end to end, mid-epoch and end-of-epoch validation
    zero_counts()
    t0 = time.time()
    cpu_flag = ["--cpu"] if device.type == "cpu" else []
    result = train_cli.main([
        *cpu_flag, *overrides, "train.num_epochs=1", "train.log_every=2",
        "train.eval_every_batches=3", "train.test_epoch=2",
        f"train.ckpt_dir={tmp / 'runs'}",
    ])
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    counts = read_counts()
    run_dir = Path(result["run_dir"])
    kinds = [json.loads(line)["kind"]
             for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    steps = loader.batches_per_epoch()
    log(f"  cli.train: {cli_s:.1f} s wall, result {result}, records {kinds}, "
        f"launches {counts}")
    # steps x per_step plus E validation batches x per_batch, E > 0
    head = "B4" if per_batch.get("B4") else "B6"
    evals = counts[head] - steps * per_step[head]
    if evals <= 0 or counts != {
        k: steps * per_step.get(k, 0) + evals * per_batch.get(k, 0)
        for k in KERNELS
    }:
        raise SystemExit(f"cli.train launches {counts} are not {steps} steps "
                         f"x {per_step} + validation batches x {per_batch}")
    if (kinds.count("train") != steps // 2 or kinds.count("epoch") != 1
            or kinds.count("val") != steps // 3 + 1):
        raise SystemExit(f"metrics.jsonl records {kinds}")
    for name in ("weight.pt", "model_best.pt"):
        if not (run_dir / name).is_file():
            raise SystemExit(f"cli.train wrote no {name}")
    if not {"img_acc", "binary_acc", "patch_acc"} <= set(result):
        raise SystemExit(f"summary keys missing: {result}")

    grad_hold(cfg, device, graph, witnessed)
    return {"counts": totals, "step_ms": median_ms, "steps": state.step,
            "cli_wall_s": cli_s}


def rest_phase(cfg, graph) -> dict:
    """Phase 7: the paths of the slice besides GIN's, each with its launch
    counts. Returns the counts of the whole phase."""
    import dataclasses

    import numpy as np
    import torch
    from cgcnet_tpu_torch.nn.model import CGCNet, cross_entropy_loss, make_stage1_adj
    from cgcnet_tpu_torch.train.loop import make_train_step
    from cgcnet_tpu_torch.train.state import create_train_state

    device = graph.device
    totals = expected({})

    def counted(want: dict, what: str) -> None:
        counts = read_counts()
        if counts != expected(want):
            raise SystemExit(f"{what}: launches {counts} != {want}")
        for k, v in counts.items():
            totals[k] += v

    def close(got, ref, tol, what):
        err = (got.float() - ref.float()).abs().max().item()
        lim = tol * ref.float().abs().max().item()
        log(f"  {what}: max abs diff {err:.3e} (tol {lim:.3e})")
        if not err <= lim:
            raise SystemExit(f"{what}: out of tolerance")

    # EllAdjFactored without block values: B7 forward and on the transpose
    # tables backward, against the factored gather branch
    adj = make_stage1_adj(graph, cfg.model, torch.float32)
    g = torch.randn(graph.x.shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(0))

    def matvec_and_grad(a):
        x = graph.x.clone().requires_grad_(True)
        out = a.matvec(x)
        torch.sum(out * g).backward()
        return out.detach(), x.grad

    zero_counts()
    fly = matvec_and_grad(dataclasses.replace(adj, vals=None, vals_t=None))
    counted({"B7": 2}, "EllAdjFactored without vals, forward + backward")
    ref = matvec_and_grad(dataclasses.replace(adj, impl="gather"))
    for got, want, what in zip(fly, ref, ("A @ x", "A^T g")):
        close(got, want, TOL[("B7", "float32")], f"B7 {what} vs the gather branch")

    # SAGE: the deeper fold (B4) and fused_assign_norm=never (B6), one model
    sd = CGCNet(cfg.model, torch.Generator().manual_seed(1234)).state_dict()
    logits = {}
    for head, over, per in (
        ("B4", [], SERVE_PER_BATCH),
        ("B6", ["model.fused_assign_norm=never"], {"B1": 1, "B2": 4, "B6": 1}),
    ):
        model = CGCNet(cfg.apply_overrides(over).model)
        model.load_state_dict(sd)
        model = model.to(device).eval()
        zero_counts()
        with torch.inference_mode():
            logits[head] = model(graph)
        counted(per, f"SAGE forward through {head}")
    close(logits["B6"], logits["B4"], 1e-4,
          "SAGE logits, fused_assign_norm=never (B6) vs default (B4)")

    # GAT and SAGE+elu: one forward and one train step each, B6 once each
    # (GAT aggregates by attention: its only stage-1 matvec is A @ S)
    step_fn = make_train_step()
    for over, serve, train in (
        (["model.gcn_name=GAT"], {"B1": 1, "B2": 1, "B6": 1},
         {"B1": 2, "B2": 2, "B6": 1}),
        (["model.activation=elu"], GIN_SERVE_PER_BATCH, GIN_TRAIN_PER_STEP),
    ):
        state = create_train_state(cfg.apply_overrides(over), device, seed=5)
        zero_counts()
        with torch.inference_mode():
            out = state.model.eval()(graph)
        counted(serve, f"{over[0]} forward")
        zero_counts()
        loss = float(step_fn(state, graph)["loss"])
        counted(train, f"{over[0]} train step")
        log(f"  {over[0]}: logits finite {bool(torch.isfinite(out).all())}, "
            f"train-step loss {loss:.6f}")
        if not (torch.isfinite(out).all() and np.isfinite(loss)):
            raise SystemExit(f"{over[0]}: not finite")

    # the batch with its block metadata stripped: ELL gathers, no kernel
    bare = dataclasses.replace(graph, blk_cols=None, blk_mask=None,
                               blk_cols_t=None, blk_mask_t=None)
    model = CGCNet(cfg.model)
    model.load_state_dict(sd)
    model = model.to(device).eval()
    zero_counts()
    with torch.inference_mode():
        out = model(bare)
    close(out, logits["B4"], 1e-4, "logits without metadata vs with")
    model.train()
    loss = cross_entropy_loss(model(bare), bare.y)
    loss.backward()
    counted({}, "forward + backward of a batch without metadata")
    if not (torch.isfinite(loss) and all(
            torch.isfinite(q.grad).all() for q in model.parameters())):
        raise SystemExit("batch without metadata: loss or gradients not finite")
    log(f"  batch without metadata: train-mode loss {loss.item():.6f}, no "
        "kernel launched")
    return totals


def slice_phase(tmp: Path, device) -> dict:
    import torch
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.train.state import create_train_state

    t0 = time.time()
    overrides, cfg = make_data(tmp)
    gin_overrides = [*overrides, "model.gcn_name=GIN"]
    gin_cfg = cfg.apply_overrides(["model.gcn_name=GIN"])
    log(f"  dataset: {time.time() - t0:.1f} s")
    # one canonical batch and the kernel inputs one training step gives them
    valid = NucleiGraphDataset(cfg.data, "valid")
    loader = GraphLoader(valid, cfg.data.batch_size, device=device,
                         shuffle=False, num_workers=4)
    graph = next(iter(loader.epoch(0)))
    log(f"  batch: x {tuple(graph.x.shape)}, n_nodes {graph.n_nodes.tolist()}, "
        f"blk_cols {tuple(graph.blk_cols.shape)}, blk_cols_t "
        f"{tuple(graph.blk_cols_t.shape)}")
    if tuple(graph.x.shape[:2]) != (CANONICAL["B"], CANONICAL["N"]):
        raise SystemExit(f"batch is not the canonical {CANONICAL}: {graph.x.shape}")
    seen = capture_inputs(create_train_state(cfg, device, seed=1234).model, graph)
    gin_seen = capture_inputs(
        create_train_state(gin_cfg, device, seed=1234).model, graph)
    for name, got, per, head in (("SAGE", seen, TRAIN_PER_STEP, "B4"),
                                 ("GIN", gin_seen, GIN_TRAIN_PER_STEP, "B6")):
        c = got[head][0][1].shape[-1]
        calls = {k: len(v) for k, v in got.items()}
        if c != CANONICAL["C"] or calls != expected(per):
            raise SystemExit(f"unexpected {name} kernel calls: C={c}, {calls}")

    log("phase 3: kernels vs plain versions (canonical shapes)")
    kernels = kernel_phase(seen, gin_seen, graph)
    del seen, gin_seen
    torch.cuda.empty_cache()

    log("phase 4: serving slice (cli.predict on the card, --reps 2)")
    serve_counts, fwd_ms, wall = serve_phase(
        tmp, device, overrides, cfg, graph, len(valid), SERVE_PER_BATCH)

    log("phase 5: training slice (train.loop, cli.train, card vs CPU)")
    train = train_phase(tmp, device, overrides, cfg, graph, TRAIN_PER_STEP,
                        SERVE_PER_BATCH)

    log("phase 6: GIN slice (cli.predict, train.loop, cli.train, card vs CPU)")
    gin_serve_counts, gin_fwd_ms, gin_wall = serve_phase(
        tmp, device, gin_overrides, gin_cfg, graph, len(valid),
        GIN_SERVE_PER_BATCH)
    gin_train = train_phase(tmp, device, gin_overrides, gin_cfg, graph,
                            GIN_TRAIN_PER_STEP, GIN_SERVE_PER_BATCH,
                            witnessed=True)

    log("phase 7: B7 without block values, B6 vs B4, GAT, SAGE+elu, the "
        "gather path")
    rest_counts = rest_phase(cfg, graph)
    paths = {"serve": serve_counts, "train": train["counts"],
             "gin_serve": gin_serve_counts, "gin_train": gin_train["counts"],
             "rest": rest_counts}
    for entry in kernels:
        key = entry.pop("key")
        by_path = {name: counts[key] for name, counts in paths.items()}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        if entry["launches"] == 0:
            raise SystemExit(f"{entry['name']}: no launch on any path")
    return {"kernels": kernels, "forward_ms_per_batch": fwd_ms,
            "predict_wall_s": wall, "train_step_ms": train["step_ms"],
            "train_steps": train["steps"], "train_cli_wall_s": train["cli_wall_s"],
            "gin_forward_ms_per_batch": gin_fwd_ms, "gin_predict_wall_s": gin_wall,
            "gin_train_step_ms": gin_train["step_ms"],
            "gin_train_steps": gin_train["steps"],
            "gin_train_cli_wall_s": gin_train["cli_wall_s"]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "cgcnet_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no cgcnet_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    log("phase 2: build kernels (nvcc, sm_90a)")
    from cgcnet_tpu_torch.ops import _cuda

    t0 = time.time()
    lib_path = _cuda.build()
    _cuda.library()
    log(f"  built {lib_path.name} in {time.time() - t0:.1f} s")
    for line in (_cuda.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  " + line.strip())

    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        numbers = slice_phase(Path(tmp), device)
    print(json.dumps(numbers))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
