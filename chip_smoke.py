#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cgcnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each fatal on failure (exit code != 0):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build of the hand-written kernels from ``cgcnet_tpu_torch/csrc`` (nvcc),
   with the compiler's registers and spills of every instantiation of the
   bf16 tensor-core kernels (``TC_KERNELS``);
3. kernels: B1 (block build, for A and for the binary transpose blocks),
   B2 (block-sparse matmul, at every width one training step gives it, on
   the forward and on the transpose blocks, walking the live slots the
   model counted beside B1), B3 (BN statistics of the assign
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
   forward and backward with no kernel launched;
8. slide serving: ``cli.slide.main`` on a synthetic 100k-nuclei slide,
   ``--shards 1``, bf16, the phase-4 patch checkpoint, ``--slides 3``, with
   the counters read (B1 = 2 per slide build; B2 = 3, B8 = 1, B4 = 1 per
   forward); the forward's CUDA-event time; its logits against the plain
   versions on the card;
9. slide training: 12 steps of ``make_slide_train_step`` at 100k, bf16
   (B2 = 5, B3 = 1, B4 = 1 with S lane-padded to 1152, B8 = 2 — one with
   the row accumulator and split outputs —, B5 = 1 per step), finite
   loss, parameters and running statistics changed, one step's loss and
   gradients against the plain versions on the card (``step_hold``: the
   plain side keeps the kernels of ``assign_head.STATS_HELD``, B3 and B9b,
   so both sides read the same BN statistics, which the statistics hold
   below judges on their own; the gradients are held on the plain steps
   replayed with the kernel step's max-readout routing, so a near-tied
   readout that swaps nodes on the last bits does not move them, and a
   node moved further than ``READOUT_STEPS`` bf16 steps, or more than
   ``READOUT_SHARE`` of a readout's columns moved, fails the hold); one
   ``cli.slide --train-epochs 2 --out`` round trip, the written file served
   again;
10. capacity path: 6 steps with ``model.assign_tail_chunk=65536
   mesh.remat_stage1=true`` (chunks of 65536 and 34816 rows; B9b = 1, B9a
   = 5, B5 = 2, B8 = 2, B2 = 8 per step), the step hold as in phase 9;
   then an f32 forward and step of an 8192-nuclei
   slide on the card against the CPU (block tables built by hand for both);
   then the statistics hold: B3's and B9b's column sums and sums of squares
   on the slide's own bf16 inputs against the exact (f64) statistics of the
   plain version's h, within ``assign_head.STATS_TOL``, printed beside the plain
   versions' and two witnesses' distances (a right computation by another
   route, which must pass, and one a rounding step off, which must fail);
   then B8 (the A @ S legs, the transpose legs with and without the
   accumulator, halo windows from shard 0 of a 4-shard stripe-sorted
   partition — on no path of this run, 0 launches —, the ``epilogue_sw``
   option), B9a, B9b, B3, B4 (serving, and
   training's lane-padded ``c_out``), B5 (the training call and each
   capacity chunk) and the int8 B1/B2 legs against their plain versions on
   the card, in f32 and bf16, on inputs captured from phases 8-10, timed as
   in phase 3. B4, B6 and B9a also carry ``product_library_ms``, their
   product [rows x (F12+C)] @ [(F12+C) x C] alone as one cuBLAS call (a
   yardstick), and one B4 and one B9a call at the slide's shapes the device
   time of each of the head's launches (``split_ms``: row norm, product,
   softmax, and the padded weight copies as ``other``) from a
   torch.profiler trace.

The statistics hold runs after the step holds of phases 9 and 10 that
rest on it (it reads inputs those phases capture): a run whose statistics
fail it fails all the same, whatever the step holds said before.

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
KERNELS = ("B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8", "B9a", "B9b")
# launches per train step and per serving batch, SAGE (canonical) and GIN;
# a kernel not named launches 0 times
TRAIN_PER_STEP = {"B1": 2, "B2": 7, "B3": 1, "B4": 1, "B5": 1}
SERVE_PER_BATCH = {"B1": 1, "B2": 4, "B4": 1}
GIN_TRAIN_PER_STEP = {"B1": 2, "B2": 7, "B6": 1}
GIN_SERVE_PER_BATCH = {"B1": 1, "B2": 4, "B6": 1}
# the whole-slide path: a synthetic slide of SLIDE_NUCLEI nuclei (100352
# rows, 784 row tiles), one shard, bf16 activations, the canonical widths
SLIDE_NUCLEI = 100_000
SLIDE_CAP = -(-SLIDE_NUCLEI // 512) * 512   # 100352 rows, 784 row tiles
SLIDE_DTYPE = ["model.compute_dtype=bfloat16"]
CAP_CHUNK = 65536       # model.assign_tail_chunk of the capacity path
SLIDE_CAPACITY = [f"model.assign_tail_chunk={CAP_CHUNK}",
                  "mesh.remat_stage1=true"]
SLIDE_STREAM = 3        # slides of the cli.slide --slides stream
SLIDE_TRAIN_STEPS = 12
SLIDE_CAP_STEPS = 6
SMALL_SLIDE_NUCLEI = 8192   # the f32 card-vs-CPU slide
# B8's halo-window variant: shard 0 of the slide stripe-sorted for 4 shards
# (a partition whose halo outgrows the resident tail), at the A@S width
HALO_SHARDS, HALO_NUCLEI, HALO_F = 4, 100_000, 1152
SLIDE_BUILD = {"B1": 2}                              # per slide build
SLIDE_FORWARD = {"B2": 3, "B8": 1, "B4": 1}          # per forward
SLIDE_TRAIN_PER_STEP = {"B2": 5, "B3": 1, "B4": 1, "B5": 1, "B8": 2}
SLIDE_CAP_PER_STEP = {"B2": 8, "B5": 2, "B8": 2, "B9a": 5, "B9b": 1}
# the slide holds run in bf16 (the slide path's activations): kernels
# against their plain versions on the same card, at the f32 rules (logits
# LOGIT_ATOL/RTOL, gradients GRAD_REL/GRAD_FLOOR) widened by BF16_WIDEN x
# the distance between the plain bf16 computation and the plain f32 one on
# the same card — what bf16 rounding alone moves: the kernels and the plain
# versions round at other points, two such bf16 computations part by up to
# the sum of their distances from the f32 one, and either may lie up to
# about twice as far from it as the other (on an H100 80GB HBM3 the JK
# attention bias, whose gradient is zero in theory and rounding noise in
# bf16, parted by 2.34x that distance)
BF16_WIDEN = 4.0
# a gradient that is zero in theory (the JK attention biases: a shared
# score offset, ``zero_in_theory``) comes out as rounding noise; in bf16
# its floor is half a bf16 step of the model's largest gradient (on an
# H100 80GB HBM3 jk2.att.bias parted by 1e-4 of the model's largest
# gradient on the capacity path, where its plain bf16 and f32 values
# happened to agree to 2.4e-7). Every other tensor keeps GRAD_FLOOR
BF16_FLOOR = 2.0 ** -9
# the step holds' replay of the kernel step's max readouts on the plain
# steps (``step_hold``): a readout column whose own maximum lies elsewhere
# than the kernel step's node is a near-tie only when the plain step's value
# at that node lies within READOUT_STEPS bf16 steps of its own maximum, and
# at most READOUT_SHARE of a readout's columns may move. On an H100 80GB
# HBM3 right computations (every kernel; the held statistics nudged by
# 1e-7) moved nodes up to 9 steps on the stage-3 readout against the plain
# bf16 step and 7.5 against the f32 one, and 4 of the stage-1 readout's 20
# columns against the f32 step
READOUT_STEPS = 16.0
READOUT_SHARE = 0.5
# B8, B9a, B9b as B2, B4 and B3: f32 B8 1e-4 (sums over 128*M block
# columns in another order), B9a and B9b 1e-5 (the F3-term dot forming p
# is rounded alike, then B4's and B3's sums); bf16 2^-6
TOL.update({
    ("B8", "float32"): 1e-4, ("B8", "bfloat16"): 2.0 ** -6,
    ("B9a", "float32"): 1e-5, ("B9a", "bfloat16"): 2.0 ** -6,
    ("B9b", "float32"): 1e-5, ("B9b", "bfloat16"): 2.0 ** -6,
})
PATCH_PATHS = ("serve", "train", "gin_serve", "gin_train", "rest")
SLIDE_PATHS = ("slide_serve", "slide_train", "slide_capacity")


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
            "B7": bsr.bsr_gather_sum, "B8": bsr.bsr_matmul_banded,
            "B9a": ah.assign_head_softmax_pre_lin,
            "B9b": ah.l2relu_stats_lin}


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


def kernel_sites() -> list:
    """(module, name, kernel id, plain version) of every site where the
    model calls a kernel wrapper through a module's global name."""
    from cgcnet_tpu_torch.nn import model as model_mod
    from cgcnet_tpu_torch.ops import assign_head as ah
    from cgcnet_tpu_torch.ops import bsr, ell
    from cgcnet_tpu_torch.parallel import mega_model

    return [
        (model_mod, "bsr_build_blocks", "B1", bsr.bsr_build_blocks_plain),
        (mega_model, "bsr_build_blocks", "B1", bsr.bsr_build_blocks_plain),
        (ell, "bsr_matmul", "B2", bsr.bsr_matmul_plain),
        (ah, "l2relu_stats", "B3", ah.l2relu_stats_plain),
        (ah, "assign_head_softmax_pre", "B4", ah.assign_head_softmax_pre_plain),
        (ah, "assign_tail_bwd", "B5", ah.assign_tail_bwd_plain),
        (ah, "assign_head_softmax", "B6", ah.assign_head_softmax_plain),
        (ell, "bsr_gather_sum", "B7", bsr.bsr_gather_sum_plain),
        (ell, "bsr_matmul_banded", "B8", bsr.bsr_matmul_banded_plain),
        (mega_model, "bsr_matmul_banded", "B8", bsr.bsr_matmul_banded_plain),
        (ah, "assign_head_softmax_pre_lin", "B9a",
         ah.assign_head_softmax_pre_lin_plain),
        (ah, "l2relu_stats_lin", "B9b", ah.l2relu_stats_lin_plain),
    ]


@contextlib.contextmanager
def sites_replaced(replacement):
    """For the duration, each site where the model calls a kernel wrapper
    calls ``replacement(kernel id, wrapper, plain version)`` instead."""
    sites = kernel_sites()
    originals = [getattr(mod, name) for mod, name, _, _ in sites]
    for (mod, name, key, plain), orig in zip(sites, originals):
        setattr(mod, name, replacement(key, orig, plain))
    try:
        yield
    finally:
        for (mod, name, _, _), orig in zip(sites, originals):
            setattr(mod, name, orig)


def all_plain(key, wrapper, plain):
    """Every site its plain version."""
    return plain


def stats_shared(key, wrapper, plain):
    """The step holds' plain bf16 side: the kernels whose statistics the
    statistics hold judges (``assign_head.STATS_HELD``: B3, B9b) stay the
    kernel, every other site its plain version."""
    from cgcnet_tpu_torch.ops import assign_head as ah

    return wrapper if key in ah.STATS_HELD else plain


def bf16_steps(gap, scale):
    """``gap`` in bf16 steps at ``scale`` (elementwise): a step is 2^-7 of
    the power of two at or below |scale|."""
    import torch

    exp = torch.frexp(scale.abs().float()).exponent
    return gap.float() / torch.ldexp(torch.ones_like(gap.float()), exp - 8)


def readout_routing():
    """A torch function mode over the model's max readouts (``torch.amax``
    over the nodes of a [nodes, F] tensor). Entered as it is, it records,
    per readout in call order, where each column's maximum lies (``masks``);
    inside ``replay()`` each readout instead takes the mean of x at the
    recorded positions — the maximum, on the recording side — whose gradient
    goes to those positions, split evenly among ties, as amax's does. So a
    step replayed this way routes its readouts' gradients to the nodes the
    recorded step chose, whatever its own last bits would have chosen.
    Each replay appends to ``moves`` one (columns, columns moved, worst gap)
    per readout: a column moved when its own maximum lies elsewhere than
    the recorded one, and its gap is its own maximum less its least value
    at the recorded nodes, in bf16 steps (``bf16_steps``) of the larger of
    the two."""
    import torch
    from torch.overrides import TorchFunctionMode

    class Routing(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.masks, self.moves, self.replaying, self.i = [], [], False, 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
            if not (func is torch.amax and dim in (0, (0,), [0])
                    and not kwargs.get("keepdim") and len(args) <= 2
                    and args[0].dim() == 2 and args[0].shape[0] > 1):
                return func(*args, **kwargs)
            x = args[0]
            if not self.replaying:
                out = func(*args, **kwargs)
                self.masks.append(x.detach() == out.detach()[None])
                return out
            if self.i >= len(self.masks):
                raise SystemExit("readout routing: more readouts replayed "
                                 "than recorded")
            mask = self.masks[self.i]
            self.i += 1
            xd = x.detach()
            top = torch.amax(xd, 0)
            moved = ((xd == top[None]) != mask).any(0)
            low = torch.where(mask, xd, torch.full_like(xd, float("inf")))
            low = torch.amin(low, 0)
            gap = bf16_steps(top - low, torch.maximum(top.abs(), low.abs()))
            self.moves[-1].append((
                mask.shape[1], int(moved.sum()),
                float(gap[moved].max()) if moved.any() else 0.0))
            w = mask.float()
            return (x.float() * (w / w.sum(0))).sum(0).to(x.dtype)

        @contextlib.contextmanager
        def replay(self):
            self.replaying, self.i = True, 0
            self.moves.append([])
            try:
                with self:
                    yield
            finally:
                self.replaying = False
            if self.i != len(self.masks):
                raise SystemExit(f"readout routing: {self.i} readouts "
                                 f"replayed, {len(self.masks)} recorded")

    return Routing()


def capture_inputs(model, graph) -> dict:
    """Run one training step's forward and backward with shims in front of
    the kernel wrappers and keep (clones of) the arguments each one is
    given, in call order."""
    import torch

    seen: dict[str, list] = {key: [] for key in KERNELS}

    def shim_for(key, wrapper, plain):
        def shim(*args):
            if key in ("B8", "B9a", "B9b"):  # not on the patch path
                return wrapper(*args)
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


def record_kernel(results, name, key, dt, out, ref, kernel_fn, plain_fn,
                  bytes_, ops, library=None, source="", replaces="",
                  ops_dt=None, paths=None, reps=15, plain_reps=15,
                  extra=None) -> None:
    """Hold a kernel's output (a tensor or a tuple) against its plain
    version's at TOL, time kernel, plain version and library call (CUDA
    events), and append the kernel-line entry to ``results``; ``paths``
    names the main paths whose launches it counts (default the patch
    paths; () for a variant that no path of this run takes); ``extra``
    adds fields to the entry (the head's yardstick and split); ``ops`` may
    be a {dtype: count} split, each part at its type's peak rate."""
    import torch

    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = max((o.float() - r.float()).abs().max().item()
              for o, r in zip(outs, refs))
    scale = max(r.float().abs().max().item() for r in refs)
    tol = TOL[(key, dt)] * scale
    ok = err <= tol
    ms = time_ms(kernel_fn, reps=reps)
    plain_ms = time_ms(plain_fn, reps=plain_reps, warmup=min(2, plain_reps))
    lib_ms = None
    if library is not None:
        # the yardstick only: a library without this call is recorded as
        # null, it does not fail the run
        try:
            lib_ms = time_ms(library(), reps=reps)
        except (RuntimeError, NotImplementedError) as e:
            log(f"  library call unavailable for {name}: {e}")
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    # ops: a count at the rate of ops_dt (default the leg's type), or
    # {type: count} for work split between the tensor cores and the CUDA
    # cores (B9b in bf16), each part at its own rate
    parts = ops if isinstance(ops, dict) else {ops_dt or dt: ops}
    t_ops = sum(n / PEAK_OPS_PER_S[d] for d, n in parts.items()) * 1e3
    entry = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": None, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms, "key": key,
        "paths": PATCH_PATHS if paths is None else paths,
        **(extra or {}),
    }
    log(f"  {name}: max_abs_err {err:.3e} (max|ref| {scale:.3e}, tol "
        f"{tol:.3e}) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {lib_ms} ms, bound "
        f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})"
        + "".join(f"; {k} {v}" for k, v in (extra or {}).items()))
    if not ok:
        raise SystemExit(f"kernel {name} disagrees with its plain version")
    results.append(entry)


def product_library_ms(rows: int, k: int, c: int, dt, device) -> float:
    """The head's product alone as one cuBLAS call, [rows x k] @ [k x c] in
    ``dt`` (f32 without TF32), on random operands of those shapes: a
    yardstick for B4 / B6 / B9a; the port never calls it."""
    import torch

    gen = torch.Generator(device=device).manual_seed(5)
    a = torch.randn((rows, k), generator=gen, device=device).to(dt)
    w = torch.randn((k, c), generator=gen, device=device).to(dt)
    ms = time_ms(lambda: a @ w, reps=10)
    del a, w
    return ms


# the head's launches by kernel name: row norm (B4, B9a), product, softmax
HEAD_PARTS = {"row_norm": ("rnorm_kernel", "rnorm_lin_tc_kernel"),
              "product": ("gemm_tc_kernel", "gemm_kernel"),
              "softmax": ("softmax_kernel", "softmax_rows_kernel")}


def head_split(fn, calls: int = 3) -> dict:
    """Device ms per call of each of the head's launches (HEAD_PARTS) and
    of the wrapper's other kernels (``other``: the padded weight copies),
    from the kernel events of a torch.profiler trace of ``calls`` calls;
    "not measured" where the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = {part: 0.0 for part in (*HEAD_PARTS, "other")}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        part = next((p for p, names in HEAD_PARTS.items()
                     if any(n in e.name for n in names)), "other")
        us[part] += e.time_range.elapsed_us()
    if not any(us.values()):
        return {part: "not measured" for part in us}
    return {part: v / calls / 1e3 for part, v in us.items()}


def kernel_phase(seen: dict, gin_seen: dict, graph) -> list[dict]:
    import torch
    from cgcnet_tpu_torch.ops import assign_head as ah
    from cgcnet_tpu_torch.ops import bsr

    t = bsr.TILE
    results = []
    rows_real = int(seen["B4"][0][5].sum().item())

    def record(*args, **kwargs):
        record_kernel(results, *args, **kwargs)

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
                library=lambda nbr=nbr, w=w: _bsr_build_library_call(
                    nbr, w, dt),
                source="cgcnet_tpu_torch/csrc/bsr_build.cu",
                replaces="cgcnet_tpu/ops/pallas/bsr_kernel.py:275",
            )
            blocks.append((which, out, blk_cols, blk_mask))
        # ---- B2, at every width a training step gives it, on the forward
        # blocks (the first 4 calls) and the transpose blocks (the rest) ----
        done = set()
        for i, (_, _, x_, slots) in enumerate(seen["B2"]):
            which, vals, blk_cols, blk_mask = blocks[
                0 if i < SERVE_PER_BATCH["B2"] else 1]
            if (which, x_.shape[-1]) in done:
                continue
            done.add((which, x_.shape[-1]))
            if not torch.equal(slots, bsr.live_slot_counts(blk_mask)):
                raise SystemExit(f"B2 {which}: the model's live slot counts "
                                 "are not its blocks'")
            b, r, m = blk_cols.shape
            nnzb = int(blk_mask.sum().item())
            walked = int(slots.sum().item())
            x = x_.to(dt)
            nc, f = x.shape[1], x.shape[2]
            out = bsr.bsr_matmul(vals, blk_cols, x, slots)
            ref = bsr.bsr_matmul_plain(vals, blk_cols, x, slots)
            record(
                f"B2 bsr_matmul {which} {tag} B={b} N={nc} M={m} live "
                f"slots {walked} of {b * r * m} F={f}", "B2",
                dt_name, out, ref,
                lambda x=x, v=vals, c=blk_cols, s_=slots:
                    bsr.bsr_matmul(v, c, x, s_),
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
            extra={"product_library_ms": product_library_ms(
                b * n, f12 + c, c, dt, p.device)},
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
            extra={"product_library_ms": product_library_ms(
                b * n, f12 + c, c, dt, h3a.device)},
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
        for i, (_, _, x_, _) in enumerate(seen["B2"]):
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
                bsr.bsr_build_blocks(nbr, w, blk_cols, blk_mask, dt), blk_cols,
                x, bsr.live_slot_counts(blk_mask))
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


def _csr_of(nbr, w, dtype):
    """The block-diagonal ``torch.sparse_csr_tensor`` [B*N, B*N] of the
    batch's ELL (nbr, w), values in ``dtype`` (duplicate columns summed)."""
    import torch

    b, n, k = nbr.shape
    dev = nbr.device
    rows = torch.arange(b * n, device=dev).repeat_interleave(k)
    cols = (nbr.long() + torch.arange(b, device=dev).reshape(b, 1, 1) * n)
    vals = w.reshape(-1)
    keep = vals != 0
    a = torch.sparse_coo_tensor(
        torch.stack([rows[keep], cols.reshape(-1)[keep]]),
        vals[keep].to(dtype), size=(b * n, b * n)).coalesce()
    return a.to_sparse_csr()


def _csr_library_call(nbr, w, blk_cols, blk_mask, x):
    """One PyTorch call computing B7's function: a block-diagonal
    ``torch.sparse_csr_tensor`` over the batch, built once from the same ELL
    (not timed), times x. A yardstick; the port never calls it."""
    b, n, _ = nbr.shape
    a = _csr_of(nbr, w, x.dtype)
    xs = x.reshape(b * n, x.shape[-1])
    return lambda: a @ xs


def _bsr_build_library_call(nbr, w, dtype):
    """The nearest one PyTorch call to B1's function: the same adjacency as
    a block-diagonal CSR tensor (built once, not timed) converted to
    128x128 blocks, ``Tensor.to_sparse_bsr`` (its own block layout, over
    the blocks that hold an entry). A yardstick; the port never calls it."""
    a = _csr_of(nbr, w, dtype)
    return lambda: a.to_sparse_bsr((128, 128))


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
        with sites_replaced(all_plain):
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


# ---------------------------------------------------------------------------
# phases 8-10: the whole-slide path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def slide_capture(seen: dict):
    """For the duration, keep clones of the (args, kwargs) of the first call
    each kernel wrapper gets at each distinct (kernel, tensor shapes and
    other arguments) on the slide path, then call the wrapper."""
    import torch

    def clone(a):
        return a.detach().clone() if isinstance(a, torch.Tensor) else a

    def shim_for(key, wrapper, plain):
        def shim(*args, **kwargs):
            sig = (key, tuple(tuple(a.shape) if isinstance(a, torch.Tensor)
                              else a for a in args),
                   tuple(sorted(k for k, v in kwargs.items()
                                if v is not None)))
            if sig not in seen:
                seen[sig] = ([clone(a) for a in args],
                             {k: clone(v) for k, v in kwargs.items()})
            before = shim.launches
            out = wrapper(*args, **kwargs)
            # a wrapper counts through its module's global name, which may
            # be this shim: hand the count on to the wrapper
            wrapper.launches += shim.launches - before
            shim.launches = before
            return out
        shim.launches = 0
        return shim

    with sites_replaced(shim_for):
        yield


def slide_grads(model, cfg, inputs, step_remat: bool):
    """(loss, {name: grad}) of one training-mode slide forward + backward
    (dropout off: no generator), the running statistics left alone."""
    import torch
    from cgcnet_tpu_torch.parallel.mega_model import mega_forward

    model.zero_grad(set_to_none=True)
    logits = mega_forward(model, cfg.model, inputs, train=True,
                          remat_stage1=step_remat and cfg.mesh.remat_stage1,
                          remat=step_remat and cfg.mesh.remat)
    loss = -torch.log_softmax(logits, -1)[1]
    loss.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def zero_in_theory(name: str) -> bool:
    """The JK attention biases: one offset shared by every layer's score,
    which the attention softmax cancels."""
    return name.startswith("jk") and name.endswith(".att.bias")


def grads_close(what, g_ker, g_ref, rel, widen=None, zero_floor=None,
                strict=True) -> tuple[str, float]:
    """Each gradient tensor within ``rel`` of its own max|grad| plus
    GRAD_FLOOR of the model's largest gradient (GRAD_REL's rule), plus
    ``widen[name]`` where given; a ``zero_in_theory`` tensor's floor is
    ``zero_floor`` of the model's largest where given. Returns the worst
    tensor and its difference as a fraction of its tolerance; fails when
    that is above 1 or a gradient is not finite, unless not ``strict``."""
    if set(g_ker) != set(g_ref):
        raise SystemExit(f"{what}: gradients of different parameters")
    top = max(g.abs().max().item() for g in g_ref.values())
    floor = {n: (zero_floor if zero_floor and zero_in_theory(n)
                 else GRAD_FLOOR) * top for n in g_ref}
    base = {n: rel * g_ref[n].abs().max().item() + floor[n] for n in g_ref}
    tol = {n: base[n] + (widen[n] if widen else 0.0) for n in g_ref}
    diff = {n: (g_ker[n] - g_ref[n]).abs().max().item() for n in g_ref}
    ratio = {n: diff[n] / tol[n] for n in g_ref}
    w = max(ratio, key=ratio.get)
    bare = max(diff[n] / base[n] for n in g_ref)
    # tensors whose tolerance the floor sets (it outweighs the rest)
    by_floor = sorted(n for n in g_ref if floor[n] > tol[n] - floor[n])
    log(f"  {what}: worst gradient {w} at {ratio[w]:.3f} of {rel:.3g} x "
        f"max|grad| + {floor[w]:.3e}"
        + (f" + {BF16_WIDEN:g}x the plain bf16 vs f32 distance "
           f"({widen[w]:.3e} there; {bare:.3f} of the rule alone)"
           if widen else "")
        + f" ({len(ratio)} tensors; {len(by_floor)} with the tolerance set "
        "by the floor: "
        + ", ".join(f"{n} (diff {diff[n]:.3e}, floor {floor[n]:.3e})"
                    for n in by_floor[:6])
        + (", ..." if len(by_floor) > 6 else "") + ")")
    if strict and not ratio[w] <= 1.0:
        raise SystemExit(f"{what}: gradient {w} out of tolerance")
    bad = [n for n, g in g_ker.items() if not torch_isfinite(g)]
    if strict and bad:
        raise SystemExit(f"{what}: gradients not finite: {bad}")
    return w, ratio[w]


def every_kernel(key, wrapper, plain):
    """Every site its kernel."""
    return wrapper


def step_hold(model, cfg_, inputs, remat, what, kernel=every_kernel,
              plain=stats_shared) -> dict:
    """One slide step's loss and gradients, kernels (``kernel`` routes the
    sites) against the plain versions on the card (``plain`` routes the
    plain bf16 side: by default it keeps the STATS_HELD kernels, so both
    sides read the same BN statistics, which the statistics hold judges;
    the f32 side is all plain), at GRAD_REL's rule with the bf16 floor,
    widened by BF16_WIDEN x the distance between the plain bf16 step and
    the plain f32 step (two right computations of the step; the GIN
    precedent of phase 6); the bf16 floor for the zero-in-theory gradients
    only. The loss is held so. The gradients are held on the two plain
    steps replayed with the kernel step's readout routing
    (``readout_routing``): a max readout whose near-tied nodes swap on the
    last bits moves its gradient to another node, a jump no rounding rule
    can hold (on the H100 one or two of the stage-3 readout's 20 columns
    swap between right computations); the distance between the replayed
    plain bf16 and f32 steps widens the rule. The replay is bounded: on each
    replayed side a moved column's gap must be within READOUT_STEPS bf16
    steps and a readout may move at most READOUT_SHARE of its columns, so a
    kernel that moves a readout's node further than rounding does fails.
    The gradients as each side routes its own readouts are logged beside.
    Returns the loss difference, the routed and unrouted worst gradients
    as fractions of their tolerances, the worst readout gap and moved
    share, and whether the kernel step's gradients are finite;
    ``require_step`` fails on them."""
    from cgcnet_tpu_torch.ops.assign_head import STATS_HELD

    def grads(replace, c, mode=None):
        with sites_replaced(replace), (mode if mode is not None
                                       else contextlib.nullcontext()):
            return slide_grads(model, c, inputs, remat)

    cfg_32 = cfg_.apply_overrides(["model.compute_dtype=float32"])
    routing = readout_routing()
    g_ker = grads(kernel, cfg_, routing)
    g_plain, g_32 = grads(plain, cfg_), grads(all_plain, cfg_32)
    lim = (LOGIT_ATOL + LOGIT_RTOL * abs(g_plain[0])
           + BF16_WIDEN * abs(g_plain[0] - g_32[0]))
    loss_frac = abs(g_ker[0] - g_plain[0]) / lim
    how = (f"sharing the statistics of {', '.join(STATS_HELD)} with the "
           "kernel side" if plain is stats_shared
           else f"sites routed by {plain.__name__}")
    log(f"  {what} one step: loss {g_ker[0]:.6f} (kernels) vs "
        f"{g_plain[0]:.6f} (plain versions on the card, {how}), f32 plain "
        f"{g_32[0]:.6f}; tol {lim:.3e} ({loss_frac:.3f} of it)")
    spread = {n: BF16_WIDEN * (g_plain[1][n] - g_32[1][n]).abs().max()
              .item() for n in g_plain[1]}
    unrouted = grads_close(
        f"{what} step gradients, readouts as each side routes them (logged, "
        "not held)", g_ker[1], g_plain[1], GRAD_REL, widen=spread,
        zero_floor=BF16_FLOOR, strict=False)
    g_plain = grads(plain, cfg_, routing.replay())
    g_32 = grads(all_plain, cfg_32, routing.replay())
    steps = share = 0.0
    for side, moves in zip(("bf16", "f32"), routing.moves):
        log(f"  {what}: the plain {side} step's readouts routed as the "
            "kernel step's: " + "; ".join(
                f"readout {i}: {n} of {cols} columns moved, worst gap "
                f"{gap:.2f} bf16 steps" for i, (cols, n, gap)
                in enumerate(moves))
            + f" (limits {READOUT_STEPS:g} steps, {READOUT_SHARE:g} of the "
            "columns)")
        steps = max([steps] + [gap for _, _, gap in moves])
        share = max([share] + [n / cols for cols, n, _ in moves])
    log(f"  {what}: replayed losses {g_plain[0]:.6f} (bf16), "
        f"{g_32[0]:.6f} (f32)")
    spread = {n: BF16_WIDEN * (g_plain[1][n] - g_32[1][n]).abs().max()
              .item() for n in g_plain[1]}
    worst = grads_close(
        f"{what} step gradients, kernels vs plain versions on the card "
        "(readouts routed as the kernel step's)", g_ker[1], g_plain[1],
        GRAD_REL, widen=spread, zero_floor=BF16_FLOOR, strict=False)
    return {"loss": loss_frac, "worst": worst[0], "grad": worst[1],
            "unrouted": unrouted[1], "steps": steps, "share": share,
            "finite": all(torch_isfinite(g) for g in g_ker[1].values()),
            "g_ker": g_ker[1], "spread": spread}


def step_verdict(r: dict) -> list:
    """What fails in a ``step_hold`` result: each entry names a broken
    limit; empty when it passes."""
    bad = []
    if not r["loss"] <= 1.0:
        bad.append(f"loss at {r['loss']:.3f} of its tolerance")
    if not r["grad"] <= 1.0:
        bad.append(f"gradient {r['worst']} at {r['grad']:.3f} of its "
                   "tolerance")
    if not r["steps"] <= READOUT_STEPS:
        bad.append(f"a readout column moved {r['steps']:.2f} bf16 steps")
    if not r["share"] <= READOUT_SHARE:
        bad.append(f"a readout moved {r['share']:.3f} of its columns")
    if not r["finite"]:
        bad.append("gradients not finite")
    return bad


def require_step(r: dict, what: str) -> None:
    bad = step_verdict(r)
    if bad:
        raise SystemExit(f"{what} step hold: " + "; ".join(bad))


def torch_isfinite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def slide_model(cfg, ckpt, device):
    """A CGCNet of ``cfg`` with the checkpoint's tensors (cli.slide's
    load_partial), on ``device``."""
    from cgcnet_tpu_torch.cli.slide import load_partial
    from cgcnet_tpu_torch.nn.model import CGCNet

    model = CGCNet(cfg.model)
    copied, skipped = load_partial(model, ckpt)
    if skipped or len(copied) != len(model.state_dict()):
        raise SystemExit(f"checkpoint load: copied {len(copied)}, skipped "
                         f"{skipped}")
    return model.to(device).eval()


def slide_phases(tmp: Path, device, ckpt: Path, seen: dict) -> dict:
    """Phases 8-10 (see the module docstring); captures the slide kernels'
    inputs into ``seen``. Returns the launch counts per path and the
    numbers of the slide path."""
    import numpy as np
    import torch
    from cgcnet_tpu_torch.cli import slide as slide_cli
    from cgcnet_tpu_torch.config import Config
    from cgcnet_tpu_torch.ops.assign_head import chunk_plan, pick_chunk
    from cgcnet_tpu_torch.parallel.mega_graph import build_bsr_tables
    from cgcnet_tpu_torch.parallel.mega_model import (
        mega_forward,
        prepare_mega_inputs,
    )
    from cgcnet_tpu_torch.parallel.mega_train import (
        make_optimizer,
        make_slide_train_step,
    )
    from cgcnet_tpu_torch.parallel.slide_setup import (
        build_slide_inputs,
        synthetic_slide,
    )

    out: dict = {}
    base = ["--synthetic", "--nuclei", str(SLIDE_NUCLEI), "--shards", "1",
            *(["--cpu"] if device.type == "cpu" else [])]

    # ---- phase 8: serving ----
    log("phase 8: slide serving (cli.slide, 100k nuclei, bf16, --slides 3)")
    zero_counts()
    t0 = time.time()
    res = slide_cli.main([*base, "--ckpt", str(ckpt), "--slides",
                          str(SLIDE_STREAM), *SLIDE_DTYPE])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    builds, forwards = 1 + SLIDE_STREAM, 2 + SLIDE_STREAM
    want = {k: SLIDE_BUILD.get(k, 0) * builds
            + SLIDE_FORWARD.get(k, 0) * forwards for k in KERNELS}
    log(f"  cli.slide: {wall:.1f} s wall; graph {res['t_graph_s'] * 1e3:.1f} "
        f"ms, partition {res['t_part_s'] * 1e3:.1f} ms, forward "
        f"{res['t_fwd_s'] * 1e3:.1f} ms (host clock); logits "
        f"{res['logits'].tolist()}, grade {res['pred'] + 1}; stream "
        f"{res['slides_per_s']:.3f} slides/s, preds {res['stream_preds']}, "
        f"table shape sets {res['shape_sets']}; launches {counts} "
        f"({builds} builds x {SLIDE_BUILD} + {forwards} forwards x "
        f"{SLIDE_FORWARD})")
    if counts != want:
        raise SystemExit(f"cli.slide launches {counts} != {want}")
    if (not res["bsr"] or res["cap"] != SLIDE_CAP or res["shape_sets"] != 1
            or not np.isfinite(res["logits"]).all()
            or res["logits"].shape != (3,)):
        raise SystemExit(f"cli.slide result {res}")
    out.update(slide_forward_host_ms=res["t_fwd_s"] * 1e3,
               slide_graph_ms=res["t_graph_s"] * 1e3,
               slide_partition_ms=res["t_part_s"] * 1e3,
               slides_per_s=res["slides_per_s"], slide_cli_wall_s=wall,
               slide_logits=res["logits"].tolist())
    paths = {"slide_serve": counts}

    cfg = Config().apply_overrides(SLIDE_DTYPE)
    feats, coords = synthetic_slide(SLIDE_NUCLEI)
    with slide_capture(seen):
        build = build_slide_inputs(cfg, feats, coords, 1, device)
    inputs = build.inputs
    model = slide_model(cfg, ckpt, device)
    with torch.no_grad(), slide_capture(seen):
        logits = mega_forward(model, cfg.model, inputs)
    cfg32 = Config()
    with torch.no_grad():
        fwd_ms = time_ms(lambda: mega_forward(model, cfg.model, inputs),
                         reps=5, warmup=1)
        with sites_replaced(all_plain):
            plain_logits = mega_forward(model, cfg.model, inputs)
            plain32 = mega_forward(model, cfg32.model, inputs)
    err = (logits - plain_logits).abs().max().item()
    spread = BF16_WIDEN * (plain_logits - plain32).abs().max().item()
    lim = LOGIT_ATOL + LOGIT_RTOL * plain_logits.abs().max().item() + spread
    log(f"  forward {fwd_ms:.3f} ms (median of 5, CUDA events); logits "
        f"{logits.tolist()} vs plain versions on the card "
        f"{plain_logits.tolist()} (f32 plain {plain32.tolist()}): max abs "
        f"diff {err:.3e} (tol {lim:.3e}: the f32 rule plus {BF16_WIDEN:g}x "
        f"the plain bf16 vs f32 distance, {spread:.3e}); same grade as "
        f"cli.slide: "
        f"{int(logits.argmax()) == res['pred']}")
    if not err <= lim or int(logits.argmax()) != res["pred"]:
        raise SystemExit("slide logits: kernels vs plain versions")
    out["slide_forward_ms"] = fwd_ms

    # ---- phase 9: training ----
    log("phase 9: slide training (100k nuclei, bf16, no chunking)")
    require_step(step_hold(model, cfg, inputs, False, "slide"), "slide")

    def train_steps(cfg_, n_steps, per_step, remat_stage1, what):
        m = slide_model(cfg_, ckpt, device).train()
        params0 = {n: p.detach().clone() for n, p in m.named_parameters()}
        stats0 = {n: b.clone() for n, b in m.named_buffers()}
        step = make_slide_train_step(m, cfg_.model, make_optimizer(m, 1e-3),
                                     remat_stage1=remat_stage1)
        totals, times, losses = expected({}), [], []
        for i in range(n_steps):
            gen = torch.Generator(device=device).manual_seed(100 + i)
            zero_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if i == 0:
                ctx = slide_capture(seen)
            else:
                ctx = contextlib.nullcontext()
            with ctx:
                start.record()
                loss = step(inputs, 1, gen)
                end.record()
                end.synchronize()
            counts = read_counts()
            if counts != expected(per_step):
                raise SystemExit(f"{what} step {i}: launches {counts} != "
                                 f"{per_step}")
            for k, v in counts.items():
                totals[k] += v
            times.append(start.elapsed_time(end))
            losses.append(float(loss))
        moved = [n for n, p in m.named_parameters()
                 if not torch.equal(p.detach(), params0[n])]
        stats_moved = [n for n, b in m.named_buffers()
                       if not torch.equal(b, stats0[n])]
        if (not np.isfinite(losses).all() or len(moved) != len(params0)
                or len(stats_moved) != len(stats0)):
            raise SystemExit(
                f"{what}: losses {losses}, parameters changed "
                f"{len(moved)}/{len(params0)}, running statistics "
                f"{len(stats_moved)}/{len(stats0)}")
        med = statistics.median(times[1:])
        log(f"  {n_steps} {what} steps: launches per step {per_step}, losses "
            f"{[round(v, 4) for v in losses]}, step {med:.3f} ms (median of "
            f"{n_steps - 1} after the first, CUDA events; all "
            f"{[round(v, 2) for v in times]}); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return totals, med

    torch.cuda.reset_peak_memory_stats()
    paths["slide_train"], out["slide_step_ms"] = train_steps(
        cfg, SLIDE_TRAIN_STEPS, SLIDE_TRAIN_PER_STEP, False, "slide train")
    out["slide_step_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

    # cli.slide --train-epochs 2 --out, then the written file served again
    zero_counts()
    t0 = time.time()
    ft = tmp / "slide_finetuned.pt"
    res_ft = slide_cli.main([*base, "--ckpt", str(ckpt), "--train-epochs",
                             "2", "--out", str(ft), *SLIDE_DTYPE])
    res_back = slide_cli.main([*base, "--ckpt", str(ft), *SLIDE_DTYPE])
    torch.cuda.synchronize()
    counts = read_counts()
    for k, v in counts.items():
        paths["slide_train"][k] += v
    log(f"  cli.slide --train-epochs 2 --out: losses {res_ft['losses']}, "
        f"fine-tuned logits {res_ft['logits_finetuned'].tolist()}; served "
        f"from the written file {res_back['logits'].tolist()}; "
        f"{time.time() - t0:.1f} s wall, launches {counts}")
    if not (np.isfinite(res_ft["losses"]).all()
            and np.array_equal(res_ft["logits_finetuned"], res_back["logits"])):
        raise SystemExit("cli.slide fine-tune round trip")

    # ---- phase 10: the capacity path ----
    log("phase 10: capacity path (assign_tail_chunk=65536, remat_stage1)")
    cap_cfg = cfg.apply_overrides(SLIDE_CAPACITY)
    ch = pick_chunk(build.cap, cap_cfg.model.assign_tail_chunk)
    plan = chunk_plan(build.cap, ch)
    log(f"  chunk plan over {build.cap} rows: {plan}")
    if plan != (CAP_CHUNK, SLIDE_CAP // CAP_CHUNK, SLIDE_CAP % CAP_CHUNK) \
            or plan[1] != 1 or not plan[2]:
        raise SystemExit(f"chunk plan {plan}: not one full chunk and a "
                         "remainder")
    require_step(step_hold(model, cap_cfg, inputs, True, "capacity"),
                 "capacity")
    torch.cuda.reset_peak_memory_stats()
    paths["slide_capacity"], out["capacity_step_ms"] = train_steps(
        cap_cfg, SLIDE_CAP_STEPS, SLIDE_CAP_PER_STEP, True, "capacity")
    out["capacity_step_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del model, inputs, build
    torch.cuda.empty_cache()

    # ---- card against CPU: a small f32 slide, tables built by hand ----
    log("  card vs CPU: f32 slide of 8192 nuclei, the same tables on both")
    cfg32 = Config()
    f, c = synthetic_slide(SMALL_SLIDE_NUCLEI, seed=7)
    b = build_slide_inputs(cfg32, f, c, 1, device)
    tables = build_bsr_tables(b.part)
    cpu_in = prepare_mega_inputs(b.inputs.x.cpu().numpy(), b.part, "cpu",
                                 n_real=b.n, bsr=tables)
    m_gpu = slide_model(cfg32, ckpt, device)
    m_cpu = slide_model(cfg32, ckpt, "cpu")
    zero_counts()
    with torch.no_grad():
        lg = mega_forward(m_gpu, cfg32.model, b.inputs).cpu().numpy()
        lc = mega_forward(m_cpu, cfg32.model, cpu_in).numpy()
    loss_g, grads_g = slide_grads(m_gpu, cfg32, b.inputs, False)
    loss_c, grads_c = slide_grads(m_cpu, cfg32, cpu_in, False)
    counts = read_counts()
    log(f"  logits card {lg.tolist()} vs CPU {lc.tolist()} (atol "
        f"{LOGIT_ATOL}, rtol {LOGIT_RTOL}); loss {loss_g:.7f} vs "
        f"{loss_c:.7f}; card launches {counts}")
    if not (np.allclose(lg, lc, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
            and np.isclose(loss_g, loss_c, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)):
        raise SystemExit("small slide: card vs CPU")
    if counts["B8"] or not counts["B2"] or not counts["B4"]:
        raise SystemExit(f"small f32 slide: launches {counts}")
    grads_close("small slide step gradients, card vs CPU (GRAD_REL rule)",
                {n: g.cpu() for n, g in grads_g.items()}, grads_c, GRAD_REL)
    out["paths"] = paths
    return out


def stats_hold(p3, n3, lin9, n9) -> dict:
    """B3 (on ``p3``) and B9b (on ``lin9`` = (x3, kc3, b3)) against the
    exact statistics, beside the plain versions' f32 sums and the two
    witnesses; fails unless the kernels and witness (i) are within
    ``ah.STATS_TOL`` and witness (ii) is not. Returns the distances."""
    import torch
    from cgcnet_tpu_torch.ops import assign_head as ah

    x3, kc3, b3 = lin9
    tol = ah.STATS_TOL
    cases = {
        "B3": (ah.l2relu_stats_reference(p3, n3), {
            "kernel": lambda: ah.l2relu_stats(p3, n3),
            "plain": lambda: ah.l2relu_stats_plain(p3, n3),
            "witness (i): row norm as two half-row sums": lambda:
                ah.l2relu_stats_reference(p3, n3,
                                          rnorm=ah.rnorm_two_halves(p3)),
            "witness (ii): h summed without its rounding": lambda:
                ah.l2relu_stats_reference(p3, n3, round_h=False),
        }),
        "B9b": (ah.l2relu_stats_lin_reference(x3, kc3, b3, n9), {
            "kernel": lambda: ah.l2relu_stats_lin(x3, kc3, b3, n9),
            "plain": lambda: ah.l2relu_stats_lin_plain(x3, kc3, b3, n9),
            "witness (i): the dot summed in reverse order": lambda:
                ah.l2relu_stats_reference(ah.lin_p_reversed(x3, kc3, b3),
                                          n9),
            "witness (ii): p rounded once": lambda:
                ah.l2relu_stats_reference(
                    ah.lin_p_rounded_once(x3, kc3, b3), n9),
        }),
    }
    out = {}
    for key, (ref, runs) in cases.items():
        dist = {}
        for what, fn in runs.items():
            dist[what] = ah.stats_distance(fn(), ref)
            torch.cuda.empty_cache()
        kern, w1, w2 = (dist[k] for k in dist if k != "plain")
        ok = kern <= tol and w1 <= tol and w2 > tol
        log(f"  statistics hold {key} (bf16, {p3.shape[1]} rows): max over "
            f"columns of |stat - exact| / |exact|, tol {tol:.3e}: "
            + "; ".join(f"{k} {v:.3e}" for k, v in dist.items())
            + f" -> {'ok' if ok else 'FAIL'}")
        if not (w1 <= tol and w2 > tol):
            raise SystemExit(f"statistics hold {key}: the tolerance does not "
                             "separate the witnesses")
        if not kern <= tol:
            raise SystemExit(f"statistics hold {key}: the kernel's "
                             "statistics are off the exact ones")
        out[key] = dist
    return out


def slide_kernel_phase(seen: dict, device) -> tuple[list[dict], dict]:
    """B8, B9a, B9b, B3, B4 (with ``c_out``), B5 and the int8 B1/B2 legs
    against their plain versions on the card, in f32 and bf16, on the inputs
    captured from phases 8-10 (one per distinct call shape), timed like
    phase 3."""
    import numpy as np
    import torch
    from cgcnet_tpu_torch.config import Config
    from cgcnet_tpu_torch.dataflow import native
    from cgcnet_tpu_torch.ops import assign_head as ah
    from cgcnet_tpu_torch.ops import bsr
    from cgcnet_tpu_torch.parallel.mega_graph import (
        build_bsr_tables,
        partition_graph,
    )
    from cgcnet_tpu_torch.parallel.slide_setup import (
        spatial_sort_order,
        synthetic_slide,
    )

    t = bsr.TILE
    results = []

    def record(*args, **kwargs):
        # the slide's plain versions take 15-17 ms at 100k: fewer repeats
        kwargs.setdefault("paths", SLIDE_PATHS)
        record_kernel(results, *args, reps=10, plain_reps=3, **kwargs)

    def calls(key):
        return [v for (k, _, _), v in seen.items() if k == key]

    # ---- the statistics hold: B3 and B9b on the slide's own inputs ----
    (p3, n3), _ = calls("B3")[0]
    (x3h, kc3h, b3h, n9h), _ = calls("B9b")[0]
    if p3.dtype != torch.bfloat16 or x3h.dtype != torch.bfloat16:
        raise SystemExit("statistics hold: the slide's inputs are not bf16")
    stats = stats_hold(p3, n3, (x3h, kc3h, b3h), n9h)

    b8_calls = calls("B8")
    names = []
    for args, kw in b8_calls:
        x = args[3]
        if kw.get("acc") is not None:
            names.append(f"A^T g + acc (split outputs) F={x.shape[-1]}")
        elif kw.get("halo") is not None:
            names.append(f"A@S F={x.shape[-1]}")
        else:
            names.append(f"A^T g F={x.shape[-1]}")
    log(f"  captured B8 calls: {names}")
    if not any("acc" in n for n in names) or len(b8_calls) < 3:
        raise SystemExit(f"B8 calls captured: {names}")

    # the halo-window variant: shard 0 of a 4-shard stripe-sorted partition
    cfg = Config()
    shards = HALO_SHARDS
    f0, c0 = synthetic_slide(HALO_NUCLEI)
    q = t * bsr.G_BAND * shards
    cap = -(-HALO_NUCLEI // q) * q
    order = spatial_sort_order(c0, cfg.data.max_edge_distance, stripes=shards,
                               shard_rows=cap // shards)
    nbr, mask = native.radius_knn(c0[order], cfg.data.max_edge_distance,
                                  cfg.data.max_neighbours)
    nbrp = np.tile(np.arange(cap, dtype=np.int32)[:, None], (1, nbr.shape[1]))
    maskp = np.zeros((cap, nbr.shape[1]), np.float32)
    nbrp[:len(nbr)], maskp[:len(nbr)] = nbr, mask
    part = partition_graph(nbrp, maskp, shards)
    tab = build_bsr_tables(part)
    if tab is None or tab.win_halo is None:
        raise SystemExit("the 4-shard partition built no halo-window table")
    ns = cap // shards
    nb0 = torch.as_tensor(part.nbr_remap[0], device=device)
    off0 = torch.as_tensor(part.nbr_mask[0], device=device) * (
        nb0 != torch.arange(ns, device=device)[:, None])
    bc0 = torch.as_tensor(tab.blk_cols[0], device=device)
    bm0 = torch.as_tensor(tab.blk_mask[0], device=device)
    vals0 = bsr.bsr_build_blocks(nb0[None], off0[None], bc0[None], bm0[None],
                                 torch.int8)
    gen = torch.Generator(device=device).manual_seed(11)
    f_s = HALO_F
    x_h = torch.randn((1, ns, f_s), generator=gen, device=device)
    halo_h = torch.randn((1, tab.nc - ns, f_s), generator=gen, device=device)
    log(f"  halo windows: shard 0 of {shards}, {ns} rows, halo "
        f"{tab.nc - ns} rows, M {tab.blk_cols.shape[-1]}")
    b8_cases = [(n, a, k) for n, (a, k) in zip(names, b8_calls)]
    # the window contract held once for these tables, as the slide path
    # holds it once per slide (mega_model.check_windows); the launches then
    # skip the per-call check, as the path's do
    win0 = torch.as_tensor(tab.win_base[0:1], device=device)
    hwin0 = torch.as_tensor(tab.win_halo[0:1], device=device)
    bsr.check_band_windows(bc0[None], bm0[None] > 0, win0, ns,
                           (tab.nc - ns) // t, hwin0)
    b8_cases.append((
        f"A@S halo windows (shard 0 of {shards}) F={f_s}",
        [vals0, bc0[None], win0, x_h],
        {"ns_rows": ns, "halo": halo_h, "halo_win": hwin0,
         "check_windows": False,
         "live_slots": bsr.live_slot_counts(bm0[None])},
    ))
    # the epilogue option, on the training A@S leg's inputs
    base_args, base_kw = next((a, k) for n, (a, k) in zip(names, b8_calls)
                              if n.startswith("A@S F=1152"))
    r_rows = base_args[1].shape[1] * t
    sw = torch.zeros((1, r_rows, 128), device=device)
    sw[0, :, 0] = torch.rand(r_rows, generator=gen, device=device)
    sw[0, :, 1] = 0.4
    b8_cases.append(("A@S + epilogue_sw F=1152", base_args,
                     {**base_kw, "epilogue_sw": sw}))

    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        isz = torch.empty((), dtype=dt).element_size()
        tag = "f32" if dt == torch.float32 else "bf16"
        # ---- B8 ----
        for name, args, kw in b8_cases:
            vals, blk_cols, win, x = args
            x = x.to(dt)
            kw = {k: (v.to(dt) if k in ("halo", "acc", "epilogue_sw")
                      and v is not None else v) for k, v in kw.items()}
            a = (vals, blk_cols, win, x)
            out = bsr.bsr_matmul_banded(*a, **kw)
            ref = bsr.bsr_matmul_banded_plain(*a, **kw)
            bm = kw.get("blk_mask")
            live = (bm > 0) if bm is not None else vals.reshape(
                *vals.shape[:3], -1).ne(0).any(-1)
            nnzb = int(live.sum().item())
            _, r, m = blk_cols.shape
            f = x.shape[-1]
            nh = kw["halo"].shape[1] if kw.get("halo") is not None else 0
            extra = sum(kw[k].numel() * isz for k in ("acc", "epilogue_sw")
                        if kw.get(k) is not None)
            record(
                f"B8 bsr_matmul_banded {name} {tag} R={r} M={m}", "B8",
                dt_name, out, ref,
                lambda a=a, kw=kw: bsr.bsr_matmul_banded(*a, **kw),
                lambda a=a, kw=kw: bsr.bsr_matmul_banded_plain(*a, **kw),
                # real block slots (int8), their column ids, x and the halo
                # read once, the output written once, acc / sw read once
                bytes_=nnzb * t * t + r * m * 4 + (x.shape[1] + nh) * f * isz
                + r * t * f * isz + extra,
                ops=2 * nnzb * t * t * f,
                library=lambda a=a, kw=kw, live=live:
                    _banded_library_call(*a, kw.get("halo"), live),
                source="cgcnet_tpu_torch/csrc/bsr_banded.cu",
                replaces=("cgcnet_tpu/ops/pallas/bsr_kernel.py:966 (:1097 "
                          "_banded_halo_kernel)" if "halo windows" in name
                          else "cgcnet_tpu/ops/pallas/bsr_kernel.py:966 "
                          "(:1181 _banded_kernel)"),
                # the halo-window kernel (:1097) runs at more than one
                # shard only: no path of this run launches it
                paths=() if "halo windows" in name else SLIDE_PATHS,
            )
        # ---- B3, B4 (serving, and training's lane-padded c_out) and B5
        # (the training call and the capacity path's chunks) at the slide's
        # shapes ----
        for (p, nn3), _ in calls("B3"):
            p = p.to(dt)
            b, n, c = p.shape
            rr = int(nn3.sum().item())
            record(
                f"B3 l2relu_stats slide {tag} N={n} C={c}", "B3", dt_name,
                torch.stack(ah.l2relu_stats(p, nn3)),
                torch.stack(ah.l2relu_stats_plain(p, nn3)),
                lambda p=p, nn3=nn3: ah.l2relu_stats(p, nn3),
                lambda p=p, nn3=nn3: ah.l2relu_stats_plain(p, nn3),
                bytes_=rr * c * isz + b * 4 + 2 * c * 4,
                ops=6 * rr * c, ops_dt="float32",
                source="cgcnet_tpu_torch/csrc/assign_tail.cu",
                replaces="cgcnet_tpu/ops/pallas/assign_head.py:180",
            )
        for i4, (args, _) in enumerate(calls("B4")):
            x12, p, k12, k3f, const, nn4 = args[:6]
            c_out = args[6] if len(args) > 6 else None
            h4 = (x12.to(dt), p.to(dt), k12, k3f, const, nn4, c_out)
            b, n, c = p.shape
            f12 = x12.shape[-1]
            co = c_out or c
            rr = int(nn4.sum().item())
            out, _ = ah.assign_head_softmax_pre(*h4)
            if out.shape[-1] != co or out[..., c:].any():
                raise SystemExit(f"B4 c_out={c_out}: pad columns are not "
                                 "exact zeros")
            extra = {"product_library_ms": product_library_ms(
                b * n, f12 + c, c, dt, device)}
            if i4 == 0:  # the split of one call (the first: serving)
                extra["split_ms"] = head_split(
                    lambda h4=h4: ah.assign_head_softmax_pre(*h4))
            record(
                f"B4 assign_head_softmax_pre slide {tag} N={n} F12={f12} "
                f"C={c} c_out={co}", "B4", dt_name, out,
                ah.assign_head_softmax_pre_plain(*h4)[0],
                lambda h4=h4: ah.assign_head_softmax_pre(*h4),
                lambda h4=h4: ah.assign_head_softmax_pre_plain(*h4),
                bytes_=rr * (f12 + c) * isz + (f12 + c) * c * isz + c * 4
                + b * n * co * isz,
                ops=2 * rr * (f12 + c) * c,
                source="cgcnet_tpu_torch/csrc/assign_head.cu",
                replaces="cgcnet_tpu/ops/pallas/assign_head.py:286",
                extra=extra,
            )
        for (p, dh, u, w, nn5), _ in calls("B5"):
            a5 = (p.to(dt), dh.to(dt), u, w, nn5)
            b, n, c = p.shape
            rr = int(nn5.sum().item())
            out = ah.assign_tail_bwd(*a5)
            if out[:, rr:].any():
                raise SystemExit("B5: rows past n_nodes are not exactly 0")
            record(
                f"B5 assign_tail_bwd slide {tag} N={n} C={c}", "B5", dt_name,
                out, ah.assign_tail_bwd_plain(*a5),
                lambda a5=a5: ah.assign_tail_bwd(*a5),
                lambda a5=a5: ah.assign_tail_bwd_plain(*a5),
                bytes_=(2 * rr + b * n) * c * isz + 2 * c * 4 + b * 4,
                ops=10 * rr * c, ops_dt="float32",
                source="cgcnet_tpu_torch/csrc/assign_tail.cu",
                replaces="cgcnet_tpu/ops/pallas/assign_head.py:423",
            )
        # ---- B9a, B9b: the capacity forward's full-slide calls ----
        (x12, x3, kc3, b3, k12, k3f, const, n_nodes), _ = max(
            calls("B9a"), key=lambda v: v[0][1].shape[1])
        n, f3, c = x3.shape[1], x3.shape[2], kc3.shape[1]
        f12 = x12.shape[-1]
        rows_real = int(n_nodes.sum().item())
        a9 = (x12.to(dt), x3.to(dt), kc3, b3, k12, k3f, const, n_nodes)
        record(
            f"B9a assign_head_softmax_pre_lin {tag} N={n} F12={f12} F3={f3} "
            f"C={c}", "B9a", dt_name,
            ah.assign_head_softmax_pre_lin(*a9),
            ah.assign_head_softmax_pre_lin_plain(*a9),
            lambda: ah.assign_head_softmax_pre_lin(*a9),
            lambda: ah.assign_head_softmax_pre_lin_plain(*a9),
            bytes_=rows_real * (f12 + f3) * isz
            + (f3 + 1 + f12 + c) * c * isz + c * 4 + n * c * isz,
            ops=2 * rows_real * c * (f3 + f12 + c),
            source="cgcnet_tpu_torch/csrc/assign_head.cu",
            replaces="cgcnet_tpu/ops/pallas/assign_head.py:882",
            extra={"product_library_ms": product_library_ms(
                n, f12 + c, c, dt, device),
                "split_ms": head_split(
                    lambda: ah.assign_head_softmax_pre_lin(*a9))},
        )
        (x3b, kc3b, b3b, nnb), _ = calls("B9b")[0]
        a9b = (x3b.to(dt), kc3b, b3b, nnb)
        record(
            f"B9b l2relu_stats_lin {tag} N={n} F3={f3} C={c}", "B9b", dt_name,
            torch.stack(ah.l2relu_stats_lin(*a9b)),
            torch.stack(ah.l2relu_stats_lin_plain(*a9b)),
            lambda: ah.l2relu_stats_lin(*a9b),
            lambda: ah.l2relu_stats_lin_plain(*a9b),
            bytes_=rows_real * f3 * isz + (f3 + 1) * c * isz + 2 * c * 4,
            # p formed per element (the F3-term dot, on the tensor cores in
            # bf16), then the row norm and the sums (6 operations an
            # element) on the f32 CUDA cores
            ops={dt_name: 2 * rows_real * c * f3, "float32": 6 * rows_real * c},
            source="cgcnet_tpu_torch/csrc/assign_tail.cu",
            replaces="cgcnet_tpu/ops/pallas/assign_head.py:943",
        )
        # ---- int8 B1: the forward and transpose blocks of the slide ----
        for (nbr_, w_, bc_, bm_, _dt), _ in calls("B1"):
            bb, nn_, k = nbr_.shape
            r, m = bc_.shape[1:]
            a1 = (nbr_, w_, bc_, bm_, torch.int8)
            which = "A" if nn_ == SLIDE_CAP else "A^T"
            record(
                f"B1 bsr_build_blocks int8 {which} (x {tag} slide) N={nn_} "
                f"K={k} M={m}", "B1", dt_name,
                bsr.bsr_build_blocks(*a1), bsr.bsr_build_blocks_plain(*a1),
                lambda a1=a1: bsr.bsr_build_blocks(*a1),
                lambda a1=a1: bsr.bsr_build_blocks_plain(*a1),
                bytes_=nn_ * k * 8 + r * m * 8 + r * m * t * t,
                ops=nn_ * k, ops_dt="float32",
                source="cgcnet_tpu_torch/csrc/bsr_build.cu",
                replaces="cgcnet_tpu/ops/pallas/bsr_kernel.py:275",
            )
        # ---- int8 B2: every width and direction of the slide's legs ----
        for (vals, bc_, x_, slots), _ in calls("B2"):
            x = x_.to(dt)
            _, r, m = bc_.shape
            nc, f = x.shape[1], x.shape[2]
            live = vals.reshape(*vals.shape[:3], -1).ne(0).any(-1)
            nnzb = int(live.sum().item())
            walked = int(slots.sum().item())
            which = "A" if r * t == SLIDE_CAP else "A^T"
            record(
                f"B2 bsr_matmul int8 {which} {tag} N={nc} M={m} live slots "
                f"{walked} of {r * m} F={f}", "B2",
                dt_name, bsr.bsr_matmul(vals, bc_, x, slots),
                bsr.bsr_matmul_plain(vals, bc_, x, slots),
                lambda x=x, v=vals, c_=bc_, s_=slots:
                    bsr.bsr_matmul(v, c_, x, s_),
                lambda x=x, v=vals, c_=bc_: bsr.bsr_matmul_plain(v, c_, x),
                bytes_=nnzb * t * t + r * m * 4 + nc * f * isz
                + r * t * f * isz,
                ops=2 * nnzb * t * t * f,
                library=lambda x=x, v=vals, c_=bc_, live=live:
                    _bsr_library_call(v.to(x.dtype), c_, live.float(), x),
                source="cgcnet_tpu_torch/csrc/bsr_matmul.cu",
                replaces="cgcnet_tpu/ops/pallas/bsr_kernel.py:400",
            )
    return results, stats


def _banded_library_call(vals, blk_cols, win, x, halo, live):
    """One PyTorch call computing B8's function: ``torch.sparse_bsr_tensor``
    over the live block slots (values converted to x's type once, not
    timed) times [x ++ halo] (concatenated once, not timed). A yardstick;
    the port never calls it."""
    import torch

    xx = x[0] if halo is None else torch.cat([x[0], halo[0]], dim=0)
    keep = live.reshape(-1)
    _, r, m = blk_cols.shape
    t = vals.shape[-1]
    counts = live.reshape(r, m).sum(-1)
    crow = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(
        torch.int64)
    a = torch.sparse_bsr_tensor(
        crow, blk_cols.reshape(-1)[keep].to(torch.int64),
        vals.reshape(r * m, t, t)[keep].to(x.dtype),
        size=(r * t, xx.shape[0]),
    )
    return lambda: a @ xx


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
    del graph
    torch.cuda.empty_cache()

    slide_seen: dict = {}
    slide = slide_phases(tmp, device, tmp / "model_SAGE.pt", slide_seen)
    paths.update(slide.pop("paths"))
    log("  slide kernels vs plain versions (inputs of phases 8-10)")
    slide_kernels, stats = slide_kernel_phase(slide_seen, device)
    kernels += slide_kernels
    for entry in kernels:
        key = entry.pop("key")
        by_path = {name: paths[name][key] for name in entry.pop("paths")}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        if by_path and entry["launches"] == 0:
            raise SystemExit(f"{entry['name']}: no launch on any path")
    return {**slide, "kernels": kernels, "stats_hold": stats,
            "forward_ms_per_batch": fwd_ms,
            "predict_wall_s": wall, "train_step_ms": train["step_ms"],
            "train_steps": train["steps"], "train_cli_wall_s": train["cli_wall_s"],
            "gin_forward_ms_per_batch": gin_fwd_ms, "gin_predict_wall_s": gin_wall,
            "gin_train_step_ms": gin_train["step_ms"],
            "gin_train_steps": gin_train["steps"],
            "gin_train_cli_wall_s": gin_train["cli_wall_s"]}


# the tensor-core kernels whose compiler report phase 2 must hold
TC_KERNELS = ("banded_tc_kernel", "gemm_tc_kernel", "bsr_matmul_tc_kernel")


def tc_report(build_log: str) -> None:
    """Registers and spills of every instantiation of TC_KERNELS from the
    compiler's ``-Xptxas -v`` report; fails when one has no entry."""
    lines = build_log.splitlines()
    for name in TC_KERNELS:
        found = []
        for i, line in enumerate(lines):
            if "Compiling entry" not in line or name not in line:
                continue
            spill = regs = "?"
            for nxt in lines[i + 1:i + 5]:
                if "spill" in nxt:  # "... N bytes spill stores, M bytes ..."
                    w = nxt.replace(",", " ").split()
                    spill = "/".join(w[j - 2] for j, t in enumerate(w)
                                     if t == "spill")
                if "Used" in nxt and "registers" in nxt:
                    regs = nxt.split("Used")[1].split("registers")[0].strip()
            found.append(f"{regs} regs, spill bytes {spill}")
        if not found:
            raise SystemExit(f"phase 2: no compiler report for {name}")
        log(f"  {name}: {len(found)} instantiations: " + "; ".join(found))
    # ptxas's note when it has to wait for each product before the next
    serial = [ln for ln in lines if "C7515" in ln]
    log(f"  products serialized by the compiler: {len(serial)} functions"
        + "".join(f"\n    {ln.strip()[:200]}" for ln in serial[:4]))


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
    build_log = (_cuda.BUILD_DIR / "build.log").read_text()
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  " + line.strip())
    tc_report(build_log)

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
