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
   that one canonical training step gives them (captured), in f32 and bf16,
   each held against its plain PyTorch version on the same CUDA tensors,
   with CUDA-event timings of kernel, plain version and (B2) one PyTorch
   library call;
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
   gradients on the card against the CPU plain path.

The second-to-last lines are one JSON object of per-kernel numbers and the
nvidia-smi line; the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX.
"""

from __future__ import annotations

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
# order (exact); the others sum in another order — f32: B2 1e-4 (the JAX
# suite's), B3 1e-5 (column sums of 23040 rows), B4 1e-5 (1180-term f32
# dots, then exp), B5 1e-4 (1140-term row dot feeding a difference); bf16:
# the two roundings of a stored value may land one bf16 step apart, and a
# step is up to 2^-7 of the value, so 2^-6
TOL = {
    ("B1", "float32"): 0.0, ("B1", "bfloat16"): 0.0,
    ("B2", "float32"): 1e-4, ("B2", "bfloat16"): 2.0 ** -6,
    ("B3", "float32"): 1e-5, ("B3", "bfloat16"): 2.0 ** -6,
    ("B4", "float32"): 1e-5, ("B4", "bfloat16"): 2.0 ** -6,
    ("B5", "float32"): 1e-4, ("B5", "bfloat16"): 2.0 ** -6,
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
# synthetic patches of 9000..11404 nuclei, sampled at ratio 0.5, fill the
# canonical capacity: batches of B=4 graphs padded to N=5760, C=1140 clusters
DATA_NODES = (9000, 11404)
CANONICAL = {"B": 4, "N": 5760, "C": 1140}
TRAIN_EPOCHS = 2        # of 6 batches each (24 training patches, drop_last)
TRAIN_PER_STEP = {"B1": 2, "B2": 7, "B3": 1, "B4": 1, "B5": 1}
SERVE_PER_BATCH = {"B1": 1, "B2": 4, "B4": 1}


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
            "B5": ah.assign_tail_bwd}


def zero_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in wrappers().items()}


def grads_of(model, graph) -> tuple[float, dict]:
    """(loss, {name: grad}) of one training-mode forward + backward."""
    from cgcnet_tpu_torch.nn.model import cross_entropy_loss

    model.train()
    model.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(model(graph), graph.y)
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}


def capture_inputs(model, graph) -> dict:
    """Run one training step's forward and backward with shims in front of
    the five kernel wrappers and keep (clones of) the arguments each one is
    given, in call order."""
    import torch
    from cgcnet_tpu_torch.nn import model as model_mod
    from cgcnet_tpu_torch.ops import assign_head as ah
    from cgcnet_tpu_torch.ops import ell

    seen: dict[str, list] = {k: [] for k in TRAIN_PER_STEP}
    sites = [(model_mod, "bsr_build_blocks", "B1"), (ell, "bsr_matmul", "B2"),
             (ah, "l2relu_stats", "B3"), (ah, "assign_head_softmax_pre", "B4"),
             (ah, "assign_tail_bwd", "B5")]
    originals = [getattr(mod, name) for mod, name, _ in sites]
    for (mod, name, key), orig in zip(sites, originals):
        def shim(*args, _orig=orig, _key=key):
            seen[_key].append(
                [a.detach().clone() if isinstance(a, torch.Tensor) else a
                 for a in args]
            )
            return _orig(*args)
        # a wrapper counts its launches through its module's global name,
        # which is the shim for the duration of the capture
        shim.launches = 0
        setattr(mod, name, shim)
    try:
        grads_of(model, graph)
    finally:
        for (mod, name, _), orig in zip(sites, originals):
            setattr(mod, name, orig)
    model.zero_grad(set_to_none=True)
    return seen


def kernel_phase(seen: dict) -> list[dict]:
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
    return results


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


def serve_phase(tmp: Path, device, overrides, cfg, graph,
                n_patches: int) -> tuple[dict, float, float]:
    """Phase 4: cli.predict on the card with the launch counters read."""
    import numpy as np
    import torch
    from cgcnet_tpu_torch.cli import predict
    from cgcnet_tpu_torch.nn.model import CGCNet
    from cgcnet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    ckpt = save_checkpoint(
        tmp / "model.pt",
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
    log(f"  predict: {wall:.2f} s wall, {n_batches} batches, result {result}, "
        f"launches {counts}")
    want = {k: (SERVE_PER_BATCH.get(k, 0) * n_batches) for k in counts}
    if counts != want:
        raise SystemExit(f"launch counts {counts} != 1/4/1 x {n_batches} batches")
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
    log(f"  forward latency per batch (x {tuple(graph.x.shape)}, "
        f"{cfg.model.compute_dtype}): {fwd_ms:.3f} ms (median of 10, CUDA events)")
    return counts, fwd_ms, wall


def train_phase(tmp: Path, device, overrides, cfg, graph) -> dict:
    """Phase 5: optimizer steps through train.loop with the launch counters
    read per step, one cli.train.main epoch, card vs CPU gradients."""
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
    step_ms, losses, totals = [], [], {k: 0 for k in TRAIN_PER_STEP}
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
            if counts != TRAIN_PER_STEP:
                raise SystemExit(
                    f"step {state.step}: launches {counts} != {TRAIN_PER_STEP}")
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
    log(f"  {state.step} train steps (x {tuple(graph.x.shape)}, "
        f"{cfg.model.compute_dtype}): launches per step {TRAIN_PER_STEP}, "
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
    if counts["B3"] != steps or counts["B5"] != steps:
        raise SystemExit(f"cli.train launched B3/B5 {counts}, not {steps} steps")
    if (kinds.count("train") != steps // 2 or kinds.count("epoch") != 1
            or kinds.count("val") != steps // 3 + 1):
        raise SystemExit(f"metrics.jsonl records {kinds}")
    for name in ("weight.pt", "model_best.pt"):
        if not (run_dir / name).is_file():
            raise SystemExit(f"cli.train wrote no {name}")
    if not {"img_acc", "binary_acc", "patch_acc"} <= set(result):
        raise SystemExit(f"summary keys missing: {result}")

    # one step on the card and on the CPU plain path: same weights and
    # batch, dropout off (CPU and CUDA generators differ)
    cfg0 = cfg.apply_overrides(["model.drop_out=0.0"])
    gpu = create_train_state(cfg0, device, seed=7).model
    cpu = create_train_state(cfg0, "cpu", seed=7).model
    loss_gpu, g_gpu = grads_of(gpu, graph)
    t0 = time.time()
    loss_cpu, g_cpu = grads_of(cpu, graph.to("cpu"))
    cpu_s = time.time() - t0
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in g_cpu.values())
    worst, worst_name = 0.0, ""
    for name, gc in g_cpu.items():
        ratio = ((g_gpu[name].cpu() - gc).abs().max()
                 / (GRAD_REL * gc.abs().max() + floor)).item()
        if ratio > worst:
            worst, worst_name = ratio, name
    log(f"  card vs CPU train step: loss {loss_gpu:.7f} vs {loss_cpu:.7f}; "
        f"worst gradient {worst_name} at {worst:.3f} of its tolerance "
        f"({GRAD_REL} x max|grad| + {floor:.3e}); CPU step {cpu_s:.1f} s")
    if not np.isclose(loss_gpu, loss_cpu, atol=LOGIT_ATOL, rtol=LOGIT_RTOL):
        raise SystemExit(f"card loss {loss_gpu} != CPU {loss_cpu}")
    if not worst <= 1.0:
        raise SystemExit(f"gradient {worst_name} card vs CPU out of tolerance")
    return {"counts": totals, "step_ms": median_ms, "steps": state.step,
            "cli_wall_s": cli_s}


def slice_phase(tmp: Path, device) -> dict:
    import torch
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.train.state import create_train_state

    t0 = time.time()
    overrides, cfg = make_data(tmp)
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
    c = seen["B4"][0][1].shape[-1]
    calls = {k: len(v) for k, v in seen.items()}
    if c != CANONICAL["C"] or calls != TRAIN_PER_STEP:
        raise SystemExit(f"unexpected kernel calls: C={c}, {calls}")

    log("phase 3: kernels vs plain versions (canonical shapes)")
    kernels = kernel_phase(seen)
    del seen
    torch.cuda.empty_cache()

    log("phase 4: serving slice (cli.predict on the card, --reps 2)")
    serve_counts, fwd_ms, wall = serve_phase(tmp, device, overrides, cfg, graph,
                                           len(valid))

    log("phase 5: training slice (train.loop, cli.train, card vs CPU)")
    train = train_phase(tmp, device, overrides, cfg, graph)
    for entry in kernels:
        key = entry.pop("key")
        by_path = {"serve": serve_counts[key], "train": train["counts"][key]}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
    return {"kernels": kernels, "forward_ms_per_batch": fwd_ms,
            "predict_wall_s": wall, "train_step_ms": train["step_ms"],
            "train_steps": train["steps"], "train_cli_wall_s": train["cli_wall_s"]}


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
