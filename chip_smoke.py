#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cgcnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each fatal on failure (exit code != 0):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build of the hand-written kernels from ``cgcnet_tpu_torch/csrc`` (nvcc);
3. kernels: B1 (block build), B2 (block-sparse matmul, at every width the
   serving path gives it) and B4 (fused assign head) on the inputs that one
   canonical forward gives them (captured), in f32 and bf16, each held
   against its plain PyTorch version on the same CUDA tensors, with CUDA-event
   timings of kernel, plain version and (B2) one PyTorch library call;
4. serving slice: a synthetic dataset whose sampled graphs fill the
   canonical capacity (B=4, N=5760, C=1140), a seeded canonical CGCNet saved
   in the port's checkpoint format, ``cli.predict.main`` on the card with
   ``--reps 2`` while the launch counters are read (B1 = 1, B2 = 4, B4 = 1
   per batch), one batch recomputed on the CPU through the plain versions,
   and the per-batch forward latency.

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
# order (exact); B2 and B4 sum in another order — f32: B2 1e-4 (the JAX
# suite's), B4 1e-5 (1180-term f32 dots, then exp); bf16: the two roundings
# of the stored result may land one bf16 step apart, and a step is up to
# 2^-7 of the value, so 2^-6
TOL = {
    ("B1", "float32"): 0.0, ("B1", "bfloat16"): 0.0,
    ("B2", "float32"): 1e-4, ("B2", "bfloat16"): 2.0 ** -6,
    ("B4", "float32"): 1e-5, ("B4", "bfloat16"): 2.0 ** -6,
}
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-3   # whole model, card vs CPU, f32
# synthetic patches of 9000..11404 nuclei, sampled at ratio 0.5, fill the
# canonical capacity: batches of B=4 graphs padded to N=5760, C=1140 clusters
DATA_NODES = (9000, 11404)
CANONICAL = {"B": 4, "N": 5760, "C": 1140}


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


def capture_inputs(model, graph) -> dict:
    """Run one forward with shims in front of the three kernel wrappers and
    keep (clones of) the arguments each one is given."""
    import torch
    from cgcnet_tpu_torch.nn import blocks, model as model_mod
    from cgcnet_tpu_torch.ops import ell

    seen: dict[str, list] = {"B1": [], "B2": [], "B4": []}
    sites = [(model_mod, "bsr_build_blocks", "B1"), (ell, "bsr_matmul", "B2"),
             (blocks, "assign_head_softmax_pre", "B4")]
    originals = [getattr(mod, name) for mod, name, _ in sites]
    for (mod, name, key), orig in zip(sites, originals):
        def shim(*args, _orig=orig, _key=key):
            seen[_key].append(
                [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
            )
            return _orig(*args)
        setattr(mod, name, shim)
    try:
        with torch.inference_mode():
            model(graph)
    finally:
        for (mod, name, _), orig in zip(sites, originals):
            setattr(mod, name, orig)
    return seen


def kernel_phase(seen: dict) -> list[dict]:
    import torch
    from cgcnet_tpu_torch.ops import assign_head as ah
    from cgcnet_tpu_torch.ops import bsr

    t = bsr.TILE
    nbr, w, blk_cols, blk_mask, _ = seen["B1"][0]
    b, n, k = nbr.shape
    r, m = blk_cols.shape[1:]
    nnzb = int(blk_mask.sum().item())
    rows_real = int(seen["B4"][0][5].sum().item())
    results = []

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
        # ---- B1 ----
        args = (nbr, w, blk_cols, blk_mask, dt)
        out = bsr.bsr_build_blocks(*args)
        ref = bsr.bsr_build_blocks_plain(*args)
        record(
            f"B1 bsr_build_blocks {tag} B={b} N={n} K={k} M={m}", "B1", dt_name,
            out, ref, lambda: bsr.bsr_build_blocks(*args),
            lambda: bsr.bsr_build_blocks_plain(*args),
            bytes_=b * n * k * 8 + b * r * m * 8 + b * r * m * t * t * isz,
            ops=2 * b * r * m * t * t * k, ops_dt="float32",
            source="cgcnet_tpu_torch/csrc/bsr_build.cu",
            replaces="cgcnet_tpu/ops/pallas/bsr_kernel.py:275",
        )
        vals = out
        # ---- B2, at every width the serving path gives it ----
        widths = []
        for v_, c_, x_ in seen["B2"]:
            if x_.shape[-1] not in widths:
                widths.append(x_.shape[-1])
                x = x_.to(dt)
                nc, f = x.shape[1], x.shape[2]
                out = bsr.bsr_matmul(vals, blk_cols, x)
                ref = bsr.bsr_matmul_plain(vals, blk_cols, x)
                record(
                    f"B2 bsr_matmul {tag} B={b} N={n} M={m} F={f}", "B2",
                    dt_name, out, ref,
                    lambda x=x: bsr.bsr_matmul(vals, blk_cols, x),
                    lambda x=x: bsr.bsr_matmul_plain(vals, blk_cols, x),
                    bytes_=nnzb * t * t * isz + b * r * m * 4
                    + b * nc * f * isz + b * r * t * f * isz,
                    ops=2 * nnzb * t * t * f,
                    library=lambda x=x: _bsr_library_call(
                        vals, blk_cols, blk_mask, x),
                    source="cgcnet_tpu_torch/csrc/bsr_matmul.cu",
                    replaces="cgcnet_tpu/ops/pallas/bsr_kernel.py:400",
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


def slice_phase(tmp: Path, device) -> tuple[dict, float, float]:
    import numpy as np
    import torch
    from cgcnet_tpu_torch.cli import predict
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.dataflow.synthetic import generate_dataset
    from cgcnet_tpu_torch.nn.model import CGCNet
    from cgcnet_tpu_torch.ops import assign_head, bsr
    from cgcnet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    root = tmp / "data"
    t0 = time.time()
    generate_dataset(str(root), patches_per_image=2, images_per_grade=2,
                     n_nodes=DATA_NODES, seed=0)
    overrides = [f"data.root={root}", "data.num_workers=4",
                 f"data.max_num_nodes={DATA_NODES[1]}"]
    cfg = predict.serving_config(overrides)
    ckpt = save_checkpoint(
        tmp / "model.pt",
        CGCNet(cfg.model, torch.Generator().manual_seed(1234)).state_dict(),
        cfg, {"origin": "chip_smoke random init, seed 1234"},
    )
    log(f"  dataset + checkpoint: {time.time() - t0:.1f} s")

    # one canonical batch and the kernel inputs its forward produces
    ds = NucleiGraphDataset(cfg.data, "valid")
    state_dict = load_checkpoint(ckpt)[0]
    model = predict.build_model(cfg, state_dict, device)
    loader = GraphLoader(ds, cfg.data.batch_size, device=device, shuffle=False,
                         num_workers=4)
    graph = next(iter(loader.epoch(0)))
    log(f"  batch: x {tuple(graph.x.shape)}, n_nodes {graph.n_nodes.tolist()}, "
        f"blk_cols {tuple(graph.blk_cols.shape)}")
    if tuple(graph.x.shape[:2]) != (CANONICAL["B"], CANONICAL["N"]):
        raise SystemExit(f"batch is not the canonical {CANONICAL}: {graph.x.shape}")
    seen = capture_inputs(model, graph)
    c = seen["B4"][0][1].shape[-1]
    if c != CANONICAL["C"] or len(seen["B1"]) != 1 or len(seen["B2"]) != 4:
        raise SystemExit(f"unexpected kernel calls: C={c}, "
                         f"{ {k: len(v) for k, v in seen.items()} }")

    log("phase 3: kernels vs plain versions (canonical shapes)")
    kernels = kernel_phase(seen)
    del seen

    log("phase 4: serving slice (cli.predict on the card, --reps 2)")
    wrappers = {"B1": bsr.bsr_build_blocks, "B2": bsr.bsr_matmul,
                "B4": assign_head.assign_head_softmax_pre}
    for fn in wrappers.values():
        fn.launches = 0
    out_path = tmp / "pred.jsonl"
    t0 = time.time()
    cpu_flag = ["--cpu"] if device.type == "cpu" else []
    result = predict.main([*cpu_flag, "--ckpt", str(ckpt), "--reps", "2",
                           "--out", str(out_path), *overrides])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {k: fn.launches for k, fn in wrappers.items()}
    n_batches = 2 * -(-len(ds) // cfg.data.batch_size)
    log(f"  predict: {wall:.2f} s wall, {n_batches} batches, result {result}, "
        f"launches {counts}")
    if counts != {"B1": n_batches, "B2": 4 * n_batches, "B4": n_batches}:
        raise SystemExit(f"launch counts {counts} != 1/4/1 x {n_batches} batches")
    if not {"img_acc", "binary_acc", "patch_acc"} <= set(result):
        raise SystemExit(f"summary keys missing: {result}")
    recs = [json.loads(line) for line in out_path.read_text().splitlines()]
    patches = [r for r in recs if "patch" in r]
    if len(patches) != len(ds) or not all(
        len(r["logits"]) == 3 and np.isfinite(r["logits"]).all() for r in patches
    ):
        raise SystemExit("predictions are missing or not finite")
    for entry in kernels:
        entry["launches"] = counts[entry.pop("key")]

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
    return {"kernels": kernels}, fwd_ms, wall


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
        numbers, fwd_ms, wall = slice_phase(Path(tmp), device)
    numbers["forward_ms_per_batch"] = fwd_ms
    numbers["predict_wall_s"] = wall
    print(json.dumps(numbers))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
