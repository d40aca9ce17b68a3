#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's canonical eval forward, or
of one canonical training step, on the patch path or on a whole slide.

    python3 scripts/profile_torch_forward.py [--steps 5]           # forward
    python3 scripts/profile_torch_forward.py --train [--steps 5]   # train step
    python3 scripts/profile_torch_forward.py --train model.gcn_name=GIN
    python3 scripts/profile_torch_forward.py --slide               # mega_forward
    python3 scripts/profile_torch_forward.py --slide --train       # slide step
    python3 scripts/profile_torch_forward.py --slide --train --capacity

Needs one GPU. The patch path: the same synthetic canonical batch and
seeded model as ``chip_smoke.py`` (B=4 graphs padded to N=5760, C=1140,
f32; config overrides such as ``model.gcn_name=GIN`` select another model),
a few forwards (or optimizer steps through ``train.loop.make_train_step``).
``--slide``: a synthetic slide of ``--nuclei`` nuclei (100000: 100352
rows, one shard) in bf16, as ``chip_smoke.py`` phases 8-10 run it, with a
seeded model: ``parallel.mega_model.mega_forward`` in eval mode, or with
``--train`` one step of ``parallel.mega_train.make_slide_train_step``
without chunking, or with ``--capacity`` on the capacity path
(``chip_smoke.SLIDE_CAPACITY``: ``model.assign_tail_chunk=65536
mesh.remat_stage1=true``). Under ``torch.profiler`` it prints, for the
window: the device time per kernel name (top 25), the share of the port's
own kernels (every ``__global__`` kernel under ``cgcnet_tpu_torch/csrc``,
``OWN_KERNELS``) and of everything else, the device-busy share of the wall
time (kernel time over wall time, which the profiler itself lengthens),
the wall time per step without the profiler (CUDA events), and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# every __global__ kernel under cgcnet_tpu_torch/csrc (a CPU test holds the
# list against the sources), by the file it lives in
OWN_KERNELS = (
    # assign_head.cu: B4, B6, B9a
    "rnorm_kernel", "rnorm_lin_tc_kernel", "gemm_kernel", "gemm_tc_kernel",
    "softmax_kernel", "softmax_rows_kernel", "lin_p_probe_kernel",
    # assign_tail.cu: B3, B9b, B5
    "stats_kernel", "stats_lin_tc_kernel", "stats_reduce_kernel",
    "tail_bwd_kernel", "tail_bwd_staged_kernel",
    # bsr_banded.cu: B8
    "banded_kernel", "banded_tc_kernel",
    # bsr_build.cu: B1
    "build_blocks_kernel",
    # bsr_gather.cu: B7
    "bsr_gather_kernel",
    # bsr_matmul.cu: B2
    "bsr_matmul_f32_kernel", "bsr_matmul_tc_kernel",
)


def own_kernel(name: str) -> bool:
    """Whether a profiler kernel name (demangled, with its namespace and
    template arguments) is one of ``OWN_KERNELS``."""
    return any(f"::{k}<" in name or f"::{k}(" in name or name == k
               or name.startswith((f"{k}<", f"{k}(")) for k in OWN_KERNELS)


def slide_step(args, device):
    """(step, what, grad mode, description) of the slide path."""
    import torch

    import chip_smoke
    from cgcnet_tpu_torch.config import Config
    from cgcnet_tpu_torch.nn.model import CGCNet
    from cgcnet_tpu_torch.parallel.mega_model import mega_forward
    from cgcnet_tpu_torch.parallel.mega_train import (
        make_optimizer,
        make_slide_train_step,
    )
    from cgcnet_tpu_torch.parallel.slide_setup import (
        build_slide_inputs,
        synthetic_slide,
    )

    over = [*chip_smoke.SLIDE_DTYPE,
            *(chip_smoke.SLIDE_CAPACITY if args.capacity else []),
            *args.overrides]
    cfg = Config().apply_overrides(over)
    feats, coords = synthetic_slide(args.nuclei)
    inputs = build_slide_inputs(cfg, feats, coords, 1, device).inputs
    model = CGCNet(cfg.model, torch.Generator().manual_seed(1234)).to(device)
    desc = (f"slide {args.nuclei} nuclei ({inputs.nbr_remap.shape[0]} rows), "
            f"{' '.join(over)}")
    if not args.train:
        model.eval()
        return (lambda: mega_forward(model, cfg.model, inputs), "forwards",
                torch.inference_mode, desc)
    model.train()
    step = make_slide_train_step(model, cfg.model, make_optimizer(model, 1e-3),
                                 remat_stage1=cfg.mesh.remat_stage1)
    gen = torch.Generator(device=device).manual_seed(100)
    return (lambda: step(inputs, 1, gen), "train steps", torch.enable_grad,
            desc)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--train", action="store_true",
                    help="profile optimizer steps instead of eval forwards")
    ap.add_argument("--slide", action="store_true",
                    help="the whole-slide path (bf16) instead of the patches")
    ap.add_argument("--capacity", action="store_true",
                    help="with --slide --train: the capacity path's step")
    ap.add_argument("--nuclei", type=int, default=100_000,
                    help="with --slide: the synthetic slide's nuclei")
    ap.add_argument("overrides", nargs="*",
                    help="config overrides: section.key=value")
    args = ap.parse_args()
    if args.capacity and not (args.slide and args.train):
        ap.error("--capacity needs --slide --train")
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_forward: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    if args.slide:
        step, what, grad_mode, desc = slide_step(args, device)
    else:
        step, what, grad_mode, desc = patch_step(args, device)
    with grad_mode():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        step_ms = chip_smoke.time_ms(step, reps=10, warmup=0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): the CPU-side op events
    # carry their kernels' time too and would count it twice, and so do the
    # device ranges of user annotations (e.g. "Optimizer.step#Adam.step")
    rows = [
        (e.key, e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    ]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    own = sum(r[1] for r in rows if own_kernel(r[0]))
    print(f"card: {smi}; {desc}, {args.steps} {what}")
    print(f"without the profiler: {step_ms:.3f} ms per step (median of 10, "
          "CUDA events)")
    if total == 0:
        print("profiler recorded no device time")
        return 1
    print(f"wall {wall_us / args.steps / 1e3:.3f} ms/step, device "
          f"{total / args.steps / 1e3:.3f} ms/step, busy share "
          f"{total / wall_us:.3f}")
    print(f"own kernels (csrc/) {own / args.steps / 1e3:.3f} ms/step, "
          f"everything else {(total - own) / args.steps / 1e3:.3f} ms/step, "
          f"{sum(r[2] for r in rows) // args.steps} device events/step")
    for name, us, count in rows[:25]:
        print(f"{us / args.steps / 1e3:9.4f} ms/step  {count // args.steps:4d} "
              f"calls/step  {'*' if own_kernel(name) else ' '} {name[:110]}")
    return 0


def patch_step(args, device):
    """(step, what, grad mode, description) of the canonical patch path."""
    import torch

    import chip_smoke
    from cgcnet_tpu_torch.cli import predict
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.dataflow.synthetic import generate_dataset
    from cgcnet_tpu_torch.nn.model import CGCNet
    from cgcnet_tpu_torch.train.loop import make_train_step
    from cgcnet_tpu_torch.train.state import create_train_state

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "data"
        generate_dataset(str(root), patches_per_image=2, images_per_grade=2,
                         n_nodes=chip_smoke.DATA_NODES, seed=0)
        cfg = predict.serving_config(
            [f"data.root={root}", f"data.max_num_nodes={chip_smoke.DATA_NODES[1]}",
             *args.overrides]
        )
        model = predict.build_model(
            cfg, CGCNet(cfg.model, torch.Generator().manual_seed(1234)).state_dict(),
            device,
        )
        loader = GraphLoader(NucleiGraphDataset(cfg.data, "valid"),
                             cfg.data.batch_size, device=device, shuffle=False)
        graph = next(iter(loader.epoch(0)))
    desc = (f"{cfg.model.gcn_name}, batch x {tuple(graph.x.shape)}")
    if args.train:
        state = create_train_state(cfg, device, seed=1234)
        train_step = make_train_step()
        return (lambda: train_step(state, graph)), "train steps", \
            torch.enable_grad, desc
    return (lambda: model(graph)), "forwards", torch.inference_mode, desc


if __name__ == "__main__":
    sys.exit(main())
