#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's canonical eval forward, or
of one canonical training step.

    python3 scripts/profile_torch_forward.py [--steps 5]           # forward
    python3 scripts/profile_torch_forward.py --train [--steps 5]   # train step
    python3 scripts/profile_torch_forward.py --train model.gcn_name=GIN

Needs one GPU. Builds the same synthetic canonical batch and seeded model
as ``chip_smoke.py`` (B=4 graphs padded to N=5760, C=1140, f32; config
overrides such as ``model.gcn_name=GIN`` select another model), runs a few
forwards (or optimizer steps through ``train.loop.make_train_step``) under
``torch.profiler`` and prints, for the window: the device time per kernel
name (top 25), the share of the port's own kernels (B1-B7) and of
everything else, the device-busy share of the wall time (kernel time over
wall time, which the profiler itself lengthens), the wall time per
step without the profiler (CUDA events), and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OWN_KERNELS = ("build_blocks_kernel", "bsr_matmul_kernel", "rnorm_kernel",
               "gemm_kernel", "softmax_kernel", "stats_partial_kernel",
               "stats_reduce_kernel", "tail_bwd_kernel", "bsr_gather_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--train", action="store_true",
                    help="profile optimizer steps instead of eval forwards")
    ap.add_argument("overrides", nargs="*",
                    help="config overrides: section.key=value")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_forward: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from cgcnet_tpu_torch.cli import predict
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.dataflow.synthetic import generate_dataset
    from cgcnet_tpu_torch.nn.model import CGCNet
    from cgcnet_tpu_torch.train.loop import make_train_step
    from cgcnet_tpu_torch.train.state import create_train_state

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
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
    if args.train:
        state = create_train_state(cfg, device, seed=1234)
        train_step = make_train_step()
        step, what = (lambda: train_step(state, graph)), "train steps"
        grad_mode = torch.enable_grad
    else:
        step, what = (lambda: model(graph)), "forwards"
        grad_mode = torch.inference_mode
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
    own = sum(r[1] for r in rows if any(k in r[0] for k in OWN_KERNELS))
    print(f"card: {smi}; {cfg.model.gcn_name}, batch x {tuple(graph.x.shape)}, "
          f"{args.steps} {what}")
    print(f"without the profiler: {step_ms:.3f} ms per step (median of 10, "
          "CUDA events)")
    if total == 0:
        print("profiler recorded no device time")
        return 1
    print(f"wall {wall_us / args.steps / 1e3:.3f} ms/step, device "
          f"{total / args.steps / 1e3:.3f} ms/step, busy share "
          f"{total / wall_us:.3f}")
    print(f"own kernels (B1-B7) {own / args.steps / 1e3:.3f} ms/step, "
          f"everything else {(total - own) / args.steps / 1e3:.3f} ms/step, "
          f"{sum(r[2] for r in rows) // args.steps} device events/step")
    for name, us, count in rows[:25]:
        print(f"{us / args.steps / 1e3:9.4f} ms/step  {count // args.steps:4d} "
              f"calls/step  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
