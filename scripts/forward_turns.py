#!/usr/bin/env python3
"""Eager forward time of the canonical patch batch, for one checkout.

    python3 scripts/forward_turns.py [--root DIR] [--reps 30]

Needs one GPU. Builds ``chip_smoke.py``'s synthetic canonical data (B=4
graphs padded to N=5760, C=1140, f32), a seeded canonical CGCNet from the
``cgcnet_tpu_torch`` of ``--root`` (default: this checkout; its kernels are
built there), and prints one JSON line: the root, the median of ``--reps``
CUDA-event timings of ``model(graph)`` under ``torch.no_grad`` (after
warmup), every timing, and the card's name and power limit. Two trees
compare only within one call: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    # the package (and its kernels) of --root; chip_smoke of this checkout
    sys.path.insert(0, str(Path(args.root).resolve()))
    sys.path.insert(1, str(REPO))
    import torch

    import chip_smoke
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.nn.model import CGCNet

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        _, cfg = chip_smoke.make_data(Path(tmp))
        loader = GraphLoader(NucleiGraphDataset(cfg.data, "valid"),
                             cfg.data.batch_size, device=device,
                             shuffle=False, num_workers=4)
        graph = next(iter(loader.epoch(0)))
    model = CGCNet(cfg.model, torch.Generator().manual_seed(1234))
    model = model.to(device).eval()
    times = []

    def forward():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        model(graph)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))

    with torch.no_grad():
        for _ in range(5):
            model(graph)
        torch.cuda.synchronize()
        for _ in range(args.reps):
            forward()
    import cgcnet_tpu_torch

    print(json.dumps({
        "root": args.root, "package": str(Path(cgcnet_tpu_torch.__file__).parent),
        "forward_ms": sorted(times)[len(times) // 2], "all_ms": times,
        "x": list(graph.x.shape), "device": chip_smoke.card_line(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
