#!/usr/bin/env python3
"""Device time of each launch of one whole-slide assign-head call, on one
NVIDIA GPU: B4 (``assign_head_softmax_pre``) at the slide's shapes — one
graph of 100352 rows (100000 real), F12=40, C=1140 — in bf16 and in f32,
on random operands made from a seed; ``chip_smoke.head_split``'s parts (row
norm, product, softmax, other) from a torch.profiler trace.

    python3 scripts/head_split.py                  # this checkout's kernels
    python3 scripts/head_split.py --root DIR       # another checkout's

``--root`` imports ``cgcnet_tpu_torch`` (and builds its kernels) from DIR,
so two commits' launches can be compared in one run on one card: run
parent, change, change, parent. Prints one JSON object per dtype. Imports
nothing of JAX. Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
ROWS, REAL, F12, C = 100352, 100000, 40, 1140


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("head_split: no CUDA device", file=sys.stderr)
        return 2
    # this checkout's chip_smoke (its head_split), the kernels of --root
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(Path(args.root).resolve()))
    from cgcnet_tpu_torch.ops import assign_head as ah

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    n_nodes = torch.tensor([REAL], dtype=torch.int32, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        x12, p = rnd(1, ROWS, F12).to(dt), rnd(1, ROWS, C).to(dt)
        k12, k3f, const = rnd(F12, C) * 0.2, rnd(C, C) * 0.05, rnd(C) * 0.1
        split = cs.head_split(lambda: ah.assign_head_softmax_pre(
            x12, p, k12, k3f, const, n_nodes), calls=args.calls)
        print(json.dumps({
            "root": args.root, "dtype": str(dt).split(".")[-1], "rows": ROWS,
            "C": C, "F12": F12, "device_ms_per_call": split,
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del x12, p
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
