"""Toy sizes of the benchmark's cells for the CPU tests: the same drivers,
widths and checks, with fewer and smaller patches, pool-1's clusters cut
with the patches (1000 nuclei -> 100 then 10 clusters)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]      # portbench/
REPO = ROOT.parent

_PATCH_CONFIG = {"program": {"model": {"max_num_nodes": 1000},
                             "data": {"max_num_nodes": 1000,
                                      "num_workers": 2}}}
_PATCH_TRAFFIC = {"batch": 4, "images_per_grade": 2, "patches_per_image": 2,
                  "nuclei": [700, 1000], "trace_steps": 3, "epochs": 2}

OVERRIDES = {
    "patch_train_b16": {"config": _PATCH_CONFIG, "traffic": _PATCH_TRAFFIC},
    "patch_grade_b16": {"config": _PATCH_CONFIG, "traffic": _PATCH_TRAFFIC},
}


def bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def importable() -> None:
    """Put portbench/ and the checkout on the path, as ``run.py`` does."""
    for p in (str(REPO), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def run_toy(cell: str, seed: int = 7, *, seconds: float = 1.0,
            trace: bool = False, control: str = "",
            details: dict | None = None) -> dict:
    """One run of ``cell`` at its toy size on the CPU."""
    importable()
    import torch

    import run

    torch.set_num_threads(2)
    return run.run_cell(cell, seed, seconds, trace, device="cpu",
                        control=control, overrides=OVERRIDES[cell],
                        bench=bench(), details=details)
