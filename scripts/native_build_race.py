#!/usr/bin/env python3
"""Concurrent first loads of the native graph library, on the CPU: in each
trial, PROCS processes start at one moment on a fresh copy of
``native/build.sh`` and ``native/cgraph.cpp`` (no ``libcgraph.so``), each
loads the library through a binding file, and each that gets it computes
``radius_knn`` on 64 points.

    python3 scripts/native_build_race.py [--binding FILE] [--trials N]
                                         [--procs P]

``--binding`` is a ``cgcnet_tpu_torch/dataflow/native.py`` (default this
checkout's; another checkout's for a witness). A binding with
``build_and_load(path)`` is called with the copy's path; an older one has
its ``_SO`` pointed at the copy and ``_load()`` called. Prints one line a
trial and a JSON summary last: processes that did not load the library
(``lost``), graphs unlike ``cgcnet_tpu_torch.ops.knn.radius_knn_np``'s
(``wrong``) and files left beside the library (``left``). The copies live
under ``build/native_race/`` and are removed after each trial.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
RADIUS, K = 30.0, 6

CHILD = r"""
import importlib.util, sys, time
from pathlib import Path
import numpy as np
binding, so, root, i, radius, k = sys.argv[1:]
spec = importlib.util.spec_from_file_location("native_binding", binding)
native = importlib.util.module_from_spec(spec)
spec.loader.exec_module(native)
root = Path(root)
(root / f"ready{i}").touch()
while not (root / "go").exists():
    time.sleep(0.001)
if hasattr(native, "build_and_load"):
    native._LIB, native._TRIED = native.build_and_load(Path(so)), True
else:
    native._SO = Path(so)
if native._load() is None:
    sys.exit(3)
nbr, mask = native.radius_knn(np.load(root / "pos.npy"), float(radius), int(k))
np.savez(root / f"out{i}.npz", nbr=nbr, mask=mask)
"""


def trial(binding: Path, procs: int, base: Path) -> dict:
    """One trial in a fresh folder under ``base`` (removed after it):
    {"lost", "wrong", "left", "rcs"}."""
    root = Path(tempfile.mkdtemp(dir=base))
    try:
        native_dir = root / "native"
        native_dir.mkdir()
        for name in ("build.sh", "cgraph.cpp"):
            shutil.copy2(REPO / "native" / name, native_dir / name)
        pos = np.random.default_rng(0).uniform(0, 100, (64, 2)).astype(
            np.float32)
        np.save(root / "pos.npy", pos)
        ps = [subprocess.Popen(
            [sys.executable, "-c", CHILD, str(binding),
             str(native_dir / "libcgraph.so"), str(root), str(i),
             str(RADIUS), str(K)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(procs)]
        deadline = time.monotonic() + 120
        while not all((root / f"ready{i}").exists() for i in range(procs)):
            if time.monotonic() > deadline or any(
                    p.poll() is not None for p in ps):
                for p in ps:
                    p.kill()
                raise RuntimeError("the processes did not start: " + "; ".join(
                    p.communicate()[0] for p in ps))
            time.sleep(0.01)
        (root / "go").touch()
        for p in ps:
            p.communicate(timeout=300)
        from cgcnet_tpu_torch.ops.knn import radius_knn_np

        want = radius_knn_np(pos, RADIUS, K)
        wrong = 0
        for i, p in enumerate(ps):
            if p.returncode == 0:
                got = np.load(root / f"out{i}.npz")
                wrong += not (np.array_equal(got["nbr"], want[0])
                              and np.array_equal(got["mask"], want[1]))
        left = sorted({p.name for p in native_dir.iterdir()}
                      - {"build.sh", "cgraph.cpp", "libcgraph.so"})
        build = root / "build"
        if build.is_dir():
            left += sorted(f"build/{p.name}" for p in build.iterdir()
                           if p.name != "native.lock")
        return dict(lost=sum(p.returncode != 0 for p in ps), wrong=wrong,
                    left=left, rcs=[p.returncode for p in ps])
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--binding", type=Path, default=REPO / "cgcnet_tpu_torch"
                    / "dataflow" / "native.py")
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--procs", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    base = REPO / "build" / "native_race"
    base.mkdir(parents=True, exist_ok=True)
    results = []
    for t in range(args.trials):
        res = trial(args.binding.resolve(), args.procs, base)
        print(f"trial {t}: lost {res['lost']} of {args.procs}, wrong "
              f"{res['wrong']}, left {res['left']}, rcs {res['rcs']}",
              flush=True)
        results.append(res)
    print(json.dumps({
        "binding": str(args.binding), "trials": args.trials,
        "procs": args.procs,
        "lost_per_trial": [r["lost"] for r in results],
        "trials_with_a_loss": sum(r["lost"] > 0 for r in results),
        "wrong": sum(r["wrong"] for r in results),
        "left": sorted({f for r in results for f in r["left"]})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
