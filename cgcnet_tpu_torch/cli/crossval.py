"""Full 3-fold cross-validation driver. Port of ``cgcnet_tpu/cli/crossval.py``.

The reference trains one fold per invocation (parallel_train.sh); this driver
runs all three folds (dataflow/data.py:15-19 split table) through
``cli.train.main`` and averages the image-level, binary and patch accuracy
across them. Flags such as ``--cpu`` and ``--synthetic`` pass through.

Usage:
    python -m cgcnet_tpu_torch.cli.crossval [--cpu] data.root=/data [overrides...]
"""

from __future__ import annotations

import json
import sys

import numpy as np

METRICS = ("img_acc", "binary_acc", "patch_acc")


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    from cgcnet_tpu_torch.cli.train import main as train_main

    results = {}
    for fold in (1, 2, 3):
        print(f"===== fold {fold} =====")
        results[fold] = train_main(argv + [f"data.cross_val={fold}"])
    agg = {
        key: float(np.mean([r[key] for r in results.values()]))
        for key in METRICS
    }
    print("cross-val mean:", json.dumps(agg, indent=2))
    return {"folds": results, "mean": agg}


if __name__ == "__main__":
    main()
