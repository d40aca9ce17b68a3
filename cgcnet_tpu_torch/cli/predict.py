"""Batch inference CLI — grade patches with a trained checkpoint.

Loads a checkpoint of this package (``train/checkpoint.py``; JAX weights
come over through ``state_dict_from_flax``), runs every patch of a split on
the CUDA device (``--cpu`` for the CPU), optionally with test-time
multi-sampling, and writes per-patch predictions plus the image-level
majority votes. Same flags and output as ``cgcnet_tpu/cli/predict.py``.

Usage:
    python -m cgcnet_tpu_torch.cli.predict --ckpt model.pt \
        [--split valid] [--out predictions.jsonl] data.root=/data [overrides]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch


def select_device(cpu: bool) -> torch.device:
    """The CUDA device unless ``cpu``; no silent fallback to the CPU."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass --cpu to run the plain PyTorch path on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def serving_config(overrides: list[str]):
    """Config from ``section.key=value`` overrides, with the model's node
    capacity and input width taken from the data section."""
    from cgcnet_tpu_torch.config import Config

    cfg = Config().apply_overrides(list(overrides))
    return cfg.apply_overrides(
        [f"model.max_num_nodes={cfg.data.max_num_nodes}",
         f"model.input_dim={cfg.data.num_features}"]
    )


def build_model(cfg, state_dict, device: torch.device):
    """Eval-mode CGCNet with ``state_dict`` loaded (every key must match),
    with TF32 off so f32 stays f32 on the card."""
    from cgcnet_tpu_torch.nn.model import CGCNet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = CGCNet(cfg.model)
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True, help="checkpoint (torch.save file)")
    p.add_argument("--split", default="valid", choices=["train", "valid"])
    p.add_argument("--out", default="", help="JSONL output path (optional)")
    p.add_argument(
        "--reps", type=int, default=0,
        help="test-time resampling repeats (0 = train.test_epoch default)",
    )
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain PyTorch versions of the kernels)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    device = select_device(args.cpu)

    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.train.checkpoint import load_checkpoint
    from cgcnet_tpu_torch.train.metrics import ImageLevelMetric, image_stem

    cfg = serving_config(args.overrides)
    ds = NucleiGraphDataset(
        cfg.data, args.split, full_graph=cfg.data.full_test_graph
    )
    loader = GraphLoader(
        ds, 1 if cfg.data.full_test_graph else cfg.data.batch_size,
        device=device, shuffle=False, num_workers=cfg.data.num_workers,
    )
    state_dict, _, _ = load_checkpoint(args.ckpt)
    model = build_model(cfg, state_dict, device)
    print(f"loaded {args.ckpt}", file=sys.stderr)

    multi = cfg.data.sample_ratio < 1 and not cfg.data.full_test_graph
    reps = args.reps or (cfg.train.test_epoch if multi else 1)
    logit_sum: dict[int, np.ndarray] = {}
    labels: dict[int, int] = {}
    with torch.inference_mode():
        for rep in range(reps):
            for graph in loader.epoch(rep):
                logits = model(graph).cpu().numpy()
                y = graph.y.cpu().numpy()
                for i, pidx in enumerate(graph.patch_idx.cpu().numpy()):
                    pidx = int(pidx)
                    logit_sum[pidx] = logit_sum.get(pidx, 0.0) + logits[i]
                    labels[pidx] = int(y[i])

    metric = ImageLevelMetric()
    records = []
    for pidx in sorted(logit_sum):
        mean = logit_sum[pidx] / reps
        pred = int(np.argmax(mean))
        name = ds.names[pidx]
        metric.add_batch([name], [pred], [labels[pidx]])
        records.append(
            {
                "patch": name,
                "image": image_stem(name),
                "pred": pred,
                "label": labels[pidx],
                "logits": [float(v) for v in mean],
            }
        )
    result = metric.result()
    result["patch_acc"] = float(
        np.mean([r["pred"] == r["label"] for r in records])
    )
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with out.open("w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
            f.write(json.dumps({"summary": result}) + "\n")
        print(f"wrote {len(records)} predictions -> {out}", file=sys.stderr)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
