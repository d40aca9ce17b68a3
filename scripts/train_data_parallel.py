#!/usr/bin/env python3
"""The patch training step over a data axis of ranks, one process a rank.

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        scripts/train_data_parallel.py --cpu --synthetic --steps 4
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        scripts/train_data_parallel.py --steps 100 data.root=<root> \\
        --out runs/dp.pt                                   # on the cards

Each rank joins the launcher's group (``parallel.mesh.multihost_init``;
``--coordinator host:port`` for processes started by hand with ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` set), loads only its rows of every
global batch of ``data.batch_size`` graphs (the process-sharded
``GraphLoader``) and takes ``make_train_step(data_axis=)`` steps: every
BN statistic and B3's sums over the global batch, DDP's gradient average.
Rank 0 prints the global loss and accuracy and writes the checkpoint.
Trailing ``section.key=value`` arguments override the config.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch.distributed as dist  # noqa: E402

from cgcnet_tpu_torch.config import Config  # noqa: E402
from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset  # noqa: E402
from cgcnet_tpu_torch.dataflow.loader import GraphLoader  # noqa: E402
from cgcnet_tpu_torch.parallel.mesh import multihost_init  # noqa: E402
from cgcnet_tpu_torch.train.checkpoint import save_train_checkpoint  # noqa: E402
from cgcnet_tpu_torch.train.loop import make_train_step  # noqa: E402
from cgcnet_tpu_torch.train.state import create_train_state  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="train on a synthetic dataset (each rank generates "
                        "the same one from data.seed)")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--out", default=None, help="checkpoint path (rank 0)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    axis = multihost_init(args.coordinator, cpu=args.cpu)
    try:
        cfg = Config().apply_overrides(args.overrides)
        if args.synthetic:
            from cgcnet_tpu_torch.dataflow.synthetic import generate_dataset

            root = tempfile.mkdtemp(prefix="cgc_synth_")
            generate_dataset(root, seed=cfg.data.seed)
            cfg = cfg.apply_overrides([f"data.root={root}",
                                       "data.max_num_nodes=512"])
        cfg = cfg.apply_overrides(
            [f"model.max_num_nodes={cfg.data.max_num_nodes}",
             f"model.input_dim={cfg.data.num_features}"])
        loader = GraphLoader(
            NucleiGraphDataset(cfg.data, "train"), cfg.data.batch_size,
            device=axis.device, num_workers=cfg.data.num_workers,
            seed=cfg.data.seed, drop_last=True, rank=axis.rank,
            world=axis.size)
        state = create_train_state(cfg, axis.device)
        step = make_train_step(data_axis=axis)
        epoch = 0
        while state.step < args.steps:
            for graph in loader.epoch(epoch):
                m = step(state, graph)
                if axis.rank == 0:
                    print(f"step {state.step}: loss {float(m['loss']):.6f} "
                          f"acc {float(m['acc']):.3f} ({axis.size} ranks, "
                          f"{graph.x.shape[0]} graphs each)", flush=True)
                if state.step >= args.steps:
                    break
            epoch += 1
        if args.out:
            out = Path(args.out)
            path = save_train_checkpoint(out.parent, state, cfg, epoch=epoch,
                                         name=out.stem)
            if axis.rank == 0:
                print(f"wrote {path}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
