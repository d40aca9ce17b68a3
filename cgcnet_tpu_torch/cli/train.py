"""Training CLI (reference train.py:299-435) — same flags and overrides as
``cgcnet_tpu/cli/train.py``; runs on the CUDA device unless ``--cpu``.

Usage:
    python -m cgcnet_tpu_torch.cli.train [--config cfg.json] [--synthetic]
        [--eval-only] [--cpu] [section.key=value ...]

Examples:
    # the canonical configuration on a synthetic dataset, on the card
    python -m cgcnet_tpu_torch.cli.train --synthetic train.num_epochs=2

    # the same on the CPU (plain PyTorch versions of the kernels)
    python -m cgcnet_tpu_torch.cli.train --cpu --synthetic train.num_epochs=2
"""

from __future__ import annotations

import argparse
import tempfile

from cgcnet_tpu_torch.config import Config


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", help="JSON config file")
    p.add_argument(
        "--synthetic",
        action="store_true",
        help="generate a synthetic dataset under a temp root and train on it",
    )
    p.add_argument(
        "--eval-only", action="store_true", help="skip training, evaluate only"
    )
    p.add_argument(
        "--visualize",
        action="store_true",
        help="dump GEXF cluster-assignment files (not ported yet: raises)",
    )
    p.add_argument(
        "--cpu",
        action="store_true",
        help="run on the CPU (plain PyTorch versions of the kernels)",
    )
    p.add_argument(
        "overrides", nargs="*", help="config overrides: section.key=value"
    )
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from cgcnet_tpu_torch.cli.predict import select_device

    device = select_device(args.cpu)
    if args.visualize:
        raise NotImplementedError(
            "--visualize: not ported yet (utils, remaining entry points and "
            "host code)"
        )
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    cfg = cfg.apply_overrides(args.overrides)

    if args.synthetic:
        from cgcnet_tpu_torch.dataflow.synthetic import generate_dataset

        root = tempfile.mkdtemp(prefix="cgc_synth_")
        generate_dataset(root, seed=cfg.data.seed)
        cfg = cfg.apply_overrides(
            [f"data.root={root}", "data.max_num_nodes=512"]
        )

    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.train.checkpoint import load_train_checkpoint
    from cgcnet_tpu_torch.train.loop import Trainer, evaluate, resume_state
    from cgcnet_tpu_torch.train.state import create_train_state

    cfg = cfg.apply_overrides(
        [f"model.max_num_nodes={cfg.data.max_num_nodes}",
         f"model.input_dim={cfg.data.num_features}"]
    )
    train_ds = NucleiGraphDataset(cfg.data, "train")
    val_ds = NucleiGraphDataset(
        cfg.data, "valid", full_graph=cfg.data.full_test_graph
    )
    train_loader = GraphLoader(
        train_ds, cfg.data.batch_size, device=device, shuffle=True,
        num_workers=cfg.data.num_workers, seed=cfg.data.seed, drop_last=True,
        dynamic_buckets=cfg.data.dynamic_buckets,
    )
    # full-graph test mode evaluates one unsampled patch at a time
    # (reference NucleiDatasetTest: batch=1, dataflow/data.py:281-316)
    val_loader = GraphLoader(
        val_ds, 1 if cfg.data.full_test_graph else cfg.data.batch_size,
        device=device, shuffle=False, num_workers=cfg.data.num_workers,
        dynamic_buckets=cfg.data.dynamic_buckets,
    )
    state = create_train_state(cfg, device)
    start_epoch = 0
    if cfg.train.resume:
        state, start_epoch = resume_state(cfg, state)
        print(f"=> resumed from epoch {start_epoch}")

    trainer = Trainer(cfg, state, train_loader, val_loader,
                      start_epoch=start_epoch)
    if not args.eval_only:
        best = trainer.train()
        print("best:", best)
        # the final evaluation reports the selected model (best image-level
        # validation accuracy), not whatever the last epoch left behind
        best_ckpt = trainer.run_dir / "model_best.pt"
        if best_ckpt.exists():
            load_train_checkpoint(best_ckpt, trainer.state)
    multi_sample = cfg.data.sample_ratio < 1 and not cfg.data.full_test_graph
    final = evaluate(
        trainer.state, val_loader,
        test_time=cfg.train.test_epoch if multi_sample else 1,
        vote_per_repeat=cfg.train.vote_per_repeat,
        max_num_examples=cfg.train.eval_max_examples or None,
    )
    print("final:", final)
    return {**final, "run_dir": str(trainer.run_dir)}


if __name__ == "__main__":
    main()
