"""Export a trained checkpoint as a single-file serving artifact.

Port of ``cgcnet_tpu/cli/export.py``. Loads a checkpoint, traces the
eval-mode forward with ``torch.export`` at the serving shapes (batch x the
capacity the loader pads to), and writes the artifact of
``utils/export_model.py``. Serving it needs torch and this package's custom
ops, not the model code or the checkpoint.

- On the card (the default): the kernel artifact. The forward runs the
  block path, and the program records the hand-written kernels (B1, B2, and
  B4 or B6) as ``torch.ops.cgcnet_tpu_torch.*``; it serves on a card and
  takes the loader's batches as they come (block metadata, transpose
  tables; the block-slot counts and the transpose width are symbolic). A
  host without a card cannot export it: the command raises.
- ``--cpu``: the portable artifact, traced on the CPU through the ELL
  gather path; its signature takes x, nbr, nbr_mask and n_nodes, and it
  serves on the CPU.

Usage:
    python -m cgcnet_tpu_torch.cli.export --ckpt runs/<id>/model_best.pt \
        -o model.cgexp [--batch 4] [--symbolic-batch] [--cpu] [overrides]

Serve it:
    from cgcnet_tpu_torch.utils.export_model import load_exported
    forward, header = load_exported("model.cgexp")
    logits = forward(graph)   # a loader batch on the header's device
"""

from __future__ import annotations

import argparse
import json
import sys


def serving_graph(cfg, batch: int, device, kernels: bool):
    """An all-padding CellGraph batch at the serving shapes (the export
    reads only shapes and dtypes). The kernel artifact's graph carries
    transpose tables of the dataset's nominal width and block metadata of
    ``data.bsr_blocks`` slots, as the loader builds them (the artifact
    takes any width and slot count); the portable graph carries neither,
    so its forward takes the ELL gather path."""
    import torch

    from cgcnet_tpu_torch.core.graph import CellGraph
    from cgcnet_tpu_torch.dataflow.dataset import round_up

    # the capacity rule of NucleiGraphDataset
    cap = round_up(cfg.data.padded_nodes, 128)
    k = cfg.data.max_neighbours
    f = cfg.data.num_features
    own = torch.arange(cap, dtype=torch.int32, device=device)[None, :, None]
    extra = {}
    if kernels:
        kt = 24  # NucleiGraphDataset's nominal transpose width
        r, m = cap // 128, max(cfg.data.bsr_blocks, 2)
        extra = {
            "nbr_t": own.expand(batch, cap, kt).contiguous(),
            "nbr_t_mask": torch.zeros((batch, cap, kt), device=device),
            "blk_cols": torch.zeros((batch, r, m), dtype=torch.int32,
                                    device=device),
            "blk_mask": torch.zeros((batch, r, m), device=device),
            "blk_cols_t": torch.zeros((batch, r, m), dtype=torch.int32,
                                      device=device),
            "blk_mask_t": torch.zeros((batch, r, m), device=device),
        }
    return CellGraph(
        x=torch.zeros((batch, cap, f), device=device),
        nbr=own.expand(batch, cap, k).contiguous(),
        nbr_mask=torch.zeros((batch, cap, k), device=device),
        n_nodes=torch.zeros((batch,), dtype=torch.int32, device=device),
        **extra,
    )


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True, help="checkpoint (torch.save file)")
    p.add_argument("-o", "--out", required=True, help="artifact output path")
    p.add_argument("--batch", type=int, default=4, help="serving batch size")
    p.add_argument(
        "--symbolic-batch", action="store_true",
        help="export with a symbolic batch dimension (one artifact, any "
        "batch size; the node capacity stays static)",
    )
    p.add_argument(
        "--cpu", action="store_true",
        help="export the portable artifact on the CPU (ELL gather path, no "
        "custom op); without it the kernel artifact is exported on the card",
    )
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    from cgcnet_tpu_torch.cli.predict import build_model, select_device, serving_config
    from cgcnet_tpu_torch.train.checkpoint import load_checkpoint
    from cgcnet_tpu_torch.utils.export_model import export_forward, save_exported

    device = select_device(args.cpu)
    kernels = device.type == "cuda"
    cfg = serving_config(args.overrides)
    if kernels and cfg.model.use_pallas == "never":
        p.error("the kernel artifact runs the block path: drop "
                "model.use_pallas=never, or export --cpu")
    state_dict, _, _ = load_checkpoint(args.ckpt)
    model = build_model(cfg, state_dict, device)
    print(f"loaded {args.ckpt}", file=sys.stderr)

    example = serving_graph(cfg, args.batch, device, kernels)
    program, header = export_forward(
        model, example, symbolic_batch=args.symbolic_batch)
    if kernels and not header["custom_ops"]:
        raise RuntimeError(
            "the traced forward recorded no kernel: the kernel artifact "
            "would run plain PyTorch")
    header["ckpt"] = str(args.ckpt)
    path = save_exported(program, header, args.out)
    size = path.stat().st_size
    result = {
        "out": str(path),
        "bytes": size,
        "device": header["device"],
        "fields": header["fields"],
        "custom_ops": header["custom_ops"],
    }
    print(f"wrote {size/1e6:.1f} MB -> {path}", file=sys.stderr)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
