"""Whole-slide grading CLI (BASELINE.json configs 4-5).

Grades an unsampled whole-slide cell graph (100k+ nuclei) with
patch-trained CGCNet parameters through the slide path
(``parallel/mega_model.py``), optionally fine-tunes them on the slide, and
grades a stream of slides with the host build of each slide pipelined
behind the forward of the one before. Same flags and output as
``cgcnet_tpu/cli/slide.py``. Runs on the CUDA device; ``--cpu`` runs on the
CPU with the kernels' plain versions (and the gather path: block tables are
built for a card only).

``--shards D`` above 1 runs one process per shard under the launcher
(``parallel/mesh.py``: gloo on the CPU and where ranks share a card, nccl
where each rank owns one); rank 0 prints and writes ``--out``.

Usage:
    python -m cgcnet_tpu_torch.cli.slide --synthetic --nuclei 100000 \
        --shards 1 model.compute_dtype=bfloat16
    python -m cgcnet_tpu_torch.cli.slide --proto slide.npz --ckpt model.pt
    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m cgcnet_tpu_torch.cli.slide --cpu --synthetic --nuclei 20000 \
        --shards 2
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from cgcnet_tpu_torch.parallel.mesh import GraphAxis, launched_axis, launcher


def load_partial(model, path) -> tuple[list[str], list[str]]:
    """Copy the checkpoint's tensors whose name and shape match the model's
    (the JAX package's ``load_partial``); returns (copied, skipped)."""
    from cgcnet_tpu_torch.train.checkpoint import load_checkpoint

    sd, _, _ = load_checkpoint(path)
    own = model.state_dict()
    copied, skipped = [], []
    with torch.no_grad():
        for name, val in sd.items():
            if name in own and tuple(own[name].shape) == tuple(val.shape):
                own[name].copy_(val)
                copied.append(name)
            else:
                skipped.append(name)
    return copied, skipped


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--proto", help="slide proto (.npz: features, coords, label)")
    p.add_argument("--ckpt", help="checkpoint of this package (torch.save)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--nuclei", type=int, default=100_000)
    p.add_argument("--shards", type=int, default=0,
                   help="0 = the launcher's world size (1 without one); "
                        "one process per shard")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain PyTorch versions of the kernels)")
    p.add_argument(
        "--slides", type=int, default=1,
        help="grade a stream of N slides (--synthetic: distinct seeds), the "
             "host build of slide i+1 pipelined behind the forward of slide "
             "i; sticky table caps keep one set of shapes",
    )
    p.add_argument(
        "--train-epochs", type=int, default=0,
        help="fine-tune the weights on this slide's label for N epochs "
             "before grading again",
    )
    p.add_argument("--out", help="write the (fine-tuned) checkpoint here")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    with launched_axis(args.cpu) as axis:
        return _run(p, args, axis)


def _run(p, args, axis: GraphAxis) -> dict:
    shards = args.shards or axis.size
    if shards != axis.size:
        raise ValueError(
            f"--shards {shards} runs one process per shard (this process is "
            f"in a graph axis of {axis.size}): {launcher(shards)}")
    device = axis.device
    say = print if axis.rank == 0 else (lambda *a, **k: None)

    from cgcnet_tpu_torch.config import Config
    from cgcnet_tpu_torch.nn.model import CGCNet
    from cgcnet_tpu_torch.parallel.mega_graph import broadcast_
    from cgcnet_tpu_torch.parallel.mega_model import mega_forward
    from cgcnet_tpu_torch.parallel.slide_setup import (
        SlideCaps,
        build_slide_inputs,
        synthetic_slide,
    )
    from cgcnet_tpu_torch.train.checkpoint import save_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config().apply_overrides(args.overrides)

    # ---- slide data ----
    if args.synthetic:
        feats, coords = synthetic_slide(args.nuclei)
        label = None
    else:
        if not args.proto:
            p.error("--proto or --synthetic required")
        with np.load(args.proto) as z:
            feats, coords, label = z["features"], z["coords"], int(z["label"])

    # ---- normalize / band-sort / pad / radius graph / partition (+tables)
    build = build_slide_inputs(cfg, feats, coords, shards, device, axis=axis)
    n, inputs = build.n, build.inputs

    mcfg = cfg.model.__class__(**{**cfg.model.__dict__,
                                  "input_dim": build.input_dim})
    model = CGCNet(mcfg).to(device).eval()
    if args.ckpt:
        copied, _ = load_partial(model, args.ckpt)
        say(f"loaded {len(copied)} tensors from {args.ckpt}")
    broadcast_(model.state_dict().values(), axis)

    def fwd(inp):
        with torch.no_grad():
            out = mega_forward(model, mcfg, inp, train=False,
                               halo_overlap=cfg.mesh.halo_overlap)
        return out.float().cpu().numpy()

    t0 = time.perf_counter()
    logits = fwd(inputs)       # the first call also builds the kernels
    t_fwd_c = time.perf_counter() - t0
    _sync(device)
    t0 = time.perf_counter()
    logits = fwd(inputs)
    t_fwd = time.perf_counter() - t0

    pred = int(np.argmax(logits))
    halo = int(build.part.req_mask.sum())
    say(f"slide: {n} nuclei, {shards} shards, halo rows {halo} "
        f"({100 * halo / max(n, 1):.2f}%)")
    say(f"timing: graph {build.t_graph_s * 1e3:.0f} ms, "
        f"partition {build.t_part_s * 1e3:.0f} ms, "
        f"forward {t_fwd * 1e3:.0f} ms (first call {t_fwd_c:.1f} s)")
    say(f"logits {logits}  predicted grade {pred + 1}"
        + (f" (true {label + 1})" if label is not None else ""))
    result = {"logits": logits, "pred": pred, "n": n, "cap": build.cap,
              "bsr": build.bsr, "t_graph_s": build.t_graph_s,
              "t_part_s": build.t_part_s, "t_fwd_s": t_fwd}

    if args.train_epochs > 0:
        # ---- slide-level fine-tuning ----
        from cgcnet_tpu_torch.parallel.mega_train import train_slides

        lbl = label if label is not None else pred
        model, losses = train_slides(
            model, mcfg, [(inputs, lbl)], lr=cfg.train.lr,
            epochs=args.train_epochs, remat=cfg.mesh.remat,
            remat_stage1=cfg.mesh.remat_stage1,
        )
        say(f"fine-tune: {args.train_epochs} epochs on this slide, "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        logits2 = fwd(inputs)
        say(f"post-finetune logits {logits2} predicted grade "
            f"{int(np.argmax(logits2)) + 1}")
        result.update(losses=losses, logits_finetuned=logits2)
        if args.out and axis.rank == 0:
            save_checkpoint(args.out, model.state_dict(), cfg,
                            {"slide_epochs": args.train_epochs,
                             "losses": losses})
            say(f"saved fine-tuned weights to {args.out}")

    if args.slides > 1:
        # ---- streaming: the host build pipelined behind the forward ----
        if not args.synthetic:
            p.error("--slides N pairs with --synthetic")
        from concurrent.futures import ThreadPoolExecutor

        def _w(a):  # table width (1 without block tables)
            return a.shape[-1] if a is not None else 1

        caps = SlideCaps().grown(
            build.part.halo_capacity, _w(inputs.nbr_t), _w(inputs.blk_cols),
            _w(inputs.blk_cols_t),
        )

        def build_one(i):
            nonlocal caps
            f, c = synthetic_slide(args.nuclei, seed=1000 + i)
            b = build_slide_inputs(cfg, f, c, shards, device, caps=caps,
                                   axis=axis)
            caps = b.caps or caps
            return b

        def shapes(inp):
            return tuple(
                tuple(t.shape) for t in (inp.nbr_remap, inp.req_idx,
                                         inp.nbr_t, inp.blk_cols,
                                         inp.blk_cols_t)
                if t is not None
            )

        preds, seen = [], set()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=1) as ex:
            nxt = ex.submit(build_one, 0)
            for i in range(args.slides):
                b = nxt.result()
                if i + 1 < args.slides:
                    nxt = ex.submit(build_one, i + 1)
                seen.add(shapes(b.inputs))
                preds.append(int(np.argmax(fwd(b.inputs))))
        wall = time.perf_counter() - t0
        say(f"stream: {args.slides} slides in {wall:.2f} s "
            f"({args.slides / wall:.1f} slides/s, pipelined host build), "
            f"table shape sets: {len(seen)}, preds {preds}")
        result.update(stream_preds=preds, slides_per_s=args.slides / wall,
                      shape_sets=len(seen), stream_wall_s=wall)
    return result


if __name__ == "__main__":
    main()
