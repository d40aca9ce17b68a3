#!/usr/bin/env python3
"""How far rounding alone moves the whole-slide bf16 loss that chip_smoke.py
holds (phases 9-10), on one NVIDIA GPU.

    python3 scripts/slide_hold_probe.py           # from the repository root
    python3 scripts/slide_hold_probe.py --holds   # the two holds only

On chip_smoke.py's slide (``synthetic_slide(100000)``, one shard, bf16,
the canonical model with its random initialisation, seed 1234) it prints
the one-step loss of the capacity path (``assign_tail_chunk=65536``,
``remat_stage1``) and of the no-chunk path:

- with every kernel, with every plain version, and in f32 (the three
  numbers the hold compares), with the hold's tolerance and verdict
  (``--holds`` stops here);
- with every kernel but one, that one routed to its plain version (which
  kernel moves the loss);
- capacity path only: with the assign tail's BN statistics (B9b) taken
  from the plain version and nudged by a relative 1e-9 .. 1e-7 (three
  seeds each), and taken exactly (row norm and sums in f64, rounded once)
  — how much the loss moves when only the last bits of the statistics do.

Imports nothing of JAX. Needs a card.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    holds_only = "--holds" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("slide_hold_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from cgcnet_tpu_torch.config import Config
    from cgcnet_tpu_torch.nn.model import CGCNet
    from cgcnet_tpu_torch.ops import assign_head as ah
    from cgcnet_tpu_torch.parallel.slide_setup import (
        build_slide_inputs,
        synthetic_slide,
    )
    from cgcnet_tpu_torch.train.checkpoint import save_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = Config().apply_overrides(cs.SLIDE_DTYPE)
    feats, coords = synthetic_slide(cs.SLIDE_NUCLEI)
    inputs = build_slide_inputs(cfg, feats, coords, 1, dev).inputs
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(
            Path(tmp) / "model.pt",
            CGCNet(Config().model,
                   torch.Generator().manual_seed(1234)).state_dict(),
            Config(), {"origin": "slide_hold_probe random init, seed 1234"},
        )
        model = cs.slide_model(cfg, ckpt, dev)

    def loss(c, remat, replace=lambda key, wrapper, plain: wrapper):
        with cs.sites_replaced(replace):
            return cs.slide_grads(model, c, inputs, remat)[0]

    def plain_for(keys):
        return lambda key, wrapper, plain: plain if key in keys else wrapper

    cap = cfg.apply_overrides(cs.SLIDE_CAPACITY)
    for name, c, remat in (("capacity", cap, True), ("no chunk", cfg, False)):
        f32 = c.apply_overrides(["model.compute_dtype=float32"])
        ker, plain = loss(c, remat), loss(c, remat, plain_for(cs.KERNELS))
        p32 = loss(f32, remat, plain_for(cs.KERNELS))
        # chip_smoke.py's step_hold rule
        lim = (cs.LOGIT_ATOL + cs.LOGIT_RTOL * abs(plain)
               + cs.BF16_WIDEN * abs(plain - p32))
        print(f"{name}: kernels {ker:.6f}, plain versions {plain:.6f}, f32 "
              f"plain {p32:.6f}; |kernels - plain| {abs(ker - plain):.3e}, "
              f"tol {lim:.3e}: {'ok' if abs(ker - plain) <= lim else 'FAIL'}",
              flush=True)
        if holds_only:
            continue
        for key in ("B2", "B3", "B4", "B5", "B8", "B9a", "B9b"):
            print(f"  every kernel but {key}: "
                  f"{loss(c, remat, plain_for((key,))):.6f}", flush=True)

    def with_stats(fn):
        return loss(cap, True,
                    lambda key, wrapper, plain: fn if key == "B9b" else wrapper)

    def exact(x3, kc3, b3, n_nodes):
        p = ah.lin_p(x3, kc3, b3).double()
        rn = 1.0 / torch.clamp_min(
            torch.sqrt(torch.sum(p * p, -1, keepdim=True)), 1e-12)
        rows = ah._prefix_mask(n_nodes, p.shape[1]).double()[..., None]
        h = (torch.clamp_min(p, 0.0) * rn * rows).float().to(x3.dtype)
        h = h.double()
        return torch.sum(h, (0, 1)).float(), torch.sum(h * h, (0, 1)).float()

    if holds_only:
        print(torch.cuda.get_device_name(0))
        return 0
    print(f"capacity, B9b statistics exact: {with_stats(exact):.6f}",
          flush=True)
    for rel in (1e-9, 1e-8, 3e-8, 1e-7):
        got = []
        for seed in range(3):
            gen = torch.Generator(device=dev).manual_seed(seed)

            def nudged(*args, rel=rel, gen=gen):
                s, q = ah.l2relu_stats_lin_plain(*args)
                return tuple(t * (1 + rel * torch.randn(
                    t.shape, generator=gen, device=dev)) for t in (s, q))

            got.append(with_stats(nudged))
        print(f"capacity, plain B9b statistics nudged by {rel:g}: "
              + ", ".join(f"{v:.6f}" for v in got), flush=True)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
