#!/usr/bin/env python3
"""How far rounding alone moves the whole-slide bf16 loss that chip_smoke.py
holds (phases 9-10), on one NVIDIA GPU.

    python3 scripts/slide_hold_probe.py           # from the repository root
    python3 scripts/slide_hold_probe.py --holds   # the two holds only
    python3 scripts/slide_hold_probe.py --witness # the step holds against
                                                  # a planted fault

On chip_smoke.py's slide (``synthetic_slide(100000)``, one shard, bf16,
the canonical model with its random initialisation, seed 1234) it prints
the one-step loss of the capacity path (``assign_tail_chunk=65536``,
``remat_stage1``) and of the no-chunk path:

- with every kernel, with the plain versions but for the
  ``assign_head.STATS_HELD`` kernels (B3, B9b: both sides read the same
  statistics), and in f32 all plain (the three numbers ``chip_smoke.py``'s
  step hold compares), with the hold's tolerance and verdict (``--holds``
  stops here);
- with every kernel but one, that one routed to its plain version (which
  kernel moves the loss);
- capacity path only: with the assign tail's BN statistics (B9b) taken
  from the plain version and nudged by a relative 1e-9 .. 1e-7 (three
  seeds each), and taken exactly (row norm and sums in f64, rounded once)
  — how much the loss moves when only the last bits of the statistics do.

``--witness`` runs, for the no-chunk and the capacity step,
``chip_smoke.step_hold`` against ten kernel sides: every kernel, and every
kernel with one planted fault — B5 with the statistics' cotangents u and w
dropped (zeros; a backward fault), and forward faults, which may move
readout nodes: B8 with every 64th row of its output times 1 + 2^-3, the
assign head (B4, B9a) with cluster 0's column of S times 1 + 2^-1, 4 or
16, and B2 with one node's row of its output times 1 + 2^-3, 2, 8 or 64
(stage 1's aggregation, read by the first readout). For each it prints the
loss difference and the worst gradient as fractions of their tolerances
(above 1 fails) in three forms: the old one (the plain side all plain),
the shared statistics alone (the plain bf16 side keeps the
``assign_head.STATS_HELD`` kernels, B3 and B9b), and ``chip_smoke.py``'s
(the shared statistics, the gradients on the kernel step's readout
routing, bounded by ``READOUT_STEPS`` and ``READOUT_SHARE``), with the
routed readouts' worst gap and moved share; and how far each fault moves
the gradients against the routed hold's tolerance. Then
``chip_smoke.py``'s form with both sides' held statistics nudged by the
same relative 1e-7 (four draws): how often the hold passes on equally
right statistics. Then, for each max readout of the forward
(``torch.amax`` over the nodes, as ``chip_smoke.readout_routing`` records
them), how many feature columns change their argmax node between the plain
side and the kernels, and the exact statistics.
``--root DIR`` takes the package (and kernels) of another checkout.

Imports nothing of JAX. Needs a card.
"""

from __future__ import annotations

import importlib.util
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent


def exact_stats(p, n_nodes):
    """The exact (f64) statistics of p's h, in f32."""
    from cgcnet_tpu_torch.ops import assign_head as ah

    return tuple(t.float() for t in ah.l2relu_stats_reference(p, n_nodes))


def witness(cs, ah, model, inputs, cfg, draws: int = 4) -> None:
    """The ``--witness`` mode (module docstring)."""
    from cgcnet_tpu_torch.parallel.mega_model import mega_forward

    cap = cfg.apply_overrides(cs.SLIDE_CAPACITY)

    def b5_fault(key, wrapper, plain):
        if key != "B5":
            return wrapper

        def faulty(p, dh, u, w, n_nodes):
            return wrapper(p, dh, torch.zeros_like(u), torch.zeros_like(w),
                           n_nodes)
        faulty.launches = 0  # the wrapper counts through the name it replaces
        return faulty

    def b8_fault(rel):
        """B8 with every 64th row of its output times (1 + rel)."""
        def replace(key, wrapper, plain):
            if key != "B8":
                return wrapper

            def bump(t):
                t = t.clone()
                t[(slice(None),) * (t.dim() - 2) + (slice(None, None, 64),)] \
                    *= 1 + rel
                return t

            def faulty(*args, **kwargs):
                out = wrapper(*args, **kwargs)
                if isinstance(out, tuple):
                    return (bump(out[0]),) + tuple(out[1:])
                return bump(out)
            faulty.launches = 0
            return faulty
        replace.__name__ = f"B8 rows bumped by {rel:g}"
        return replace

    def b2_fault(rel, row=1000):
        """B2 with one row of its output (one node's aggregate at stage
        1) times (1 + rel)."""
        def replace(key, wrapper, plain):
            if key != "B2":
                return wrapper

            def faulty(*args, **kwargs):
                out = wrapper(*args, **kwargs).clone()
                out[..., row, :] *= 1 + rel
                return out
            faulty.launches = 0
            return faulty
        replace.__name__ = f"B2 row {row} times 1 + {rel:g}"
        return replace

    def head_fault(rel):
        """The assign head (B4, B9a) with cluster 0's column of S times
        (1 + rel): one pooled node of stage 2 too large."""
        def replace(key, wrapper, plain):
            if key not in ("B4", "B9a"):
                return wrapper

            def faulty(*args, **kwargs):
                out = wrapper(*args, **kwargs)
                s = out[0] if isinstance(out, tuple) else out
                s = s.clone()
                s[..., 0] *= 1 + rel
                # B4 returns S and its transpose
                return (s, s.transpose(1, 2)) if isinstance(out, tuple) else s
            faulty.launches = 0
            return faulty
        replace.__name__ = f"head S column 0 times 1 + {rel:g}"
        return replace

    def nudged(fn, seed, rel=1e-7):
        """``fn``'s statistics times (1 + rel * N(0, 1)), the same draw at
        every call."""
        def stats(*args):
            gen = torch.Generator(device=args[0].device).manual_seed(seed)
            return tuple(t * (1 + rel * torch.randn(
                t.shape, generator=gen, device=t.device)) for t in fn(*args))
        stats.launches = 0
        return stats

    def held(base, seed):
        """``base``'s routing with the held statistics nudged (seed)."""
        def replace(key, wrapper, plain):
            if key in ah.STATS_HELD:
                return nudged(wrapper, seed)
            return base(key, wrapper, plain)
        replace.__name__ = f"{base.__name__}, held statistics nudged"
        return replace

    sides = {
        "every kernel": cs.every_kernel,
        "planted fault: B5 without u, w": b5_fault,
        "planted fault: B8 rows 0, 64, ... times 1 + 2^-3": b8_fault(2 ** -3),
        "planted fault: S column 0 times 1 + 2^-1": head_fault(2 ** -1),
        "planted fault: S column 0 times 4": head_fault(3.0),
        "planted fault: S column 0 times 16": head_fault(15.0),
        "planted fault: B2 row 1000 times 1 + 2^-3": b2_fault(2 ** -3),
        "planted fault: B2 row 1000 times 2": b2_fault(1.0),
        "planted fault: B2 row 1000 times 8": b2_fault(7.0),
        "planted fault: B2 row 1000 times 64": b2_fault(63.0),
    }
    for path, c, remat in (("no chunk", cfg, False), ("capacity", cap, True)):
        def hold(what, kernel, plain=cs.stats_shared):
            return cs.step_hold(model, c, inputs, remat, f"{path}, {what}",
                                kernel=kernel, plain=plain)

        def show(what, r, old=None):
            shipped = cs.step_verdict(r)
            print(f"witness {path}, {what}: loss {r['loss']:.3f} of its "
                  "tolerance; gradients"
                  + (f" in the old form (plain side all plain) "
                     f"{old['unrouted']:.3f} -> "
                     f"{'FAIL' if old['unrouted'] > 1 else 'ok'};"
                     if old is not None else "")
                  + f" with the statistics shared alone (B3, B9b) "
                  f"{r['unrouted']:.3f} -> "
                  f"{'FAIL' if r['unrouted'] > 1 else 'ok'}; routed "
                  f"(chip_smoke.py's hold) {r['worst']} at {r['grad']:.3f}, "
                  f"readouts: worst gap {r['steps']:.2f} bf16 steps, moved "
                  f"share {r['share']:.3f} -> "
                  + ("FAIL: " + "; ".join(shipped) if shipped else "ok"),
                  flush=True)

        got = {}
        for side, kernel in sides.items():
            old = hold(f"{side}, old form", kernel, cs.all_plain)
            got[side] = hold(side, kernel)
            show(side, got[side], old)
        ok = got["every kernel"]
        for side in list(sides)[1:]:
            name, moved = cs.grads_close(
                f"{path}, {side} against every kernel", got[side]["g_ker"],
                ok["g_ker"], cs.GRAD_REL, widen=ok["spread"],
                zero_floor=cs.BF16_FLOOR, strict=False)
            print(f"witness {path}, {side}: moves {name} by {moved:.3f} of "
                  "the routed hold's tolerance (its largest move)",
                  flush=True)
        for seed in range(draws):
            what = f"both sides' held statistics nudged by 1e-7 (seed {seed})"
            show(what, hold(what, held(cs.every_kernel, seed),
                            held(cs.all_plain, seed)))

        def readouts(replace):
            routing = cs.readout_routing()
            with torch.no_grad(), cs.sites_replaced(replace), routing:
                mega_forward(model, c.model, inputs, train=True,
                             remat_stage1=remat and c.mesh.remat_stage1)
            return routing.masks

        plain = readouts(cs.stats_shared)
        pairs = {"kernels": readouts(cs.every_kernel),
                 "the exact B9b / B3 statistics": readouts(
                     lambda key, wrapper, plain_: exact_held(ah, key, wrapper,
                                                             plain_))}
        for what, got in pairs.items():
            for i, (a, b) in enumerate(zip(plain, got)):
                print(f"{path}: max readout {i} over {a.shape[1]} columns: "
                      f"{int((a != b).any(0).sum())} change their argmax "
                      f"node between the new form's plain side and {what}",
                      flush=True)


def exact_held(ah, key, wrapper, plain):
    """The new form's plain side with the held statistics taken exactly."""
    if key == "B3":
        fn = lambda p, n_nodes: exact_stats(p, n_nodes)  # noqa: E731
    elif key == "B9b":
        fn = lambda x3, kc3, b3, n_nodes: exact_stats(  # noqa: E731
            ah.lin_p(x3, kc3, b3), n_nodes)
    else:
        return plain
    fn.launches = 0
    return fn


def main() -> int:

    args = sys.argv[1:]
    holds_only = "--holds" in args
    if not torch.cuda.is_available():
        print("slide_hold_probe: no CUDA device", file=sys.stderr)
        return 2
    # --root DIR: the kernels and package of another checkout, this one's
    # holds (chip_smoke.py)
    root = args[args.index("--root") + 1] if "--root" in args else str(REPO)
    sys.path.insert(0, str(Path(root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from cgcnet_tpu_torch.config import Config
    from cgcnet_tpu_torch.nn.model import CGCNet
    from cgcnet_tpu_torch.ops import assign_head as ah
    from cgcnet_tpu_torch.parallel.slide_setup import (
        build_slide_inputs,
        synthetic_slide,
    )
    from cgcnet_tpu_torch.train.checkpoint import save_checkpoint

    if not hasattr(ah, "STATS_HELD"):  # a checkout from before the rule
        ah.STATS_HELD = ("B3", "B9b")
    print(f"package: {Path(ah.__file__).resolve().parent.parent}",
          flush=True)
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

    if "--witness" in sys.argv[1:]:
        witness(cs, ah, model, inputs, cfg)
        print(torch.cuda.get_device_name(0))
        return 0

    def loss(c, remat, replace=cs.every_kernel):
        with cs.sites_replaced(replace):
            return cs.slide_grads(model, c, inputs, remat)[0]

    def plain_for(keys):
        return lambda key, wrapper, plain: plain if key in keys else wrapper

    cap = cfg.apply_overrides(cs.SLIDE_CAPACITY)
    for name, c, remat in (("capacity", cap, True), ("no chunk", cfg, False)):
        f32 = c.apply_overrides(["model.compute_dtype=float32"])
        ker, plain = loss(c, remat), loss(c, remat, cs.stats_shared)
        p32 = loss(f32, remat, cs.all_plain)
        # chip_smoke.py's step_hold rule: the plain side keeps the
        # STATS_HELD kernels
        lim = (cs.LOGIT_ATOL + cs.LOGIT_RTOL * abs(plain)
               + cs.BF16_WIDEN * abs(plain - p32))
        print(f"{name}: kernels {ker:.6f}, plain versions (sharing "
              f"{', '.join(ah.STATS_HELD)}) {plain:.6f}, f32 plain "
              f"{p32:.6f}; |kernels - plain| {abs(ker - plain):.3e}, tol "
              f"{lim:.3e}: {'ok' if abs(ker - plain) <= lim else 'FAIL'}",
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
