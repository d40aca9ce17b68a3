#!/usr/bin/env python3
"""How far rounding alone moves the whole-slide bf16 loss that chip_smoke.py
holds (phases 9-10), on one NVIDIA GPU.

    python3 scripts/slide_hold_probe.py           # from the repository root
    python3 scripts/slide_hold_probe.py --holds   # the two holds only
    python3 scripts/slide_hold_probe.py --b9b     # the capacity hold under
                                                  # B9b statistics by route

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

``--b9b`` instead runs the capacity step's whole hold (loss and gradients,
``chip_smoke.py``'s rule) with B9b's statistics taken by route, every other
kernel on: the kernel, the plain version, the exact (f64) statistics, the
statistics of p formed on the tensor cores by B9a's routine (the test-only
``cgc_lin_p_probe``) summed by B3's kernel (row norm and sums in B9b's
order: a B9b with that p), by PyTorch and exactly, and the plain and exact
statistics nudged by a relative 1e-7 or 1e-6 (several seeds), with each
un-nudged route's distance from the exact statistics as ``chip_smoke.py``'s
statistics hold measures it; then how many p values the tensor-core routine
and a reversed-order dot round to another bf16 value than the plain
version.

Imports nothing of JAX. Needs a card.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def b9b_routes(cs, ah, model, inputs, cfg, dev) -> None:
    """The ``--b9b`` mode (module docstring)."""
    import torch
    from cgcnet_tpu_torch.ops import _cuda

    def grads(c, replace):
        with cs.sites_replaced(replace):
            return cs.slide_grads(model, c, inputs, True)

    cap = cfg.apply_overrides(cs.SLIDE_CAPACITY)
    plain_all = lambda key, wrapper, plain: plain  # noqa: E731
    g_plain = grads(cap, plain_all)
    g_32 = grads(cap.apply_overrides(["model.compute_dtype=float32"]),
                 plain_all)
    spread = {n: cs.BF16_WIDEN * (g_plain[1][n] - g_32[1][n]).abs().max()
              .item() for n in g_plain[1]}
    lim = (cs.LOGIT_ATOL + cs.LOGIT_RTOL * abs(g_plain[0])
           + cs.BF16_WIDEN * abs(g_plain[0] - g_32[0]))

    def mma_p(x3, kc3, b3):
        x = x3.reshape(-1, x3.shape[-1]).contiguous()
        kc3t = ah.pad_lin_kernel(kc3)
        bb = b3.to(torch.bfloat16).contiguous()
        p = torch.empty((x.shape[0], kc3.shape[1]), dtype=torch.bfloat16,
                        device=dev)
        _cuda.launch("cgc_lin_p_probe", x.data_ptr(), kc3t.data_ptr(),
                     bb.data_ptr(), p.data_ptr(), x.shape[0], x.shape[1],
                     kc3.shape[1], *kc3t.shape, dev.index,
                     _cuda.stream_of(x))
        return p.reshape(x3.shape[:-1] + (kc3.shape[1],))

    def exact(p, n_nodes):
        return tuple(t.float() for t in ah.l2relu_stats_reference(p, n_nodes))

    routes = {
        "plain": lambda a, kern: ah.l2relu_stats_lin_plain(*a),
        "kernel": lambda a, kern: kern(*a),
        "exact": lambda a, kern: exact(ah.lin_p(*a[:3]), a[3]),
        "tensor-core p, B3's kernel": lambda a, kern:
            ah.l2relu_stats(mma_p(*a[:3]), a[3]),
        "tensor-core p, PyTorch sums": lambda a, kern:
            ah.l2relu_stats_plain(mma_p(*a[:3]), a[3]),
        "tensor-core p, exact sums": lambda a, kern:
            exact(mma_p(*a[:3]), a[3]),
    }
    runs = [(name, 0.0, 0) for name in routes]
    runs += [("plain", 1e-7, s) for s in range(3)]
    runs += [("plain", 1e-6, s) for s in range(5)]
    runs += [("exact", 1e-6, s) for s in range(3)]
    seen = {}
    for name, rel, seed in runs:
        def fn(*args, name=name, rel=rel, seed=seed):
            seen.setdefault("args", args)
            st = routes[name](args, kern["w"])
            if rel:
                gen = torch.Generator(device=dev).manual_seed(seed)
                st = tuple(t * (1 + rel * torch.randn(
                    t.shape, generator=gen, device=dev)) for t in st)
            return st
        fn.launches = 0  # the wrapper counts through the name it replaces
        kern = {}

        def replace(key, wrapper, plain, fn=fn, kern=kern):
            if key != "B9b":
                return wrapper
            kern["w"] = wrapper
            return fn

        loss, g = grads(cap, replace)
        tag = f"B9b {name}" + (f", nudged by {rel:g} (seed {seed})"
                               if rel else "")
        if not rel:
            a = seen["args"]
            dist = ah.stats_distance(routes[name](a, kern["w"]),
                                     ah.l2relu_stats_lin_reference(*a))
            print(f"{tag}: statistics hold distance {dist:.3e} (tol "
                  f"{ah.STATS_TOL:.3e})", flush=True)
        verdict = "ok" if abs(loss - g_plain[0]) <= lim else "FAIL"
        print(f"{tag}: loss {loss:.6f}, |loss - plain| "
              f"{abs(loss - g_plain[0]):.3e} (tol {lim:.3e}) {verdict}",
              flush=True)
        try:
            cs.grads_close(f"{tag}: gradients", g, g_plain[1], cs.GRAD_REL,
                           widen=spread, zero_floor=cs.BF16_FLOOR)
        except SystemExit as e:
            print(f"  {e}", flush=True)
    x3, kc3, b3, _ = seen["args"]
    plain_p = ah.lin_p(x3, kc3, b3)
    for name, got in (("tensor-core routine", mma_p(x3, kc3, b3)),
                      ("reversed-order dot", ah.lin_p_reversed(x3, kc3, b3))):
        d = got.float() - plain_p.float()
        print(f"p values off the plain p, {name}: {int((d != 0).sum())} of "
              f"{d.numel()} ({int((d > 0).sum())} up, {int((d < 0).sum())} "
              "down)", flush=True)


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

    if "--b9b" in sys.argv[1:]:
        b9b_routes(cs, ah, model, inputs, cfg, dev)
        print(torch.cuda.get_device_name(0))
        return 0

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
