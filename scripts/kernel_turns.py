#!/usr/bin/env python3
"""Device time of hand-written kernels at the whole slide's and the patch
path's shapes, on one NVIDIA GPU, for this checkout's kernels or another's,
on inputs made from seeds. Groups of legs (``--legs``, default all):

- ``b2``: B2 (``bsr_matmul``) on the whole slide's int8 blocks (a synthetic
  100k-nuclei slide, one shard, built as ``cli.slide`` builds it) at F=18
  and F=40, the forward operator over [x ++ halo] and its transpose, with
  bf16 and f32 x; and on a patch batch at the canonical capacity (B=4,
  N=5760: radius-kNN graphs of 4000-5760 spatially sorted nuclei, norm_adj
  weights, block capacity quantized as the loader does) at F=18 and F=1140
  in f32, and at F=1140 with bf16 blocks and x;
- ``b9b``: B9b (``l2relu_stats_lin``) at the slide's shapes (100352 rows,
  100000 real, F3=20, C=1140) in bf16 and f32, and at C=2304 in bf16;
- ``b5``: B5 (``assign_tail_bwd``) on the slide's full rows (100352 x
  1140, 100000 real) in bf16 and f32, on the capacity path's chunks (65536
  rows, all real; 34816 rows, 34464 real) in bf16, and on a patch batch
  (B=4, N=5760, 4000-5760 real rows a graph) in f32 and bf16, and on the
  slide's full rows at C=2304 in bf16 (where u and w are not held);
- ``b3``: B3 (``l2relu_stats``) on the slide's rows (100352 x 1140,
  100000 real) in bf16 and f32 and on a patch batch (B=4, N=5760,
  4000-5760 real rows a graph) in f32 and bf16; each line also carries
  ``sha256``, the first 16 hex digits of the SHA-256 of the (sum, sumsq)
  bits, so two turns of one tree can be seen to agree;
- ``b1``: B1 (``bsr_build_blocks``) on a patch batch's A (as ``b2``) in f32
  and bf16, and on the slide's int8 blocks of A and of its transpose (as
  ``parallel.mega_model.build_vals`` builds them);
- ``head``: one whole-slide B4 call (``assign_head_softmax_pre``: 100352
  rows, 100000 real, F12=40, C=1140) in bf16 and f32, and one bf16 B9a
  call (``assign_head_softmax_pre_lin``, F3=20), split by
  ``chip_smoke.head_split`` into its row norm, product, softmax and other
  launches; the B9a leg also prints a checksum of its S (the first 16 hex
  digits of the SHA-256 of its bytes), so two commits' S can be compared
  bit for bit.

    python3 scripts/kernel_turns.py                    # this checkout's
    python3 scripts/kernel_turns.py --root DIR         # another checkout's
    python3 scripts/kernel_turns.py --legs b2,head     # some groups only

``--root`` imports ``cgcnet_tpu_torch`` (and builds its kernels) from DIR,
so two commits can be compared in one run on one card: run parent,
change, change, parent. A B2 without a ``live_slots`` argument (an older
checkout's) is called without it. Prints one JSON line per leg, with the
card's name and power limit: for ``b2``, ``b9b`` and ``b5`` legs ``ms``, the
median of ``--reps`` CUDA-event timings of the wrapper call
(``chip_smoke.time_ms``, as chip_smoke.py times a kernel: the wrapper's
host work included where the card would wait for it), and ``device_ms``,
the device time of the call's kernels from a torch.profiler trace (the
kernel alone; B9b's and B3's reductions and B2's lone launch), and for
``b5``, ``b3`` and ``b1`` legs ``bound_ms`` and ``bound_share`` (bound over
device ms): bytes over 3.35 TB/s — B5 p and dh over the real rows read
once and dp written once, B3 p over the real rows read once, B1 the ELL
slice and slot tables read once and the blocks written once; for ``head``
legs ``device_ms_per_call``, the device ms of each part. Imports nothing of
JAX. Needs a card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
SLIDE_NUCLEI, F3, F12, C = 100_000, 20, 40, 1140
PATCH_B, PATCH_N, CAPS = 4, 5760, (4, 6, 8, 12, 16)
GROUPS = ("b2", "b9b", "b5", "head", "b3", "b1")
PATCH_REAL = [4000, 5760, 4800, 5321]
_SLIDE = {}


def slide_inputs(dev):
    """The synthetic 100k-nuclei slide's block tables, one shard, bf16
    model (built once per run)."""
    if "inp" not in _SLIDE:
        from cgcnet_tpu_torch.config import Config
        from cgcnet_tpu_torch.parallel.slide_setup import (
            build_slide_inputs,
            synthetic_slide,
        )

        cfg = Config().apply_overrides(["model.compute_dtype=bfloat16"])
        feats, coords = synthetic_slide(SLIDE_NUCLEI)
        _SLIDE["inp"] = build_slide_inputs(cfg, feats, coords, 1, dev).inputs
    return _SLIDE["inp"]


def patch_batch(knn, bsr, seed: int = 0):
    """(nbr, w, blk_cols, blk_mask) numpy arrays of a canonical-capacity
    batch: norm_adj weights (self 0.4), block capacity the loader's."""
    rng = np.random.default_rng(seed)
    nbrs, ws, metas = [], [], []
    for _ in range(PATCH_B):
        n = int(rng.integers(4000, PATCH_N + 1))
        pos = rng.uniform(0, 60 * np.sqrt(n), (n, 2)).astype(np.float32)
        pos = pos[np.lexsort((pos[:, 1], np.floor(pos[:, 0] / 100.0)))]
        nbr, m = knn.radius_knn_np(pos, 100.0, 8)
        own = np.arange(n, PATCH_N, dtype=np.int32)[:, None]
        nbr = np.concatenate([nbr, np.tile(own, (1, 8))])
        m = np.concatenate([m, np.zeros((PATCH_N - n, 8), np.float32)])
        is_self = (nbr == np.arange(PATCH_N)[:, None]) * m
        off = m - is_self
        valid = (np.arange(PATCH_N) < n).astype(np.float32)
        scale = 0.6 / (off.sum(-1) + 1e-15) * valid
        ws.append((scale[:, None] * off
                   + (0.4 * valid)[:, None] * is_self).astype(np.float32))
        nbrs.append(nbr)
        metas.append((nbr, m))
    need = max(bsr.bsr_blocks_needed(nb, mk) for nb, mk in metas)
    cap = next(c for c in CAPS if c >= need)
    cols, masks = zip(*(bsr.bsr_block_meta(nb, mk, cap)[:2]
                        for nb, mk in metas))
    return (np.stack(nbrs), np.stack(ws), np.stack(cols).astype(np.int32),
            np.stack(masks))


def device_ms(fn, calls: int = 10):
    """(device ms per call of every kernel ``fn`` launches, {kernel name:
    device ms per call}) from the kernel events of a torch.profiler trace;
    (None, {}) where it holds none."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"(\w+)\s*[<(]", re.sub(r"^void\s+", "", e.name))
        key = m.group(1) if m else e.name[:40]
        split[key] = split.get(key, 0.0) + e.time_range.elapsed_us()
    us = sum(split.values())
    if not us:
        return None, {}
    return us / calls / 1e3, {k: v / calls / 1e3 for k, v in split.items()}


def b2_legs(bsr, knn, dev, rnd) -> list:
    """(name, call) of every B2 leg (module docstring)."""
    import torch

    live_arg = "live_slots" in inspect.signature(bsr.bsr_matmul).parameters

    def b2(vals, cols, x, slots):
        if live_arg:
            return lambda: bsr.bsr_matmul(vals, cols, x, slots)
        return lambda: bsr.bsr_matmul(vals, cols, x)

    legs = []
    inp = slide_inputs(dev)
    nc, ns = inp.nbr_t.shape[0], inp.nbr_remap.shape[0]
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for f in (18, 40):
            x, g = rnd(1, nc, f).to(dt), rnd(1, ns, f).to(dt)
            legs.append((f"B2 slide int8 A {tag} F={f}", b2(
                inp.vals, inp.blk_cols[None], x, inp.slots[None])))
            legs.append((f"B2 slide int8 A^T {tag} F={f}", b2(
                inp.vals_t, inp.blk_cols_t[None], g, inp.slots_t[None])))
    nbr, w, cols, mask = (torch.from_numpy(a).to(dev)
                          for a in patch_batch(knn, bsr))
    slots = bsr.live_slot_counts(mask)
    vals = {dt: bsr.bsr_build_blocks(nbr, w, cols, mask, dt)
            for dt in (torch.float32, torch.bfloat16)}
    m = cols.shape[-1]
    for dt, tag, f in ((torch.float32, "f32", 18),
                       (torch.float32, "f32", 1140),
                       (torch.bfloat16, "bf16", 1140)):
        x = rnd(PATCH_B, PATCH_N, f).to(dt)
        legs.append((f"B2 patch A {tag} M={m} F={f}",
                     b2(vals[dt], cols, x, slots)))
    return legs


def b9b_legs(ah, dev, rnd) -> list:
    """(name, call) of B9b at the slide's shapes, bf16 and f32, and at
    C=2304 in bf16."""
    import torch

    n_nodes = torch.tensor([SLIDE_NUCLEI], dtype=torch.int32, device=dev)
    rows = -(-SLIDE_NUCLEI // 512) * 512
    legs = []
    for dt, tag, c in ((torch.bfloat16, "bf16", C), (torch.float32, "f32", C),
                       (torch.bfloat16, "bf16", 2304)):
        kc3, b3 = rnd(F3, c) * 0.3, rnd(c) * 0.1
        x3 = torch.relu(rnd(1, rows, F3)).to(dt)
        legs.append((f"B9b {tag} N={rows} F3={F3} C={c}",
                     lambda x3=x3, kc3=kc3, b3=b3:
                         ah.l2relu_stats_lin(x3, kc3, b3, n_nodes)))
    return legs


def b5_legs(ah, dev, rnd) -> list:
    """(name, call, bound ms) of B5 (module docstring)."""
    import torch

    rows = -(-SLIDE_NUCLEI // 512) * 512
    shapes = [  # (tag, dtype, B, N, real rows per graph, C)
        ("slide full rows", torch.bfloat16, 1, rows, [SLIDE_NUCLEI], C),
        ("slide full rows", torch.float32, 1, rows, [SLIDE_NUCLEI], C),
        ("capacity chunk", torch.bfloat16, 1, 65536, [65536], C),
        ("capacity chunk", torch.bfloat16, 1, rows - 65536,
         [SLIDE_NUCLEI - 65536], C),
        ("patch", torch.float32, PATCH_B, PATCH_N, PATCH_REAL, C),
        ("patch", torch.bfloat16, PATCH_B, PATCH_N, PATCH_REAL, C),
        # u and w read per vector, not held (C above 1280)
        ("slide full rows", torch.bfloat16, 1, rows, [SLIDE_NUCLEI], 2304),
    ]
    legs = []
    for tag, dt, b, n, real, cc in shapes:
        n_nodes = torch.tensor(real, dtype=torch.int32, device=dev)
        p, dh = rnd(b, n, cc).to(dt), (rnd(b, n, cc) * 1e-3).to(dt)
        u, w = rnd(cc) * 1e-3, rnd(cc) * 1e-3
        isz = p.element_size()
        bound = (2 * sum(real) + b * n) * cc * isz / 3.35e12 * 1e3
        name = f"B5 {tag} {str(dt).split('.')[-1]} B={b} N={n} C={cc}"
        legs.append((name, lambda a=(p, dh, u, w, n_nodes):
                     ah.assign_tail_bwd(*a), bound))
    return legs


def b3_legs(ah, dev, rnd) -> list:
    """(name, call, bound ms, p, n_nodes) of B3 (module docstring)."""
    import torch

    rows = -(-SLIDE_NUCLEI // 512) * 512
    shapes = [  # (tag, dtype, B, N, real rows per graph)
        ("slide", torch.bfloat16, 1, rows, [SLIDE_NUCLEI]),
        ("slide", torch.float32, 1, rows, [SLIDE_NUCLEI]),
        ("patch", torch.float32, PATCH_B, PATCH_N, PATCH_REAL),
        ("patch", torch.bfloat16, PATCH_B, PATCH_N, PATCH_REAL),
    ]
    legs = []
    for tag, dt, b, n, real in shapes:
        n_nodes = torch.tensor(real, dtype=torch.int32, device=dev)
        p = rnd(b, n, C).to(dt)
        bound = sum(real) * C * p.element_size() / 3.35e12 * 1e3
        name = f"B3 {tag} {str(dt).split('.')[-1]} B={b} N={n} C={C}"
        legs.append((name, lambda p=p, nn=n_nodes: ah.l2relu_stats(p, nn),
                     bound, p, n_nodes))
    return legs


def b1_legs(bsr, knn, dev) -> list:
    """(name, call, bound ms) of B1 (module docstring)."""
    import torch

    t = bsr.TILE
    nbr, w, cols, mask = (torch.from_numpy(a).to(dev)
                          for a in patch_batch(knn, bsr))
    inp = slide_inputs(dev)
    row = torch.arange(inp.nbr_remap.shape[0], device=dev)
    off = inp.nbr_mask * (inp.nbr_remap != row[:, None]).to(
        inp.nbr_mask.dtype)
    tr = inp.blk_cols_t.shape[0] * t
    cases = [
        ("patch A f32", (nbr, w, cols, mask, torch.float32)),
        ("patch A bf16", (nbr, w, cols, mask, torch.bfloat16)),
        ("slide int8 A", (inp.nbr_remap[None], off[None],
                          inp.blk_cols[None], inp.blk_mask[None],
                          torch.int8)),
        ("slide int8 A^T", (inp.nbr_t[None, :tr], inp.mask_t[None, :tr],
                            inp.blk_cols_t[None], inp.blk_mask_t[None],
                            torch.int8)),
    ]
    legs = []
    for tag, a in cases:
        b, n, k = a[0].shape
        r, m = a[2].shape[1:]
        isz = torch.empty((), dtype=a[4]).element_size()
        bytes_ = b * n * k * 8 + b * r * m * 8 + b * r * m * t * t * isz
        legs.append((f"B1 {tag} B={b} N={n} K={k} M={m}",
                     lambda a=a: bsr.bsr_build_blocks(*a),
                     bytes_ / 3.35e12 * 1e3))
    return legs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--calls", type=int, default=5,
                    help="head calls traced per split")
    ap.add_argument("--legs", default=",".join(GROUPS),
                    help="comma-separated groups: " + ", ".join(GROUPS))
    args = ap.parse_args()
    groups = args.legs.split(",")
    if not set(groups) <= set(GROUPS):
        ap.error(f"--legs: groups are {', '.join(GROUPS)}")
    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    # this checkout's chip_smoke (time_ms, head_split), the kernels of --root
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(Path(args.root).resolve()))
    from cgcnet_tpu_torch.ops import assign_head as ah
    from cgcnet_tpu_torch.ops import bsr, knn

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    legs = []
    if "b2" in groups:
        legs += [(n, fn, None) for n, fn in b2_legs(bsr, knn, dev, rnd)]
    if "b9b" in groups:
        legs += [(n, fn, None) for n, fn in b9b_legs(ah, dev, rnd)]
    if "b5" in groups:
        legs += b5_legs(ah, dev, rnd)
    sums = {}
    if "b3" in groups:
        for name, fn, bound, p, nn in b3_legs(ah, dev, rnd):
            out = torch.stack(ah.l2relu_stats(p, nn))
            sums[name] = hashlib.sha256(
                out.cpu().numpy().tobytes()).hexdigest()[:16]
            legs.append((name, fn, bound))
    if "b1" in groups:
        legs += b1_legs(bsr, knn, dev)
    for name, fn, bound in legs:
        ms = cs.time_ms(fn, reps=args.reps)
        dev_ms, split = device_ms(fn)
        line = {"root": args.root, "leg": name, "ms": ms,
                "device_ms": dev_ms, "device": smi}
        if len(split) > 1:
            line["device_ms_by_kernel"] = split
        if bound is not None:
            line["bound_ms"] = bound
            if dev_ms:
                line["bound_share"] = bound / dev_ms
        if name in sums:
            line["sha256"] = sums[name]
        print(json.dumps(line), flush=True)
    del legs
    _SLIDE.clear()
    torch.cuda.empty_cache()
    if "head" in groups:
        n_nodes = torch.tensor([SLIDE_NUCLEI], dtype=torch.int32, device=dev)
        rows = -(-SLIDE_NUCLEI // 512) * 512
        for dt in (torch.bfloat16, torch.float32):
            x12, p = rnd(1, rows, F12).to(dt), rnd(1, rows, C).to(dt)
            k12, k3f, const = rnd(F12, C) * 0.2, rnd(C, C) * 0.05, rnd(C) * 0.1
            split = cs.head_split(lambda: ah.assign_head_softmax_pre(
                x12, p, k12, k3f, const, n_nodes), calls=args.calls)
            tag = str(dt).split(".")[-1]
            print(json.dumps({
                "root": args.root, "leg": f"B4 head {tag} N={rows} F12={F12} "
                f"C={C}", "device_ms_per_call": split, "device": smi}),
                flush=True)
            del x12, p
            torch.cuda.empty_cache()
        x12 = rnd(1, rows, F12).bfloat16()
        x3 = torch.relu(rnd(1, rows, F3)).bfloat16()
        kc3, b3 = rnd(F3, C) * 0.3, rnd(C) * 0.1
        k12, k3f, const = rnd(F12, C) * 0.2, rnd(C, C) * 0.05, rnd(C) * 0.1
        a9 = (x12, x3, kc3, b3, k12, k3f, const, n_nodes)
        s = ah.assign_head_softmax_pre_lin(*a9)
        digest = hashlib.sha256(
            s.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
        split = cs.head_split(lambda: ah.assign_head_softmax_pre_lin(*a9),
                              calls=args.calls)
        print(json.dumps({
            "root": args.root, "leg": f"B9a head bfloat16 N={rows} "
            f"F12={F12} F3={F3} C={C}", "device_ms_per_call": split,
            "s_sha256": digest, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
