#!/usr/bin/env python3
"""Planted-fault witnesses of the holds that measure the port against the
spread of the reference's own right computations:

- ``stage1``: the bf16 stage-1 JK and embed1 gradients of the slide's block
  path (tests/test_torch_slide_bf16.py,
  ``test_block_path_stage1_bf16_gradients_within_jax_spread``); the
  faults: one row of B2's int8 transpose leg (one node's stage-1 backward
  aggregate) times 1.125, every row of it times 1.125, and times 2;
- ``halo``: the bf16 training loss on the halo-window strip at D = 2
  (tests/test_torch_multishard.py,
  ``test_block_path_halo_windows_bf16_loss_within_jax_spread``), the two
  ranks spawned here; the faults: one row of B2's int8 forward leg (one
  node's stage-1 aggregate) on rank 0 times 1.125, and every row of it;
- ``golden``: the golden fixture's SGD trajectory at step 20 against the
  port's float64 trajectory (tests/test_torch_golden.py,
  ``test_golden_sgd_long_trajectory_within_twice_of_float64``); the fault:
  one node's stage-1 edge weights (a row of the EllAdj's ``w``) times
  1.125 in the port's f32 trajectory. It also prints one step of each f32
  computation from the float64 trajectory's states (``one_step_errors``):
  whether the two compute the same function along the way.

    python3 scripts/spread_hold_witness.py [--holds stage1,halo,golden]

From the repository root, on the CPU (the plain versions; JAX in interpret
mode), with the test suite's helpers. For each hold it prints the right
computation's ratio and each planted fault's: the largest, over the held
quantities, of the port's distance over the hold's limit (twice the
reference's distance plus the tolerance) — at most 1 passes — with the
quantity that sets it; the golden hold is held both ways and prints the
larger of its two directions. ``stage1`` ~3 min, ``halo`` ~3 min,
``golden`` ~1 min.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
ROW, SCALE = 1000, 1.125


def worst(dists: dict, both_ways: bool = False) -> tuple[float, str]:
    """(largest ratio, its quantity) of {what: (d_port, d_ref, tol)}."""
    ratios = {}
    for what, (d_t, d_j, tol) in dists.items():
        r = d_t / (2.0 * d_j + tol)
        if both_ways:
            r = max(r, d_j / (2.0 * d_t + tol))
        ratios[what] = r
    what = max(ratios, key=ratios.get)
    return ratios[what], what


def report(hold: str, runs: dict, both_ways=False, each=False) -> None:
    """Each run's ratio ({kind: distances}, the right computation first);
    with ``each``, every quantity's ratios first."""
    if each:
        for what in next(iter(runs.values())):
            print(f"{hold}:   {what:36s} " + "  ".join(
                f"{worst({what: d[what]}, both_ways)[0]:.4f}"
                for d in runs.values()), flush=True)
    for kind, dists in runs.items():
        r, what = worst(dists, both_ways)
        print(f"{hold}: {kind}: ratio {r:.4f} ({what}) -> "
              f"{'passes' if r <= 1.0 else 'fails'}", flush=True)


def stage1() -> None:
    import torch

    import test_torch_slide_bf16 as t
    import torch_multishard_worker as worker
    from cgcnet_tpu_torch.ops import ell
    from cgcnet_tpu_torch.parallel.mesh import ONE

    res = t.bf16_result()
    r16, r32 = res["r16"], res["r32"]
    runs = {"right computation": t.stage1_bf16_distances(
        r16["t_grads"], r32["t_grads"])}
    orig = ell.bsr_matmul
    for row, scale in ((ROW, SCALE), (None, SCALE), (None, 2.0)):
        ell.bsr_matmul = worker.planted_b2(
            dict(leg="transpose", row=row, scale=scale, rank=0), r16["tinp"],
            ONE)
        try:
            faulty = t._port_variant(r16, {})
        finally:
            ell.bsr_matmul = orig
        assert not torch.equal(faulty["t_grads"]["embed1.gcn1.lin.bias"],
                               r16["t_grads"]["embed1.gcn1.lin.bias"])
        runs[f"planted fault ({_rows(row)} x {scale})"] = \
            t.stage1_bf16_distances(faulty["t_grads"], r32["t_grads"])
    report("stage1", runs, each=True)


def halo() -> None:
    import torch
    import torch.multiprocessing as tmp_mp

    import test_torch_multishard as tm
    import torch_multishard_worker as worker

    root = Path(tempfile.mkdtemp())
    (root / "out").mkdir()
    case = tm._model_case("halo", tm.HALO_CFG, *tm.halo_slide(), 4096, True,
                          False, variants=[("f32", {"compute_dtype":
                                                    "float32"}, {})],
                          spread=True)
    faults = {row: dict(case, name=f"halo_fault_{_rows(row)}", variants=[],
                        fault=dict(leg="forward", row=row, scale=SCALE,
                                   rank=0))
              for row in (ROW, None)}
    torch.save([case, *faults.values()], root / "job.pt")
    ctx = tmp_mp.start_processes(
        worker.run, args=(2, str(root / "init"), str(root / "job.pt"),
                          str(root / "out")),
        nprocs=2, join=False, start_method="spawn")
    ref = tm.jax_model(case, 2)
    while not ctx.join(timeout=600):
        pass
    res = [torch.load(root / "out" / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    t32 = tm._same_on_every_rank(res, "halo", "f32")["loss"]
    runs = {}
    for kind, name in (("right computation", "halo"),
                       *((f"planted fault ({_rows(row)} x {SCALE})",
                          c["name"]) for row, c in faults.items())):
        t16 = tm._same_on_every_rank(res, name, "base")["loss"]
        runs[kind] = {"loss": tm.halo_loss_distances(t16, t32, ref)}
        print(f"halo: {kind}: bf16 loss {t16!r}, port f32 {t32!r}, JAX "
              f"bf16 {tm.halo_loss_spread(ref)}", flush=True)
    report("halo", runs)


def one_step_errors(tg, graph, variables, steps=(0, 5, 10, 19)) -> None:
    """From the float64 trajectory's state after each of ``steps`` steps,
    one training-mode loss and gradient of the port in f32 and of JAX in
    f32 (jitted), each against the port's in float64: the loss's distance
    and the largest gradient distance over the tensors, each as a share of
    the tensor's max (at least 1e-3 of the model's largest gradient)."""
    import contextlib
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from flax.traverse_util import unflatten_dict

    from cgcnet_tpu_torch.config import ModelConfig
    from cgcnet_tpu_torch.train.checkpoint import _flatten
    from cgcnet_tpu_torch.train.checkpoint import state_dict_from_flax

    cfg = tg.compat_cfg()
    net = tg.jmodel.CGCNet(cfg)
    jg = tg.JaxCellGraph(**{k: jnp.asarray(v) for k, v in graph.items()},
                         y=jnp.asarray(tg.LABELS))

    def jax_variables(sd):
        """The port's state dict in the JAX model's tree (f32)."""
        out = {}
        for coll in ("params", "batch_stats"):
            flat = {}
            for path, _ in _flatten(variables[coll]).items():
                *mods, name = path
                port = ({"kernel": "weight", "scale": "weight"}.get(name, name)
                        if coll == "params" else
                        {"mean": "running_mean", "var": "running_var"}[name])
                arr = sd[".".join((*mods, port))].float().numpy()
                flat[path] = jnp.asarray(np.ascontiguousarray(
                    arr.T if name == "kernel" else arr))
            out[coll] = unflatten_dict(flat)
        return out

    def jax_grads(sd):
        v = jax_variables(sd)

        def loss(p):
            out, _ = net.apply({"params": p, "batch_stats": v["batch_stats"]},
                               jg, train=True, mutable=["batch_stats"])
            return tg.jmodel.cross_entropy_loss(out, jg.y)

        val, g = jax.jit(jax.value_and_grad(loss))(v["params"])
        return float(val), {k: t.double().numpy() for k, t in
                            state_dict_from_flax({"params": g}).items()}

    def port_grads(sd, f64):
        model = tg.tmodel.CGCNet(ModelConfig(**dataclasses.asdict(cfg)))
        model.load_state_dict({k: t.float() for k, t in sd.items()})
        g = tg._graph(graph, y=tg.LABELS)
        if f64:
            model.double()
            g = dataclasses.replace(g, x=g.x.double(),
                                    nbr_mask=g.nbr_mask.double())
        dtype = torch.get_default_dtype()
        try:
            if f64:
                torch.set_default_dtype(torch.float64)
            with tg.Float64Mode() if f64 else contextlib.nullcontext():
                loss = tg.tmodel.cross_entropy_loss(model.train()(g), g.y)
                loss.backward()
        finally:
            torch.set_default_dtype(dtype)
        return float(loss.detach()), {k: q.grad.double().numpy()
                                      for k, q in model.named_parameters()}

    for k in steps:
        sd = tg.port_trajectory(graph, variables, f64=True, steps=k)[2]
        l64, g64 = port_grads(sd, True)
        top = max(float(np.abs(a).max()) for a in g64.values())

        def err(loss, grads):
            share = {n: float(np.abs(grads[n] - g64[n]).max())
                     / max(float(np.abs(g64[n]).max()), 1e-3 * top)
                     for n in g64}
            worst_ = max(share, key=share.get)
            return (f"loss {abs(loss - l64):.3e}, gradients "
                    f"{share[worst_]:.3e} ({worst_})")

        print(f"golden: one step from the float64 state after {k} steps: "
              f"port f32 {err(*port_grads(sd, False))}; JAX f32 "
              f"{err(*jax_grads(sd))}", flush=True)


def golden() -> None:
    import test_torch_golden as tg

    fixture = tg.load_golden()
    graph, variables = fixture[0], fixture[1]
    tr = tg.trajectories(fixture)
    one_step_errors(tg, graph, variables)

    def hook(adj):
        adj.w = adj.w.clone()
        adj.w[0, 5] *= SCALE
        return adj

    faulty = tg.port_trajectory(graph, variables, adj_hook=hook)
    report("golden", {
        "right computation": tg.spread_distances(tr["port"], tr["jax"],
                                                 tr["f64"]),
        f"planted fault (node 5's edge weights x {SCALE})":
            tg.spread_distances(faulty, tr["jax"], tr["f64"])},
        both_ways=True)


def _rows(row) -> str:
    return "every row" if row is None else f"row {row}"


HOLDS = {"stage1": stage1, "halo": halo, "golden": golden}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--holds", default="stage1,halo,golden",
                    help="comma-separated: " + ",".join(HOLDS))
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    import conftest  # noqa: F401  (the suite's JAX CPU setup)
    import torch

    import cgcnet_tpu.ops.pallas.assign_head as jah
    import cgcnet_tpu.ops.pallas.bsr_kernel as bk

    torch.set_num_threads(1)  # as the test files run (their fixtures)
    bk.set_interpret(True)
    jah.set_interpret(True)
    for name in args.holds.split(","):
        HOLDS[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
