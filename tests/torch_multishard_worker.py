"""One rank of tests/test_torch_multishard.py: the port's whole-slide path
as one process per shard over a gloo group on the CPU.

Imports torch, numpy and the port only (a spawned rank imports no JAX).
The test writes a job (``torch.save``: the cases, their slides, weights and
cotangents as numpy arrays and tensors), spawns ``world`` ranks of
:func:`run`, and reads back each rank's results (``rank{r}.pt``).
"""

from __future__ import annotations

import dataclasses
import datetime
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from cgcnet_tpu_torch.config import ModelConfig
from cgcnet_tpu_torch.nn.model import CGCNet
from cgcnet_tpu_torch.ops import assign_head as ah
from cgcnet_tpu_torch.ops import bsr as tbsr
from cgcnet_tpu_torch.ops import ell
from cgcnet_tpu_torch.parallel import mega_graph as tmg
from cgcnet_tpu_torch.parallel import mega_model as tmm
from cgcnet_tpu_torch.parallel import mega_train as tmt
from cgcnet_tpu_torch.parallel.mesh import GraphAxis, init_graph_axis

# a rank that waits longer than this on the others fails (and with it the
# test) instead of hanging
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)
# calls of the slide's training tails (counted while a model case runs)
TAILS = {"psum": 0, "chunked_lin": 0}


def _model(case) -> tuple[ModelConfig, CGCNet]:
    cfg = ModelConfig(**case["mcfg"])
    model = CGCNet(cfg)
    model.load_state_dict(case["state_dict"])
    return cfg, model.eval()


def _inputs(case, axis: GraphAxis) -> tmm.MegaInputs:
    x, nbr, mask = case["x"], case["nbr"], case["mask"]
    part = tmg.partition_graph(nbr, mask, axis.size)
    tables = tmg.build_bsr_tables(part) if case["tables"] else None
    return tmm.prepare_mega_inputs(x, part, "cpu", n_real=case["n_real"],
                                   bsr=tables, axis=axis)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().copy()


def _stats_sd(stats: dict) -> dict:
    return {f"{blk}.{bn}.running_{k}": _np(st[k])
            for blk, bns in stats.items() for bn, st in bns.items()
            for k in ("mean", "var")}


def _port_run(model, cfg, inp, label, eval_only=False, **fwd) -> dict:
    """Eval logits and, unless ``eval_only``, the training loss, gradients
    (loss / D backpropagated, then summed over the axis, as a training
    step does) and running statistics."""
    with torch.no_grad():
        out = {"eval": _np(tmm.mega_forward(model, cfg, inp, train=False,
                                            **fwd))}
    if eval_only:
        return out
    model.zero_grad(set_to_none=True)
    tails = dict(TAILS)
    logits, stats = tmm.mega_forward(model, cfg, inp, train=True,
                                     return_stats=True, **fwd)
    loss = -torch.log_softmax(logits, -1)[label]
    (loss / inp.axis.size).backward()
    tmt.reduce_grads(model, inp.axis)
    out.update(loss=float(loss.detach()), stats=_stats_sd(stats),
               tail={k: TAILS[k] - tails[k] for k in TAILS},
               grads={n: _np(p.grad) for n, p in model.named_parameters()
                      if p.grad is not None})
    model.zero_grad(set_to_none=True)
    return out


def planted_b2(fault: dict, inp: tmm.MegaInputs, axis: GraphAxis):
    """B2 (``ops/ell.py``'s) with a planted fault on rank ``fault["rank"]``:
    row ``fault["row"]`` (every row for None) of each output of its
    ``fault["leg"]`` leg — the int8 blocks ``vals`` ("forward") or
    ``vals_t`` ("transpose") — times ``fault["scale"]``. The planted-fault
    witnesses' (scripts/spread_hold_witness.py)."""
    orig = ell.bsr_matmul
    leg = inp.vals if fault["leg"] == "forward" else inp.vals_t

    def faulty(vals, *args, **kwargs):
        out = orig(vals, *args, **kwargs)
        if axis.rank == fault["rank"] and vals.data_ptr() == leg.data_ptr():
            out = out.clone()
            row = fault["row"]
            out[..., slice(None) if row is None else row, :] *= fault["scale"]
        return out
    return faulty


def model_case(case, axis: GraphAxis) -> dict:
    """The port's mega_forward on this rank's shard: the case's config and
    each port-only variant (config overrides, forward kwargs), and the
    facts of its tables (halo windows, hybrid transpose) and of its B8
    calls (whether each passed halo windows); with a planted ``fault``,
    through :func:`planted_b2`."""
    cfg, model = _model(case)
    inp = _inputs(case, axis)
    calls = []
    orig = (tbsr.bsr_matmul_banded_plain, ah.assign_tail_train_psum,
            ah.assign_tail_train_chunked_lin, ell.bsr_matmul)
    if case.get("fault"):
        ell.bsr_matmul = planted_b2(case["fault"], inp, axis)

    def counting(*a, **kw):
        # bsr_matmul_banded_plain(vals, blk_cols, win_base, x, ns_rows,
        # halo, halo_win, ...)
        hw = a[6] if len(a) > 6 else kw.get("halo_win")
        calls.append(hw is not None and hw.shape[-1] > 0)
        return orig[0](*a, **kw)

    def tail(name, fn):
        def counted(*a, **kw):
            TAILS[name] += 1
            return fn(*a, **kw)
        return counted

    tbsr.bsr_matmul_banded_plain = counting
    ah.assign_tail_train_psum = tail("psum", orig[1])
    ah.assign_tail_train_chunked_lin = tail("chunked_lin", orig[2])
    try:
        res = {"base": _port_run(model, cfg, inp, case["label"],
                                 case["eval_only"], **case["fwd"])}
        for name, over, fwd in case["variants"]:
            vcfg = dataclasses.replace(cfg, **over)
            vmodel = CGCNet(vcfg)
            vmodel.load_state_dict(model.state_dict())
            res[name] = _port_run(vmodel.eval(), vcfg, inp, case["label"],
                                  case["eval_only"], **fwd)
    finally:
        (tbsr.bsr_matmul_banded_plain, ah.assign_tail_train_psum,
         ah.assign_tail_train_chunked_lin, ell.bsr_matmul) = orig
    res["b8_halo_window_calls"] = sum(calls)
    res["win_halo"] = inp.win_halo is not None
    return res


def steps_case(case, axis: GraphAxis) -> dict:
    """Two ``make_slide_train_step`` steps (Adam, head dropout from the
    per-step generator); this rank's parameters, Adam state and running
    statistics after each."""
    cfg, model = _model(case)
    inp = _inputs(case, axis)
    model.train()
    opt = tmt.make_optimizer(model, 1e-3)
    step = tmt.make_slide_train_step(model, cfg, opt)
    out = []
    for i in range(2):
        loss = step(inp, case["label"], tmt.step_generator(inp.device, 0, i))
        state = {f"param.{n}": p.detach().clone()
                 for n, p in model.named_parameters()}
        state.update({f"buffer.{n}": b.clone()
                      for n, b in model.named_buffers()})
        for n, p in model.named_parameters():
            for k, v in opt.state[p].items():
                state[f"adam.{n}.{k}"] = v.clone()
        out.append({"loss": float(loss), "state": state})
    return {"steps": out}


def collectives_case(case, axis: GraphAxis) -> dict:
    """The collectives and the reference aggregations on this rank's shard
    of a graph, with their backward: through autograd, and the halo
    exchange's also through the explicit reverse all-to-all."""
    x, nbr, mask = case["x"], case["nbr"], case["mask"]
    d, r = axis.size, axis.rank
    part = tmg.partition_graph(nbr, mask, d)
    ns = x.shape[0] // d
    rows = slice(r * ns, (r + 1) * ns)
    xr = torch.tensor(x[rows], requires_grad=True)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.ascontiguousarray(a),
                                                   dtype=dt)
    nbr_r, mask_r = t(part.nbr_remap[r], torch.int32), t(part.nbr_mask[r])
    req_i, req_m = t(part.req_idx[r], torch.int32), t(part.req_mask[r])
    out = {}
    halo = tmg.halo_exchange(xr, req_i, req_m, axis)
    out["halo"] = _np(halo)
    gh = t(case["g_halo"][r])
    (auto,) = torch.autograd.grad(halo, xr, gh)
    out["halo_grad_autograd"] = _np(auto)
    out["halo_grad_vjp"] = _np(tmg.halo_exchange_vjp(gh, req_i, req_m, ns,
                                                     axis))
    g = t(case["g_out"][rows])
    for name, fn, args in (
            ("gather", tmg.sharded_gather_sum,
             (nbr_r, mask_r, mask_r, req_i, req_m)),
            ("overlap", tmg.sharded_gather_sum_overlap,
             (nbr_r, mask_r, mask_r, req_i, req_m)),
            ("allgather", tmg.sharded_gather_sum_allgather,
             (t(nbr[rows], torch.int32), t(mask[rows])))):
        y = fn(xr, *args, axis=axis)
        (gx,) = torch.autograd.grad(y, xr, g)
        out[name], out[name + "_grad"] = _np(y), _np(gx)
    # psum / all_gather of exact values (small integers: sums exact in any
    # order) with their backward
    v = torch.tensor(case["v"][r], requires_grad=True)
    gv = torch.tensor(case["gv"][r])
    for name, fn in (("psum", tmg.psum), ("all_gather", tmg.all_gather)):
        y = fn(v, axis)
        (gy,) = torch.autograd.grad(y, v, gv if name == "psum"
                                    else torch.tensor(case["gv_stack"][r]))
        out[name], out[name + "_grad"] = _np(y), _np(gy)
    bf = torch.tensor(case["v"][r]).to(torch.bfloat16) / 3
    out["psum_bf16"] = tmg.psum(bf, axis)
    out["halo_bf16"] = tmg.halo_exchange(xr.detach().to(torch.bfloat16),
                                         req_i, req_m, axis)
    return out


def pool_case(case, axis: GraphAxis) -> dict:
    """``PoolAggregate`` (the A @ S leg and both DiffPool contractions, the
    transpose leg's backward through B8's plain version and, with a hybrid
    transpose, the halo rows' in-edges as an ELL gather) on this rank's
    shard in f32, its outputs summed over the axis as mega_forward sums
    them, and its gradient of sum(x_pool * ct_x) + sum(adj_pool * ct_adj)."""
    cfg = ModelConfig(**case["mcfg"])
    inp = _inputs(case, axis)
    adj = tmm.ShardedAdj(inp, cfg)
    pa = adj.pool_aggregate_args()
    ns = inp.x.shape[0]
    rows = slice(axis.rank * ns, (axis.rank + 1) * ns)
    s = torch.tensor(case["s"][rows], requires_grad=True)
    pembed = torch.tensor(case["pembed"][rows], requires_grad=True)
    x_pool, adj_pool = tmm.PoolAggregate.apply(pa, adj.scale, adj.self_w,
                                               adj.pool_ratio, s, pembed)
    x_pool, adj_pool = tmg.psum(x_pool, axis), tmg.psum(adj_pool, axis)
    loss = (x_pool * torch.tensor(case["ct_x"])).sum() \
        + (adj_pool * torch.tensor(case["ct_adj"])).sum()
    (loss / axis.size).backward()
    nbr_t_h = pa[7]
    return {"x_pool": _np(x_pool), "adj_pool": _np(adj_pool),
            "ds": _np(s.grad), "dpembed": _np(pembed.grad),
            "hybrid_rows": 0 if nbr_t_h is None else int(nbr_t_h.shape[0])}


def cli_case(case, axis: GraphAxis) -> dict:
    """``cli.slide.main`` with the case's arguments, inside this group."""
    from cgcnet_tpu_torch.cli import slide as slide_cli

    res = slide_cli.main(case["argv"])
    return {k: res[k] for k in ("logits", "pred", "n", "cap", "bsr")}


def tail_case(case, axis: GraphAxis) -> dict:
    """``assign_tail_train_chunked`` on this rank's rows, the statistics
    summed over the axis, at each of the case's chunks: S, mean, var and
    the gradients of sum(S * ds) + sum(S^T * ds_t) in (x12, p, k12, k3,
    lin_bias, bn_scale, bn_bias) — the parameters' as this rank's share,
    ``None`` where the port gives none (n)."""
    ns = case["x12"].shape[1] // axis.size
    rows = slice(axis.rank * ns, (axis.rank + 1) * ns)
    t = lambda a: torch.tensor(np.ascontiguousarray(a))
    n_nodes = torch.tensor([min(max(case["n_real"] - rows.start, 0), ns)],
                           dtype=torch.int32)
    out = {}
    for chunk in case["chunks"]:
        v = [t(case["x12"][:, rows]), t(case["p"][:, rows])] + [
            t(case[k]) for k in ("k12", "k3", "lb", "sc", "bi")]
        n = torch.tensor(float(case["n_real"]))
        for a in v + [n]:
            a.requires_grad_(True)
        s, mean, var = ah.assign_tail_train_chunked(
            *v, n_nodes, n, 1e-5, axis=axis, chunk_rows=chunk)
        loss = (s * t(case["ds"][:, rows])).sum() + (
            s.transpose(1, 2) * t(case["ds_t"][:, :, rows])).sum()
        grads = torch.autograd.grad(loss, v + [n], allow_unused=True)
        out[chunk] = {"s": _np(s), "mean": _np(mean), "var": _np(var),
                      "grads": [None if g is None else _np(g)
                                for g in grads]}
    return out


KINDS = {"model": model_case, "steps": steps_case,
         "collectives": collectives_case, "pool": pool_case, "cli": cli_case,
         "tail": tail_case}


def run(rank: int, world: int, init_file: str, job_path: str,
        out_dir: str) -> None:
    """Rank ``rank`` of ``world``: join the group, run every case of the
    job, save this rank's results."""
    torch.set_num_threads(1)
    axis = init_graph_axis(rank, world, cpu=True,
                           init_method=f"file://{init_file}",
                           timeout=COLLECTIVE_TIMEOUT)
    try:
        job = torch.load(job_path, weights_only=False)
        out = {case["name"]: KINDS[case["kind"]](case, axis)
               for case in job}
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def card_job(world: int, seed: int = 5) -> dict:
    """The card test's inputs (numpy, from a seed): a spatially sorted
    band graph of 256 nuclei, its rows' features, and per-rank values."""
    from cgcnet_tpu_torch.ops.knn import radius_knn_np

    rng = np.random.default_rng(seed)
    n = 256
    pos = np.sort(rng.uniform(0, n * 2.0, (n, 1)), axis=0)
    pos = np.concatenate([pos, rng.uniform(0, 50, (n, 1))], 1).astype(
        np.float32)
    nbr, mask = radius_knn_np(pos, 60.0, 6)
    return {"nbr": nbr, "mask": mask,
            "x": rng.normal(size=(n, 40)).astype(np.float32),
            "v": rng.normal(size=(world, 7, 33)).astype(np.float32)}


def card_collectives(rank: int, world: int, init_file: str,
                     out_dir: str) -> None:
    """Rank ``rank`` of ``world`` ranks sharing one card (gloo, by the
    backend rule): a bf16 halo exchange, a psum in f32 and in bf16 and an
    all_gather of CUDA tensors; the results saved on the CPU."""
    axis = init_graph_axis(rank, world, cpu=False,
                           init_method=f"file://{init_file}",
                           timeout=COLLECTIVE_TIMEOUT)
    try:
        job = card_job(world)
        part = tmg.partition_graph(job["nbr"], job["mask"], world)
        ns = job["x"].shape[0] // world
        dev = axis.device
        x = torch.tensor(job["x"][rank * ns:(rank + 1) * ns],
                         device=dev).to(torch.bfloat16)
        halo = tmg.halo_exchange(
            x, torch.tensor(part.req_idx[rank], device=dev),
            torch.tensor(part.req_mask[rank], device=dev), axis)
        v = torch.tensor(job["v"][rank], device=dev)
        out = {"backend": axis.backend, "staged": axis.staged,
               "device": str(halo.device), "halo": halo.cpu(),
               "psum": tmg.psum(v, axis).cpu(),
               "psum_bf16": tmg.psum(v.to(torch.bfloat16), axis).cpu(),
               "all_gather": tmg.all_gather(v, axis).cpu()}
        torch.save(out, Path(out_dir) / f"card{rank}.pt")
    finally:
        dist.destroy_process_group()
