"""One rank of tests/test_torch_data_parallel.py,
tests/test_torch_checkpoint_sharded.py and tests/test_torch_loader_workers.py:
the port's data axis as one process per rank over a gloo group on the CPU.

Imports torch, numpy and the port only (a spawned rank imports no JAX).
The test writes a job (``torch.save``: the cases with their batches,
weights and configs as numpy arrays and tensors), spawns ``world`` ranks of
:func:`run`, and reads back each rank's results (``rank{r}.pt``).
"""

from __future__ import annotations

import datetime
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from cgcnet_tpu_torch.config import Config
from cgcnet_tpu_torch.core.graph import CellGraph
from cgcnet_tpu_torch.parallel.dryrun import counted
from cgcnet_tpu_torch.parallel.mesh import (
    GraphAxis,
    init_graph_axis,
    multihost_init,
    shard_batch,
)
from cgcnet_tpu_torch.train import checkpoint_sharded as cs
from cgcnet_tpu_torch.train.loop import make_train_step
from cgcnet_tpu_torch.train.state import create_train_state

# a rank that waits longer than this on the others fails (and with it the
# test) instead of hanging
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)


def graph_of(batch: dict) -> CellGraph:
    return CellGraph(**{k: torch.from_numpy(np.array(v))
                        for k, v in batch.items()})


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _snap(model) -> dict:
    return {"params": {n: _cpu(p) for n, p in model.named_parameters()},
            "grads": {n: _cpu(p.grad) for n, p in model.named_parameters()
                      if p.grad is not None},
            "buffers": {n: _cpu(b) for n, b in model.named_buffers()}}


def state_of(case, device="cpu") -> object:
    """The case's training state on ``device``: its config, its weights
    when it carries them (else the seeded init)."""
    state = create_train_state(Config().apply_overrides(case["over"]), device,
                               seed=0)
    if case.get("state_dict") is not None:
        state.model.load_state_dict(case["state_dict"], strict=True)
    return state


def steps_case(case, axis: GraphAxis) -> dict:
    """``case["steps"]`` data-parallel steps on this rank's rows of the
    case's batch; after each: the step's (global) metrics, the parameters,
    the averaged gradients and the running statistics. ``per_rank``: the
    witness — the axis never reaches the model's statistics (each rank's
    BN and B3 run over its own rows), the gradients are still averaged.
    Each step's kernel launches are counted (none on the CPU)."""
    state = state_of(case, axis.device)
    if case.get("per_rank"):
        state.model.set_data_axis = lambda _axis: None
    step = make_train_step(data_axis=axis)
    graph = shard_batch(graph_of(case["batch"]), axis).to(axis.device)
    out = []
    for _ in range(case["steps"]):
        m, launches = counted(lambda: step(state, graph))
        out.append({"loss": float(m["loss"]), "acc": float(m["acc"]),
                    "edges": int(m["edges"]), "launches": launches,
                    **_snap(state.model)})
    return {"steps": out, "n_nodes": graph.n_nodes.tolist()}


def loader_case(case, axis: GraphAxis) -> dict:
    """The process-sharded loader on the case's dataset root (this rank's
    rows of each global batch of the first epochs), one data-parallel step
    on its first batch, and ``save_checkpoint`` into a directory of this
    rank's own: whether the file exists after."""
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.train.checkpoint import save_checkpoint

    cfg = Config().apply_overrides(case["over"])
    loader = GraphLoader(NucleiGraphDataset(cfg.data, "train"),
                         case["batch_size"], device="cpu", num_workers=1,
                         seed=case["seed"], drop_last=True, rank=axis.rank,
                         world=axis.size)
    batches = {e: [{k: v.numpy() for k, v in vars(g).items()
                    if v is not None} for g in loader.epoch(e)]
               for e in case["epochs"]}
    state = create_train_state(cfg, "cpu", seed=0)
    graph = next(iter(loader.epoch(0)))
    m = make_train_step(data_axis=axis)(state, graph)
    path = save_checkpoint(
        Path(case["ckpt_root"]) / f"rank{axis.rank}" / "weight.pt",
        state.model.state_dict(), cfg)
    return {"batches": batches, "loss": float(m["loss"]),
            "wrote": path.is_file(), "path": str(path),
            "workers": loader.num_workers}


def workers_case(case, axis: GraphAxis) -> list:
    """The process-sharded loader at each worker count of
    ``case["workers"]``, each run from a fresh dataset and the seeded
    state: this rank's rows of the first ``case["steps"]`` global batches
    of epoch 0 and the data-parallel step's loss on each."""
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader

    cfg = Config().apply_overrides(case["over"])
    runs = []
    for workers in case["workers"]:
        loader = GraphLoader(NucleiGraphDataset(cfg.data, "train"),
                             case["batch_size"], device="cpu",
                             num_workers=workers, seed=case["seed"],
                             drop_last=True, rank=axis.rank, world=axis.size)
        state = create_train_state(cfg, "cpu", seed=0)
        step = make_train_step(data_axis=axis)
        batches, losses = [], []
        for graph in loader.epoch(0):
            batches.append({k: v.numpy().copy() for k, v in vars(graph).items()
                            if v is not None})
            losses.append(float(step(state, graph)["loss"]))
            if len(losses) == case["steps"]:
                break
        runs.append({"workers": loader.num_workers, "batches": batches,
                     "losses": losses})
    return runs


def sharded_case(case, axis: GraphAxis) -> dict:
    """Sharded checkpoints at D ranks: (a) a row-sharded / replicated /
    plain state saved and loaded into the same layout; (b) the same
    checkpoint loaded replicated; (c) a training state (model + Adam after
    one data-parallel step) saved, then the unbroken run's next step."""
    root, r, d, dev = Path(case["root"]), axis.rank, axis.size, axis.device
    full = torch.from_numpy(case["x"]).to(dev)
    w = torch.from_numpy(case["w"]).to(dev)
    rows = full.shape[0] // d
    state = {"x": cs.shard_rows(full[r * rows:(r + 1) * rows].clone(), axis),
             "nested": {"w": cs.replicate(w.clone(), axis),
                        "step": torch.tensor(7)}}
    path = cs.save_sharded(root / "layout", state)
    target = {"x": cs.shard_rows(torch.zeros_like(full[:rows]), axis),
              "nested": {"w": cs.replicate(torch.zeros_like(w), axis),
                         "step": torch.tensor(0)}}
    cs.load_sharded(path, target)
    repl = cs.load_sharded(path, {"x": cs.replicate(torch.zeros_like(full),
                                                    axis)})
    out = {"same": {"x": _cpu(target["x"].to_local()),
                    "x_placements": list(target["x"].placements),
                    "w": _cpu(target["nested"]["w"].to_local()),
                    "w_placements": list(target["nested"]["w"].placements),
                    "step": int(target["nested"]["step"])},
           "replicated": {"x": _cpu(repl["x"].to_local()),
                          "placements": list(repl["x"].placements)},
           "files": sorted(os.listdir(path))}

    ts = state_of(case["train"], dev)
    step = make_train_step(data_axis=axis)
    graph = shard_batch(graph_of(case["train"]["batch"]), axis).to(dev)
    first = step(ts, graph)
    saved = cs.train_state(ts.model, ts.optimizer)
    out["saved"] = {k: (_cpu(v) if torch.is_tensor(v) else v)
                    for k, v in _flat(saved).items()}
    cs.save_sharded(root / "train", saved)
    nxt = step(ts, graph)
    out["train"] = {"loss1": float(first["loss"]),
                    "loss2": float(nxt["loss"]), **_snap(ts.model)}
    return out


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "."))
        else:
            out[key] = v
    return out


KINDS = {"steps": steps_case, "loader": loader_case, "sharded": sharded_case,
         "workers": workers_case}


def run(rank: int, world: int, init: str, job_path: str, out_dir: str,
        cpu: bool = True) -> None:
    """Rank ``rank`` of ``world``: join the group (``init``: a
    ``host:port`` joins through ``multihost_init`` over TCP, as
    separately started processes would, with the launcher's environment
    set here; else a ``file://`` store at that path), on the CPU or, with
    ``cpu`` False, on a card (gloo when the ranks share one), run every
    case of the job, save this rank's results (on the CPU)."""
    torch.set_num_threads(1)
    if init.startswith("tcp:"):
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank))
        axis = multihost_init(init[len("tcp:"):], cpu=cpu,
                              timeout=COLLECTIVE_TIMEOUT)
    else:
        axis = init_graph_axis(rank, world, cpu=cpu,
                               init_method=f"file://{init}",
                               timeout=COLLECTIVE_TIMEOUT)
    try:
        job = torch.load(job_path, weights_only=False)
        out = {"axis": {"rank": axis.rank, "size": axis.size,
                        "backend": axis.backend,
                        "world": dist.get_world_size()}}
        out.update({case["name"]: KINDS[case["kind"]](case, axis)
                    for case in job})
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
