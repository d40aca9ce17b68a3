"""Multi-rank dry run: the training steps of the port's parallel paths over
n ranks at tiny shapes.

Port of ``cgcnet_tpu/parallel/dryrun.py``. ``run_dryrun(n)`` spawns n
ranks (a ``torch.distributed`` group: gloo on the CPU; on CUDA by
``parallel/mesh.py``'s backend rule) and each runs:

1. the data-parallel CGCNet training step (``train.loop.make_train_step``
   over the data axis: global BN and B3 statistics, DDP's gradient
   all-reduce), one graph per rank of an n-graph batch;
2. when the (data, graph) split of n ranks (:func:`_mesh_shape`) has a
   graph axis > 1, on its first ranks: the whole-slide training step
   (``parallel/mega_train.py``: halo all-to-all, psum BN and DiffPool,
   head dropout, Adam) and the capacity step (``assign_tail_chunk``,
   ``remat_stage1``) on a slide of 128 rows a shard.

Each step must give a finite loss and move the parameters; a rank that
fails fails the run. The graphs come from the port's own
``dataflow/synthetic.py`` and ``ops/knn.py``.

    python -m cgcnet_tpu_torch.parallel.dryrun --ranks 2 --cpu
    python -m cgcnet_tpu_torch.parallel.dryrun --ranks 4      # on a card
"""

from __future__ import annotations

import argparse
import datetime
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from cgcnet_tpu_torch.config import Config, ModelConfig
from cgcnet_tpu_torch.core.convert import transpose_ell_np
from cgcnet_tpu_torch.core.graph import CellGraph
from cgcnet_tpu_torch.dataflow.dataset import attach_bsr_meta
from cgcnet_tpu_torch.dataflow.synthetic import make_patch
from cgcnet_tpu_torch.ops import kernel_wrappers
from cgcnet_tpu_torch.ops.knn import radius_knn_np
from cgcnet_tpu_torch.parallel.mesh import (
    GraphAxis,
    init_graph_axis,
    shard_batch,
)

DP_CAP = 256              # nodes a graph of the data-parallel step
SLIDE_ROWS = 128          # rows a shard of the slide (one block-row tile)
SMALL = ["model.hidden_dim=8", "model.embedding_dim=8",
         "model.assign_hidden_dim=8", f"model.max_num_nodes={2 * DP_CAP}",
         "model.drop_out=0.0"]
# a rank that waits on the others longer than this fails, and so the run
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)
def _mesh_shape(n: int) -> tuple[int, int]:
    """(data, graph) split of n ranks: the widest graph axis of 4, 2, 1
    that divides n."""
    for g in (4, 2, 1):
        if n % g == 0:
            return n // g, g
    return n, 1


def launches() -> dict:
    """Every kernel wrapper's launch count."""
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def counted(fn) -> tuple:
    """(fn's result, the kernel launches it made)."""
    before = launches()
    out = fn()
    return out, {k: v - before[k] for k, v in launches().items()}


def example_batch(n_graphs: int, cap: int = DP_CAP, seed: int = 0,
                  k: int = 8, kt: int = 24) -> dict:
    """A collated batch (numpy) of ``n_graphs`` synthetic patches of
    0.7-1x ``cap`` nuclei (``synthetic.make_patch``, grades in turn),
    spatially sorted, radius-kNN (100 px, ``k`` neighbours), transpose
    tables and block metadata; 16 appearance features (standardized) and
    2 normalized coordinates a node."""
    rng = np.random.default_rng(seed)
    keys = ("x", "nbr", "nbr_mask", "nbr_t", "nbr_t_mask")
    out = {key: [] for key in keys}
    n_nodes = []
    for g in range(n_graphs):
        n = int(rng.integers(int(cap * 0.7), cap + 1))
        tile = 60.0 * np.sqrt(n)
        feats, pos = make_patch(rng, g % 3, n, tile=tile)
        band = np.floor(pos[:, 0] / 100.0)
        order = np.lexsort((pos[:, 1], band))
        feats, pos = feats[order], pos[order]
        nbr, m = radius_knn_np(pos, 100.0, k)
        nbr_t, m_t, _ = transpose_ell_np(nbr, m, kt)
        x = np.concatenate([(feats - 40.0) / 10.0, pos / tile], axis=1)
        own = np.arange(n, cap, dtype=np.int32)[:, None]
        pad = lambda a, fill: np.concatenate([a, fill])
        out["x"].append(pad(x.astype(np.float32),
                            np.zeros((cap - n, x.shape[1]), np.float32)))
        out["nbr"].append(pad(nbr, np.tile(own, (1, k))))
        out["nbr_mask"].append(pad(m, np.zeros((cap - n, k), np.float32)))
        out["nbr_t"].append(pad(nbr_t, np.tile(own, (1, kt))))
        out["nbr_t_mask"].append(pad(m_t, np.zeros((cap - n, kt),
                                                   np.float32)))
        n_nodes.append(n)
    batch = {key: np.stack(v) for key, v in out.items()}
    batch["n_nodes"] = np.asarray(n_nodes, np.int32)
    batch["y"] = np.arange(n_graphs, dtype=np.int32) % 3
    attach_bsr_meta(batch, 8, True)
    return batch


def _moved(model, before: dict) -> float:
    return float(sum(torch.sum(torch.abs(p.detach() - before[n])).item()
                     for n, p in model.named_parameters()))


def _require(name: str, loss: float, moved: float) -> None:
    if not np.isfinite(loss):
        raise AssertionError(f"{name} step produced loss {loss}")
    if not moved > 0:
        raise AssertionError(f"{name} step did not move the parameters")


def dp_step(axis: GraphAxis) -> dict:
    """The data-parallel training step on this rank's graph of an
    ``axis.size``-graph batch; its loss, parameter movement and launches."""
    from cgcnet_tpu_torch.train.loop import make_train_step
    from cgcnet_tpu_torch.train.state import create_train_state

    cfg = Config().apply_overrides(SMALL)
    graph = shard_batch(CellGraph.from_numpy(example_batch(axis.size)),
                        axis).to(axis.device)
    state = create_train_state(cfg, axis.device, seed=0)
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    step = make_train_step(data_axis=axis)
    metrics, made = counted(lambda: step(state, graph))
    loss = float(metrics["loss"])
    moved = _moved(state.model, before)
    _require("data-parallel", loss, moved)
    return {"loss": loss, "moved": moved, "launches": made}


def slide_steps(axis: GraphAxis) -> dict:
    """The whole-slide training step and the capacity step over ``axis``
    (the graph axis) on a slide of SLIDE_ROWS rows a shard; their losses,
    parameter movements and launches."""
    from cgcnet_tpu_torch.nn.model import CGCNet
    from cgcnet_tpu_torch.parallel.mega_graph import (
        build_bsr_tables,
        partition_graph,
    )
    from cgcnet_tpu_torch.parallel.mega_model import prepare_mega_inputs
    from cgcnet_tpu_torch.parallel.mega_train import (
        make_optimizer,
        make_slide_train_step,
    )

    rng = np.random.default_rng(0)
    n = SLIDE_ROWS * axis.size
    pos = np.stack([np.sort(rng.uniform(0, n * 3.0, n)),
                    rng.uniform(0, 80, n)], -1).astype(np.float32)
    nbr, mask = radius_knn_np(pos, 100.0, 6)
    part = partition_graph(nbr, mask, axis.size)
    tables = build_bsr_tables(part)
    if tables is None:
        raise AssertionError("the dry run's block tables did not build")
    x = rng.normal(size=(n, 18)).astype(np.float32)
    inputs = prepare_mega_inputs(x, part, axis.device, n_real=n, bsr=tables,
                                 axis=axis)
    mcfg = ModelConfig(input_dim=18, max_num_nodes=2 * n, assign_ratio=0.05,
                       hidden_dim=8, embedding_dim=8, assign_hidden_dim=8,
                       drop_out=0.2, norm_adj=True, jk=True,
                       use_pallas="always")
    out = {}
    for name, cfg, remat_stage1 in (
            ("slide", mcfg, False),
            ("slide-capacity", ModelConfig(**{**mcfg.__dict__,
                                              "assign_tail_chunk": 128}),
             True)):
        model = CGCNet(cfg, torch.Generator().manual_seed(0)).to(axis.device)
        model.train()
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        step = make_slide_train_step(model, cfg, make_optimizer(model, 1e-3),
                                     remat_stage1=remat_stage1)
        gen = torch.Generator(device=axis.device).manual_seed(7)
        loss, made = counted(lambda: float(step(inputs, 1, gen)))
        moved = _moved(model, before)
        _require(name, loss, moved)
        out[name] = {"loss": loss, "moved": moved, "launches": made}
    return out


def _rank(rank: int, n: int, work: str, cpu: bool) -> None:
    """Rank ``rank`` of ``n`` (a spawned process): join the group, run the
    steps, save this rank's results under ``work``."""
    torch.set_num_threads(1)
    axis = init_graph_axis(rank, n, cpu=cpu,
                           init_method=f"file://{work}/init",
                           timeout=COLLECTIVE_TIMEOUT)
    try:
        out = {"backend": axis.backend, "device": str(axis.device),
               "dp": dp_step(axis)}
        _, n_graph = _mesh_shape(n)
        if n_graph > 1:
            # every rank makes the group; its first n_graph ranks use it
            group = dist.new_group(list(range(n_graph)), backend=axis.backend)
            if rank < n_graph:
                out.update(slide_steps(GraphAxis(rank, n_graph, axis.device,
                                                 group, axis.backend)))
        torch.save(out, Path(work) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_dryrun(n: int, cpu: bool = False) -> list[dict]:
    """Spawn ``n`` ranks (on the card unless ``cpu``) and run the dry run;
    returns each rank's results (losses, parameter movements, launches).
    A rank's failure raises here with its traceback."""
    import torch.multiprocessing as mp

    if not cpu and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass --cpu to run the dry run on the CPU")
    with tempfile.TemporaryDirectory() as work:
        mp.start_processes(_rank, args=(n, work, cpu), nprocs=n, join=True,
                           start_method="spawn")
        return [torch.load(Path(work) / f"rank{r}.pt", weights_only=False)
                for r in range(n)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, required=True)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    args = p.parse_args(argv)
    for r, res in enumerate(run_dryrun(args.ranks, cpu=args.cpu)):
        print(json.dumps({"rank": r, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
