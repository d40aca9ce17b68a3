"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Every input is made from a numpy seed and handed to both packages as numpy
arrays: the JAX reference gets jnp arrays, the port gets CPU tensors.
Ranks spawned by the port's tests start and join through ``RankGroup``.
"""

from __future__ import annotations

import faulthandler
import os
import signal
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# The shared library native/libcgraph.so is built once, before any test
# runs: several test_torch_* modules import this one at module level, so
# every xdist worker makes this call while it collects, and no worker gets
# a test before all have collected. The port's binding builds under a lock
# between processes and moves the finished file into place, so the JAX
# package's binding later finds it whole and only loads it.
from cgcnet_tpu_torch.dataflow import native as _native  # noqa: E402

_native.available()

GRAPH_FIELDS = (
    "x", "nbr", "nbr_mask", "n_nodes", "y", "nbr_t", "nbr_t_mask",
    "blk_cols", "blk_mask", "blk_cols_t", "blk_mask_t",
)

# small canonical-shaped model: SAGE, relu, BN, JK, norm_adj, folded tail;
# max_num_nodes 2048 -> pool-1 204 clusters, pool-2 20
SMALL_MODEL = dict(
    hidden_dim=8, embedding_dim=8, assign_hidden_dim=8,
    max_num_nodes=2048, drop_out=0.0,
)


def example_batch(batch: int = 2, cap: int = 1024, seed: int = 0) -> dict:
    """``__graft_entry__._example_graph`` (radius-kNN over spatially sorted
    nuclei, transpose tables, BSR metadata) as a dict of numpy arrays."""
    from __graft_entry__ import _example_graph

    g = _example_graph(batch=batch, cap=cap, seed=seed)
    return {k: np.array(getattr(g, k)) for k in GRAPH_FIELDS}


def jax_graph(batch: dict):
    import jax.numpy as jnp
    from cgcnet_tpu.core.graph import CellGraph

    return CellGraph(**{k: jnp.asarray(v) for k, v in batch.items()})


def torch_graph(batch: dict):
    import torch
    from cgcnet_tpu_torch.core.graph import CellGraph

    return CellGraph(**{k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


def random_tree(init_fn, seed: int) -> dict:
    """Flax {"params", "batch_stats"} with the structure ``init_fn`` (a
    flax ``init`` call) would make, every leaf drawn from a numpy seed:
    weights ~ U(-0.5, 0.5), BN scale ~ U(0.5, 1.5), running mean ~
    N(0, 0.2), running var ~ U(0.5, 1.5) — so BN does real work (a fresh
    init leaves it at mean 0, var 1)."""
    import jax

    shapes = jax.eval_shape(init_fn)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "mean":
            return (rng.normal(size=s.shape) * 0.2).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, size=s.shape).astype(np.float32)
        return rng.uniform(-0.5, 0.5, size=s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def stage1_weights(batch: dict, self_weight: float = 0.4) -> np.ndarray:
    """Forward ELL weights of the norm_adj stage-1 operator (what
    nn/model.py:make_stage1_adj feeds the block build)."""
    nbr, m = batch["nbr"], batch["nbr_mask"]
    n = nbr.shape[1]
    is_self = (nbr == np.arange(n)[None, :, None]) * m
    off = m - is_self
    deg = off.sum(-1)
    valid = (np.arange(n)[None, :] < batch["n_nodes"][:, None]).astype(np.float32)
    scale = (1.0 - self_weight) / (deg + 1e-15) * valid
    return (
        scale[..., None] * off + (self_weight * valid)[..., None] * is_self
    ).astype(np.float32)


# ---------------------------------------------------------------------------
# spawned ranks, joined within a limit
# ---------------------------------------------------------------------------

TAIL_LINES = 30  # lines of a rank's log quoted when it fails


def _logged_rank(rank: int, fn, logs: str, *args) -> None:
    """Run ``fn(rank, *args)`` with this rank's stdout and stderr in
    ``logs/rank{rank}.log``; SIGUSR1 writes its threads' stacks there."""
    log = open(Path(logs) / f"rank{rank}.log", "w")
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    sys.stdout.reconfigure(line_buffering=True)
    faulthandler.register(signal.SIGUSR1, file=log, all_threads=True)
    fn(rank, *args)
    (Path(logs) / f"rank{rank}.done").write_text(f"{time.monotonic()}\n")


def log_tail(logs: Path, rank: int, lines: int = TAIL_LINES) -> str:
    path = Path(logs) / f"rank{rank}.log"
    if not path.exists():
        return "(no log)"
    text = path.read_text(errors="replace").rstrip().splitlines()
    return "\n".join(text[-lines:]) or "(empty log)"


class RankGroup:
    """``nprocs`` spawned ranks of ``fn(rank, *args)``, each writing its
    stdout and stderr to ``logs/rank{r}.log``, joined within ``limit``
    seconds of their start.

    ``join()`` returns once every rank has exited cleanly; a rank that
    raised or died raises as ``ProcessContext.join`` does (the other ranks
    are ended). At the limit it ends the ranks still alive and fails the
    test, naming them and quoting what each last wrote. ``logs/joined_s``
    gets the seconds from the spawn to the last rank's exit and to the
    join."""

    def __init__(self, fn, args: tuple, nprocs: int, logs: Path,
                 limit: float):
        import torch.multiprocessing as tmp_mp

        self.logs, self.limit = Path(logs), float(limit)
        self.logs.mkdir(parents=True, exist_ok=True)
        self.t0 = time.monotonic()
        self.ctx = tmp_mp.start_processes(
            _logged_rank, args=(fn, str(self.logs), *args), nprocs=nprocs,
            join=False, start_method="spawn")
        self.joined = False

    def join(self) -> None:
        if self.joined:
            return
        from torch.multiprocessing.spawn import ProcessException

        deadline = self.t0 + self.limit
        try:
            while not self.ctx.join(
                    timeout=max(0.05, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    self._fail_late()
        except ProcessException:
            print(self._tails(range(len(self.ctx.processes))),
                  file=sys.stderr)
            raise
        self.joined = True
        done = max(float((self.logs / f"rank{r}.done").read_text())
                   for r in range(len(self.ctx.processes)))
        (self.logs / "joined_s").write_text(
            f"{done - self.t0:.1f} {time.monotonic() - self.t0:.1f}\n")

    def _tails(self, ranks) -> str:
        return "\n".join(f"--- rank {r} last wrote:\n"
                         f"{log_tail(self.logs, r)}" for r in ranks)

    def _fail_late(self) -> None:
        import pytest

        late = [r for r, p in enumerate(self.ctx.processes) if p.is_alive()]
        for r in late:
            try:
                os.kill(self.ctx.processes[r].pid, signal.SIGUSR1)
            except OSError:
                pass
        time.sleep(0.5)
        tails = self._tails(late)
        self.close()
        pytest.fail(
            f"rank{'s' if len(late) > 1 else ''} "
            f"{', '.join(map(str, late))} of {len(self.ctx.processes)} "
            f"still running {self.limit:.0f} s after the spawn; ended.\n"
            f"{tails}", pytrace=False)

    def close(self) -> None:
        """End ranks still alive (no test joined them, or one was late)."""
        for proc in self.ctx.processes:
            if proc.is_alive():
                proc.terminate()
        for proc in self.ctx.processes:
            proc.join(5)
            if proc.is_alive():
                proc.kill()
                proc.join()


def run_ranks(fn, args: tuple, nprocs: int, logs: Path, limit: float) -> None:
    """Spawn the ranks of ``fn(rank, *args)`` and join them within
    ``limit`` seconds (``RankGroup``)."""
    group = RankGroup(fn, args, nprocs, logs, limit)
    try:
        group.join()
    finally:
        group.close()
