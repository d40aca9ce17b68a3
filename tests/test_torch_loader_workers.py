"""PyTorch port, the threaded loader at several workers: every array of
every batch (the block metadata and the padding widths included) is the
same at ``num_workers`` 1, 4 and 0 (auto: one a usable core), run after
run, and equals the JAX loader's at one worker.

The loader's batches share two pieces of grow-only state: the sticky BSR
caps and the dataset's nominal transpose width. Each case below makes one
of them move during the run: patches whose block needs grow the caps from
4 to 6 slots, a transpose width that overflows and widens, and dynamic
buckets with an overflowing width. Then the data axis: two gloo ranks of
``make_train_step(data_axis=)`` on the process-sharded loader at 1 and 4
workers a rank, their batches and losses bit for bit, and the one-process
step (world 1: the kind of reference phase 13 of ``chip_smoke.py`` holds
the ranks against) at 1 and 4 workers.
"""

import socket

import numpy as np
import pytest
import torch

from cgcnet_tpu.config import Config as JaxConfig
from cgcnet_tpu.dataflow.dataset import NucleiGraphDataset as JaxDataset
from cgcnet_tpu.dataflow.loader import GraphLoader as JaxLoader
from cgcnet_tpu_torch.config import Config
from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
from cgcnet_tpu_torch.dataflow.loader import GraphLoader
from cgcnet_tpu_torch.dataflow.synthetic import generate_dataset
from cgcnet_tpu_torch.train.loop import make_train_step
from cgcnet_tpu_torch.train.state import create_train_state

import torch_data_parallel_worker as worker
from torch_port_util import RankGroup

FIELDS = ("x", "nbr", "nbr_mask", "nbr_t", "nbr_t_mask", "n_nodes", "y",
          "patch_idx", "blk_cols", "blk_mask", "blk_cols_t", "blk_mask_t")
WORKERS = (1, 4, 0)
RUNS = 2            # each worker count runs this many times
EPOCHS = (0, 1)
BATCH = 2
# the shuffle's seed: each case's state moves after its first batch
SEED = 8
# (data kwargs of generate_dataset, config overrides, transpose width,
# dynamic buckets): which shared state each case moves
CASES = {
    # 750..1500 rows a graph: the block caps grow from 4 to 6 slots
    "sticky_caps": (dict(n_nodes=(1500, 3000)),
                    ["data.max_num_nodes=3000"], 24, False),
    # the nominal width 8 overflows at the third batch and widens to 16
    "overflow": (dict(n_nodes=(150, 600)), ["data.max_num_nodes=600"], 8,
                 False),
    # buckets of 256 and 512 rows, a width 12 that the third batch widens
    "buckets": (dict(n_nodes=(150, 600)), ["data.max_num_nodes=600"], 12,
                True),
}
COMMON = ["data.min_nodes_no_subsample=50", "data.bsr_blocks=16"]
# the data axis: 12 training patches in 3 global batches of 4; the ranks
# load the "overflow" case's patches (a rank raises on an overflowing
# width, so at the default width), the one-process step the
# "sticky_caps" case's (its caps grow within the 3 steps)
D = 2
DP_BATCH, DP_SEED, DP_STEPS = 4, SEED, 3
DP_WORKERS = (1, 4, 1, 4)
# seconds from the spawn to the last rank's exit (tests/torch_port_util.py's
# RankGroup): at least 3x the slowest the spawn took in a whole test run
RANKS_LIMIT = 120
MODEL_OVER = ["model.max_num_nodes=512", "model.hidden_dim=8",
              "model.embedding_dim=8", "model.assign_hidden_dim=8",
              "model.drop_out=0.0", "train.optim=sgd", "train.lr=1e-3"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several test workers share
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One synthetic tree per patch size (18 patches, 12 of them training)."""
    out = {}
    for size in {tuple(c[0]["n_nodes"]) for c in CASES.values()}:
        root = tmp_path_factory.mktemp("loader_workers") / "data"
        generate_dataset(str(root), patches_per_image=2, images_per_grade=1,
                         n_nodes=size, seed=3)
        out[size] = root
    return out


def _over(roots, case):
    data, over, _, _ = CASES[case]
    return [f"data.root={roots[tuple(data['n_nodes'])]}", *over, *COMMON]


def _port_batches(roots, case, workers):
    _, _, width, buckets = CASES[case]
    cfg = Config().apply_overrides(_over(roots, case))
    loader = GraphLoader(
        NucleiGraphDataset(cfg.data, "train", transpose_width=width), BATCH,
        device="cpu", shuffle=True, num_workers=workers, seed=SEED,
        dynamic_buckets=buckets)
    batches = [{k: getattr(g, k).numpy() for k in FIELDS
                if getattr(g, k) is not None}
               for e in EPOCHS for g in loader.epoch(e)]
    return batches, loader.num_workers


def _jax_batches(roots, case):
    _, _, width, buckets = CASES[case]
    cfg = JaxConfig().apply_overrides(_over(roots, case))
    loader = JaxLoader(
        JaxDataset(cfg.data, "train", transpose_width=width), BATCH,
        shuffle=True, num_workers=1, seed=SEED, wire=False,
        dynamic_buckets=buckets)
    return [{k: np.asarray(getattr(g, k)) for k in FIELDS
             if getattr(g, k) is not None}
            for e in EPOCHS for g in loader.epoch(e)]


def _assert_same(got, ref, what):
    assert len(got) == len(ref) > 0, what
    for i, (a, b) in enumerate(zip(got, ref)):
        assert set(a) == set(b), (what, i)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, \
                (what, i, k, a[k].shape, b[k].shape)
            np.testing.assert_array_equal(a[k], b[k],
                                          err_msg=f"{what} batch {i} {k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_equal_at_every_worker_count(roots, ranks, case):
    """Every batch of two epochs, at each worker count, each run twice,
    equals the JAX loader's at one worker bit for bit; the case's shared
    state moved (the caps grew, the width widened, several buckets)."""
    ref = _jax_batches(roots, case)
    counts = set()
    for workers in WORKERS:
        for run in range(RUNS):
            got, n = _port_batches(roots, case, workers)
            counts.add(n)
            _assert_same(got, ref, f"{case}, num_workers={workers} run {run}")
    assert len(counts) >= 2, counts
    caps = {b["blk_cols"].shape[-1] for b in ref}
    widths = {b["nbr_t"].shape[-1] for b in ref}
    rows = {b["x"].shape[1] for b in ref}
    width = CASES[case][2]
    moved = {"sticky_caps": len(caps) >= 2,
             "overflow": min(widths) == width < max(widths),
             "buckets": max(widths) > width and len(rows) >= 2}
    assert moved[case], (caps, widths, rows)


def test_one_process_steps_equal_at_1_and_4_workers(roots):
    """The one-process step (world 1, the sticky caps on): batches and the
    DP_STEPS losses the same bits at 1 and 4 workers, each run twice; the
    caps grew within those steps."""
    cfg = Config().apply_overrides(_dp_over(roots, "sticky_caps"))
    runs = []
    for workers in DP_WORKERS:
        loader = GraphLoader(NucleiGraphDataset(cfg.data, "train"), DP_BATCH,
                             device="cpu", num_workers=workers, seed=DP_SEED,
                             drop_last=True)
        state = create_train_state(cfg, "cpu", seed=0)
        step = make_train_step()
        batches, losses = [], []
        for graph in loader.epoch(0):
            batches.append({k: getattr(graph, k).numpy().copy()
                            for k in FIELDS})
            losses.append(float(step(state, graph)["loss"]))
        runs.append((batches, losses))
    batches, losses = runs[0]
    assert len(losses) == DP_STEPS and all(np.isfinite(losses))
    assert len({b["blk_cols"].shape[-1] for b in batches}) >= 2
    for i, (b, l) in enumerate(runs[1:], 1):
        assert l == losses, (i, l, losses)
        _assert_same(b, batches, f"one process, run {i}")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _dp_over(roots, case):
    data, over, _, _ = CASES[case]
    return [f"data.root={roots[tuple(data['n_nodes'])]}", *over, *COMMON,
            *MODEL_OVER]


class Ranks:
    """The D spawned ranks running the workers case; started when the first
    test needs them, so they run while the one-process cases do."""

    def __init__(self, root, roots):
        self.out = root / "out"
        self.out.mkdir()
        torch.save([dict(name="workers", kind="workers",
                         over=_dp_over(roots, "overflow"),
                         batch_size=DP_BATCH, seed=DP_SEED, steps=DP_STEPS,
                         workers=DP_WORKERS)], root / "job.pt")
        self.group = RankGroup(
            worker.run, (D, f"tcp:localhost:{_free_port()}",
                         str(root / "job.pt"), str(self.out)),
            D, root / "logs", limit=RANKS_LIMIT)

    def results(self) -> list:
        """Each rank's runs (joins the ranks; a rank's failure raises with
        its traceback and ends the other)."""
        self.group.join()
        return [torch.load(self.out / f"rank{r}.pt",
                           weights_only=False)["workers"] for r in range(D)]

    def close(self) -> None:
        self.group.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, roots):
    group = Ranks(tmp_path_factory.mktemp("loader_workers_dp"), roots)
    yield group
    group.close()


def test_data_axis_batches_and_losses_equal_at_1_and_4_workers(ranks):
    """Each rank's rows of the first DP_STEPS global batches and the
    data-parallel losses on them are the same bits at 1 and at 4 workers a
    rank, each run twice; both ranks read the same global losses."""
    ranks = ranks.results()
    for r, runs in enumerate(ranks):
        assert [run["workers"] for run in runs] == list(DP_WORKERS)
        first = runs[0]
        assert len(first["losses"]) == DP_STEPS
        assert all(np.isfinite(first["losses"]))
        for i, run in enumerate(runs[1:], 1):
            assert run["losses"] == first["losses"], (r, i)
            _assert_same(run["batches"], first["batches"],
                         f"rank {r}, run {i} ({run['workers']} workers)")
    assert ranks[0][0]["losses"] == ranks[1][0]["losses"]
