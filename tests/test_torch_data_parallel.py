"""PyTorch port, the data axis: the patch training step over D = 2 ranks
(``make_train_step(data_axis=)``: every BN moment and the fused tail's B3
sums over the global batch, DDP's gradient average), multi-process
start-up (``parallel/mesh.py: multihost_init``), the process-sharded
loader, the rank-0 checkpoint and the dry run, each run as processes of a
gloo group on the CPU.

The D = 2 ranks run in ``tests/torch_data_parallel_worker.py`` (torch,
numpy and the port only), joined through ``multihost_init`` over TCP; one
spawn runs every case, started when the first test needs it, so the ranks
compute while this process compiles the JAX side: its jitted training
step, and its gradient, on the same 4-graph batch sharded over
``make_mesh(4, 1)`` (tests/test_parallel.py's data-parallel step) with the
same weights (``state_dict_from_flax``), on its XLA path.

The steps run with ``model.drop_out=0``, as the JAX suite's data-parallel
tests do (tests/test_parallel.py, tests/mh_worker.py): JAX's sharded step
draws one global dropout mask, each rank here draws from its own
generator. Tolerances are tests/test_torch_train.py's: the whole step's
loss atol 2e-5, rtol 1e-4; gradients and the parameters SGD updates with
them ``GRAD_TOL``; running statistics atol 1e-5, rtol 1e-4. The ranks
hold the same parameters bit for bit.
"""

import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cgcnet_tpu.config import Config as JaxConfig
from cgcnet_tpu.dataflow.dataset import NucleiGraphDataset as JaxDataset
from cgcnet_tpu.dataflow.dataset import attach_bsr_meta as jax_attach_bsr_meta
from cgcnet_tpu.dataflow.loader import GraphLoader as JaxLoader
from cgcnet_tpu.dataflow.synthetic import generate_dataset
from cgcnet_tpu.nn import model as jmodel
from cgcnet_tpu.parallel.mesh import make_mesh
from cgcnet_tpu.train import loop as jloop
from cgcnet_tpu.train import optim as joptim
from cgcnet_tpu.train.state import TrainState as JaxTrainState
from cgcnet_tpu_torch.config import Config
from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
from cgcnet_tpu_torch.dataflow.loader import GraphLoader
from cgcnet_tpu_torch.nn.model import CGCNet
from cgcnet_tpu_torch.parallel import dryrun
from cgcnet_tpu_torch.parallel.mesh import GraphAxis, shard_batch
from cgcnet_tpu_torch.train.checkpoint import (
    save_checkpoint,
    state_dict_from_flax,
)
from cgcnet_tpu_torch.train.loop import make_train_step
from cgcnet_tpu_torch.train.state import create_train_state

import torch_data_parallel_worker as worker
from torch_port_util import (
    SMALL_MODEL, RankGroup, example_batch, jax_graph, random_tree,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 virtual devices"
)

D = 2
STEPS = 2
MODEL = dict(SMALL_MODEL, max_num_nodes=512)   # 51 then 5 clusters
OVER = ["train.optim=sgd", "train.lr=1e-3", "train.weight_decay=1e-4",
        "train.momentum=0.9"] + [f"model.{k}={v}" for k, v in MODEL.items()]
LOSS_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
STATS_TOL = dict(atol=1e-5, rtol=1e-4)
# seconds from the spawn to the last rank's exit (tests/torch_port_util.py's
# RankGroup): at least 3x the slowest the spawn took in a whole test run
RANKS_LIMIT = 120
# the process-sharded loader's dataset (tests/test_multihost.py's)
LOADER_OVER = ["data.max_num_nodes=256", "data.sample_ratio=1.0",
               "data.num_workers=1", "model.max_num_nodes=256",
               "model.hidden_dim=8", "model.embedding_dim=8",
               "model.assign_hidden_dim=8", "model.drop_out=0.0"]
LOADER_BATCH, LOADER_SEED, LOADER_EPOCHS = 4, 7, (0, 1)
FIELDS = ("x", "nbr", "nbr_mask", "nbr_t", "nbr_t_mask", "n_nodes", "y",
          "patch_idx")
META = ("blk_cols", "blk_mask", "blk_cols_t", "blk_mask_t")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several test workers share
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def data():
    """The 4-graph batch (256 rows a graph, BSR metadata) and weights drawn
    from a numpy seed: (numpy batch, flax variables, port state_dict)."""
    batch = example_batch(batch=4, cap=256, seed=3)
    batch["y"] = np.array([0, 2, 1, 2], np.int32)
    net = jmodel.CGCNet(JaxConfig().apply_overrides(OVER).model)
    variables = random_tree(
        lambda: net.init({"params": jax.random.key(0)}, jax_graph(batch),
                         train=False), 1)
    return batch, variables, state_dict_from_flax(variables)


class Ranks:
    """The D spawned ranks running every case of the job."""

    def __init__(self, root, job, init):
        self.out = root / "out"
        self.out.mkdir()
        torch.save(job, root / "job.pt")
        self.group = RankGroup(
            worker.run, (D, init, str(root / "job.pt"), str(self.out)), D,
            root / "logs", limit=RANKS_LIMIT)
        self._res = None

    def results(self) -> list:
        """Every rank's results (joins the ranks; a rank's failure raises
        with its traceback and ends the others)."""
        if self._res is None:
            self.group.join()
            self._res = [torch.load(self.out / f"rank{r}.pt",
                                    weights_only=False) for r in range(D)]
        return self._res

    def close(self) -> None:
        self.group.close()


@pytest.fixture(scope="module")
def loader_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_loader") / "data"
    generate_dataset(str(root), patches_per_image=3, images_per_grade=1,
                     n_nodes=(100, 200), seed=11)
    return root


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, data, loader_root):
    root = tmp_path_factory.mktemp("data_parallel")
    batch, _, sd = data
    steps = dict(kind="steps", over=OVER, state_dict=sd, batch=batch,
                 steps=STEPS)
    job = [dict(steps, name="dp"),
           dict(steps, name="witness", per_rank=True, steps=1),
           dict(name="loader", kind="loader",
                over=[f"data.root={loader_root}", *LOADER_OVER],
                batch_size=LOADER_BATCH, seed=LOADER_SEED,
                epochs=LOADER_EPOCHS, ckpt_root=str(root / "ckpt"))]
    group = Ranks(root, job, f"tcp:localhost:{_free_port()}")
    yield group
    group.close()


# ---------------------------------------------------------------------------
# the references: JAX's step on the data mesh, the port's one-process step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ref(data, ranks):
    """JAX's gradient of the first step and STEPS jitted SGD steps on the
    batch sharded over make_mesh(4, 1), the state replicated (the ranks are
    already computing)."""
    batch, variables, _ = data
    jcfg = JaxConfig().apply_overrides(OVER + ["model.use_pallas=never"])
    net = jmodel.CGCNet(jcfg.model)
    tx = joptim.make_optimizer(jcfg.train, steps_per_epoch=100)
    mesh = make_mesh(4, 1, devices=jax.devices()[:4])
    graph = jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P("data"))),
        jax_graph(batch))
    repl = lambda t: jax.tree.map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P())), t)
    jstate = repl(JaxTrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        step=jnp.zeros((), jnp.int32),
        rng=jax.random.key_data(jax.random.key(0))))

    def loss_fn(params):
        out, _ = net.apply({**variables, "params": params}, graph, train=True,
                           mutable=["batch_stats"],
                           rngs={"dropout": jax.random.key(1)})
        return jmodel.cross_entropy_loss(out, graph.y)

    grads = jax.jit(jax.grad(loss_fn))(jstate.params)
    jstep = jax.jit(lambda s, g: jloop.make_train_step(net)(s, g, tx))
    out = []
    for _ in range(STEPS):
        jstate, m = jstep(jstate, graph)
        out.append({"loss": float(m["loss"]), "acc": float(m["acc"]),
                    "state": _sd(state_dict_from_flax(
                        {"params": jstate.params,
                         "batch_stats": jstate.batch_stats}))})
    return {"grads": _sd(state_dict_from_flax({"params": grads})),
            "steps": out}


def _sd(sd) -> dict:
    return {k: np.asarray(v) for k, v in sd.items()}


@pytest.fixture(scope="module")
def one_process(data):
    """The port's one-process step on the whole batch, STEPS times."""
    batch, _, sd = data
    state = create_train_state(Config().apply_overrides(OVER), "cpu", seed=0)
    state.model.load_state_dict(sd, strict=True)
    step = make_train_step()
    graph = worker.graph_of(batch)
    out = []
    for _ in range(STEPS):
        m = step(state, graph)
        out.append({"loss": float(m["loss"]), "acc": float(m["acc"]),
                    "edges": int(m["edges"]), **worker._snap(state.model)})
    return out


def _port_sd(step: dict) -> dict:
    """A step record's parameters and running statistics by state_dict
    name."""
    out = {k: v.numpy() for k, v in step["params"].items()}
    out.update({k: v.numpy() for k, v in step["buffers"].items()
                if "running" in k})
    return out


def _hold_state(port: dict, ref: dict, what: str) -> None:
    assert set(ref) <= set(port), set(ref) - set(port)
    for k, r in ref.items():
        tol = STATS_TOL if "running" in k else GRAD_TOL
        np.testing.assert_allclose(port[k], r, err_msg=f"{what}: {k}", **tol)


# ---------------------------------------------------------------------------
# the data-parallel step
# ---------------------------------------------------------------------------

def test_ranks_hold_the_same_state(ranks):
    """After each step both ranks hold the same parameters, averaged
    gradients and running statistics bit for bit (DDP does not broadcast
    the buffers: they agree by construction), and report the same global
    metrics; each rank trained on its own two graphs."""
    r0, r1 = (res["dp"] for res in ranks.results())
    assert r0["n_nodes"] != r1["n_nodes"]
    for i, (a, b) in enumerate(zip(r0["steps"], r1["steps"])):
        for key in ("loss", "acc", "edges"):
            assert a[key] == b[key], (i, key)
        for part in ("params", "grads", "buffers"):
            assert set(a[part]) == set(b[part])
            for k, t in a[part].items():
                assert torch.equal(t, b[part][k]), (i, part, k)


def test_every_parameter_gets_a_gradient(ranks, data):
    """The canonical path reaches every parameter, so DDP runs without
    ``find_unused_parameters``."""
    names = {n for n, _ in CGCNet(Config().apply_overrides(OVER).model)
             .named_parameters()}
    for step in ranks.results()[0]["dp"]["steps"]:
        assert set(step["grads"]) == names


def test_loss_matches_jax_data_mesh(ranks, jax_ref):
    steps = ranks.results()[0]["dp"]["steps"]
    for i, (port, ref) in enumerate(zip(steps, jax_ref["steps"])):
        np.testing.assert_allclose(port["loss"], ref["loss"], **LOSS_TOL,
                                   err_msg=f"step {i}")
        assert port["acc"] == pytest.approx(ref["acc"], abs=1e-6)


def test_gradients_match_jax_data_mesh(ranks, jax_ref):
    grads = ranks.results()[0]["dp"]["steps"][0]["grads"]
    assert set(grads) == set(jax_ref["grads"])
    for k, r in jax_ref["grads"].items():
        np.testing.assert_allclose(grads[k].numpy(), r, err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("step", range(STEPS))
def test_state_matches_jax_data_mesh(ranks, jax_ref, step):
    """The parameters SGD updated and every BN's running statistics (the
    fused tail's bn3 included) after each step."""
    port = _port_sd(ranks.results()[0]["dp"]["steps"][step])
    _hold_state(port, jax_ref["steps"][step]["state"], f"step {step}")


@pytest.mark.parametrize("step", range(STEPS))
def test_step_matches_one_process(ranks, one_process, step):
    """The same holds against the port's one-process step on the whole
    batch: loss, gradients, parameters and running statistics."""
    port = ranks.results()[0]["dp"]["steps"][step]
    ref = one_process[step]
    np.testing.assert_allclose(port["loss"], ref["loss"], **LOSS_TOL)
    assert port["acc"] == ref["acc"] and port["edges"] == ref["edges"]
    for k, g in ref["grads"].items():
        np.testing.assert_allclose(port["grads"][k].numpy(), g.numpy(),
                                   err_msg=k, **GRAD_TOL)
    _hold_state(_port_sd(port), _port_sd(ref), f"step {step}")


def test_per_rank_statistics_witness(ranks, jax_ref):
    """The witness: the same D = 2 step with each rank's statistics over
    its own rows (the axis kept from BN and the tail) misses JAX's loss by
    more than the rule, so the holds above see the global statistics."""
    r0, r1 = (res["witness"]["steps"][0] for res in ranks.results())
    assert r0["loss"] == r1["loss"]
    ref = jax_ref["steps"][0]["loss"]
    miss = abs(r0["loss"] - ref)
    assert miss > LOSS_TOL["atol"] + LOSS_TOL["rtol"] * abs(ref), miss


# ---------------------------------------------------------------------------
# multi-process start-up, the loader, the rank-0 checkpoint
# ---------------------------------------------------------------------------

def test_multihost_init_joins_over_tcp(ranks, one_process):
    """The ranks joined one default group through
    ``multihost_init("localhost:<port>")`` with the launcher's environment
    (gloo on the CPU), and their first step agrees with each other's and
    with the one-process step (tests/test_multihost.py's case)."""
    res = ranks.results()
    assert [r["axis"] for r in res] == [
        {"rank": r, "size": D, "backend": "gloo", "world": D}
        for r in range(D)]
    losses = [r["dp"]["steps"][0]["loss"] for r in res]
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], one_process[0]["loss"], **LOSS_TOL)


def _jax_rows(loader_root, epochs):
    cfg = JaxConfig().apply_overrides([f"data.root={loader_root}",
                                       *LOADER_OVER])
    loader = JaxLoader(JaxDataset(cfg.data, "train"), LOADER_BATCH,
                       shuffle=True, num_workers=1, seed=LOADER_SEED,
                       drop_last=True)
    out = {e: [{k: np.asarray(getattr(g, k)) for k in FIELDS}
               for g in loader.epoch(e)] for e in epochs}
    return out, cfg.data.bsr_blocks


def test_process_sharded_loader_rows_match_jax(ranks, loader_root):
    """Rank r's batches are rows [r·per, (r+1)·per) of JAX's single-process
    loader's batches, field by field, exactly; their block metadata is
    JAX's ``attach_bsr_meta(..., quantize=False, sticky_caps=None)`` on the
    same rows."""
    ref, blocks = _jax_rows(loader_root, LOADER_EPOCHS)
    per = LOADER_BATCH // D
    for r, res in enumerate(ranks.results()):
        got = res["loader"]["batches"]
        for e in LOADER_EPOCHS:
            assert len(got[e]) == len(ref[e]) > 0
            for a, b in zip(got[e], ref[e]):
                rows = {k: np.ascontiguousarray(v[r * per:(r + 1) * per])
                        for k, v in b.items()}
                for k in FIELDS:
                    assert a[k].dtype == rows[k].dtype, k
                    np.testing.assert_array_equal(a[k], rows[k], err_msg=k)
                jax_attach_bsr_meta(rows, blocks, False, sticky_caps=None)
                for k in META:
                    np.testing.assert_array_equal(a[k], rows[k], err_msg=k)
                    assert a[k].shape[-1] == blocks


def test_process_sharded_step_and_rank0_checkpoint(ranks):
    """One step on the sharded batches agrees across ranks; only rank 0's
    directory gains the checkpoint, the other rank gets the path back; the
    auto worker count is the usable cores over the ranks (here 1, set)."""
    r0, r1 = (res["loader"] for res in ranks.results())
    assert r0["loss"] == r1["loss"] and np.isfinite(r0["loss"])
    assert r0["wrote"] and not r1["wrote"]
    assert r1["path"].endswith("rank1/weight.pt")


def test_process_sharded_loader_refusals(loader_root):
    """Each rule of the JAX loader's ``process_shard`` raises here too."""
    cfg = Config().apply_overrides([f"data.root={loader_root}",
                                    *LOADER_OVER])
    ds = NucleiGraphDataset(cfg.data, "train")
    kw = dict(device="cpu", num_workers=1, drop_last=True, rank=0, world=2)
    with pytest.raises(ValueError, match="does not split"):
        GraphLoader(ds, 3, **kw)
    with pytest.raises(ValueError, match="drop_last"):
        GraphLoader(ds, 4, **{**kw, "drop_last": False})
    with pytest.raises(ValueError, match="dynamic buckets"):
        GraphLoader(ds, 4, dynamic_buckets=True, **kw)
    with pytest.raises(ValueError, match="rank 2"):
        GraphLoader(ds, 4, **{**kw, "rank": 2})
    auto = GraphLoader(ds, 4, **{**kw, "num_workers": 0})
    one = GraphLoader(ds, 4, device="cpu", num_workers=0)
    assert auto.num_workers == max(1, one.num_workers // 2)
    ds.transpose_width = 1
    if ds.supports_fast_path():
        with pytest.raises(RuntimeError, match="transpose width overflow"):
            next(iter(GraphLoader(ds, 4, **kw).epoch(0)))


def test_checkpoint_writes_without_a_group(tmp_path):
    """Outside a process group every process writes, as before."""
    cfg = Config().apply_overrides(OVER)
    path = save_checkpoint(tmp_path / "w.pt", {"a": torch.ones(2)}, cfg)
    assert path.is_file()


def test_shard_batch_rows():
    """A rank's slice: rows [r·B/D, (r+1)·B/D) of every batch-axis field;
    the graph itself for one rank; a batch that does not split raises."""
    g = worker.graph_of(dryrun.example_batch(4, cap=128))
    for r in range(2):
        part = shard_batch(g, GraphAxis(rank=r, size=2))
        for f in ("x", "nbr", "n_nodes", "y", "blk_cols_t"):
            assert torch.equal(getattr(part, f),
                               getattr(g, f)[2 * r:2 * r + 2]), f
    assert shard_batch(g, GraphAxis()) is g
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(g, GraphAxis(rank=0, size=3))


def test_one_member_axis_changes_nothing():
    """An axis of one rank: the same statistics, bit for bit, and no
    collective (no group exists)."""
    from cgcnet_tpu_torch.nn.layers import batch_moments

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 40, 6)).astype(np.float32))
    mask = (torch.arange(40)[None] < torch.tensor([[33], [40]])).float()
    for m in (None, mask):
        for a, b in zip(batch_moments(x, m), batch_moments(x, m, GraphAxis())):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_dryrun_two_ranks():
    """``run_dryrun(2)`` on CPU ranks: the data-parallel step, and (a
    graph axis of 2) the slide and capacity steps: finite losses, moved
    parameters, the same on both ranks."""
    res = dryrun.run_dryrun(2, cpu=True)
    assert dryrun._mesh_shape(2) == (1, 2)
    for name in ("dp", "slide", "slide-capacity"):
        a, b = (r[name] for r in res)
        assert np.isfinite(a["loss"]) and a["moved"] > 0, name
        assert a["loss"] == b["loss"], name
