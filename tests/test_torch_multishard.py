"""PyTorch port, the multi-shard whole-slide path: the graph axis
(``parallel/mesh.py``), its collectives and the JAX package's reference
aggregations over them (``parallel/mega_graph.py``), ``mega_forward`` and
the training step over D shards, and ``cli.slide`` at ``--shards 2``, each
run as D processes over a gloo group on the CPU (``file://`` init under
``tmp_path``) and held against the JAX package at the same D on its
virtual CPU mesh (``make_mesh(1, d)``, Pallas in interpret mode).

The ranks run in ``tests/torch_multishard_worker.py`` (torch, numpy and
the port only): one spawn per shard count runs every case of that count,
started when the first test needs it, so the ranks compute while this
process compiles the JAX side (once per case and count).

Tolerances are the slide files' (tests/test_torch_slide_model.py): f32
logits and loss atol 2e-5, rtol 1e-4; gradients rtol 2e-4 and atol 2e-4
of each tensor's max plus GRAD_FLOOR of the model's largest; running
statistics atol 2e-5, rtol 1e-4; bf16 by accuracy against the port's f32
result on the same slide (tests/test_torch_slide_bf16.py's ``no_worse``).
The reference aggregations are held at the JAX suite's 1e-5
(tests/test_parallel.py); rows that only move (the halo rows) and sums of
small integers exactly. Gradients are held with ``jk`` off: JAX's jitted
slide gradient is wrong for ``jk1.*`` / ``embed1.*`` with ``jk`` on
(``MEGA_JIT_FAULT``); logits are held with ``jk`` on as well.
"""

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp_mp

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import cgcnet_tpu.ops.pallas.assign_head as jah
import cgcnet_tpu.ops.pallas.bsr_kernel as bk
from cgcnet_tpu.config import Config as JaxConfig
from cgcnet_tpu.ops.ell import ell_gather_sum as j_ell_gather_sum
from cgcnet_tpu.ops.knn import radius_knn_np
from cgcnet_tpu.parallel import mega_graph as jmg
from cgcnet_tpu.parallel import mega_model as jmm
from cgcnet_tpu.parallel import slide_setup as jss
from cgcnet_tpu.parallel.mesh import make_mesh
from cgcnet_tpu_torch.cli import slide as slide_cli
from cgcnet_tpu_torch.ops.ell import EPS
from cgcnet_tpu_torch.parallel import mega_model as tmm
from cgcnet_tpu_torch.parallel import mega_graph as tmg
from cgcnet_tpu_torch.parallel.mesh import backend_for, rank_device

import torch_multishard_worker as worker
from test_torch_slide_bf16 import no_worse
from test_torch_slide_cli import OVERRIDES as CLI_OVERRIDES
from test_torch_slide_cli import jax_weights  # noqa: F401 (a fixture)
from test_torch_slide_graph import strip_graph
from test_torch_slide_model import (
    GRAD_TOL,
    LOGIT_TOL,
    SMALL,
    _hold,
    _jax_run,
    _models,
    strip_slide,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 virtual devices"
)

# the model cases' slide: 1024 rows, 960 real (the last of 4 shards part
# padding); 512 / 256 rows a shard, so the fused tail runs at D = 2 and 4
SLIDE = (1024, 960, 3)
LABEL = 1
TRAIN_CFG = dict(SMALL, jk=False)
EVAL_CFG = dict(SMALL)                      # jk on
# bf16 with B8 on the A @ S leg (d1 = 520 >= BAND_MIN_F) over 2 shards of
# the 4096-row strip whose tables carry halo windows
HALO_CFG = dict(SMALL, max_num_nodes=5200, compute_dtype="bfloat16",
                jk=False)
CLI_NUCLEI = 1500
# the bf16 training loss on the halo-window strip swings with the last bits
# of the pooled batch statistics (ROADMAP.md §3), so it is held against
# the spread of JAX's right computations of it (``halo_loss_spread``): the
# jitted eval-and-gradient program's loss, the same program's on x moved
# by one f32 rounding step (ULP_DRAWS draws of the signs, seeds 0, 1, ...),
# and a forward-only program's compiled with XLA's excess precision off.
# Under such moves the loss takes one of two values in either package
# (PERF.md §7), so a single draw would judge by one of them
ULP_DRAWS = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several test workers share
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def interpret_mode():
    bk.set_interpret(True)
    jah.set_interpret(True)
    yield
    bk.set_interpret(False)
    jah.set_interpret(False)


# ---------------------------------------------------------------------------
# inputs (numpy, from seeds)
# ---------------------------------------------------------------------------

def collectives_graph(seed=0, n=128, k=4, f=8):
    """tests/test_parallel.py's spatially sorted band graph: (nbr, mask, x)."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.uniform(0, n * 2.0, (n, 1)), axis=0)
    pos = np.concatenate([pos, rng.uniform(0, 50, (n, 1))], 1).astype(
        np.float32)
    nbr, mask = radius_knn_np(pos, 60.0, k)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return nbr, mask, x


def halo_slide(n=4096, shards=2, feat=18, seed=7):
    """tests/test_torch_slide_graph.py's (4096, 2, "halo_windows") strip,
    every row real, with features: (x, nbr, mask)."""
    nbr, mask = strip_graph(n, shards, seed=seed)
    x = np.random.default_rng(seed).normal(size=(n, feat)).astype(np.float32)
    return x, nbr.astype(np.int32), mask.astype(np.float32)


def _case(name, kind, **kw):
    return dict(name=name, kind=kind, **kw)


_MODELS: dict = {}


def models(mcfg: dict, seed: int = 1):
    """tests/test_torch_slide_model.py's ``_models``, once per config."""
    key = (tuple(sorted(mcfg.items())), seed)
    if key not in _MODELS:
        _MODELS[key] = _models(mcfg, seed)
    return _MODELS[key]


def _model_case(name, mcfg, x, nbr, mask, n_real, tables, eval_only,
                variants=(), fwd=None, seed=1, kind="model", spread=False,
                fault=None):
    """A model case; ``spread``: JAX's loss by several right computations
    (``jax_model``); ``fault``: the ranks' planted fault
    (tests/torch_multishard_worker.py's ``model_case``)."""
    _, _, _, model = models(mcfg, seed)
    return _case(name, kind, mcfg=mcfg, state_dict=model.state_dict(),
                 x=x, nbr=nbr, mask=mask, n_real=n_real, tables=tables,
                 label=LABEL, eval_only=eval_only, variants=list(variants),
                 fwd=fwd or {}, spread=spread, fault=fault)


def collectives_job(d):
    nbr, mask, x = collectives_graph()
    part = tmg.partition_graph(nbr, mask, d)
    rng = np.random.default_rng(10 + d)
    ints = lambda *shape: rng.integers(-8, 9, shape).astype(np.float32)
    return _case(
        "collectives", "collectives", x=x, nbr=nbr, mask=mask,
        g_out=rng.normal(size=x.shape).astype(np.float32),
        g_halo=rng.normal(size=(d, d * part.halo_capacity, x.shape[1]))
        .astype(np.float32),
        v=ints(d, 5, 3), gv=ints(d, 5, 3), gv_stack=ints(d, d, 5, 3))


def pool_job():
    """(10240, 4, "hybrid") strip: forward blocks over [x ++ halo], the
    transpose blocks over the local rows only."""
    nbr, mask = strip_graph(10240, 4, seed=7)
    rng = np.random.default_rng(21)
    c, f = 128, 8
    return _case(
        "pool", "pool", mcfg=dict(SMALL), x=np.zeros((10240, 18), np.float32),
        nbr=nbr.astype(np.int32), mask=mask.astype(np.float32), n_real=10240,
        tables=True, s=rng.normal(size=(10240, c)).astype(np.float32),
        pembed=rng.normal(size=(10240, f)).astype(np.float32),
        ct_x=rng.normal(size=(c, f)).astype(np.float32),
        ct_adj=rng.normal(size=(c, c)).astype(np.float32))


def jobs(d, ckpt):
    x, nbr, mask = strip_slide(*SLIDE)
    out = [
        collectives_job(d),
        _model_case("train", TRAIN_CFG, x, nbr, mask, SLIDE[1], False, False,
                    variants=[("chunked", {"assign_tail_chunk": 256}, {}),
                              ("overlap", {}, {"halo_overlap": True})]),
        _model_case("eval_jk", EVAL_CFG, x, nbr, mask, SLIDE[1], False, True),
    ]
    if d == 2:
        out += [
            _model_case("steps", dict(EVAL_CFG, drop_out=0.5), x, nbr, mask,
                        SLIDE[1], False, False, kind="steps"),
            _model_case("halo", HALO_CFG, *halo_slide(), 4096, True, False,
                        variants=[("f32", {"compute_dtype": "float32"},
                                   {})], spread=True),
            _model_case("halo_gather", HALO_CFG, *halo_slide(), 4096, False,
                        False),
            _case("cli", "cli", argv=[
                "--cpu", "--synthetic", "--nuclei", str(CLI_NUCLEI),
                "--shards", "2", "--ckpt", str(ckpt), *CLI_OVERRIDES]),
        ]
    else:
        out.append(pool_job())
    return out


# ---------------------------------------------------------------------------
# the ranks: one spawn per shard count, every case of that count
# ---------------------------------------------------------------------------

class Ranks:
    """D spawned ranks running the jobs of ``jobs(d)``."""

    def __init__(self, d, root, ckpt):
        self.d, self.out = d, root / f"out{d}"
        self.out.mkdir()
        self.job = jobs(d, ckpt)
        torch.save(self.job, root / f"job{d}.pt")
        self.ctx = tmp_mp.start_processes(
            worker.run, args=(d, str(root / f"init{d}"),
                              str(root / f"job{d}.pt"), str(self.out)),
            nprocs=d, join=False, start_method="spawn")
        self._res = None

    def results(self) -> list:
        """Every rank's results (joins the ranks; a rank's failure raises
        with its traceback and ends the others)."""
        if self._res is None:
            while not self.ctx.join(timeout=600):
                pass
            self._res = [torch.load(self.out / f"rank{r}.pt",
                                    weights_only=False)
                         for r in range(self.d)]
        return self._res

    def case(self, name):
        return next(c for c in self.job if c["name"] == name)

    def close(self) -> None:
        """End ranks no test joined (a run of some of the tests)."""
        for proc in self.ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_weights):
    """The ranks of D = 2 and 4, started together (the CLI case reads
    ``jax_weights``' checkpoint: tests/test_torch_slide_cli.py's)."""
    root = tmp_path_factory.mktemp("multishard")
    groups = {d: Ranks(d, root, jax_weights[1]) for d in (2, 4)}
    yield groups
    for group in groups.values():
        group.close()


# ---------------------------------------------------------------------------
# the JAX side, once per case and shard count
# ---------------------------------------------------------------------------

_JAX: dict = {}


def _jax_inputs(x, nbr, mask, n_real, d, tables):
    mesh = make_mesh(1, d, devices=jax.devices()[:d])
    part = jmg.partition_graph(nbr, mask, d)
    tab = jmg.build_bsr_tables(part) if tables else None
    return mesh, jmm.prepare_mega_inputs(x, part, mesh, n_real=n_real,
                                         bsr=tab)


def moved_by_one_ulp(x: np.ndarray, seed: int) -> np.ndarray:
    """``x`` with every nonzero entry moved one f32 rounding step up or
    down (signs drawn from ``seed``)."""
    toward = np.random.default_rng(seed).choice(
        np.array([-np.inf, np.inf], np.float32), size=x.shape)
    return np.where(x != 0, np.nextafter(x, toward), x)


def jax_model(case, d):
    """JAX's eval logits (and, unless eval-only, training loss, gradients
    and running statistics) of a model case at D shards; for a ``spread``
    case also the training loss on x moved by one rounding step, ULP_DRAWS
    times (``j_loss_moved``), and by a forward-only program compiled with
    XLA's excess precision off (``j_loss_off``)."""
    key = (case["name"], d)
    if key not in _JAX:
        jcfg, variables, _, _ = models(case["mcfg"])
        mesh, jinp = _jax_inputs(case["x"], case["nbr"], case["mask"],
                                 case["n_real"], d, case["tables"])
        if case["eval_only"]:
            ev = jax.jit(lambda v: jmm.mega_forward(
                v, jcfg, jinp, mesh, train=False))(variables)
            _JAX[key] = dict(j_eval=np.asarray(ev))
        elif case.get("spread"):
            _JAX[key] = _jax_run(
                jcfg, variables, jinp, mesh, LABEL,
                x_moved=[moved_by_one_ulp(np.asarray(jinp.x), seed)
                         for seed in range(ULP_DRAWS)])

            def loss(v, inp):
                logits = jmm.mega_forward(v, jcfg, inp, mesh, train=True)
                return -jax.nn.log_softmax(logits)[LABEL]

            _JAX[key]["j_loss_off"] = float(jax.jit(
                loss, compiler_options={"xla_allow_excess_precision": False})(
                    variables, jinp))
        else:
            _JAX[key] = _jax_run(jcfg, variables, jinp, mesh, LABEL)
    return _JAX[key]


def halo_loss_spread(ref: dict) -> list:
    """JAX's right computations of a ``spread`` case's training loss."""
    return [ref["j_loss"], *ref["j_loss_moved"], ref["j_loss_off"]]


def _as_port(res: dict) -> dict:
    """A rank's model result in tests/test_torch_slide_model.py's form."""
    out = dict(t_eval=res["eval"])
    if "loss" in res:
        out.update(t_loss=res["loss"],
                   t_grads={n: torch.from_numpy(g)
                            for n, g in res["grads"].items()},
                   t_stats={n: torch.from_numpy(s)
                            for n, s in res["stats"].items()})
    return out


def _same_on_every_rank(results, name, run):
    """Rank 0's result of ``run`` after checking every rank's is the same,
    bit for bit (the replicated stages)."""
    r0 = results[0][name][run]
    for res in results[1:]:
        other = res[name][run]
        np.testing.assert_array_equal(other["eval"], r0["eval"])
        if "loss" in r0:
            assert other["loss"] == r0["loss"]
            for n, g in r0["grads"].items():
                np.testing.assert_array_equal(other["grads"][n], g, err_msg=n)
            for n, s in r0["stats"].items():
                np.testing.assert_array_equal(other["stats"][n], s, err_msg=n)
    return r0


# ---------------------------------------------------------------------------
# the graph axis
# ---------------------------------------------------------------------------

def test_backend_rule():
    """gloo on the CPU; nccl when every rank owns a card, else gloo with
    ranks sharing the cards round robin."""
    assert backend_for("cpu", 4, 0) == "gloo"
    assert backend_for("cuda", 4, 1) == "gloo"
    assert backend_for("cuda", 4, 4) == "nccl"
    assert backend_for("cuda", 2, 8) == "nccl"
    assert rank_device("cpu", 3, 0) == torch.device("cpu")
    assert [rank_device("cuda", r, 1) for r in range(4)] == \
        [torch.device("cuda", 0)] * 4
    assert rank_device("cuda", 5, 4) == torch.device("cuda", 1)


@pytest.mark.parametrize("d", [2, 4])
def test_collectives_match_jax(ranks, d):
    """The halo exchange (rows exact, against JAX's ``_halo_exchange`` on
    each shard; its autograd backward equal to the reverse all-to-all of
    ``halo_exchange_vjp``), JAX's reference aggregations and their
    gradients (``sharded_gather_sum``, ``_overlap``, ``_allgather``), and
    ``psum`` / ``all_gather`` with their backward against autograd through
    the single-process equivalents, exactly, in f32 and in bf16."""
    case = ranks[d].case("collectives")
    nbr, mask, x = case["nbr"], case["mask"], case["x"]
    n, k = nbr.shape
    mesh = make_mesh(1, d, devices=jax.devices()[:d])
    part = jmg.partition_graph(nbr, mask, d)
    put = lambda a: jax.device_put(jnp.asarray(a),
                                   NamedSharding(mesh, P("graph")))
    tabs = (put(part.nbr_remap.reshape(n, k)), put(part.nbr_mask.reshape(n, k)),
            put(part.nbr_mask.reshape(n, k)),
            put(part.req_idx.reshape(-1, part.halo_capacity)),
            put(part.req_mask.reshape(-1, part.halo_capacity)))
    g = put(case["g_out"])
    fns = {
        "gather": lambda xx: jmg.sharded_gather_sum(xx, *tabs, mesh=mesh),
        "overlap": lambda xx: jmg.sharded_gather_sum_overlap(xx, *tabs,
                                                             mesh=mesh),
        "allgather": lambda xx: jmg.sharded_gather_sum_allgather(
            xx, put(nbr), put(mask), mesh=mesh),
    }

    def outputs_and_grads(xx):
        out = {name: fn(xx) for name, fn in fns.items()}
        out.update({name + "_grad": jax.grad(
            lambda z, f=fn: jnp.sum(f(z) * g))(xx)
            for name, fn in fns.items()})
        return out

    ref = {k_: np.asarray(v_)
           for k_, v_ in jax.jit(outputs_and_grads)(put(x)).items()}
    halo = np.asarray(jax.shard_map(
        lambda xl, ri, rm: jmg._halo_exchange(xl, ri, rm, "graph"),
        mesh=mesh, in_specs=(P("graph"),) * 3, out_specs=P("graph"))(
            put(x), tabs[3], tabs[4])).reshape(d, -1, x.shape[1])

    v, gv, gvs = (torch.tensor(case[k_]) for k_ in ("v", "gv", "gv_stack"))
    vv = v.clone().requires_grad_(True)
    (psum_grad,) = torch.autograd.grad(
        sum((vv.sum(0) * gv[r]).sum() for r in range(d)), vv)
    vv = v.clone().requires_grad_(True)
    (gather_grad,) = torch.autograd.grad(
        sum((vv * gvs[r]).sum() for r in range(d)), vv)
    parts = [v[r].to(torch.bfloat16) / 3 for r in range(d)]
    bf_sum = parts[0]
    for part_ in parts[1:]:
        bf_sum = bf_sum + part_

    ns = n // d
    for r, res in enumerate(ranks[d].results()):
        c = res["collectives"]
        rows = slice(r * ns, (r + 1) * ns)
        np.testing.assert_array_equal(c["halo"], halo[r])
        assert torch.equal(c["halo_bf16"],
                           torch.tensor(halo[r]).to(torch.bfloat16))
        np.testing.assert_array_equal(c["halo_grad_autograd"],
                                      c["halo_grad_vjp"])
        for name in ("gather", "overlap", "allgather"):
            np.testing.assert_allclose(c[name], ref[name][rows], atol=1e-5,
                                       err_msg=name)
            np.testing.assert_allclose(c[name + "_grad"],
                                       ref[name + "_grad"][rows], atol=1e-5,
                                       err_msg=name)
        np.testing.assert_array_equal(c["psum"], v.sum(0).numpy())
        np.testing.assert_array_equal(c["psum_grad"], psum_grad[r].numpy())
        np.testing.assert_array_equal(c["all_gather"], v.numpy())
        np.testing.assert_array_equal(c["all_gather_grad"],
                                      gather_grad[r].numpy())
        assert torch.equal(c["psum_bf16"], bf_sum)


# ---------------------------------------------------------------------------
# mega_forward over D shards against JAX's at the same D
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 4])
def test_mega_forward_eval_jk_matches_jax(ranks, d):
    """Eval logits with ``jk`` on, the same bits on every rank."""
    ref = jax_model(ranks[d].case("eval_jk"), d)
    r0 = _same_on_every_rank(ranks[d].results(), "eval_jk", "base")
    np.testing.assert_allclose(r0["eval"], ref["j_eval"], **LOGIT_TOL)


@pytest.mark.parametrize("d", [2, 4])
def test_mega_forward_train_matches_jax(ranks, d):
    """Eval logits, training loss, every gradient (``jk`` off; the loss /
    D routing and the gradient sum over the axis) and the running
    statistics, through the fused tail (``AssignTailTrainPsum``: the BN
    statistics summed over the axis, their cotangents from the summed
    dK3f / dconst, the parameters' from this shard's share); the same bits
    on every rank."""
    ref = jax_model(ranks[d].case("train"), d)
    results = ranks[d].results()
    r0 = _same_on_every_rank(results, "train", "base")
    assert r0["tail"] == {"psum": 1, "chunked_lin": 0}, r0["tail"]
    _hold({**_as_port(r0), **ref})


def test_chunked_lin_and_overlap_match_jax(ranks):
    """At D = 2, the capacity path's chunked-lin tail (two 256-row chunks a
    shard; its statistics and dK3f summed over the axis) and the
    interior / boundary split of ``halo_overlap`` against the same JAX
    result: neither changes the function."""
    ref = jax_model(ranks[2].case("train"), 2)
    results = ranks[2].results()
    for run in ("chunked", "overlap"):
        r0 = _same_on_every_rank(results, "train", run)
        _hold({**_as_port(r0), **ref})
    assert results[0]["train"]["chunked"]["tail"] == \
        {"psum": 0, "chunked_lin": 1}


def test_block_path_halo_windows_bf16(ranks):
    """The block path with hand-built tables over 2 shards of the 4096-row
    strip whose tables carry halo windows, bf16 (B8 on the A @ S legs over
    [x ++ halo windows]; plain versions on the CPU):

    - against the gather path over the same halo exchange at D = 2: eval
      logits and training loss bit for bit, running statistics and
      gradients within one bf16 rounding (2^-6 of each tensor's max, the
      card tests' bf16 rule: the transpose legs sum in another order);
    - against JAX's bf16 at D = 2 by accuracy against the port's f32
      result on the same slide (tests/test_torch_slide_bf16.py's rule):
      logits, running statistics and every gradient. The training loss is
      held by the two checks above, in f32 against JAX's
      (``test_mega_forward_train_matches_jax``) and, in bf16, against the
      spread of JAX's right computations of it
      (``test_block_path_halo_windows_bf16_loss_within_jax_spread``): on
      this slide the bf16 train-mode loss swings with the last bits of the
      pooled batch statistics (ROADMAP.md §3), at one shard as at two."""
    res = ranks[2].results()
    ref = jax_model(ranks[2].case("halo"), 2)
    assert all(r["halo"]["win_halo"] for r in res)
    assert all(r["halo"]["b8_halo_window_calls"] >= 2 for r in res), \
        [r["halo"]["b8_halo_window_calls"] for r in res]
    assert not any(r["halo_gather"]["b8_halo_window_calls"] for r in res)
    t16 = _same_on_every_rank(res, "halo", "base")
    t32 = _same_on_every_rank(res, "halo", "f32")
    g16 = _same_on_every_rank(res, "halo_gather", "base")
    np.testing.assert_array_equal(t16["eval"], g16["eval"])
    assert t16["loss"] == g16["loss"]
    for part in ("stats", "grads"):
        assert set(t16[part]) == set(g16[part])
        for name, want in g16[part].items():
            np.testing.assert_allclose(
                t16[part][name], want, rtol=0,
                atol=2.0 ** -6 * float(np.abs(want).max()), err_msg=name)
    no_worse("logits", t16["eval"], ref["j_eval"], t32["eval"],
             LOGIT_TOL["atol"])
    for name, s32 in t32["stats"].items():
        no_worse(name, t16["stats"][name], ref["j_stats"][name].numpy(), s32,
                 2e-5)
    assert set(t32["grads"]) <= set(ref["j_grads"])
    for name, g32 in t32["grads"].items():
        no_worse(name, t16["grads"][name], ref["j_grads"][name].numpy(), g32,
                 GRAD_TOL["atol"] + GRAD_TOL["rtol"] * float(np.abs(g32).max()))


def halo_loss_distances(t16: float, t32: float, ref: dict) -> tuple:
    """(the port's bf16 loss's distance from its f32 loss, the largest of
    JAX's bf16 losses' distances from it, the tolerance)."""
    return (abs(t16 - t32), max(abs(j - t32) for j in halo_loss_spread(ref)),
            LOGIT_TOL["atol"])


def test_block_path_halo_windows_bf16_loss_within_jax_spread(ranks):
    """The bf16 training loss of the block path on the halo-window strip at
    D = 2: its distance from the port's f32 loss on the same slide within
    twice the largest distance of JAX's bf16 right computations of it
    (``halo_loss_spread``: the eval-and-gradient program, that program on
    x moved by one rounding step, a forward-only program without XLA's
    excess precision) from the same f32 loss, plus the f32 loss
    tolerance."""
    res = ranks[2].results()
    ref = jax_model(ranks[2].case("halo"), 2)
    t16 = _same_on_every_rank(res, "halo", "base")["loss"]
    t32 = _same_on_every_rank(res, "halo", "f32")["loss"]
    d_t, d_j, tol = halo_loss_distances(t16, t32, ref)
    assert d_t <= 2.0 * d_j + tol, (d_t, d_j, tol, halo_loss_spread(ref))


def test_hybrid_pool_aggregate_gradient(ranks):
    """``PoolAggregate`` at 4 shards of the (10240, 4, "hybrid") strip
    (transpose blocks over the local rows only, the halo rows' in-edges as
    an ELL gather), f32: its pooled outputs summed over the axis and its
    gradient in S and pembed against JAX's gather path at D = 4 (the same
    function through ``_halo_exchange``, ``ell_gather_sum`` and a psum),
    at the slide files' gradient rule."""
    case = ranks[4].case("pool")
    d, n = 4, case["s"].shape[0]
    ns = n // d
    part = jmg.partition_graph(case["nbr"], case["mask"], d)
    p = SMALL.get("self_weight", 0.4)
    row = np.arange(ns, dtype=np.int32)[None, :, None]
    off = part.nbr_mask * (part.nbr_remap != row)
    scale = ((1.0 - p) / (off.sum(-1) + EPS)).astype(np.float32)
    mesh = make_mesh(1, d, devices=jax.devices()[:d])
    put = lambda a: jax.device_put(jnp.asarray(a),
                                   NamedSharding(mesh, P("graph")))

    def local(s_l, pe_l, nbr_l, w_l, sc_l, ri, rm):
        halo = jmg._halo_exchange(s_l, ri, rm, "graph")
        agg = j_ell_gather_sum(nbr_l[None], w_l[None],
                               jnp.concatenate([s_l, halo])[None])[0]
        a_s = sc_l[:, None] * agg + p * s_l
        return (jax.lax.psum(s_l.T @ pe_l, "graph"),
                jax.lax.psum(s_l.T @ a_s, "graph"))

    fn = jax.shard_map(local, mesh=mesh, in_specs=(P("graph"),) * 7,
                       out_specs=(P(), P()))
    consts = (put(part.nbr_remap.reshape(n, -1)), put(off.reshape(n, -1)),
              put(scale.reshape(n)),
              put(part.req_idx.reshape(-1, part.halo_capacity)),
              put(part.req_mask.reshape(-1, part.halo_capacity)))
    (xp, ap), vjp = jax.vjp(lambda s_, pe_: fn(s_, pe_, *consts),
                            put(case["s"]), put(case["pembed"]))
    ds, dpe = (np.asarray(a) for a in vjp((jnp.asarray(case["ct_x"]),
                                           jnp.asarray(case["ct_adj"]))))
    res = ranks[4].results()
    assert max(r["pool"]["hybrid_rows"] for r in res) > 0
    close = lambda got, want, what: np.testing.assert_allclose(
        got, want, rtol=GRAD_TOL["rtol"],
        atol=GRAD_TOL["atol"] * np.abs(want).max(), err_msg=what)
    for r, out in enumerate(res):
        rows = slice(r * ns, (r + 1) * ns)
        close(out["pool"]["x_pool"], np.asarray(xp), "x_pool")
        close(out["pool"]["adj_pool"], np.asarray(ap), "adj_pool")
        close(out["pool"]["ds"], ds[rows], "dS")
        close(out["pool"]["dpembed"], dpe[rows], "dpembed")


def test_shard_count_invariance(ranks):
    """The port's eval logits (``jk`` on) at D = 1, 2 and 4 agree
    (tests/test_mega_model.py:71's rule, atol 2e-5)."""
    case = ranks[2].case("eval_jk")
    _, _, tcfg, model = models(case["mcfg"])
    part = tmg.partition_graph(case["nbr"], case["mask"], 1)
    with torch.no_grad():
        one = tmm.mega_forward(model, tcfg, tmm.prepare_mega_inputs(
            case["x"], part, "cpu", n_real=case["n_real"])).numpy()
    for d in (2, 4):
        np.testing.assert_allclose(ranks[d].results()[0]["eval_jk"]["base"]
                                   ["eval"], one, atol=2e-5, err_msg=str(d))


def test_ranks_bit_identical_after_two_steps(ranks):
    """Two ``make_slide_train_step`` steps at D = 2 (Adam, head dropout):
    every rank's parameters, Adam state and running statistics are
    ``torch.equal`` to rank 0's after each step, and the step moved
    them."""
    res = ranks[2].results()
    case = ranks[2].case("steps")
    for i in range(2):
        s0 = res[0]["steps"]["steps"][i]
        assert np.isfinite(s0["loss"])
        for other in res[1:]:
            s = other["steps"]["steps"][i]
            assert s["loss"] == s0["loss"]
            assert set(s["state"]) == set(s0["state"])
            for name, t in s0["state"].items():
                assert torch.equal(s["state"][name], t), (i, name)
    st = res[0]["steps"]["steps"][1]["state"]
    moved = [n for n, t in case["state_dict"].items()
             if f"param.{n}" in st and not torch.equal(st[f"param.{n}"], t)]
    assert len(moved) == sum(1 for n in st if n.startswith("param."))
    assert any(n.startswith("adam.") for n in st)


def test_slide_cli_two_ranks_grades_like_jax(ranks, jax_weights):
    """``cli.slide --cpu --shards 2`` as two ranks grades the synthetic
    slide as JAX's ``mega_forward`` does on JAX's own 2-shard build of it
    (tests/test_torch_slide_cli.py's one-shard recipe), the same logits on
    both ranks; in a process that joined no group, ``--shards 2`` is
    refused with the launcher command named (never a quiet one-shard
    run)."""
    variables, _ = jax_weights
    jcfg = JaxConfig().apply_overrides(CLI_OVERRIDES)
    feats, coords = jss.synthetic_slide(CLI_NUCLEI)
    mesh = make_mesh(1, 2, devices=jax.devices()[:2])
    build = jss.build_slide_inputs(jcfg, feats, coords, 2, mesh)
    ref = np.asarray(jax.jit(lambda v: jmm.mega_forward(
        v, jcfg.model, build.inputs, mesh, train=False,
        halo_overlap=True))(variables))
    res = ranks[2].results()
    for r in res:
        c = r["cli"]
        assert not c["bsr"] and c["n"] == CLI_NUCLEI and c["cap"] == 2048
        np.testing.assert_array_equal(c["logits"], res[0]["cli"]["logits"])
    np.testing.assert_allclose(res[0]["cli"]["logits"], ref, **LOGIT_TOL)
    assert res[0]["cli"]["pred"] == int(np.argmax(ref))
    with pytest.raises(ValueError, match="torch.distributed.run"):
        slide_cli.main(["--cpu", "--synthetic", "--nuclei", "600",
                        "--shards", "2"])
