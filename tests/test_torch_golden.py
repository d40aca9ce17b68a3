"""PyTorch port, the golden fixture: ``tests/golden/cgcnet_golden.npz``
(logits of the reference's pure-torch oracle with transplanted weights,
made by tests/make_golden.py) through the port, and SGD steps of the port
against the JAX package's ``make_train_step`` on the same graphs.

The fixture's graphs have capacity 40 and carry neither BSR metadata nor
transpose tables, and its configuration (``compat_cfg``: use_pallas off,
masked_bn and masked_readout off) runs the EllAdj gather path with
renorm_ell weights, the unfused folded tail and ``diff_pool``: no kernel.

Tolerances are tests/test_golden.py's: logits atol 2e-5 / rtol 1e-4,
running statistics atol 1e-5 / rtol 1e-4; the SGD trajectory as
tests/test_torch_train.py holds it (losses as the logits, parameters and
running statistics atol 5e-5 / rtol 1e-4 after the last step).

SGD steps and rate: one step's gradients agree with JAX's to 8e-5 of
each tensor's largest entry, but the fixture's small graphs (max readout
over zero-padded rows, BN over 9 rows at stage 3) amplify f32 noise. At
lr 1e-3 a max-readout near-tie flips at step 5 (the two losses then part
by 1e-2, both trajectories right). At lr 1e-4 no readout flips, but the
two trajectories drift apart: ``embed3.bn3.running_mean`` parts by 2e-6
after 6 steps, 6e-5 after 11 and 2.8e-4 after 20, and the losses by
1.8e-4 at step 20 (JAX against itself with x moved by one rounding step
parts there by 2.7e-5 after 20 steps). The step count is cut to 8 for
that drift, not for a flip: at 8 steps lr 1e-4 every hold keeps the
tolerances above with a margin of 2.5x or more.

Past step 8 the trajectory is held against a witness of the exact one: the
port's plain path run in float64 (the golden path runs no kernel; the
package's f32 casts taken to float64 by ``Float64Mode``, which fails the
run if any float32 tensor is made). At step LONG_STEPS (20) each f32
trajectory — the port's and JAX's — must lie within twice the other's
distance from the float64 one, plus the tolerances above: losses, then
parameters and running statistics, each tensor by its max. Neither f32
trajectory is the exact one, so neither is the yardstick of the other;
one that computed another function would part from the float64 witness
alone. The three trajectories are computed once per worker
(``trajectories``) and read by both SGD tests.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import unflatten_dict
from torch.overrides import TorchFunctionMode

from cgcnet_tpu.config import TrainConfig as JaxTrainConfig
from cgcnet_tpu.core.graph import CellGraph as JaxCellGraph
from cgcnet_tpu.nn import model as jmodel
from cgcnet_tpu.train import loop as jloop
from cgcnet_tpu.train import optim as joptim
from cgcnet_tpu.train.state import TrainState as JaxTrainState
from cgcnet_tpu_torch.config import Config, ModelConfig, TrainConfig
from cgcnet_tpu_torch.core.graph import CellGraph
from cgcnet_tpu_torch.nn import adjacency as tadj
from cgcnet_tpu_torch.nn import model as tmodel
from cgcnet_tpu_torch.train.checkpoint import state_dict_from_flax
from cgcnet_tpu_torch.train.loop import make_train_step
from cgcnet_tpu_torch.train.state import create_train_state

from test_parity_torch import compat_cfg

GOLDEN = Path(__file__).parent / "golden" / "cgcnet_golden.npz"
# SGD on the fixture (see the module docstring for the step count and rate)
SGD_STEPS = 8
# the float64 witness's step count (module docstring)
LONG_STEPS = 20
SGD = dict(optim="sgd", lr=1e-4, weight_decay=1e-4, momentum=0.9)
LABELS = np.array([0, 2, 1], np.int32)  # the fixture has none; seeded choice


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several test workers share
    the cores; one thread also fixes torch's summation order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    return load_golden()


def load_golden():
    """(graph, variables, running statistics after the training forward,
    training logits, eval logits) of the fixture."""
    z = np.load(GOLDEN)
    graph = {k: z[k] for k in ("x", "nbr", "nbr_mask", "n_nodes")}
    variables, stats_post = {}, {}
    for key in z.files:
        if key.startswith("var::"):
            coll, _, rest = key[len("var::"):].partition("/")
            variables.setdefault(coll, {})[tuple(rest.split("/"))] = z[key]
        elif key.startswith("stat::"):
            stats_post[tuple(key[len("stat::"):].split("/"))] = z[key]
    variables = {c: unflatten_dict(t) for c, t in variables.items()}
    stats_post = state_dict_from_flax({"batch_stats": unflatten_dict(stats_post)})
    return graph, variables, stats_post, z["logits_train"], z["logits_eval"]


def _port(variables):
    cfg = ModelConfig(**dataclasses.asdict(compat_cfg()))
    model = tmodel.CGCNet(cfg)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def _graph(graph, **extra):
    return CellGraph(**{k: torch.from_numpy(np.array(v))
                        for k, v in {**graph, **extra}.items()})


def test_golden_logits_and_running_stats(golden):
    """Training-mode logits (BN batch statistics over every row, the
    reference's quirk), the updated running statistics, then eval-mode
    logits with them, against the fixture."""
    graph, variables, stats_post, logits_train, logits_eval = golden
    model = _port(variables)
    g = _graph(graph)
    assert type(tmodel.make_stage1_adj(g, model.cfg, torch.float32)) is tadj.EllAdj
    with torch.no_grad():
        out = model.train()(g)
    np.testing.assert_allclose(out.numpy(), logits_train, atol=2e-5, rtol=1e-4)
    sd = model.state_dict()
    assert set(stats_post) == {k for k in sd if "running" in k}
    for k, ref in stats_post.items():
        np.testing.assert_allclose(sd[k].numpy(), ref.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    with torch.inference_mode():
        out = model.eval()(g)
    np.testing.assert_allclose(out.numpy(), logits_eval, atol=2e-5, rtol=1e-4)


class Float64Mode(TorchFunctionMode):
    """Every float32 the port asks for (``.float()``, ``dtype=``, ``.to``)
    taken as float64, under a float64 default dtype; a float32 result
    fails the run (the witness is float64 throughout)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.Tensor.float:
            func = torch.Tensor.double
        args = tuple(torch.float64 if a is torch.float32 else a for a in args)
        if kwargs.get("dtype") is torch.float32:
            kwargs["dtype"] = torch.float64
        out = func(*args, **kwargs)
        for o in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(o, torch.Tensor) and o.dtype == torch.float32:
                raise AssertionError(f"{func} made a float32 tensor")
        return out


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def port_trajectory(graph, variables, f64=False, steps=LONG_STEPS,
                    adj_hook=None):
    """The port's SGD on the fixture: (losses, state after SGD_STEPS,
    state after ``steps``), in f32 or, with ``f64``, float64 throughout.
    ``adj_hook`` (a witness's planted fault) rewrites the stage-1
    adjacency."""
    jcfg = compat_cfg()
    state = create_train_state(
        Config(model=ModelConfig(**dataclasses.asdict(jcfg)),
               train=TrainConfig(**SGD)), "cpu")
    state.model.load_state_dict(state_dict_from_flax(variables), strict=True)
    tg = _graph(graph, y=LABELS)
    if f64:
        state.model.double()
        tg = dataclasses.replace(tg, x=tg.x.double(),
                                 nbr_mask=tg.nbr_mask.double())
    step = make_train_step()
    make_adj = tmodel.make_stage1_adj
    if adj_hook is not None:
        tmodel.make_stage1_adj = lambda *a: adj_hook(make_adj(*a))
    dtype = torch.get_default_dtype()
    losses, mid = [], None
    try:
        for i in range(steps):
            if f64:
                torch.set_default_dtype(torch.float64)
                with Float64Mode():
                    m = step(state, tg)
                torch.set_default_dtype(dtype)
            else:
                m = step(state, tg)
            losses.append(float(m["loss"]))
            if i + 1 == SGD_STEPS:
                mid = _state(state.model)
    finally:
        torch.set_default_dtype(dtype)
        tmodel.make_stage1_adj = make_adj
    return np.array(losses), mid, _state(state.model)


def jax_trajectory(graph, variables, steps=LONG_STEPS):
    """JAX's jitted ``make_train_step`` on the fixture, f32: (losses, state
    after SGD_STEPS, state after ``steps``) in the port's names."""
    jcfg = compat_cfg()
    net = jmodel.CGCNet(jcfg)
    tx = joptim.make_optimizer(JaxTrainConfig(**SGD), steps_per_epoch=100)
    jstate = JaxTrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        step=jnp.zeros((), jnp.int32),
        rng=jax.random.key_data(jax.random.key(0)),
    )
    jg = JaxCellGraph(**{k: jnp.asarray(v) for k, v in graph.items()},
                      y=jnp.asarray(LABELS))
    jstep = jax.jit(lambda s, g: jloop.make_train_step(net)(s, g, tx))
    sd = lambda s: state_dict_from_flax({"params": s.params,
                                         "batch_stats": s.batch_stats})
    losses, mid = [], None
    for i in range(steps):
        jstate, jm = jstep(jstate, jg)
        losses.append(float(jm["loss"]))
        if i + 1 == SGD_STEPS:
            mid = sd(jstate)
    return np.array(losses), mid, sd(jstate)


_TRAJ: dict = {}


def trajectories(golden) -> dict:
    """JAX's f32, the port's f32 and the port's float64 trajectories of
    LONG_STEPS steps, once per worker."""
    if not _TRAJ:
        graph, variables, _, _, _ = golden
        _TRAJ.update(jax=jax_trajectory(graph, variables),
                     port=port_trajectory(graph, variables),
                     f64=port_trajectory(graph, variables, f64=True))
    return _TRAJ


def spread_distances(t32, j32, t64) -> dict:
    """{what: (the port's f32 distance from the float64 witness, JAX's,
    the tolerance)} at the last step: the loss, then each parameter and
    running statistic by its max."""
    out = {"loss": (abs(t32[0][-1] - t64[0][-1]), abs(j32[0][-1] - t64[0][-1]),
                    2e-5 + 1e-4 * abs(t64[0][-1]))}
    for k, ref in t64[2].items():
        r = ref.numpy()
        out[k] = (float(np.abs(t32[2][k].double().numpy() - r).max()),
                  float(np.abs(j32[2][k].numpy().astype(np.float64)
                               - r).max()),
                  5e-5 + 1e-4 * float(np.abs(r).max()))
    return out


def test_golden_sgd_steps_match_jax(golden):
    """SGD_STEPS optimizer steps on the fixture through the port's
    ``make_train_step`` and JAX's jitted ``make_train_step``: every step's
    loss, then the parameters and running statistics."""
    tr = trajectories(golden)
    (t_loss, t_mid, _), (j_loss, ref, _) = tr["port"], tr["jax"]
    for i in range(SGD_STEPS):
        np.testing.assert_allclose(t_loss[i], j_loss[i],
                                   atol=2e-5, rtol=1e-4, err_msg=f"step {i}")
    for k, r in ref.items():
        np.testing.assert_allclose(t_mid[k].numpy(), r.numpy(), atol=5e-5,
                                   rtol=1e-4, err_msg=k)


def test_golden_sgd_long_trajectory_within_twice_of_float64(golden):
    """At step LONG_STEPS the port's and JAX's f32 trajectories each lie
    within twice the other's distance from the port's float64 trajectory,
    plus the tolerances (module docstring): the loss, every parameter and
    every running statistic."""
    tr = trajectories(golden)
    assert tr["f64"][2]["pool1.bn3.running_mean"].dtype == torch.float64
    dists = spread_distances(tr["port"], tr["jax"], tr["f64"])
    assert set(dists) == {"loss", *tr["jax"][2]}
    for what, (d_t, d_j, tol) in dists.items():
        assert d_t <= 2.0 * d_j + tol, (what, d_t, d_j, tol)
        assert d_j <= 2.0 * d_t + tol, (what, d_t, d_j, tol)
