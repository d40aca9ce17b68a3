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
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import unflatten_dict

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


def test_golden_sgd_steps_match_jax(golden):
    """SGD_STEPS optimizer steps on the fixture through the port's
    ``make_train_step`` and JAX's jitted ``make_train_step``: every step's
    loss, then the parameters and running statistics."""
    graph, variables, _, _, _ = golden
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
    state = create_train_state(
        Config(model=ModelConfig(**dataclasses.asdict(jcfg)),
               train=TrainConfig(**SGD)), "cpu")
    state.model.load_state_dict(state_dict_from_flax(variables), strict=True)
    step = make_train_step()
    tg = _graph(graph, y=LABELS)
    for i in range(SGD_STEPS):
        jstate, jm = jstep(jstate, jg)
        m = step(state, tg)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=2e-5, rtol=1e-4, err_msg=f"step {i}")
    ref = state_dict_from_flax({"params": jstate.params,
                                "batch_stats": jstate.batch_stats})
    sd = state.model.state_dict()
    for k, r in ref.items():
        np.testing.assert_allclose(sd[k].numpy(), r.numpy(), atol=5e-5,
                                   rtol=1e-4, err_msg=k)
