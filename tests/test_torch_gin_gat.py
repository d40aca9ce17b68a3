"""PyTorch port, GIN/GAT slice: the convolutions, the activations, every
branch of the stage-1 adjacencies, and the GIN model (eval logits and one
train step) against the JAX package with transplanted parameters.

Tolerances: modules at atol 2e-6 (f32 sums in another order), 1e-5 where
a stage-1 aggregation over 128*M block columns or K slots feeds them, 1e-4
on B7's branch (its JAX suite tolerance, tests/test_bsr.py); the whole
model at atol 2e-5 / rtol 1e-4 (logits and loss, tests/test_golden.py),
running statistics at atol 1e-5 / rtol 1e-4, gradients at rtol 2e-4 /
atol 2e-4 (tests/test_torch_train.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cgcnet_tpu.ops.pallas.assign_head as ah
import cgcnet_tpu.ops.pallas.bsr_kernel as bk
from cgcnet_tpu.config import ModelConfig as JaxModelConfig
from cgcnet_tpu.nn import adjacency as jadj
from cgcnet_tpu.nn import layers as jlayers
from cgcnet_tpu.nn import model as jmodel
from cgcnet_tpu_torch.config import ModelConfig
from cgcnet_tpu_torch.nn import adjacency as tadj
from cgcnet_tpu_torch.nn import layers as tlayers
from cgcnet_tpu_torch.nn import model as tmodel
from cgcnet_tpu_torch.ops import assign_head as tah
from cgcnet_tpu_torch.ops import bsr as tbsr
from cgcnet_tpu_torch.train.checkpoint import state_dict_from_flax

from torch_port_util import example_batch, jax_graph, random_tree, torch_graph

# small canonical-shaped model at capacity 256: 51 then 5 clusters
SMALL = dict(hidden_dim=8, embedding_dim=8, assign_hidden_dim=8,
             max_num_nodes=512, drop_out=0.0)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


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
    ah.set_interpret(True)
    yield
    bk.set_interpret(False)
    ah.set_interpret(False)


@pytest.fixture(scope="module")
def batch():
    return dict(example_batch(batch=2, cap=256), y=np.array([0, 2], np.int32))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _np(t):
    return t.detach().numpy()


def _load(module, variables):
    module.load_state_dict(state_dict_from_flax(variables), strict=True)
    return module.eval()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["relu", "elu", "leakyrelu"])
def test_activation_matches_jax(name):
    x = np.linspace(-3, 3, 101, dtype=np.float32)
    np.testing.assert_allclose(
        _np(tlayers.activation(name)(_t(x))),
        np.asarray(jlayers.activation(name)(jnp.asarray(x))), atol=1e-7)


def _dense_case(seed, b=2, n=96, fin=18):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, fin)).astype(np.float32)
    adj = (rng.uniform(size=(b, n, n)) < 0.08).astype(np.float32)
    adj[0, 5] = 0.0  # a row without support
    mask = (np.arange(n)[None] < np.array([[80], [96]])).astype(np.float32)
    return x, adj, mask


@pytest.mark.parametrize("act", ["relu", "elu"])
def test_gin_conv_matches_jax(act):
    """GINConv (mlp_0, act, mlp_1, mask) on a dense adjacency and with a
    precomputed aggregation."""
    x, adj, mask = _dense_case(0)
    conv = jlayers.GINConv(12, act=act)
    ja = jadj.DenseAdj(jnp.asarray(adj))
    v = random_tree(lambda: conv.init(jax.random.key(0), jnp.asarray(x), ja,
                                      jnp.asarray(mask)), 3)
    port = _load(tlayers.GINConv(18, 12, act), v)
    ref = conv.apply(v, jnp.asarray(x), ja, jnp.asarray(mask))
    out = port(_t(x), tadj.DenseAdj(_t(adj)), _t(mask))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=2e-6)
    agg = _t(adj) @ _t(x)
    np.testing.assert_allclose(
        _np(port(_t(x), None, _t(mask), agg=agg)), np.asarray(ref), atol=2e-6)


def _stage1(batch, use_pallas="always", drop=(), weights=None):
    """The stage-1 adjacency of both packages for ``batch`` less ``drop``;
    ``weights``: the graphs carry these edge weights and the operator is
    the binary one (norm_adj off) that uses them."""
    b = {k: v for k, v in batch.items() if k not in drop}
    cfg = dict(SMALL, use_pallas=use_pallas, norm_adj=weights is None)
    jg, tg = jax_graph(b), torch_graph(b)
    if weights is not None:
        jg, tg = jg.with_weights(jnp.asarray(weights)), tg.with_weights(_t(weights))
    ja = jmodel.make_stage1_adj(jg, JaxModelConfig(**cfg), jnp.float32)
    ta = tmodel.make_stage1_adj(tg, ModelConfig(**cfg), torch.float32)
    return ja, ta


NO_META = ("blk_cols", "blk_mask", "blk_cols_t", "blk_mask_t")
NO_T = ("nbr_t", "nbr_t_mask", "blk_cols_t", "blk_mask_t")


@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("layout", ["factored", "ell", "dense"])
def test_gat_conv_matches_jax(batch, heads, layout):
    """GATConv: the ELL branch (k/v gathered once, softmax over self plus
    the K slots; slot mask from EllAdjFactored's off_mask or from EllAdj's
    weights) and the dense branch with support masking."""
    if layout == "dense":
        x, adj, mask = _dense_case(1)
        ja, ta = jadj.DenseAdj(jnp.asarray(adj)), tadj.DenseAdj(_t(adj))
    else:
        ja, ta = _stage1(batch, drop=NO_T if layout == "ell" else ())
        x = batch["x"]
        mask = (np.arange(x.shape[1])[None] < batch["n_nodes"][:, None])
        mask = mask.astype(np.float32)
    conv = jlayers.GATConv(12, heads=heads)
    v = random_tree(lambda: conv.init(jax.random.key(0), jnp.asarray(x), ja,
                                      jnp.asarray(mask)), 4)
    port = _load(tlayers.GATConv(x.shape[-1], 12, heads), v)
    rng = np.random.default_rng(heads)
    g = rng.normal(size=x.shape[:2] + (12,)).astype(np.float32)
    ref, vjp = jax.vjp(lambda xx: conv.apply(v, xx, ja, jnp.asarray(mask)),
                       jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(g))
    tx = _t(x, grad=True)
    out = port(tx, ta, _t(mask))
    torch.sum(out * _t(g)).backward()
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=2e-6)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx), atol=1e-5)


# ---------------------------------------------------------------------------
# the stage-1 adjacencies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("branch", ["blocks", "on_the_fly", "gather", "ell",
                                    "ell_weighted"])
def test_stage1_adjacency_branches_match_jax(batch, branch):
    """Each matvec branch of EllAdjFactored in the JAX package's order —
    precomputed blocks (B1 + B2), blocks built on the fly (B7), the factored
    gather — and EllAdj (no transpose tables) with renorm_ell weights or the
    graph's own edge weights (``CellGraph.with_weights``): A @ x and its
    backward, rowsum and quadform."""
    drop = NO_T if branch.startswith("ell") else ()
    weights = None
    if branch == "ell_weighted":
        rng = np.random.default_rng(8)
        weights = rng.uniform(0.5, 1.5, batch["nbr"].shape).astype(np.float32)
    ja, ta = _stage1(batch, "never" if branch == "gather" else "always", drop,
                     weights)
    if branch == "on_the_fly":
        ja = dataclasses.replace(ja, vals=None, vals_t=None)
        ta = dataclasses.replace(ta, vals=None, vals_t=None)
    if branch.startswith("ell"):
        assert type(ta) is tadj.EllAdj
    else:
        assert ta.impl == ("gather" if branch == "gather" else "bsr")
    atol = 1e-4 if branch == "on_the_fly" else 1e-5
    rng = np.random.default_rng(7)
    x = rng.normal(size=batch["x"].shape[:2] + (40,)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    out, vjp = jax.vjp(ja.matvec, jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(g))
    tx = _t(x, grad=True)
    launched = tbsr.bsr_gather_sum.launches
    tout = ta.matvec(tx)
    torch.sum(tout * _t(g)).backward()
    assert tbsr.bsr_gather_sum.launches == launched  # the CPU launches nothing
    np.testing.assert_allclose(_np(tout), np.asarray(out), atol=atol)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx), atol=atol)
    np.testing.assert_allclose(_np(ta.rowsum()), np.asarray(ja.rowsum()), atol=1e-6)
    s = np.exp(rng.normal(size=x.shape[:2] + (12,)))
    s = (s / s.sum(-1, keepdims=True)).astype(np.float32)  # rows of an S
    np.testing.assert_allclose(_np(ta.quadform(_t(s))),
                               np.asarray(ja.quadform(jnp.asarray(s))), atol=atol)


# ---------------------------------------------------------------------------
# the GIN model
# ---------------------------------------------------------------------------

def _model_case(batch, seed=1, **over):
    jg = jax_graph(batch)
    kw = dict(SMALL, **over)
    net = jmodel.CGCNet(JaxModelConfig(use_pallas="never", **kw))
    variables = random_tree(
        lambda: net.init({"params": jax.random.key(0)}, jg, train=False), seed
    )
    port = tmodel.CGCNet(ModelConfig(**kw))
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jg, variables, port, kw


@pytest.fixture(scope="module")
def gin_case(batch):
    jg, variables, port, kw = _model_case(batch, gcn_name="GIN")
    launched = tah.assign_head_softmax.launches
    with torch.inference_mode():
        logits = port.eval()(torch_graph(batch)).numpy()
    assert tah.assign_head_softmax.launches == launched
    return jg, variables, port, kw, logits


@pytest.mark.parametrize("use_pallas", ["always", "never"])
def test_gin_logits_match_jax(gin_case, use_pallas):
    """GIN eval logits against JAX's Pallas path (interpret mode: B1, B2
    and B6) and its XLA path (gathers, unfused tail), every weight and BN
    statistic transplanted."""
    jg, variables, _, kw, logits = gin_case
    net = jmodel.CGCNet(JaxModelConfig(use_pallas=use_pallas, **kw))
    ref = np.asarray(jax.jit(lambda v, g: net.apply(v, g, train=False))(variables, jg))
    assert logits.shape == (2, 3) and np.isfinite(logits).all()
    np.testing.assert_allclose(logits, ref, atol=2e-5, rtol=1e-4)


def test_gin_train_step_matches_jax(gin_case, batch):
    """One GIN training-mode forward + backward (BN batch statistics, B6's
    backward through k3f and const to h3a): loss, logits, every parameter
    gradient and the updated running statistics against JAX
    ``value_and_grad`` on its Pallas path (interpret mode)."""
    jg, variables, _, kw, _ = gin_case
    port = tmodel.CGCNet(ModelConfig(**kw))
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    port.train()
    tg = torch_graph(batch)
    logits = port(tg)
    loss = tmodel.cross_entropy_loss(logits, tg.y)
    loss.backward()
    net = jmodel.CGCNet(JaxModelConfig(use_pallas="always", **kw))

    def loss_fn(params):
        out, mut = net.apply({**variables, "params": params}, jg, train=True,
                             mutable=["batch_stats"])
        return jmodel.cross_entropy_loss(out, jg.y), (out, mut["batch_stats"])

    (ref_loss, (ref_logits, ref_stats)), ref_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    np.testing.assert_allclose(_np(loss), float(ref_loss), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(logits), np.asarray(ref_logits),
                               atol=2e-5, rtol=1e-4)
    ref_grads = state_dict_from_flax({"params": ref_grads})
    grads = {k: _np(p.grad) for k, p in port.named_parameters()}
    assert set(ref_grads) == set(grads)
    for k, r in ref_grads.items():
        np.testing.assert_allclose(grads[k], r.numpy(), err_msg=k, **GRAD_TOL)
    ref_stats = state_dict_from_flax({"batch_stats": ref_stats})
    sd = port.state_dict()
    for k, r in ref_stats.items():
        np.testing.assert_allclose(_np(sd[k]), r.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=k)
