"""PyTorch port, training slice: each Function with a hand-written backward,
the training-mode modules, one train step of the whole model, five SGD
steps, and the optimizers, against the JAX package on the same inputs.

Tolerances: the custom VJPs at the JAX suite's own (assign tail atol 5e-5,
rtol 1e-4, tests/test_assign_head.py; BSR matmul atol 1e-4,
tests/test_bsr.py); modules at atol 2e-6 (f32 sums in another order); the
whole step as the golden test holds a model (logits and loss atol 2e-5,
rtol 1e-4; running statistics atol 1e-5, rtol 1e-4; tests/test_golden.py),
gradients at rtol 2e-4, atol 2e-4 (the JAX suite's fused-against-unfused
model-gradient tolerance, tests/test_assign_head.py, with atol tightened
from 5e-4 to what the port meets with room); optimizers at atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

import cgcnet_tpu.ops.pallas.assign_head as ah
import cgcnet_tpu.ops.pallas.bsr_kernel as bk
from cgcnet_tpu.config import Config as JaxConfig
from cgcnet_tpu.config import ModelConfig as JaxModelConfig
from cgcnet_tpu.config import TrainConfig as JaxTrainConfig
from cgcnet_tpu.nn import blocks as jblocks
from cgcnet_tpu.nn import layers as jlayers
from cgcnet_tpu.nn import model as jmodel
from cgcnet_tpu.ops import ell as jell
from cgcnet_tpu.train import loop as jloop
from cgcnet_tpu.train import optim as joptim
from cgcnet_tpu.train.state import TrainState as JaxTrainState
from cgcnet_tpu_torch.config import Config, ModelConfig, TrainConfig
from cgcnet_tpu_torch.nn import adjacency as tadj
from cgcnet_tpu_torch.nn import blocks as tblocks
from cgcnet_tpu_torch.nn import layers as tlayers
from cgcnet_tpu_torch.nn import model as tmodel
from cgcnet_tpu_torch.ops import assign_head as tah
from cgcnet_tpu_torch.ops.ell import bsr_matmul_precomp
from cgcnet_tpu_torch.train import optim as toptim
from cgcnet_tpu_torch.train.checkpoint import state_dict_from_flax
from cgcnet_tpu_torch.train.loop import make_train_step
from cgcnet_tpu_torch.train.state import create_train_state

from torch_port_util import (
    SMALL_MODEL,
    example_batch,
    jax_graph,
    random_tree,
    torch_graph,
)

GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on the same cores, and torch's default of one thread per core
    oversubscribes them."""
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
    return example_batch(batch=2, cap=1024)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# Functions with hand-written backward, against jax.vjp
# ---------------------------------------------------------------------------

def _tail_inputs(seed, b=2, n=256, c=204, f12=16):
    rng = np.random.default_rng(seed)
    n_nodes = np.array([n - 37, n // 2 + 5], np.int32)
    mask = (np.arange(n)[None] < n_nodes[:, None]).astype(np.float32)
    x12 = rng.normal(size=(b, n, f12)).astype(np.float32) * mask[..., None]
    p = rng.normal(size=(b, n, c)).astype(np.float32)  # padded rows too
    p[0, 5] = 0.0
    k12 = rng.normal(size=(f12, c)).astype(np.float32)
    k3 = (rng.normal(size=(c, c)) * 0.2).astype(np.float32)
    lin_bias = rng.normal(size=(c,)).astype(np.float32)
    bn_scale = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
    bn_bias = rng.normal(size=(c,)).astype(np.float32)
    ds = rng.normal(size=(b, n, c)).astype(np.float32)
    ds_t = rng.normal(size=(b, c, n)).astype(np.float32)
    return (x12, p, k12, k3, lin_bias, bn_scale, bn_bias), n_nodes, mask, ds, ds_t


def test_assign_tail_train_matches_jax():
    """AssignTailTrain (B3, tail algebra, B4; B5 backward): S, mean, var and
    all seven input gradients against ``assign_tail_train``'s custom VJP."""
    ins, n_nodes, mask, ds, ds_t = _tail_inputs(0)
    n = float(n_nodes.sum())
    (s, s_t, mean, var), vjp = jax.vjp(
        lambda *a: ah.assign_tail_train(*a, jnp.asarray(mask), jnp.asarray(n)),
        *[jnp.asarray(a) for a in ins],
    )
    ref_grads = vjp((jnp.asarray(ds), jnp.asarray(ds_t),
                     jnp.zeros_like(mean), jnp.zeros_like(var)))
    tins = [_t(a, grad=True) for a in ins]
    ts, tmean, tvar = tah.AssignTailTrain.apply(
        *tins, _t(n_nodes), torch.tensor(n), 1e-5
    )
    loss = torch.sum(ts * _t(ds)) + torch.sum(ts.transpose(1, 2) * _t(ds_t))
    loss.backward()
    tol = dict(atol=5e-5, rtol=1e-4)
    for out, ref in ((ts, s), (tmean, mean), (tvar, var)):
        np.testing.assert_allclose(_np(out), np.asarray(ref), **tol)
    assert not tmean.requires_grad and not tvar.requires_grad
    for t, ref in zip(tins, ref_grads):
        np.testing.assert_allclose(_np(t.grad), np.asarray(ref), **tol)
    assert not _np(tins[1].grad)[mask == 0].any()  # padded rows of dp


def test_assign_head_softmax_pre_backward_matches_jax():
    """Eval-mode head (B4) with ``_ahp_bwd``'s backward."""
    (x12, p, k12, k3, lin_bias, _, _), n_nodes, mask, ds, ds_t = _tail_inputs(1)
    k3f, const = k3 * 0.7, lin_bias
    ins = (x12, p, k12, k3f, const)
    (s, _), vjp = jax.vjp(
        lambda *a: ah.assign_head_softmax_pre(*a, jnp.asarray(mask)),
        *[jnp.asarray(a) for a in ins],
    )
    ref_grads = vjp((jnp.asarray(ds), jnp.asarray(ds_t)))
    tins = [_t(a, grad=True) for a in ins]
    ts = tah.AssignHeadSoftmaxPre.apply(*tins, _t(n_nodes))
    (torch.sum(ts * _t(ds)) + torch.sum(ts.transpose(1, 2) * _t(ds_t))).backward()
    np.testing.assert_allclose(_np(ts), np.asarray(s), atol=2e-6)
    for t, ref in zip(tins, ref_grads):
        np.testing.assert_allclose(_np(t.grad), np.asarray(ref),
                                   atol=5e-5, rtol=1e-4)


def test_bsr_matmul_precomp_matches_jax(batch):
    """Stage-1 adjacency of both packages (B1 forward and binary transpose
    blocks) and A @ x with its backward through the transpose blocks."""
    cfg = JaxModelConfig(use_pallas="always", **SMALL_MODEL)
    jadj = jmodel.make_stage1_adj(jax_graph(batch), cfg, jnp.float32)
    tcfg = ModelConfig(**SMALL_MODEL)
    with torch.no_grad():
        assert tmodel.make_stage1_adj(
            torch_graph(batch), tcfg, torch.float32).vals_t is None
    adj = tmodel.make_stage1_adj(torch_graph(batch), tcfg, torch.float32)
    np.testing.assert_array_equal(_np(adj.vals_t), np.asarray(jadj.vals_t))
    rng = np.random.default_rng(3)
    x = rng.normal(size=batch["x"].shape[:2] + (40,)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    out, vjp = jax.vjp(
        lambda xx: jell.bsr_matmul_precomp(
            jadj.vals, jadj.blk_cols, jadj.vals_t, jadj.blk_cols_t,
            jadj.scale, jadj.self_w, xx),
        jnp.asarray(x),
    )
    (dx,) = vjp(jnp.asarray(g))
    tx = _t(x, grad=True)
    tout = bsr_matmul_precomp(adj.vals, adj.blk_cols, adj.vals_t,
                              adj.blk_cols_t, adj.scale, adj.self_w, tx)
    torch.sum(tout * _t(g)).backward()
    np.testing.assert_allclose(_np(tout), np.asarray(out), atol=1e-4)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx), atol=1e-4)


def test_dual_l2norm_2d_zero_row_matches_jax():
    """A padded (all-zero) row: the gradient is finite and equals the JAX
    package's hand-written VJP (plain autograd of sqrt gives NaN there)."""
    rng = np.random.default_rng(4)
    cat = rng.normal(size=(2, 64, 16)).astype(np.float32)
    cat[0, 7] = 0.0
    cat[1, 3, :8] = 0.0  # one stream of a row
    g = rng.normal(size=cat.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda c: jblocks.dual_l2norm_2d(c, 8), jnp.asarray(cat))
    (ref,) = vjp(jnp.asarray(g))
    tc = _t(cat, grad=True)
    tout = tblocks.dual_l2norm_2d(tc, 8)
    torch.sum(tout * _t(g)).backward()
    assert np.isfinite(_np(tc.grad)).all()
    np.testing.assert_allclose(_np(tout), np.asarray(out), atol=2e-6)
    np.testing.assert_allclose(_np(tc.grad), np.asarray(ref), rtol=1e-6, atol=2e-6)


def test_contract_dual_pair_backward_matches_jax():
    """DiffPool contractions: autograd through the S^T view gives
    ``_cdp_bwd``'s ds = [x | A S] @ [ct_x | ct_adj]^T."""
    rng = np.random.default_rng(5)
    b, n, c, f = 2, 96, 20, 8
    x = rng.normal(size=(b, n, f)).astype(np.float32)
    s = rng.uniform(size=(b, n, c)).astype(np.float32)
    a = (rng.uniform(size=(b, n, n)) < 0.1).astype(np.float32)
    gx = rng.normal(size=(b, c, f)).astype(np.float32)
    ga = rng.normal(size=(b, c, c)).astype(np.float32)
    from cgcnet_tpu.nn.adjacency import DenseAdj as JaxDense

    def jfn(xx, ss):
        return jblocks.diff_pool_from_s(xx, JaxDense(jnp.asarray(a)), ss,
                                        jnp.swapaxes(ss, 1, 2))

    (ox, oa), vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(s))
    rx, rs = vjp((jnp.asarray(gx), jnp.asarray(ga)))
    tx, ts = _t(x, grad=True), _t(s, grad=True)
    px, pa = tblocks.diff_pool_from_s(tx, tadj.DenseAdj(_t(a)), ts, ts.transpose(1, 2))
    (torch.sum(px * _t(gx)) + torch.sum(pa * _t(ga))).backward()
    for out, ref in ((px, ox), (pa, oa), (tx.grad, rx), (ts.grad, rs)):
        np.testing.assert_allclose(_np(out), np.asarray(ref), atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# training-mode modules
# ---------------------------------------------------------------------------

def _running(tree):
    return {k: np.asarray(v) for k, v in state_dict_from_flax(
        {"batch_stats": tree}).items()}


@pytest.mark.parametrize("masked", [True, False])
def test_batchnorm_training_matches_jax(masked):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 50, 12)).astype(np.float32) + 0.5
    mask = (np.arange(50)[None] < np.array([[41], [50]])).astype(np.float32)
    bn = jlayers.TorchBatchNorm(12)
    m = jnp.asarray(mask) if masked else None
    v = random_tree(lambda: bn.init(jax.random.key(0), jnp.asarray(x), False, m), 7)
    ref, mut = bn.apply(v, jnp.asarray(x), False, m, mutable=["batch_stats"])
    port = tlayers.TorchBatchNorm(12)
    port.load_state_dict(state_dict_from_flax(v))
    out = port.train()(_t(x), _t(mask) if masked else None)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=2e-6)
    for k, r in _running(mut["batch_stats"]).items():
        np.testing.assert_allclose(_np(port.state_dict()[k]), r, atol=2e-6)


class _JaxDual(fnn.Module):
    """An (embed, pool) block pair of the JAX package, for the dual tail."""

    def setup(self):
        kw = dict(hidden_dim=8, input_dim=18, fold_tail=True)
        self.embed1 = jblocks.GNNBlock(embedding_dim=8, use_lin=False, **kw)
        self.pool1 = jblocks.GNNBlock(embedding_dim=12, use_lin=True, **kw)

    def __call__(self, cat, mask):
        return jblocks._dual_tail(self.embed1, self.pool1, 2, cat, mask,
                                  train=True)


@pytest.mark.parametrize("use_mask", [True, False])
def test_dual_tail_train_matches_jax(use_mask):
    """One two-pass moments computation over the concatenated channels;
    each block's bn2 gets its half as the running update."""
    rng = np.random.default_rng(8)
    cat = rng.normal(size=(2, 128, 16)).astype(np.float32)
    mask = (np.arange(128)[None] < np.array([[90], [128]])).astype(np.float32)
    m = jnp.asarray(mask) if use_mask else None
    pair = _JaxDual()
    v = random_tree(lambda: pair.init(jax.random.key(0), jnp.asarray(cat), m), 9)
    ref, mut = pair.apply(v, jnp.asarray(cat), m, mutable=["batch_stats"])
    sd = state_dict_from_flax(v)
    embed = tblocks.GNNBlock(18, 8, 8, use_lin=False)
    pool = tblocks.GNNBlock(18, 8, 12, use_lin=True)
    for name, blk in (("embed1.", embed), ("pool1.", pool)):
        blk.load_state_dict({k[len(name):]: t for k, t in sd.items()
                             if k.startswith(name)}, strict=False)
        blk.train()
    out = tblocks._dual_tail(embed, pool, 2, _t(cat), _t(mask) if use_mask else None)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(_np(o), np.asarray(r), atol=2e-6)
    running = _running(mut["batch_stats"])
    for name, blk in (("embed1.", embed), ("pool1.", pool)):
        for k in ("bn2.running_mean", "bn2.running_var"):
            np.testing.assert_allclose(_np(blk.state_dict()[k]),
                                       running[name + k], atol=2e-6)


# ---------------------------------------------------------------------------
# the slice: one train step, five SGD steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_case(batch):
    """Transplanted weights and one training-mode forward + backward of the
    port (plain versions of B1-B5 on the CPU)."""
    b = dict(batch, y=np.array([0, 2], np.int32))
    jg = jax_graph(b)
    net = jmodel.CGCNet(JaxModelConfig(use_pallas="never", **SMALL_MODEL))
    variables = random_tree(
        lambda: net.init({"params": jax.random.key(0)}, jg, train=False), 1
    )
    port = tmodel.CGCNet(ModelConfig(**SMALL_MODEL))
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    port.train()
    tg = torch_graph(b)
    logits = port(tg)
    loss = tmodel.cross_entropy_loss(logits, tg.y)
    loss.backward()
    grads = {k: _np(p.grad) for k, p in port.named_parameters()}
    stats = {k: _np(t) for k, t in port.state_dict().items() if "running" in k}
    return b, jg, variables, (_np(loss), _np(logits), grads, stats)


@pytest.mark.parametrize("use_pallas", ["always", "never"])
def test_train_step_matches_jax(step_case, use_pallas):
    """Loss, logits, every parameter gradient and the updated running
    statistics against JAX ``value_and_grad(..., train=True,
    mutable=["batch_stats"])``, on its Pallas path (interpret mode: B1-B5)
    and its XLA path (unfused tail, two-pass variance)."""
    _, jg, variables, (loss, logits, grads, stats) = step_case
    net = jmodel.CGCNet(JaxModelConfig(use_pallas=use_pallas, **SMALL_MODEL))

    def loss_fn(params):
        out, mut = net.apply(
            {**variables, "params": params}, jg, train=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.key(1)},
        )
        return jmodel.cross_entropy_loss(out, jg.y), (out, mut["batch_stats"])

    (ref_loss, (ref_logits, ref_stats)), ref_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True)
    )(variables["params"])
    np.testing.assert_allclose(loss, float(ref_loss), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(logits, np.asarray(ref_logits), atol=2e-5, rtol=1e-4)
    ref_grads = state_dict_from_flax({"params": ref_grads})
    assert set(ref_grads) == set(grads)
    for k, r in ref_grads.items():
        np.testing.assert_allclose(grads[k], r.numpy(), err_msg=k, **GRAD_TOL)
    ref_stats = _running(ref_stats)
    assert set(ref_stats) == set(stats)
    for k, r in ref_stats.items():
        np.testing.assert_allclose(stats[k], r, atol=1e-5, rtol=1e-4, err_msg=k)


def test_sgd_five_steps_match_jax(step_case):
    """Five SGD steps (lr 1e-3, momentum 0.9, weight decay 1e-4) through
    the port's ``make_train_step`` and JAX's jitted ``make_train_step`` on
    its XLA path: the losses and the final parameters and running
    statistics. SGD is linear in the gradients, so f32 noise stays f32
    noise — unless a max readout's near-tie flips, which larger steps make
    likely (then both trajectories are right and differ by O(lr)). The
    parameters are held at atol 5e-5 after five chained steps."""
    b, jg, variables, _ = step_case
    over = ["train.optim=sgd", "train.lr=1e-3", "train.weight_decay=1e-4",
            "train.momentum=0.9"] + [f"model.{k}={v}" for k, v in SMALL_MODEL.items()]
    jcfg = JaxConfig().apply_overrides(over + ["model.use_pallas=never"])
    net = jmodel.CGCNet(jcfg.model)
    tx = joptim.make_optimizer(jcfg.train, steps_per_epoch=100)
    jstate = JaxTrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        step=jnp.zeros((), jnp.int32),
        rng=jax.random.key_data(jax.random.key(0)),
    )
    jstep = jax.jit(lambda s, g: jloop.make_train_step(net)(s, g, tx))
    state = create_train_state(Config().apply_overrides(over), "cpu")
    state.model.load_state_dict(state_dict_from_flax(variables), strict=True)
    step = make_train_step()
    tg = torch_graph(b)
    for i in range(5):
        jstate, jm = jstep(jstate, jg)
        m = step(state, tg)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=2e-5, rtol=1e-4, err_msg=f"step {i}")
        assert int(m["edges"]) == int(jm["edges"])
    assert state.step == int(jstate.step) == 5
    ref = state_dict_from_flax({"params": jstate.params,
                                "batch_stats": jstate.batch_stats})
    sd = state.model.state_dict()
    for k, r in ref.items():
        np.testing.assert_allclose(_np(sd[k]), r.numpy(), atol=5e-5, rtol=1e-4,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# optimizers and the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adam", "rmsprop", "sgd"])
def test_optimizer_and_steplr_match_jax(name):
    """The same fixed gradient sequence into both ``make_optimizer``s over
    three epochs of two steps, StepLR halving the rate each epoch."""
    rng = np.random.default_rng(10)
    kw = dict(optim=name, lr=0.01, weight_decay=1e-2, momentum=0.9,
              step_size=1, gamma=0.5)
    w0 = {"w": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    tx = joptim.make_optimizer(JaxTrainConfig(**kw), steps_per_epoch=2)
    params = {k: jnp.asarray(v) for k, v in w0.items()}
    opt_state = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in w0.items()}
    opt = toptim.make_optimizer(TrainConfig(**kw), list(tparams.values()))
    sched = toptim.make_scheduler(TrainConfig(**kw), opt)
    for step in range(6):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in w0.items()}
        updates, opt_state = tx.update(
            {k: jnp.asarray(g) for k, g in grads.items()}, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        if step % 2 == 1:
            sched.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(_np(p), np.asarray(params[k]), atol=1e-6,
                                       err_msg=f"{name} {k} step {step}")
    assert sched.get_last_lr() == [0.01 * 0.5 ** 3]
