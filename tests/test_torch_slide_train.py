"""PyTorch port, whole-slide path, training and the pool-1 operators: the
mega path against the patch ``CGCNet`` (the port's, and JAX's in training),
``bsr_local_matmul`` and the fused pool aggregate against JAX (values and
VJPs), 5 ``train_slides`` steps against JAX, and the head dropout. See
tests/test_torch_slide_model.py for the setup, the tolerances and the
reference fault that the patch-model hold works around.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cgcnet_tpu.ops.pallas.assign_head as jah
import cgcnet_tpu.ops.pallas.bsr_kernel as bk
from cgcnet_tpu.config import ModelConfig as JaxModelConfig
from cgcnet_tpu.core.graph import CellGraph as JaxCellGraph
from cgcnet_tpu.ops import ell as jell
from cgcnet_tpu.parallel import mega_model as jmm
from cgcnet_tpu.parallel import mega_train as jmt
from cgcnet_tpu_torch.config import ModelConfig
from cgcnet_tpu_torch.core.graph import CellGraph
from cgcnet_tpu_torch.ops import ell as tell
from cgcnet_tpu_torch.parallel import mega_graph as tmg
from cgcnet_tpu_torch.parallel import mega_model as tmm
from cgcnet_tpu_torch.parallel import mega_train as tmt
from cgcnet_tpu_torch.train.checkpoint import state_dict_from_flax

from test_torch_slide_model import (
    GRAD_TOL,
    LOGIT_TOL,
    SMALL,
    _inputs,
    _models,
    _port_grads,
    strip_slide,
)


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


def test_mega_matches_patch_model():
    """The slide path over one shard == the patch CGCNet on the same graph
    as a batch of one: logits against the port's patch model, logits and
    every gradient in training against JAX's patch model (jitted; its
    gradient is right where the jitted mega path's is not, see above)."""
    from cgcnet_tpu.nn.model import CGCNet as JaxPatch

    cap, n_real = 512, 450
    x, nbr, mask = strip_slide(cap, n_real, seed=5)
    mcfg = dict(SMALL, max_num_nodes=640, use_pallas="never")
    jcfg, variables, tcfg, model = _models(mcfg, seed=2)
    part = tmg.partition_graph(nbr, mask, 1)
    inp = tmm.prepare_mega_inputs(x, part, "cpu", n_real=n_real)
    graph = CellGraph(
        x=torch.from_numpy(x)[None], nbr=torch.from_numpy(nbr)[None],
        nbr_mask=torch.from_numpy(mask)[None],
        n_nodes=torch.tensor([n_real], dtype=torch.int32),
    )
    with torch.no_grad():
        ref = model(graph)[0]
        out = tmm.mega_forward(model, tcfg, inp, train=False)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=3e-5, rtol=1e-4)

    jg = JaxCellGraph(x=jnp.asarray(x)[None], nbr=jnp.asarray(nbr)[None],
                      nbr_mask=jnp.asarray(mask)[None],
                      n_nodes=jnp.asarray([n_real], jnp.int32))

    def jloss(params):
        out, _ = JaxPatch(jcfg).apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jg,
            train=True, mutable=["batch_stats"])
        return -jax.nn.log_softmax(out[0])[1]

    j_loss, j_grads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    logits = tmm.mega_forward(model, tcfg, inp, train=True)
    t_loss = -torch.log_softmax(logits, -1)[1]
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss), float(j_loss), **LOGIT_TOL)
    t_grads = _port_grads(model)
    j_sd = state_dict_from_flax({"params": jax.device_get(j_grads)})
    for name, gj in j_sd.items():
        gt = t_grads.get(name)
        if gt is None:
            assert not gj.abs().any(), name
            continue
        np.testing.assert_allclose(gt.numpy(), gj.numpy(), **GRAD_TOL,
                                   err_msg=name)


def test_bsr_local_matmul_matches_jax():
    """Values and VJP (local rows and halo rows) of the per-shard block
    matmul in bf16, the slide path's dtype: B2 at F=40, B8 at F=512 (B8
    engages only at 2-byte activations)."""
    dt = "bfloat16"
    x, nbr, mask = strip_slide(2048, 2040, seed=6)
    _, jinp, tinp, tab = _inputs(x, nbr, mask, 2040, True)
    assert tab.win_base is not None and tab.win_base_t is not None
    rng = np.random.default_rng(7)
    ns, nc = 2048, tab.nc
    for f in (40, 512):
        h = rng.normal(size=(ns, f)).astype(np.float32)
        halo = rng.normal(size=(nc - ns, f)).astype(np.float32)
        g = rng.normal(size=(ns, f)).astype(np.float32)
        jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
        win = jnp.asarray(tab.win_base)
        win_t = jnp.asarray(tab.win_base_t)
        jfn = lambda hh, hl: jell.bsr_local_matmul(
            jinp.vals[None], jinp.blk_cols[None], win, jinp.vals_t[None],
            jinp.blk_cols_t[None], win_t, hh, hl)
        out_j, vjp = jax.vjp(jfn, jnp.asarray(h).astype(jdt),
                             jnp.asarray(halo).astype(jdt))
        dh_j, dhalo_j = vjp(jnp.asarray(g).astype(jdt))
        ht = torch.from_numpy(h).to(tdt).requires_grad_(True)
        hlt = torch.from_numpy(halo).to(tdt).requires_grad_(True)
        out_t = tell.bsr_local_matmul(
            tinp.vals, tinp.blk_cols[None], tinp.win_base, tinp.vals_t,
            tinp.blk_cols_t[None], tinp.win_base_t, ht, hlt,
            slots=tinp.slots[None], slots_t=tinp.slots_t[None])
        dh_t, dhalo_t = torch.autograd.grad(out_t, (ht, hlt),
                                            torch.from_numpy(g).to(tdt))
        for a, b in ((out_t, out_j), (dh_t, dh_j), (dhalo_t, dhalo_j)):
            a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
            np.testing.assert_allclose(a, b, atol=2 ** -7 * np.abs(b).max())


def test_pool_aggregate_matches_jax():
    """The fused pool aggregate (A @ S and both contractions in one
    Function, the transpose leg through B8 with acc) against JAX's
    ``_pool_aggregate`` and against the port's composable form, values and
    gradients (f32, c = 128 so the accumulator applies)."""
    from jax.sharding import PartitionSpec as P

    n, c, f = 2048, 128, 20
    x, nbr, mask = strip_slide(n, n, seed=8)
    mesh, jinp, tinp, _ = _inputs(x, nbr, mask, n, True)
    rng = np.random.default_rng(9)
    s = rng.normal(size=(n, c)).astype(np.float32)
    pe = rng.normal(size=(n, f)).astype(np.float32)
    cx = rng.normal(size=(c, f)).astype(np.float32)
    ca = rng.normal(size=(c, c)).astype(np.float32)
    jcfg = JaxModelConfig()

    def jfn(s_, pe_, inp):
        adj = jmm._ShardedAdj(inp, jcfg, "graph", dtype=jnp.float32)
        pa = adj.pool_aggregate_args()

        def loss(sp):
            xp, ap = jmm._pool_aggregate("graph", *pa, *sp)
            return jnp.sum(xp * cx) + jnp.sum(ap * ca), (xp, ap)

        return jax.value_and_grad(loss, has_aux=True)((s_, pe_))

    inp_specs = jax.tree.map(lambda _: P("graph"), jinp)
    (_, (xp_j, ap_j)), (ds_j, dpe_j) = jax.jit(jax.shard_map(
        jfn, mesh=mesh, in_specs=(P("graph"), P("graph"), inp_specs),
        out_specs=((P(), (P(), P())), (P("graph"), P("graph"))),
        check_vma=False))(jnp.asarray(s), jnp.asarray(pe), jinp)

    adj = tmm.ShardedAdj(tinp, ModelConfig())
    results = []
    for fused in (True, False):
        st = torch.from_numpy(s).requires_grad_(True)
        pt = torch.from_numpy(pe).requires_grad_(True)
        if fused:
            xp, ap = tmm.PoolAggregate.apply(
                adj.pool_aggregate_args(), adj.scale, adj.self_w,
                adj.pool_ratio, st, pt)
        else:
            xp, ap = tmm.ChunkedPoolContract.apply(st, pt, adj(st), n)
        loss = torch.sum(xp * torch.from_numpy(cx)) + torch.sum(
            ap * torch.from_numpy(ca))
        ds, dpe = torch.autograd.grad(loss, (st, pt))
        results.append((xp, ap, ds, dpe))
    for res in results:
        for a, b in zip(res, (xp_j, ap_j, ds_j, dpe_j)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.detach().numpy(), b, rtol=2e-4,
                                       atol=2e-4 * np.abs(b).max())


def test_train_slides_matches_jax():
    """5 Adam steps on one slide with dropout off: the same losses and the
    same parameters and running statistics after them (jk off, see the
    module docstring)."""
    x, nbr, mask = strip_slide(512, 480, seed=10)
    # jk off: the reference's jitted step is wrong for jk1/embed1 with jk on
    mcfg = dict(SMALL, max_num_nodes=640, jk=False)
    jcfg, variables, tcfg, model = _models(mcfg, seed=3)
    mesh, jinp, tinp, _ = _inputs(x, nbr, mask, 480, False)
    j_vars, j_losses = jmt.train_slides(jcfg, variables, [(jinp, 2)], mesh,
                                        lr=1e-3, epochs=5)
    model, t_losses = tmt.train_slides(model, tcfg, [(tinp, 2)], lr=1e-3,
                                       epochs=5)
    np.testing.assert_allclose(t_losses, j_losses, atol=1e-4, rtol=1e-4)
    j_sd = state_dict_from_flax(jax.device_get(j_vars))
    t_sd = model.state_dict()
    for name, v in j_sd.items():
        np.testing.assert_allclose(t_sd[name].numpy(), v.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_head_dropout_fires():
    """Training with drop_out > 0 and a generator masks the head: the logits
    move with the generator's seed and repeat with the same seed; without a
    generator (or in eval) no dropout applies."""
    x, nbr, mask = strip_slide(512, 500, seed=11)
    mcfg = dict(SMALL, max_num_nodes=640, drop_out=0.5)
    _, _, tcfg, model = _models(mcfg, seed=4)
    _, _, tinp, _ = _inputs(x, nbr, mask, 500, False)
    with torch.no_grad():
        run = lambda g: tmm.mega_forward(model, tcfg, tinp, train=True,
                                         generator=g).numpy()
        a = run(tmt.step_generator("cpu", 0, 0))
        b = run(tmt.step_generator("cpu", 0, 0))
        c = run(tmt.step_generator("cpu", 0, 1))
        none = run(None)
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)
    assert not np.allclose(a, none)
