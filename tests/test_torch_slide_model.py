"""PyTorch port, whole-slide path, model: ``mega_forward``
(``parallel/mega_model.py``) against the JAX package's on the same slide
with transplanted parameters (JAX on a one-device mesh, Pallas in
interpret mode) — eval logits, training loss, gradients and running
statistics — on the gather path with and without ``halo_overlap`` and the
block path at f32 with the fused, chunked and unfused tails and
``remat``/``remat_stage1`` (``CASES``; the port-only variants of a case
are held by their own test against its base case's JAX result, computed
once per worker).
The other branches (GIN, GAT, ``norm_adj``/``jk`` off, bf16 with B8) are in
tests/test_torch_slide_variants.py and tests/test_torch_slide_bf16.py,
training and the pool-1 operators in tests/test_torch_slide_train.py; they
use this file's helpers.

The JAX side is one jitted program (eval forward and training gradient),
one trace and one compile per case.

A fault of the reference, pinned here: with ``jk`` on, the JIT-compiled
gradient of JAX's ``mega_forward`` on XLA:CPU is wrong for the stage-1 JK
and embed1 parameters (``jk1.*``, ``embed1.*``): its own central
differences (step 1e-2) give jk1.att.weight[0, :4] = (0.00069, 0.01253,
0.00346, -0.01043), its eager gradient (``jax.disable_jit``) (0.00040,
0.01137, 0.00304, -0.01027) — the port's, to 1e-6 — and its jitted
gradient (0.00113, 0.00781, -0.00101, -0.01112); with ``jk`` off the
jitted gradient is right. The eager JAX gradient takes ~6 min per case,
so ``test_mega_forward_matches_jax`` holds those parameters' gradients
against JAX's patch ``CGCNet`` (the same function of the parameters, whose
jitted gradient is right) in ``test_mega_matches_patch_model``, and every
other gradient against the mega path (ROADMAP.md §3).

Tolerances: f32 logits and loss atol 2e-5, rtol 1e-4 (the golden
tolerance of tests/test_golden.py); gradients rtol 2e-4 and atol 2e-4 of
each tensor's max plus GRAD_FLOOR of the model's largest; running
statistics atol 2e-5, rtol 1e-4; GAT's training loss and gradients as
stated at GAT_TRAIN_TOL. bf16 is held in tests/test_torch_slide_variants.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cgcnet_tpu.ops.pallas.assign_head as jah
import cgcnet_tpu.ops.pallas.bsr_kernel as bk
from cgcnet_tpu.config import ModelConfig as JaxModelConfig
from cgcnet_tpu.core.graph import CellGraph as JaxCellGraph
from cgcnet_tpu.nn.model import CGCNet as JaxCGCNet
from cgcnet_tpu.ops.knn import radius_knn_np
from cgcnet_tpu.parallel import mega_graph as jmg
from cgcnet_tpu.parallel import mega_model as jmm
from cgcnet_tpu.parallel.mesh import make_mesh
from cgcnet_tpu_torch.config import ModelConfig
from cgcnet_tpu_torch.nn.model import CGCNet
from cgcnet_tpu_torch.parallel import mega_graph as tmg
from cgcnet_tpu_torch.parallel import mega_model as tmm
from cgcnet_tpu_torch.train.checkpoint import state_dict_from_flax

from torch_port_util import random_tree

LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
# gradients of the mega path: rtol 2e-4 and atol 2e-4 of each tensor's max
# (tests/test_pool_aggregate.py's form: f32 noise scales with a tensor's
# largest terms, not with each entry — the binary adjacency of norm_adj off
# makes gradients of ~120 beside entries of ~0.4), plus 1e-5 of the model's
# largest gradient for the gradients that are zero in theory (the JK and GAT
# attention biases: rounding noise on both sides; chip_smoke.py's floor)
GRAD_FLOOR = 1e-5
# GAT in training: the reference's own jitted and eager forwards of this
# case part by 1.5e-4 on logits of 7-10 (f32 attention softmax over BN'd
# batch statistics); the loss is held at 2x that spread. Its gradients:
# the jitted and eager JAX ones part by up to 6.3e-3 of a tensor's max
# (plus the floor), the port's lie within 3.9e-3 of the eager ones, and
# the k biases' gradients are zero in theory (softmax shift invariance);
# each tensor is held within GAT_GRAD_REL of its max against the jitted
# JAX gradient
GAT_TRAIN_TOL = dict(atol=3e-4, rtol=0.0)
GAT_GRAD_REL = 1e-2


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


def strip_slide(cap, n_real, seed=0, k=6, feat=18):
    """A narrow strip of n_real nuclei sorted along x, padded to ``cap``
    rows (pad rows self-pointing, unmasked): (x, nbr, mask)."""
    rng = np.random.default_rng(seed)
    xs = np.sort(rng.uniform(0, n_real * 3.0, n_real))
    pos = np.stack([xs, rng.uniform(0, 80, n_real)], -1).astype(np.float32)
    nbr, mask = radius_knn_np(pos, 100.0, k)
    nbr_p = np.tile(np.arange(cap, dtype=np.int32)[:, None], (1, k))
    mask_p = np.zeros((cap, k), np.float32)
    nbr_p[:n_real], mask_p[:n_real] = nbr, mask
    x = np.zeros((cap, feat), np.float32)
    x[:n_real] = rng.normal(size=(n_real, feat)).astype(np.float32)
    return x, nbr_p, mask_p


def _models(mcfg: dict, seed: int):
    """(JAX config, JAX variables, port config, port CGCNet) with the same
    random parameters and running statistics."""
    jcfg = JaxModelConfig(**mcfg)
    tcfg = ModelConfig(**mcfg)
    k = 6
    g = JaxCellGraph(
        x=jnp.zeros((1, 256, jcfg.input_dim)),
        nbr=jnp.zeros((1, 256, k), jnp.int32), nbr_mask=jnp.zeros((1, 256, k)),
        n_nodes=jnp.asarray([256], jnp.int32),
    )
    variables = random_tree(
        lambda: JaxCGCNet(jcfg).init({"params": jax.random.key(0)}, g,
                                     train=False), seed)
    model = CGCNet(tcfg)
    res = model.load_state_dict(state_dict_from_flax(variables), strict=False)
    assert not res.unexpected_keys and not res.missing_keys, res
    return jcfg, variables, tcfg, model.eval()


def _inputs(x, nbr, mask, n_real, tables: bool):
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    part_j = jmg.partition_graph(nbr, mask, 1)
    part_t = tmg.partition_graph(nbr, mask, 1)
    tab_j = jmg.build_bsr_tables(part_j) if tables else None
    tab_t = tmg.build_bsr_tables(part_t) if tables else None
    assert (tab_j is None) == (not tables)
    jinp = jmm.prepare_mega_inputs(x, part_j, mesh, n_real=n_real, bsr=tab_j)
    tinp = tmm.prepare_mega_inputs(x, part_t, "cpu", n_real=n_real, bsr=tab_t)
    return mesh, jinp, tinp, tab_t


def _port_grads(model):
    return {name: p.grad for name, p in model.named_parameters()
            if p.grad is not None}


def _stats_sd(stats: dict) -> dict:
    out = {}
    for blk, bns in stats.items():
        for bn, st in bns.items():
            out[f"{blk}.{bn}.running_mean"] = st["mean"]
            out[f"{blk}.{bn}.running_var"] = st["var"]
    return out


def _jax_run(jcfg, variables, jinp, mesh, label, x_moved=(), **fwd) -> dict:
    """JAX's eval logits, training loss, gradients and running statistics
    (``j_*``), one jitted program of the weights and the inputs; with
    ``x_moved`` (features in ``jinp.x``'s layout) also the training loss
    of the same program on each (``j_loss_moved``)."""

    def both(v, inp):
        def jloss(params):
            logits, st = jmm.mega_forward(
                {"params": params, "batch_stats": v["batch_stats"]}, jcfg,
                inp, mesh, train=True, return_stats=True, **fwd)
            return -jax.nn.log_softmax(logits)[label], st

        ev = jmm.mega_forward(v, jcfg, inp, mesh, train=False, **fwd)
        return ev, jax.value_and_grad(jloss, has_aux=True)(v["params"])

    program = jax.jit(both)
    j_eval, ((j_loss, j_stats), j_grads) = program(variables, jinp)
    out = dict(
        j_eval=np.asarray(j_eval), j_loss=float(j_loss),
        j_grads=state_dict_from_flax({"params": jax.device_get(j_grads)}),
        j_stats=state_dict_from_flax({"batch_stats": jax.device_get(j_stats)}),
    )
    if x_moved:
        out["j_loss_moved"] = [
            float(program(variables, jinp.replace(
                x=jax.device_put(x, jinp.x.sharding)))[1][0][0])
            for x in x_moved]
    return out


def _port_run(model, tcfg, tinp, label, **fwd) -> dict:
    """The port's eval logits, training loss, gradients and running
    statistics (``t_*``)."""
    with torch.no_grad():
        t_eval = tmm.mega_forward(model, tcfg, tinp, train=False, **fwd)
    logits, t_stats = tmm.mega_forward(model, tcfg, tinp, train=True,
                                       return_stats=True, **fwd)
    t_loss = -torch.log_softmax(logits, -1)[label]
    t_loss.backward()
    return dict(t_eval=t_eval.numpy(), t_loss=float(t_loss.detach()),
                t_grads=_port_grads(model), t_stats=_stats_sd(t_stats))


def _run_both(mcfg, x, nbr, mask, n_real, tables, seed=1, label=1, **fwd):
    """Eval logits, training loss, gradients and running statistics of the
    port (``t_*``) and of JAX (``j_*``), with the port's model, config and
    inputs (``model``, ``tcfg``, ``tinp``, ``tables``)."""
    jcfg, variables, tcfg, model = _models(mcfg, seed)
    mesh, jinp, tinp, tab = _inputs(x, nbr, mask, n_real, tables)
    out = dict(tables=tab, tinp=tinp, model=model, tcfg=tcfg, label=label)
    out.update(_jax_run(jcfg, variables, jinp, mesh, label, **fwd))
    out.update(_port_run(model, tcfg, tinp, label, **fwd))
    return out


def _port_variant(r, over: dict, **fwd) -> dict:
    """The port alone on ``r``'s slide and weights with config overrides
    ``over`` (a fresh model; ``r``'s inputs)."""
    tcfg = dataclasses.replace(r["tcfg"], **over)
    model = CGCNet(tcfg)
    model.load_state_dict(r["model"].state_dict())
    return _port_run(model.eval(), tcfg, r["tinp"], r["label"], **fwd)


# the parameters whose jitted JAX mega-path gradient is wrong with jk on
MEGA_JIT_FAULT = ("jk1.", "embed1.")


def _hold(r, skip=(), loss_tol=LOGIT_TOL, grad_rel=None):
    """f32 logits, loss, gradients (but ``skip``'s) and running statistics
    of the port against JAX's."""
    np.testing.assert_allclose(r["t_eval"], r["j_eval"], **LOGIT_TOL)
    np.testing.assert_allclose(r["t_loss"], r["j_loss"], **loss_tol)
    assert set(r["t_grads"]) <= set(r["j_grads"])
    assert len(r["t_grads"]) > 0.9 * len(r["j_grads"])
    model_max = max(float(g.abs().max()) for g in r["j_grads"].values())
    rel = grad_rel or GRAD_TOL["atol"]
    for name, gj in r["j_grads"].items():
        if name.startswith(skip):
            continue
        gt = r["t_grads"].get(name)
        gj = gj.numpy()
        if gt is None:  # a parameter the port's autograd never reached
            assert not np.abs(gj).any(), name
            continue
        np.testing.assert_allclose(
            gt.float().numpy(), gj, rtol=GRAD_TOL["rtol"],
            atol=rel * np.abs(gj).max() + GRAD_FLOOR * model_max,
            err_msg=name)
    assert set(r["t_stats"]) == set(r["j_stats"])
    for name, sj in r["j_stats"].items():
        np.testing.assert_allclose(r["t_stats"][name].float().numpy(),
                                   sj.numpy(), atol=2e-5, rtol=1e-4,
                                   err_msg=name)


SMALL = dict(input_dim=18, hidden_dim=8, embedding_dim=8, assign_hidden_dim=8,
             max_num_nodes=1280, assign_ratio=0.1, drop_out=0.0)


# case: (config overrides, mega_forward kwargs, block tables, port-only
# variants). A variant changes no function — the aggregation split under
# halo_overlap, the chunked capacity tail, the unfused tail, the recompute
# — so it is held against the same JAX result (JAX's own suite holds each
# equal to its base: tests/test_mega_model.py, tests/test_assign_head.py)
CASES = {
    "gather": ({}, {}, False, {"halo_overlap": ({}, {"halo_overlap": True})}),
    "bsr_f32": ({}, {}, True, {
        "chunked": ({"assign_tail_chunk": 256}, {}),  # 640 rows: 256+256+128
        "unfused": ({"fused_assign_softmax": "never"}, {}),
        "remat": ({}, {"remat": True, "remat_stage1": True}),
    }),
    # the conv and tail options are independent of the stage-1 operator:
    # held on the gather path, whose JAX side compiles no Pallas kernel
    "gin": ({"gcn_name": "GIN"}, {}, False, {}),
    "gat": ({"gcn_name": "GAT", "gat_heads": 2}, {}, False, {}),
    "plain_adj_no_jk": ({"norm_adj": False, "jk": False}, {}, False, {}),
}


# the base cases' results (JAX and port), once per worker: the variant
# tests after them reuse them
_BASE: dict = {}


def _kw(case, mcfg):
    gat = case == "gat"
    return dict(skip=MEGA_JIT_FAULT if mcfg.get("jk", True) else (),
                loss_tol=GAT_TRAIN_TOL if gat else LOGIT_TOL,
                grad_rel=GAT_GRAD_REL if gat else None)


def base_result(case):
    """The port's and JAX's mega_forward on one branch (``CASES``)."""
    if case not in _BASE:
        over, fwd, tables, _ = CASES[case]
        mcfg = dict(SMALL, **over)
        x, nbr, mask = strip_slide(640, 600, seed=3)
        _BASE[case] = (_run_both(mcfg, x, nbr, mask, 600, tables, **fwd),
                       mcfg)
    return _BASE[case]


def check_case(case):
    """The port's mega_forward against JAX's on one branch (``CASES``):
    eval logits, train loss, gradients and running statistics."""
    r, mcfg = base_result(case)
    _hold(r, **_kw(case, mcfg))
    if CASES[case][2]:
        assert r["tinp"].vals.dtype == torch.int8


def check_variants(case):
    """Each port-only variant of ``case`` against the same JAX result."""
    r, mcfg = base_result(case)
    for v_over, v_fwd in CASES[case][3].values():
        rv = _port_variant(r, v_over, **CASES[case][1], **v_fwd)
        rv.update({k: r[k] for k in ("j_eval", "j_loss", "j_grads",
                                     "j_stats")})
        _hold(rv, **_kw(case, mcfg))


@pytest.mark.parametrize("case", ["gather", "bsr_f32"])
def test_mega_forward_matches_jax(case):
    check_case(case)


@pytest.mark.parametrize("case", ["gather", "bsr_f32"])
def test_port_variants_match_jax_base(case):
    check_variants(case)
