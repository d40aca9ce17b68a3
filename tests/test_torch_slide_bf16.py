"""PyTorch port, whole-slide path in bf16 with B8 engaged: ``mega_forward``
against JAX's on a slide whose band windows build (2048 rows), d1 = 520
clusters (S lane-padded to 640 in training, B8 on the A @ S leg and on the
fused pool aggregate's transpose leg with its row accumulator). See
tests/test_torch_slide_model.py for the setup and the reference fault.

bf16: both packages round bf16 at other places (XLA's bf16 einsums round
after each product where the port's f32-accumulating ops round once), so
the two bf16 results are held by accuracy, not bit for bit: the port's bf16
logits, loss, gradients and running statistics must lie within twice the
JAX bf16 result's distance from the f32 result of the same slide and
weights (the port's f32 run, which the block-path cases of
test_torch_slide_model.py hold against JAX's at the f32 tolerances), plus
the f32 tolerances and, for the gradients that are zero in theory (the
JK attention biases), BF16_FLOOR of the model's largest; each gradient
tensor by its max abs. The results are computed once per worker
(``bf16_result``); each test holds one part of them.
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
from cgcnet_tpu.nn.model import CGCNet as JaxPatch
from cgcnet_tpu_torch.train.checkpoint import state_dict_from_flax

from test_torch_slide_model import (
    GRAD_FLOOR,
    GRAD_TOL,
    LOGIT_TOL,
    MEGA_JIT_FAULT,
    SMALL,
    _models,
    _port_variant,
    _run_both,
    strip_slide,
)

# a gradient that is zero in theory (the JK attention biases: a shared
# score offset, ``zero_in_theory``) is rounding noise whose size depends on
# where each framework rounds; bf16's noise floor for those: half a bf16
# step of the model's largest gradient (chip_smoke.py's BF16_FLOOR)
BF16_FLOOR = 2.0 ** -9


def zero_in_theory(name: str) -> bool:
    """The JK attention biases: one offset shared by every layer's score,
    which the attention softmax cancels."""
    return name.startswith("jk") and name.endswith(".att.bias")


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


_RESULT: dict = {}
# the slide (rows, real nuclei, seed) and the bf16 configuration
SLIDE = (2048, 2000, 4)
BF16_CFG = dict(SMALL, max_num_nodes=5200, compute_dtype="bfloat16")


def bf16_result():
    """The port's and JAX's bf16 results on a slide whose band windows
    build (2048 rows per shard), d1 = 520 clusters (S lane-padded to 640 in
    training), the port's f32 result on the same weights and inputs, and
    the row accumulator of each B8 call (``acc`` given or not) — computed
    once per worker."""
    from cgcnet_tpu_torch.ops import bsr as tbsr

    if _RESULT:
        return _RESULT
    x, nbr, mask = strip_slide(*SLIDE)
    launches = []
    orig = tbsr.bsr_matmul_banded_plain

    def counting(*a, **kw):
        acc = kw.get("acc", a[7] if len(a) > 7 else None)
        launches.append(acc is not None)
        return orig(*a, **kw)

    tbsr.bsr_matmul_banded_plain = counting
    try:
        r16 = _run_both(BF16_CFG, x, nbr, mask, SLIDE[1], True)
    finally:
        tbsr.bsr_matmul_banded_plain = orig
    # the f32 reference: the port's f32 result on the same weights and
    # inputs (held against JAX's at the f32 tolerances by the block-path
    # cases of test_torch_slide_model.py)
    r32 = _port_variant(r16, {"compute_dtype": "float32"})
    _RESULT.update(r16=r16, r32=r32, launches=launches)
    return _RESULT


def no_worse(name, t16, j16, f32, tol):
    """The port's bf16 distance from the f32 result within twice JAX's,
    plus the f32 tolerance."""
    d_t = float(np.abs(np.asarray(t16, np.float32) - f32).max())
    d_j = float(np.abs(np.asarray(j16, np.float32) - f32).max())
    assert d_t <= 2.0 * d_j + tol, (name, d_t, d_j)


def test_bf16_banded_engages_b8():
    """The window tables build both ways, and B8 serves the eval A @ S leg,
    the training A @ S leg and the pool backward's transpose leg (the last
    with its row accumulator)."""
    res = bf16_result()
    assert res["r16"]["tables"].win_base is not None
    assert res["r16"]["tables"].win_base_t is not None
    assert res["launches"] == [False, False, True], res["launches"]


def test_mega_forward_bf16_banded_matches_jax():
    """bf16 eval logits, training loss and the running statistics after the
    training forward, held by accuracy against the same slide in f32
    (module docstring)."""
    r16, r32 = bf16_result()["r16"], bf16_result()["r32"]
    no_worse("logits", r16["t_eval"], r16["j_eval"], r32["t_eval"],
             LOGIT_TOL["atol"])
    no_worse("loss", r16["t_loss"], r16["j_loss"], r32["t_loss"],
             LOGIT_TOL["atol"])
    for name, s32 in r32["t_stats"].items():
        no_worse(name, r16["t_stats"][name].float().numpy(),
                 r16["j_stats"][name].numpy(), s32.numpy(), 2e-5)


def test_bf16_banded_gradients_match_jax():
    """Every gradient but the zero-in-theory ones (and MEGA_JIT_FAULT's),
    by accuracy, at the f32 gradient tolerance of each tensor's max."""
    r16, r32 = bf16_result()["r16"], bf16_result()["r32"]
    for name, g32 in r32["t_grads"].items():
        if name.startswith(MEGA_JIT_FAULT) or zero_in_theory(name):
            continue
        no_worse(name, r16["t_grads"][name].float().numpy(),
                 r16["j_grads"][name].numpy(), g32.numpy(),
                 GRAD_TOL["atol"] + GRAD_TOL["rtol"]
                 * float(g32.abs().max()))


def test_bf16_zero_in_theory_gradients_within_floor():
    """The JK attention biases' gradients (zero in theory, rounding noise):
    by accuracy with BF16_FLOOR of the model's largest gradient added."""
    r16, r32 = bf16_result()["r16"], bf16_result()["r32"]
    floor = BF16_FLOOR * max(float(g.abs().max())
                             for g in r32["t_grads"].values())
    names = [n for n in r32["t_grads"]
             if zero_in_theory(n) and not n.startswith(MEGA_JIT_FAULT)]
    assert names == ["jk2.att.bias", "jk3.att.bias"], names
    for name in names:
        g32 = r32["t_grads"][name]
        no_worse(name, r16["t_grads"][name].float().numpy(),
                 r16["j_grads"][name].numpy(), g32.numpy(),
                 GRAD_TOL["atol"] + GRAD_TOL["rtol"]
                 * float(g32.abs().max()) + floor)


def test_block_path_stage1_gradients_match_jax_patch_model():
    """The stage-1 JK and embed1 gradients (MEGA_JIT_FAULT's: the jitted
    JAX mega path's are wrong there, tests/test_torch_slide_model.py) of the
    block path — B2's int8 transpose legs carry them — in f32 (the port's
    f32 result on this slide, ``r32``) against JAX's patch CGCNet on the
    same graph as a batch of one with the same weights (jitted; its
    gradient is right where the mega path's is not) at the slide files'
    gradient rule; the zero-in-theory jk1.att.bias with their floor. (In
    bf16 the port's distance from f32 on these tensors reaches 2.4x JAX's
    patch CGCNet's, past the file's ``no_worse`` form, and the port's own
    patch path reaches 1.9x — the programs round bf16 in other places,
    scripts/stage1_bf16_distances.py — so it is not held in bf16.)"""
    r32 = bf16_result()["r32"]
    _, variables, _, _ = _models(BF16_CFG, 1)
    jcfg = JaxModelConfig(**dict(BF16_CFG, compute_dtype="float32",
                                 use_pallas="never"))
    x, nbr, mask = strip_slide(*SLIDE)
    graph = JaxCellGraph(x=jnp.asarray(x)[None], nbr=jnp.asarray(nbr)[None],
                         nbr_mask=jnp.asarray(mask)[None],
                         n_nodes=jnp.asarray([SLIDE[1]], jnp.int32))

    def jloss(params):
        out, _ = JaxPatch(jcfg).apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            graph, train=True, mutable=["batch_stats"])
        return -jax.nn.log_softmax(out[0])[bf16_result()["r16"]["label"]]

    j_grads = state_dict_from_flax({"params": jax.device_get(
        jax.jit(jax.grad(jloss))(variables["params"]))})
    model_max = max(float(g.abs().max()) for g in j_grads.values())
    names = [n for n in r32["t_grads"] if n.startswith(MEGA_JIT_FAULT)]
    assert any(n.startswith("jk1.") for n in names) \
        and any(n.startswith("embed1.") for n in names), names
    assert bf16_result()["r16"]["tinp"].vals.dtype == torch.int8
    for name in names:
        gj = j_grads[name].numpy()
        np.testing.assert_allclose(
            r32["t_grads"][name].numpy(), gj, rtol=GRAD_TOL["rtol"],
            atol=GRAD_TOL["atol"] * np.abs(gj).max() + GRAD_FLOOR * model_max,
            err_msg=name)
