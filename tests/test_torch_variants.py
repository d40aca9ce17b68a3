"""PyTorch port, the other model configurations of the GIN/GAT slice
against the JAX package with transplanted parameters: GAT (two heads),
SAGE with elu and with leakyrelu (B6 in place of B4), bn=False and the
unfolded tail (no fused head), SAGE with fused_assign_norm=never (B6)
against the default (B4), a batch whose BSR metadata was dropped (the
factored gather path) and one without transpose tables (EllAdj with
renorm_ell weights, autograd's scatter backward), and the checkpoint
transplant of GIN and GAT parameter trees.

Tolerances: logits and loss atol 2e-5 / rtol 1e-4 (tests/test_golden.py),
gradients rtol 2e-4 / atol 2e-4 (tests/test_torch_train.py); B6 against
B4 on one model atol 1e-5 (the same logits summed in another order: B4
folds the normalize into the head).
"""

import numpy as np
import pytest
import torch

import jax

import cgcnet_tpu.ops.pallas.assign_head as ah
import cgcnet_tpu.ops.pallas.bsr_kernel as bk
from cgcnet_tpu.config import ModelConfig as JaxModelConfig
from cgcnet_tpu.nn import model as jmodel
from cgcnet_tpu_torch.config import ModelConfig
from cgcnet_tpu_torch.nn import adjacency as tadj
from cgcnet_tpu_torch.nn import model as tmodel
from cgcnet_tpu_torch.ops import assign_head as tah
from cgcnet_tpu_torch.train.checkpoint import state_dict_from_flax

from torch_port_util import example_batch, jax_graph, random_tree, torch_graph

# capacity 256, 64 then 6 clusters: every width divides by two GAT heads
SMALL = dict(hidden_dim=8, embedding_dim=8, assign_hidden_dim=8,
             max_num_nodes=640, drop_out=0.0)
NO_META = ("blk_cols", "blk_mask", "blk_cols_t", "blk_mask_t")
NO_T = ("nbr_t", "nbr_t_mask", "blk_cols_t", "blk_mask_t")


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
    return dict(example_batch(batch=2, cap=256, seed=3),
                y=np.array([1, 0], np.int32))


def _case(batch, over, seed=1, drop=()):
    """(JAX graph, variables, port CGCNet, config kwargs) for ``batch``
    less the fields in ``drop``."""
    b = {k: v for k, v in batch.items() if k not in drop}
    jg = jax_graph(b)
    kw = dict(SMALL, **over)
    net = jmodel.CGCNet(JaxModelConfig(use_pallas="never", **kw))
    variables = random_tree(
        lambda: net.init({"params": jax.random.key(0)}, jg, train=False), seed
    )
    port = tmodel.CGCNet(ModelConfig(**kw))
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jg, variables, port, kw, torch_graph(b)


def _jax_logits(jg, variables, kw, use_pallas="always"):
    net = jmodel.CGCNet(JaxModelConfig(use_pallas=use_pallas, **kw))
    return np.asarray(jax.jit(lambda v, g: net.apply(v, g, train=False))(
        variables, jg))


@pytest.mark.parametrize("over,head", [
    ({"gcn_name": "GAT", "gat_heads": 2}, "B6"),
    ({"activation": "elu"}, "B6"),
    ({"activation": "leakyrelu"}, "B6"),
    ({"bn": False}, None),
    ({"fold_assign_tail": False}, None),
])
def test_variant_logits_match_jax(batch, monkeypatch, over, head):
    """Eval logits against JAX's Pallas path (interpret mode), with the
    assign head each configuration takes: B6 where the fused softmax runs
    without the SAGE+relu fold, none where the tail is not folded."""
    jg, variables, port, kw, tg = _case(batch, over)
    heads = []
    for key, name in (("B6", "assign_head_softmax_plain"),
                      ("B4", "assign_head_softmax_pre_plain")):
        def spy(*a, _orig=getattr(tah, name), _key=key):
            heads.append(_key)
            return _orig(*a)

        monkeypatch.setattr(tah, name, spy)
    launched = tah.assign_head_softmax.launches
    with torch.inference_mode():
        logits = port.eval()(tg).numpy()
    assert heads == ([head] if head else [])
    assert tah.assign_head_softmax.launches == launched  # the CPU launches nothing
    assert np.isfinite(logits).all()
    np.testing.assert_allclose(logits, _jax_logits(jg, variables, kw),
                               atol=2e-5, rtol=1e-4)


def test_b6_head_matches_b4_head(batch, monkeypatch):
    """SAGE with fused_assign_norm=never (folded tail + B6) and the default
    (the deeper fold, B4) on the same weights and batch: two kernels, one
    model."""
    _, variables, port, kw, tg = _case(batch, {})
    never = tmodel.CGCNet(ModelConfig(fused_assign_norm="never", **kw))
    never.load_state_dict(state_dict_from_flax(variables), strict=True)
    calls = []
    for name in ("assign_head_softmax_plain", "assign_head_softmax_pre_plain"):
        def spy(*a, _orig=getattr(tah, name), _name=name):
            calls.append(_name)
            return _orig(*a)

        monkeypatch.setattr(tah, name, spy)
    with torch.inference_mode():
        a, b = port.eval()(tg).numpy(), never.eval()(tg).numpy()
    np.testing.assert_allclose(a, b, atol=1e-5)
    assert calls == ["assign_head_softmax_pre_plain", "assign_head_softmax_plain"]


@pytest.mark.parametrize("drop,adj_type", [(NO_META, "factored gather"),
                                           (NO_T, "EllAdj")])
def test_batch_without_tables_matches_jax(batch, drop, adj_type):
    """A GIN batch whose BSR metadata was dropped (the loader does so past
    data.bsr_blocks) runs the factored gather path; one without transpose
    tables runs EllAdj with renorm_ell weights. Eval logits, and one train
    step's loss and gradients, against JAX (which takes the same paths)."""
    jg, variables, port, kw, tg = _case(batch, {"gcn_name": "GIN"}, drop=drop)
    adj = tmodel.make_stage1_adj(tg, port.cfg, torch.float32)
    if adj_type == "EllAdj":
        assert type(adj) is tadj.EllAdj
    else:
        assert adj.impl == "gather" and adj.vals is None
    with torch.inference_mode():
        logits = port.eval()(tg).numpy()
    np.testing.assert_allclose(logits, _jax_logits(jg, variables, kw),
                               atol=2e-5, rtol=1e-4)
    port.train()
    loss = tmodel.cross_entropy_loss(port(tg), tg.y)
    loss.backward()
    net = jmodel.CGCNet(JaxModelConfig(use_pallas="always", **kw))

    def loss_fn(params):
        out, _ = net.apply({**variables, "params": params}, jg, train=True,
                           mutable=["batch_stats"])
        return jmodel.cross_entropy_loss(out, jg.y)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=2e-5, rtol=1e-4)
    for k, r in state_dict_from_flax({"params": ref_grads}).items():
        p = dict(port.named_parameters())[k]
        np.testing.assert_allclose(p.grad.numpy(), r.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=k)


@pytest.mark.parametrize("over", [{"gcn_name": "GIN"},
                                  {"gcn_name": "GAT", "gat_heads": 2}])
def test_state_dict_from_flax_round_trips(batch, over):
    """Every leaf of a GIN or GAT parameter tree lands in the port's
    state_dict under its path (kernels transposed), a strict load takes
    them all, and the loaded model hands the same tensors back."""
    jg, variables, port, kw, _ = _case(batch, over, seed=5)
    sd = state_dict_from_flax(variables)
    assert set(sd) == set(port.state_dict())
    prefix = "embed1.gcn1." + ("mlp_0" if over["gcn_name"] == "GIN" else "q")
    kernel = variables["params"]["embed1"]["gcn1"][prefix.split(".")[-1]]["kernel"]
    np.testing.assert_array_equal(sd[prefix + ".weight"].numpy(),
                                  np.asarray(kernel).T)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
