"""PyTorch port, model: each module that holds or feeds a kernel, and the
whole eval forward, against the JAX package with transplanted parameters.

Modules are held at atol 2e-6 (f32 sums in another order; the B4 tolerance
of tests/test_assign_head.py) or 1e-5 where a B2 sum over 128*M block
columns feeds them; the whole model at atol 2e-5, rtol 1e-4, the golden
tolerance of tests/test_golden.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

import cgcnet_tpu.ops.pallas.assign_head as ah
import cgcnet_tpu.ops.pallas.bsr_kernel as bk
from cgcnet_tpu.config import ModelConfig as JaxModelConfig
from cgcnet_tpu.nn import adjacency as jadj
from cgcnet_tpu.nn import blocks as jblocks
from cgcnet_tpu.nn import jk as jjk
from cgcnet_tpu.nn import layers as jlayers
from cgcnet_tpu.nn import model as jmodel
from cgcnet_tpu_torch.config import ModelConfig
from cgcnet_tpu_torch.nn import adjacency as tadj
from cgcnet_tpu_torch.nn import blocks as tblocks
from cgcnet_tpu_torch.nn import jk as tjk
from cgcnet_tpu_torch.nn import layers as tlayers
from cgcnet_tpu_torch.nn import model as tmodel
from cgcnet_tpu_torch.train.checkpoint import state_dict_from_flax

from torch_port_util import (
    SMALL_MODEL,
    example_batch,
    jax_graph,
    random_tree,
    torch_graph,
)


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _load(module, variables, prefix=""):
    """Load the transplanted subtree under ``prefix`` into ``module``;
    every transplanted key must exist there."""
    sd = {
        k[len(prefix):]: v
        for k, v in state_dict_from_flax(variables).items()
        if k.startswith(prefix)
    }
    res = module.load_state_dict(sd, strict=False)
    assert not res.unexpected_keys, res.unexpected_keys
    return module.eval()


def test_sage_conv(batch):
    rng = np.random.default_rng(0)
    b, n, fin, fout = 2, 96, 18, 8
    x = rng.normal(size=(b, n, fin)).astype(np.float32)
    adj = (rng.uniform(size=(b, n, n)) < 0.08).astype(np.float32)
    mask = (np.arange(n)[None] < np.array([[80], [96]])).astype(np.float32)
    conv = jlayers.SAGEConv(fout, in_features=fin)
    jadj_ = jadj.DenseAdj(jnp.asarray(adj))
    v = random_tree(
        lambda: conv.init(jax.random.key(0), jnp.asarray(x), jadj_, jnp.asarray(mask)), 3
    )
    port = _load(tlayers.SAGEConv(fin, fout), v)
    tadj_ = tadj.DenseAdj(_t(adj))
    for pre in (False, True):
        ref = conv.apply(v, jnp.asarray(x), jadj_, jnp.asarray(mask), pre_normalize=pre)
        out = port(_t(x), tadj_, _t(mask), pre_normalize=pre)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-6)


def test_dense_jk():
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(2, 50, 24)).astype(np.float32)
    jk = jjk.DenseJK(8, 3)
    v = random_tree(lambda: jk.init(jax.random.key(0), jnp.asarray(xs)), 4)
    port = _load(tjk.DenseJK(8, 3), v)
    ref = jk.apply(v, jnp.asarray(xs))
    out = port(_t(xs))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-6)


class _JaxPair(fnn.Module):
    """An (embed, pool) block pair in the JAX package, for the tails."""

    c: int

    def setup(self):
        kw = dict(hidden_dim=8, input_dim=18, fold_tail=True)
        self.embed1 = jblocks.GNNBlock(embedding_dim=8, use_lin=False, **kw)
        self.pool1 = jblocks.GNNBlock(embedding_dim=self.c, use_lin=True, **kw)

    def __call__(self, cat, x1, x2, p, mask):
        tail = jblocks._dual_tail(
            self.embed1, self.pool1, 2, cat, mask, train=False
        )
        s = self.pool1.finish_folded_pre(x1, x2, p, mask, train=False)
        return tail, s


def _pair_case(seed, c=204, b=2, n=256):
    rng = np.random.default_rng(seed)
    n_nodes = np.array([n - 40, n - 100], np.int32)
    mask = (np.arange(n)[None] < n_nodes[:, None]).astype(np.float32)
    cat = rng.normal(size=(b, n, 16)).astype(np.float32)
    x1 = rng.normal(size=(b, n, 8)).astype(np.float32) * mask[..., None]
    x2 = rng.normal(size=(b, n, 8)).astype(np.float32) * mask[..., None]
    p = rng.normal(size=(b, n, c)).astype(np.float32)
    pair = _JaxPair(c)
    args = [jnp.asarray(a) for a in (cat, x1, x2, p, mask)]
    v = random_tree(lambda: pair.init(jax.random.key(0), *args), seed + 10)
    embed = _load(
        tblocks.GNNBlock(18, 8, 8, use_lin=False), v, "embed1."
    )
    pool = _load(
        tblocks.GNNBlock(18, 8, c, use_lin=True), v, "pool1."
    )
    (tail_ref, s_ref) = pair.apply(v, *args)
    return (cat, x1, x2, p, mask, n_nodes), embed, pool, tail_ref, s_ref


def test_dual_tail_eval():
    (cat, _, _, _, mask, _), embed, pool, tail_ref, _ = _pair_case(5)
    out = tblocks._dual_tail(embed, pool, 2, _t(cat), _t(mask))
    for o, r in zip(out, tail_ref):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), atol=2e-6)


def test_finish_folded_pre_eval():
    (_, x1, x2, p, _, n_nodes), _, pool, _, (s_ref, st_ref) = _pair_case(6)
    s, s_t = pool.finish_folded_pre(_t(x1), _t(x2), _t(p), _t(n_nodes))
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(s_ref), atol=2e-6)
    np.testing.assert_allclose(s_t.detach().numpy(), np.asarray(st_ref), atol=2e-6)


def test_diff_pool_from_s(batch):
    """Stage-1 adjacency (B1 blocks) and the fused DiffPool contractions."""
    rng = np.random.default_rng(7)
    b, n = batch["x"].shape[:2]
    x = rng.normal(size=(b, n, 8)).astype(np.float32)
    logits = rng.normal(size=(b, n, 204)).astype(np.float32)
    s = np.exp(logits - logits.max(-1, keepdims=True))
    s /= s.sum(-1, keepdims=True)
    s *= (np.arange(n)[None] < batch["n_nodes"][:, None])[..., None]
    s = s.astype(np.float32)
    cfg = JaxModelConfig(use_pallas="always", **SMALL_MODEL)
    jadj_ = jmodel.make_stage1_adj(jax_graph(batch), cfg, jnp.float32)
    ref_x, ref_adj = jblocks.diff_pool_from_s(
        jnp.asarray(x), jadj_, jnp.asarray(s),
        jnp.asarray(np.ascontiguousarray(s.transpose(0, 2, 1))),
    )
    tcfg = ModelConfig(**SMALL_MODEL)
    tadj_ = tmodel.make_stage1_adj(torch_graph(batch), tcfg, torch.float32)
    ts = _t(s)
    out_x, out_adj = tblocks.diff_pool_from_s(_t(x), tadj_, ts, ts.transpose(1, 2))
    np.testing.assert_allclose(out_x.numpy(), np.asarray(ref_x), atol=1e-5)
    np.testing.assert_allclose(out_adj.numpy(), np.asarray(ref_adj), atol=1e-5)


@pytest.fixture(scope="module")
def slice_case(batch):
    jg = jax_graph(batch)
    net = jmodel.CGCNet(JaxModelConfig(use_pallas="never", **SMALL_MODEL))
    variables = random_tree(
        lambda: net.init({"params": jax.random.key(0)}, jg, train=False), 1
    )
    port = tmodel.CGCNet(ModelConfig(**SMALL_MODEL))
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    port.eval()
    with torch.inference_mode():
        logits = port(torch_graph(batch)).numpy()
    return jg, variables, port, logits


@pytest.mark.parametrize("use_pallas", ["always", "never"])
def test_model_logits_match_jax(slice_case, use_pallas):
    """Eval logits against JAX's Pallas path (interpret mode) and its XLA
    path, with every weight and BN statistic transplanted."""
    jg, variables, _, logits = slice_case
    net = jmodel.CGCNet(JaxModelConfig(use_pallas=use_pallas, **SMALL_MODEL))
    ref = np.asarray(
        jax.jit(lambda v, g: net.apply(v, g, train=False))(variables, jg)
    )
    assert logits.shape == (2, 3) and np.isfinite(logits).all()
    np.testing.assert_allclose(logits, ref, atol=2e-5, rtol=1e-4)


def test_model_bf16_runs(slice_case, batch):
    """compute_dtype=bfloat16 runs the same path (bf16 storage, f32
    accumulation); logits stay within bf16 reach of the f32 ones."""
    _, _, port, logits = slice_case
    cfg = ModelConfig(compute_dtype="bfloat16", **SMALL_MODEL)
    bf = tmodel.CGCNet(cfg)
    bf.load_state_dict(port.state_dict())
    with torch.inference_mode():
        out = bf.eval()(torch_graph(batch)).numpy()
    assert out.dtype == np.float32 and np.isfinite(out).all()
    np.testing.assert_allclose(out, logits, atol=5e-2)


def test_unported_paths_raise(slice_case, batch):
    _, _, port, _ = slice_case
    for bad in ({"gcn_name": "GIN"}, {"activation": "elu"}, {"bn": False},
                {"use_pallas": "never"}, {"fused_assign_norm": "never"}):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            tmodel.CGCNet(ModelConfig(**bad, **SMALL_MODEL))
    no_meta = dict(batch)
    for k in ("blk_cols", "blk_mask", "blk_cols_t", "blk_mask_t"):
        no_meta.pop(k)
    with pytest.raises(ValueError, match="block metadata"):
        port(torch_graph(no_meta))
    # a backward through stage 1 needs the transpose tables
    no_t = dict(batch)
    for k in ("nbr_t", "nbr_t_mask", "blk_cols_t", "blk_mask_t"):
        no_t.pop(k)
    with pytest.raises(ValueError, match="transpose tables"):
        port.train()(torch_graph(no_t))
    port.eval()
