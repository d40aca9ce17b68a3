"""PyTorch port, GIN/GAT slice ops: the plain versions of B6 (fused assign
softmax) and B7 (block-sparse gather-sum; also on the cases its card
kernel, a gather over the nonzeros, must keep: duplicate columns, an edge
in a tile not listed, a tile listed twice, a masked slot) against the
Pallas functions they replace (interpret mode on the CPU), the factored
stage-1 operators'
backward against ``jax.vjp``, the ELL gather ops, ``renorm_ell``, the SDDMM
and segment ops, and the B6/B7 wrappers' CPU dispatch. The CUDA kernels
are held against their plain versions on a card by tests/test_torch_cuda.py
and chip_smoke.py.

Tolerances are the JAX suite's own for the same functions:
- B6 S and S^T atol 2e-6, gradients atol 5e-5 / rtol 1e-4
  (tests/test_assign_head.py): f32 softmax of logits summed in another
  order;
- B7 and the operators through it atol 1e-4 (tests/test_bsr.py): f32 sums
  over the 128*M block columns in another order; in bf16 also one bf16
  step (2^-7 relative): the f32 sums of the same rounded products may
  round to neighbouring bf16 values;
- the ELL gathers and their backward atol 1e-6: sums of at most K + 1
  f32 terms in another order;
- renorm_ell, SDDMM and the segment ops atol 1e-6 (the same f32 formulas).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cgcnet_tpu.ops.pallas.assign_head as ah
import cgcnet_tpu.ops.pallas.bsr_kernel as bk
from cgcnet_tpu.ops import ell as jell
from cgcnet_tpu.ops import sddmm as jsddmm
from cgcnet_tpu.ops import segment as jseg
from cgcnet_tpu_torch.ops import assign_head as tah
from cgcnet_tpu_torch.ops import bsr as tbsr
from cgcnet_tpu_torch.ops import ell as tell
from cgcnet_tpu_torch.ops import sddmm as tsddmm
from cgcnet_tpu_torch.ops import segment as tseg

from torch_port_util import example_batch

B7_ATOL = 1e-4


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
    return example_batch(batch=2, cap=256)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _np(t):
    return t.detach().float().numpy()


def _off(batch, which=""):
    """Binary off-diagonal slot mask of the forward (or ``_t``) lists."""
    nbr, m = batch["nbr" + which], batch[("nbr_mask", "nbr_t_mask")[bool(which)]]
    return (m * (nbr != np.arange(nbr.shape[1])[None, :, None])).astype(np.float32)


# ---------------------------------------------------------------------------
# B6
# ---------------------------------------------------------------------------

def _head_inputs(seed, b=2, n=256, c=204, f12=16):
    rng = np.random.default_rng(seed)
    n_nodes = np.array([n - 37, n // 2 + 5], np.int32)[:b]
    mask = (np.arange(n)[None, :] < n_nodes[:, None]).astype(np.float32)
    # masked inputs, like the conv outputs the model feeds in
    x12 = rng.normal(size=(b, n, f12)).astype(np.float32) * mask[..., None]
    h3a = rng.normal(size=(b, n, c)).astype(np.float32) * mask[..., None]
    k12 = rng.normal(size=(f12, c)).astype(np.float32)
    k3f = (rng.normal(size=(c, c)) * 0.2).astype(np.float32)
    const = rng.normal(size=(c,)).astype(np.float32)
    return (x12, h3a, k12, k3f, const), n_nodes, mask


@pytest.mark.parametrize("c", [204, 36])  # C not a multiple of 128
def test_b6_assign_head_matches_pallas(c):
    ins, n_nodes, mask = _head_inputs(0, c=c)
    s_ref, st_ref = ah._fwd_call(*[jnp.asarray(a) for a in ins], jnp.asarray(mask))
    s = tah.assign_head_softmax_plain(*[_t(a) for a in ins], _t(n_nodes))
    np.testing.assert_allclose(_np(s), np.asarray(s_ref), atol=2e-6)
    np.testing.assert_allclose(_np(s.transpose(1, 2)), np.asarray(st_ref), atol=2e-6)
    assert not _np(s)[mask == 0].any()  # rows past n_nodes exactly 0
    np.testing.assert_allclose(_np(s)[mask > 0].sum(-1), 1.0, atol=1e-5)


def test_b6_backward_matches_jax():
    """AssignHeadSoftmax (B6, ``_ah_bwd``'s backward) against the custom VJP
    of ``assign_head_softmax``, with cotangents on S and on S^T."""
    ins, n_nodes, mask = _head_inputs(1)
    rng = np.random.default_rng(2)
    ds = rng.normal(size=ins[1].shape).astype(np.float32)
    ds_t = rng.normal(size=ds.shape).astype(np.float32).transpose(0, 2, 1)
    (s, _), vjp = jax.vjp(
        lambda *a: ah.assign_head_softmax(*a, jnp.asarray(mask)),
        *[jnp.asarray(a) for a in ins],
    )
    ref_grads = vjp((jnp.asarray(ds), jnp.asarray(np.ascontiguousarray(ds_t))))
    tins = [_t(a, grad=True) for a in ins]
    ts = tah.AssignHeadSoftmax.apply(*tins, _t(n_nodes))
    (torch.sum(ts * _t(ds)) + torch.sum(ts.transpose(1, 2) * _t(ds_t))).backward()
    np.testing.assert_allclose(_np(ts), np.asarray(s), atol=2e-6)
    for t, ref in zip(tins, ref_grads):
        np.testing.assert_allclose(_np(t.grad), np.asarray(ref),
                                   atol=5e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# B7
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f", [18, 40, 300])
@pytest.mark.parametrize("variant,dtype", [
    ("resident", "float32"), ("resident", "bfloat16"), ("streamed", "float32"),
])
def test_b7_gather_sum_matches_pallas(batch, monkeypatch, f, variant, dtype):
    """bsr_gather_sum's resident variant (_bsr_resident_call) and streamed
    variant (``_RESIDENT_LIMIT=0``: _bsr_kernel) against the plain version,
    with weighted slots and padded block slots."""
    if variant == "streamed":
        monkeypatch.setattr(bk, "_RESIDENT_LIMIT", 0)
    rng = np.random.default_rng(f)
    w = batch["nbr_mask"] * rng.uniform(0.5, 1.5, batch["nbr_mask"].shape)
    w = w.astype(np.float32)
    x = rng.normal(size=batch["nbr"].shape[:2] + (f,)).astype(np.float32)
    args = (batch["nbr"], w, batch["blk_cols"], batch["blk_mask"])
    ref = bk.bsr_gather_sum(*[jnp.asarray(a) for a in args],
                            jnp.asarray(x).astype(dtype))
    out = tbsr.bsr_gather_sum_plain(*[_t(a) for a in args],
                                    _t(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    ref = np.asarray(ref.astype(jnp.float32))
    rtol = 0.0 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_np(out), ref, atol=B7_ATOL, rtol=rtol)
    # and the plain gather agrees: every edge's tile is in the metadata
    if dtype == "float32":
        np.testing.assert_allclose(
            _np(out), _np(tell.ell_gather_sum(_t(batch["nbr"]), _t(w), _t(x))),
            atol=B7_ATOL)


def _b7_edge_case(case):
    """(nbr, w, blk_cols, blk_mask, x) of a 4-row-tile batch with one of
    the cases B7's function must keep: ``duplicate`` — two slots of a row
    name one column; ``not_live`` — an edge whose column tile is not listed
    for its row tile (it adds nothing); ``tile_twice`` — a column tile
    listed in two live slots (its product adds twice); ``masked_slot`` — a
    listed tile's slot masked off (its edges add nothing)."""
    g = example_batch(batch=2, cap=512, seed=3)
    rng = np.random.default_rng(11)
    nbr, cols, mask = (g[k].copy() for k in ("nbr", "blk_cols", "blk_mask"))
    w = (g["nbr_mask"] * rng.uniform(0.5, 1.5, nbr.shape)).astype(np.float32)
    if case == "duplicate":
        nbr[:, 10:20, 1] = nbr[:, 10:20, 0]
        w[:, 10:20, :2] = (0.75, 0.625)
    elif case == "not_live":
        assert 3 not in cols[0, 0][mask[0, 0] > 0]
        nbr[0, 5, 2], w[0, 5, 2] = 3 * 128 + 9, 1.25
    elif case == "tile_twice":
        assert not mask[:, 0, 2].any()
        cols[:, 0, 2], mask[:, 0, 2] = cols[:, 0, 0], 1.0
    else:
        assert mask[:, 1, 1].all()
        mask[:, 1, 1] = 0.0
    x = rng.normal(size=nbr.shape[:2] + (24,)).astype(np.float32)
    return nbr, w, cols, mask, x


@pytest.mark.parametrize("case", ["duplicate", "not_live", "tile_twice",
                                  "masked_slot"])
@pytest.mark.parametrize("variant,dtype", [
    ("resident", "float32"), ("resident", "bfloat16"), ("streamed", "float32"),
])
def test_b7_edge_cases_match_pallas(monkeypatch, case, variant, dtype):
    """The plain version keeps bsr_gather_sum's semantics on the cases a
    gather over the nonzeros must keep too (``_b7_edge_case``), against
    both Pallas variants in f32 and the resident one in bf16."""
    if variant == "streamed":
        monkeypatch.setattr(bk, "_RESIDENT_LIMIT", 0)
    *args, x = _b7_edge_case(case)
    ref = bk.bsr_gather_sum(*[jnp.asarray(a) for a in args],
                            jnp.asarray(x).astype(dtype))
    out = tbsr.bsr_gather_sum_plain(*[_t(a) for a in args],
                                    _t(x).to(getattr(torch, dtype)))
    rtol = 0.0 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_np(out), np.asarray(ref.astype(jnp.float32)),
                               atol=B7_ATOL, rtol=rtol)


def _factored_args(batch):
    n = batch["nbr"].shape[1]
    valid = (np.arange(n)[None] < batch["n_nodes"][:, None]).astype(np.float32)
    off = _off(batch)
    scale = (0.6 / (off.sum(-1) + 1e-15) * valid).astype(np.float32)
    return off, _off(batch, "_t"), scale, (0.4 * valid).astype(np.float32)


def _vjp_case(batch, seed, f=40):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=batch["nbr"].shape[:2] + (f,)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    return x, g


def test_bsr_spmm_factored_vjp_matches_jax(batch):
    """BsrSpmmFactored (B7 forward, B7 on the transpose tables backward)
    against ``bsr_spmm_factored``'s custom VJP (Pallas, interpret mode)."""
    off, off_t, scale, self_w = _factored_args(batch)
    args = (batch["nbr"], off, batch["blk_cols"], batch["blk_mask"],
            batch["nbr_t"], off_t, batch["blk_cols_t"], batch["blk_mask_t"],
            scale, self_w)
    x, g = _vjp_case(batch, 3)
    out, vjp = jax.vjp(
        lambda xx: jell.bsr_spmm_factored(*[jnp.asarray(a) for a in args], xx),
        jnp.asarray(x),
    )
    (dx,) = vjp(jnp.asarray(g))
    tx = _t(x, grad=True)
    tout = tell.bsr_spmm_factored(*[_t(a) for a in args], tx)
    torch.sum(tout * _t(g)).backward()
    np.testing.assert_allclose(_np(tout), np.asarray(out), atol=B7_ATOL)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx), atol=B7_ATOL)


def test_ell_spmm_factored_vjp_matches_jax(batch):
    """EllSpmmFactored: gathers forward, and a gather over the transpose
    tables backward (not a scatter), against ``ell_spmm_factored``."""
    off, off_t, scale, self_w = _factored_args(batch)
    args = (batch["nbr"], off, batch["nbr_t"], off_t, scale, self_w)
    x, g = _vjp_case(batch, 4)
    out, vjp = jax.vjp(
        lambda xx: jell.ell_spmm_factored(*[jnp.asarray(a) for a in args], xx),
        jnp.asarray(x),
    )
    (dx,) = vjp(jnp.asarray(g))
    tx = _t(x, grad=True)
    tout = tell.ell_spmm_factored(*[_t(a) for a in args], tx)
    torch.sum(tout * _t(g)).backward()
    np.testing.assert_allclose(_np(tout), np.asarray(out), atol=1e-6)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx), atol=1e-6)


def test_ell_gather_sum_renorm_ell_and_rowsum_match_jax(batch):
    """renorm_ell's weights, ell_rowsum and ell_gather_sum with autograd's
    scatter-add backward, against the JAX functions and jax.vjp."""
    args = (batch["nbr"], batch["nbr_mask"], batch["n_nodes"])
    ref_w = jell.renorm_ell(*[jnp.asarray(a) for a in args], 0.4)
    w = tell.renorm_ell(*[_t(a) for a in args], 0.4)
    np.testing.assert_allclose(_np(w), np.asarray(ref_w), atol=1e-6)
    np.testing.assert_allclose(_np(tell.ell_rowsum(w)),
                               np.asarray(jell.ell_rowsum(ref_w)), atol=1e-6)
    x, g = _vjp_case(batch, 5, f=18)
    out, vjp = jax.vjp(
        lambda xx: jell.ell_gather_sum(jnp.asarray(batch["nbr"]), ref_w, xx),
        jnp.asarray(x),
    )
    (dx,) = vjp(jnp.asarray(g))
    tx = _t(x, grad=True)
    tout = tell.ell_gather_sum(_t(batch["nbr"]), w, tx)
    torch.sum(tout * _t(g)).backward()
    np.testing.assert_allclose(_np(tout), np.asarray(out), atol=1e-6)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx), atol=1e-6)


def test_sddmm_and_segment_ops_match_jax(batch):
    rng = np.random.default_rng(6)
    b, n, _ = batch["nbr"].shape
    a = rng.normal(size=(b, n, 12)).astype(np.float32)
    c = rng.normal(size=(b, n, 12)).astype(np.float32)
    mask = batch["nbr_mask"]
    scores = jsddmm.ell_sddmm(*[jnp.asarray(v) for v in (batch["nbr"], mask, a, c)])
    tscores = tsddmm.ell_sddmm(*[_t(v) for v in (batch["nbr"], mask, a, c)])
    np.testing.assert_allclose(_np(tscores), np.asarray(scores), atol=1e-5)
    np.testing.assert_allclose(
        _np(tsddmm.ell_edge_softmax(tscores, _t(mask))),
        np.asarray(jsddmm.ell_edge_softmax(scores, jnp.asarray(mask))), atol=1e-6)

    e = 300
    src = rng.integers(0, 50, e).astype(np.int32)
    dst = rng.integers(0, 60, e).astype(np.int32)  # segments 50..59 may be empty
    wv = rng.normal(size=e).astype(np.float32)
    xv = rng.normal(size=(50, 7)).astype(np.float32)
    logits = rng.normal(size=e).astype(np.float32)
    for jf, tf, ins in (
        (jseg.segment_sum, tseg.segment_sum, (xv[src], dst)),
        (jseg.segment_max, tseg.segment_max, (xv[src], dst)),
        (jseg.segment_softmax, tseg.segment_softmax, (logits, dst)),
    ):
        np.testing.assert_allclose(
            _np(tf(*[_t(v) for v in ins], 60)),
            np.asarray(jf(*[jnp.asarray(v) for v in ins], 60)), atol=1e-6)
    np.testing.assert_allclose(
        _np(tseg.coo_spmm(_t(src), _t(dst), _t(wv), _t(xv), 60)),
        np.asarray(jseg.coo_spmm(*[jnp.asarray(v) for v in (src, dst, wv, xv)], 60)),
        atol=1e-5)


# ---------------------------------------------------------------------------
# the B6 / B7 wrappers
# ---------------------------------------------------------------------------

def test_b6_b7_wrappers_take_plain_version_on_cpu(batch):
    """On CPU tensors the wrappers return the plain version's result and
    launch nothing."""
    launched = (tah.assign_head_softmax.launches, tbsr.bsr_gather_sum.launches)
    ins, n_nodes, _ = _head_inputs(3)
    args = [_t(a) for a in ins] + [_t(n_nodes)]
    torch.testing.assert_close(tah.assign_head_softmax(*args),
                               tah.assign_head_softmax_plain(*args), rtol=0, atol=0)
    x = torch.randn(2, 256, 40, generator=torch.Generator().manual_seed(0))
    g = [_t(batch[k]) for k in ("nbr", "nbr_mask", "blk_cols", "blk_mask")]
    torch.testing.assert_close(tbsr.bsr_gather_sum(*g, x),
                               tbsr.bsr_gather_sum_plain(*g, x), rtol=0, atol=0)
    assert launched == (tah.assign_head_softmax.launches,
                        tbsr.bsr_gather_sum.launches)


def test_b6_b7_wrappers_refuse_other_devices():
    """A tensor that is not on the CPU goes to the kernel or raises: meta
    tensors are refused, never computed by the plain version."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tah.assign_head_softmax(
            torch.empty(2, 256, 16, **meta), torch.empty(2, 256, 36, **meta),
            torch.empty(16, 36, **meta), torch.empty(36, 36, **meta),
            torch.empty(36, **meta), torch.empty(2, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="CUDA device"):
        tbsr.bsr_gather_sum(
            torch.empty(2, 256, 8, dtype=torch.int32, **meta),
            torch.empty(2, 256, 8, **meta),
            torch.empty(2, 2, 4, dtype=torch.int32, **meta),
            torch.empty(2, 2, 4, **meta), torch.empty(2, 256, 18, **meta))
