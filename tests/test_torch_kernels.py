"""PyTorch port, kernels B1 / B2 / B3 / B4 / B5: each plain version against
the Pallas function it replaces (interpret mode on the CPU), and the
wrappers' CPU dispatch. The CUDA kernels themselves are held against their plain
versions on a card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances are the JAX suite's own for the same kernels:
- B1 exact: both sum the same f32 weights in slot order from zero;
- B2 atol 1e-4 (tests/test_bsr.py): f32 sums over the 128*M block columns
  in another order;
- B4 atol 2e-6 on S and S^T (tests/test_assign_head.py): f32 softmax of
  logits summed in another order;
- B3 atol 1e-4, B5 atol 5e-5 / rtol 1e-4 (tests/test_assign_head.py):
  column sums over the rows and a row dot in another order; the same in
  bf16, where both sides round h (B3) and dp (B5) the same way.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cgcnet_tpu.ops.pallas.assign_head as ah
import cgcnet_tpu.ops.pallas.bsr_kernel as bk
from cgcnet_tpu_torch.ops import _cuda
from cgcnet_tpu_torch.ops import assign_head as tah
from cgcnet_tpu_torch.ops import bsr as tbsr

from torch_port_util import example_batch, stage1_weights


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
    b = example_batch(batch=2, cap=1024)
    # a duplicated neighbour (two slots naming one column) must sum: turn a
    # padded slot of row 3 into a second copy of its first off-diagonal edge
    row = 3
    k_free = int(np.argmin(b["nbr_mask"][0, row]))
    assert b["nbr_mask"][0, row, k_free] == 0
    b["nbr"][0, row, k_free] = b["nbr"][0, row, 1]
    b["nbr_mask"][0, row, k_free] = 1.0
    assert (b["blk_mask"] == 0).any(), "no padded block slots to check"
    return b


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b1_build_blocks_matches_pallas(batch, dtype):
    w = stage1_weights(batch)
    ref = bk.bsr_build_blocks(
        jnp.asarray(batch["nbr"]), jnp.asarray(w),
        jnp.asarray(batch["blk_cols"]), jnp.asarray(batch["blk_mask"]),
        jnp.dtype(dtype),
    )
    out = tbsr.bsr_build_blocks_plain(
        _t(batch["nbr"]), _t(w), _t(batch["blk_cols"]), _t(batch["blk_mask"]),
        getattr(torch, dtype),
    )
    np.testing.assert_array_equal(
        out.float().numpy(), np.asarray(ref.astype(jnp.float32))
    )
    # padded block slots are all zero, not a copy of column tile 0
    pad = batch["blk_mask"] == 0
    assert not out.float().numpy()[pad].any()


@pytest.mark.parametrize("case,dtype", [
    ("dead_tile", "float32"),   # every slot of one row tile dead
    ("kt_40", "bfloat16"),      # a transpose's KT past 32 slots a row
    ("dups", "int8"),           # duplicate columns summed, then truncated
    ("m_1", "float32"),         # one slot per row tile
])
def test_b1_edge_cases_match_pallas(case, dtype):
    """B1's plain version bit-equal to the Pallas function (interpret mode)
    where the block build has its edges: a dead row tile, more than 32 ELL
    slots a row, duplicate columns in int8, M = 1."""
    rng = np.random.default_rng(len(case))
    n, k = 512, 40 if case == "kt_40" else 9
    rows = np.arange(n)[:, None]
    if case == "m_1":  # every slot in the row's own tile
        lo, hi = rows // 128 * 128, rows // 128 * 128 + 127
    else:
        lo, hi = 0, n - 1
    nbr = np.clip(rows + rng.integers(-150, 151, (1, n, k)), lo,
                  hi).astype(np.int32)
    if dtype == "int8":
        w = (rng.uniform(size=(1, n, k)) > 0.3).astype(np.float32)
    else:
        w = rng.normal(size=(1, n, k)).astype(np.float32)
    if case == "dups":
        nbr[0, 7, 1:5] = nbr[0, 7, 0]
        w[0, 7, :5] = 1.0
    m = 1 if case == "m_1" else 6
    cols, msk, _ = tbsr.bsr_block_meta(nbr[0], np.ones((n, k)), m)
    if case == "dead_tile":
        msk[1] = 0
    args = (nbr, w, cols[None], msk[None])
    out = tbsr.bsr_build_blocks(*(_t(a) for a in args), getattr(torch, dtype))
    ref = bk.bsr_build_blocks(*(jnp.asarray(a) for a in args),
                              jnp.dtype(dtype))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert not out.float().numpy()[msk[None] == 0].any()
    if case == "dups":
        assert out[0, 0].max() >= 5  # the five copies of one column


@pytest.mark.parametrize("f,extra_rows", [(18, 0), (40, 0), (300, 0), (40, 128)])
def test_b2_bsr_matmul_matches_pallas(batch, f, extra_rows):
    w = stage1_weights(batch)
    vals = bk.bsr_build_blocks(
        jnp.asarray(batch["nbr"]), jnp.asarray(w),
        jnp.asarray(batch["blk_cols"]), jnp.asarray(batch["blk_mask"]),
    )
    rng = np.random.default_rng(f)
    b, n = batch["nbr"].shape[:2]
    # extra_rows: a rectangular operator (x has more rows than R*128)
    x = rng.normal(size=(b, n + extra_rows, f)).astype(np.float32)
    ref = bk.bsr_matmul(vals, jnp.asarray(batch["blk_cols"]), jnp.asarray(x))
    out = tbsr.bsr_matmul_plain(
        _t(np.asarray(vals)), _t(batch["blk_cols"]), _t(x)
    )
    assert out.shape == (b, n, f)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def _head_inputs(seed, b=2, n=256, c=204, f12=16):
    rng = np.random.default_rng(seed)
    n_nodes = np.array([n - 37, n // 2 + 5], np.int32)[:b]
    mask = (np.arange(n)[None, :] < n_nodes[:, None]).astype(np.float32)
    x12 = rng.normal(size=(b, n, f12)).astype(np.float32) * mask[..., None]
    p = rng.normal(size=(b, n, c)).astype(np.float32)  # raw: padded rows too
    p[0, 5] = 0.0  # an all-zero row: rnorm clamps at 1e-12
    k12 = rng.normal(size=(f12, c)).astype(np.float32)
    k3f = (rng.normal(size=(c, c)) * 0.2).astype(np.float32)
    const = rng.normal(size=(c,)).astype(np.float32)
    return x12, p, k12, k3f, const, n_nodes, mask


@pytest.mark.parametrize("c", [204, 36])  # C not a multiple of 128
def test_b4_assign_head_matches_pallas(c):
    x12, p, k12, k3f, const, n_nodes, mask = _head_inputs(0, c=c)
    s_ref, st_ref = ah._fwd_call_pre(
        jnp.asarray(x12), jnp.asarray(p), jnp.asarray(k12), jnp.asarray(k3f),
        jnp.asarray(const), jnp.asarray(mask),
    )
    s, s_t = tah.assign_head_softmax_pre_plain(
        _t(x12), _t(p), _t(k12), _t(k3f), _t(const), _t(n_nodes)
    )
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=2e-6)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(st_ref), atol=2e-6)
    # rows at or beyond n_nodes are exactly zero; S^T is a view of S
    for bi, nn in enumerate(n_nodes):
        assert not s.numpy()[bi, nn:].any()
    assert s_t.data_ptr() == s.data_ptr()
    np.testing.assert_allclose(s.numpy()[mask > 0].sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [204, 36])  # C not a multiple of 128
def test_b3_stats_matches_pallas(c, dtype):
    """Column sums of h and h^2 over real rows (rows past n_nodes hold
    nonzero p), with h rounded to p's dtype before summing."""
    _, p, _, _, _, n_nodes, mask = _head_inputs(2, c=c)
    ssum, ssq = ah.l2relu_stats(jnp.asarray(p).astype(dtype), jnp.asarray(mask))
    osum, osq = tah.l2relu_stats_plain(_t(p).to(getattr(torch, dtype)), _t(n_nodes))
    np.testing.assert_allclose(osum.numpy(), np.asarray(ssum), atol=1e-4)
    np.testing.assert_allclose(osq.numpy(), np.asarray(ssq), atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [204, 36])
def test_b5_tail_bwd_matches_pallas(c, dtype):
    """dp of normalize + relu + stats; rows past n_nodes come out 0 though
    p is not zero there."""
    rng = np.random.default_rng(c)
    _, p, _, _, _, n_nodes, mask = _head_inputs(3, c=c)
    dh = rng.normal(size=p.shape).astype(np.float32) * mask[..., None]
    u = rng.normal(size=(c,)).astype(np.float32)
    w = rng.normal(size=(c,)).astype(np.float32)
    ref = ah._bwd_call(
        jnp.asarray(p).astype(dtype), jnp.asarray(dh).astype(dtype),
        jnp.asarray(u), jnp.asarray(w), jnp.asarray(mask),
    )
    tdt = getattr(torch, dtype)
    out = tah.assign_tail_bwd_plain(_t(p).to(tdt), _t(dh).to(tdt), _t(u), _t(w),
                                    _t(n_nodes))
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=5e-5, rtol=1e-4)
    assert not out.float().numpy()[mask == 0].any()


def test_wrappers_take_plain_version_on_cpu(batch):
    """On CPU tensors the wrappers return the plain version's result and
    launch nothing."""
    w = _t(stage1_weights(batch))
    def counts():
        return (
            tbsr.bsr_build_blocks.launches, tbsr.bsr_matmul.launches,
            tah.assign_head_softmax_pre.launches, tah.l2relu_stats.launches,
            tah.assign_tail_bwd.launches,
        )

    launched = counts()
    nbr, bc, bm = _t(batch["nbr"]), _t(batch["blk_cols"]), _t(batch["blk_mask"])
    vals = tbsr.bsr_build_blocks(nbr, w, bc, bm)
    torch.testing.assert_close(
        vals, tbsr.bsr_build_blocks_plain(nbr, w, bc, bm), rtol=0, atol=0
    )
    x = torch.randn(2, 1024, 40, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(
        tbsr.bsr_matmul(vals, bc, x, tbsr.live_slot_counts(bm)),
        tbsr.bsr_matmul_plain(vals, bc, x), rtol=0, atol=0,
    )
    args = [_t(a) for a in _head_inputs(1)[:6]]
    s, _ = tah.assign_head_softmax_pre(*args)
    torch.testing.assert_close(
        s, tah.assign_head_softmax_pre_plain(*args)[0], rtol=0, atol=0
    )
    p, n_nodes = args[1], args[5]
    for got, ref in zip(tah.l2relu_stats(p, n_nodes),
                        tah.l2relu_stats_plain(p, n_nodes)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    dh, u = torch.ones_like(p), torch.ones(p.shape[-1])
    torch.testing.assert_close(
        tah.assign_tail_bwd(p, dh, u, u, n_nodes),
        tah.assign_tail_bwd_plain(p, dh, u, u, n_nodes), rtol=0, atol=0,
    )
    assert launched == counts()


def test_wrappers_refuse_other_devices(batch):
    """A tensor that is not on the CPU goes to the kernel or raises: a meta
    tensor is refused, never computed by the plain version."""
    vals = torch.empty((2, 8, 6, 128, 128), device="meta")
    bc = torch.empty((2, 8, 6), dtype=torch.int32, device="meta")
    x = torch.empty((2, 1024, 18), device="meta")
    slots = torch.empty((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tbsr.bsr_matmul(vals, bc, x, slots)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """No CUDA toolkit: the kernel build raises (it never falls back)."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.nvcc()
