"""PyTorch port, whole-slide path, host side: the partition and block tables
(``parallel/mega_graph.py``), the band-window tables (``ops/bsr.py``), the
spatial sort and the slide build (``parallel/slide_setup.py``) against the
JAX package's functions on the same numpy inputs, and the one-shard
collectives and their refusal of tables built for more shards
(tests/test_torch_multishard.py runs them over D ranks).

Every table is integer or 0/1 bookkeeping computed by the same numpy
algorithm, so every comparison is exact; ``build_slide_inputs``' features
are the same f32 formula, also held exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from cgcnet_tpu.config import Config as JaxConfig
from cgcnet_tpu.ops.knn import radius_knn_np
from cgcnet_tpu.ops.pallas import bsr_kernel as bk
from cgcnet_tpu.parallel import mega_graph as jmg
from cgcnet_tpu.parallel import slide_setup as jss
from cgcnet_tpu.parallel.mesh import make_mesh
from cgcnet_tpu_torch.config import Config
from cgcnet_tpu_torch.ops import bsr as tbsr
from cgcnet_tpu_torch.parallel import mega_graph as tmg
from cgcnet_tpu_torch.parallel import mega_model as tmm
from cgcnet_tpu_torch.parallel import slide_setup as tss

T = 128


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several test workers share
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def strip_graph(n, shards, seed=0, k=6):
    """A narrow strip of n nuclei (sorted x), stripe-sorted for ``shards``:
    the geometry whose band windows build (the JAX suite's strip case)."""
    rng = np.random.default_rng(seed)
    xs = np.sort(rng.uniform(0, n * 3.0, n))
    pos = np.stack([xs, rng.uniform(0, 80, n)], -1).astype(np.float32)
    order = jss.spatial_sort_order(pos, 100.0, stripes=shards,
                                   shard_rows=n // shards)
    return radius_knn_np(pos[order], 100.0, k)


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None, (a is None, b is None)
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_tables(t, j):
    if t is None or j is None:
        assert t is None and j is None
        return
    for name in ("blk_cols", "blk_mask", "nbr_t", "mask_t", "blk_cols_t",
                 "blk_mask_t", "win_base", "win_base_t", "win_halo"):
        _same(getattr(t, name), getattr(j, name))
    assert t.nc == j.nc


def test_band_constants_match():
    assert (tbsr.G_BAND, tbsr.W_BAND, tbsr.H_BAND_MAX, tbsr.H_SUB,
            tbsr.BAND_MIN_F) == (bk.G_BAND, bk.W_BAND, bk.H_BAND_MAX,
                                 bk.H_SUB, bk.BAND_MIN_F)


def _random_band(rng, r, m, ns_tiles, h_total, spread):
    cols = np.zeros((r, m), np.int32)
    mask = np.zeros((r, m), np.float32)
    for ri in range(r):
        lo = max(0, ri - spread)
        hi = min(ns_tiles - 1, ri + spread)
        k = int(rng.integers(1, m))
        cand = list(range(lo, hi + 1))
        sel = sorted(rng.choice(cand, size=min(k, len(cand)),
                                replace=False).tolist())
        if h_total and rng.uniform() < 0.5:
            sel.append(ns_tiles + int(rng.integers(0, h_total)))
        cols[ri, :len(sel)] = sel
        mask[ri, :len(sel)] = 1.0
    return cols, mask


@pytest.mark.parametrize("seed", range(6))
def test_band_window_tables_match(seed):
    rng = np.random.default_rng(seed)
    spread = (1, 3, 9)[seed % 3]
    r, m, ns_tiles = 32, 5, 32
    for h_total in (0, 2, 6, 12):
        cols, mask = _random_band(rng, r, m, ns_tiles, h_total, spread)
        _same(tbsr.band_window_table(cols, mask, ns_tiles),
              bk.band_window_table(cols, mask, ns_tiles))
        t = tbsr.band_window_table_halo(cols, mask, ns_tiles, h_total)
        j = bk.band_window_table_halo(cols, mask, ns_tiles, h_total)
        if t is None or j is None:
            assert t is None and j is None
        else:
            _same(t[0], j[0])
            _same(t[1], j[1])


@pytest.mark.parametrize("shards,cap", [(1, None), (2, None), (4, None),
                                        (4, 400)])
def test_partition_graph_matches(shards, cap):
    nbr, mask = strip_graph(2048, shards, seed=shards)
    t = tmg.partition_graph(nbr, mask, shards, halo_capacity=cap)
    j = jmg.partition_graph(nbr, mask, shards, halo_capacity=cap)
    for name in ("nbr_remap", "nbr_mask", "req_idx", "req_mask", "n_nodes"):
        _same(getattr(t, name), getattr(j, name))
    assert t.halo_capacity == j.halo_capacity
    with pytest.raises(ValueError):
        if shards > 1:  # one slot short of the pair that needs the most
            need = int(t.req_mask.sum(-1).max())
            tmg.partition_graph(nbr, mask, shards, halo_capacity=need - 1)
        else:
            tmg.partition_graph(nbr, mask, 3)


@pytest.mark.parametrize("n,shards,caps,feature", [
    (4096, 1, None, "resident"),    # halo in the resident tail
    (4096, 1, (16, 12, 12), "caps"),
    (4096, 2, None, "halo_windows"),
    (4096, 4, None, "no_band"),     # a band too wide: win_base None
    (10240, 4, None, "hybrid"),     # transpose blocks over local rows only
])
def test_build_bsr_tables_matches(n, shards, caps, feature):
    nbr, mask = strip_graph(n, shards, seed=7)
    part_t = tmg.partition_graph(nbr, mask, shards)
    part_j = jmg.partition_graph(nbr, mask, shards)
    kw = {} if caps is None else dict(kt_cap=caps[0], m_cap=caps[1],
                                      mt_cap=caps[2])
    t = tmg.build_bsr_tables(part_t, **kw)
    j = jmg.build_bsr_tables(part_j, **kw)
    _same_tables(t, j)
    ns = n // shards
    if feature == "resident":
        assert t.win_base is not None and t.win_halo is None
    elif feature == "caps":
        assert t.nbr_t.shape[-1] == 16 and t.blk_cols.shape[-1] == 12
        with pytest.raises(ValueError):
            tmg.build_bsr_tables(part_t, m_cap=1)
    elif feature == "halo_windows":
        assert t.win_halo is not None and t.win_base is not None
    elif feature == "no_band":
        assert t.win_base is None
    else:
        assert t.blk_cols_t.shape[1] * T == ns < t.nc


def test_build_bsr_tables_rejects_untileable():
    nbr, mask = strip_graph(1000, 1)
    assert tmg.build_bsr_tables(tmg.partition_graph(nbr, mask, 1)) is None
    assert jmg.build_bsr_tables(jmg.partition_graph(nbr, mask, 1)) is None


@pytest.mark.parametrize("stripes", [1, 2, 4])
def test_spatial_sort_order_matches(stripes):
    rng = np.random.default_rng(stripes)
    coords = rng.uniform(0, 5000, (3000, 2)).astype(np.float32)
    _same(tss.spatial_sort_order(coords, 100.0, stripes=stripes,
                                 shard_rows=3072 // stripes),
          jss.spatial_sort_order(coords, 100.0, stripes=stripes,
                                 shard_rows=3072 // stripes))


def test_build_slide_inputs_matches():
    feats, coords = tss.synthetic_slide(2500, seed=5)
    jf, jc = jss.synthetic_slide(2500, seed=5)
    np.testing.assert_array_equal(feats, jf)
    np.testing.assert_array_equal(coords, jc)
    t = tss.build_slide_inputs(Config(), feats, coords, 1, "cpu")
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    j = jss.build_slide_inputs(JaxConfig(), jf, jc, 1, mesh)
    assert (t.n, t.cap, t.input_dim, t.edges, t.bsr) == (
        j.n, j.cap, j.input_dim, j.edges, j.bsr) == (2500, 2560, 18,
                                                     t.edges, False)
    ti, ji = t.inputs, j.inputs
    np.testing.assert_array_equal(ti.x.numpy(), np.asarray(ji.x))
    np.testing.assert_array_equal(ti.nbr_remap.numpy(), np.asarray(ji.nbr_remap))
    np.testing.assert_array_equal(ti.nbr_mask.numpy(), np.asarray(ji.nbr_mask))
    np.testing.assert_array_equal(ti.valid.numpy(), np.asarray(ji.valid))
    np.testing.assert_array_equal(ti.req_idx.numpy(), np.asarray(ji.req_idx))
    # padding rows: zero features, self-pointing slots, no mask, not valid
    pad = slice(2500, 2560)
    assert not ti.x[pad].any() and not ti.nbr_mask[pad].any()
    assert (ti.nbr_remap[pad] == torch.arange(2500, 2560)[:, None]).all()
    assert ti.valid[:2500].all() and not ti.valid[pad].any()


def test_one_shard_collectives():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(256, 5)), dtype=torch.float32,
                     requires_grad=True)
    req_idx = torch.tensor([[3, 7, 0, 0]], dtype=torch.int32)
    req_mask = torch.tensor([[1.0, 1.0, 0.0, 0.0]])
    halo = tmg.halo_exchange(x, req_idx, req_mask)
    np.testing.assert_array_equal(
        halo.detach().numpy(),
        (x.detach()[req_idx[0].long()] * req_mask[0][:, None]).numpy())
    g = torch.tensor(rng.normal(size=(4, 5)), dtype=torch.float32)
    (auto,) = torch.autograd.grad(halo, x, g)
    np.testing.assert_allclose(
        tmg.halo_exchange_vjp(g, req_idx, req_mask, 256).numpy(),
        auto.numpy(), atol=0)
    assert tmg.psum(x) is x
    assert tmg.all_gather(x).shape == (1, 256, 5)
    # tables built for 2 shards in a graph axis of one rank: refused, with
    # the launcher named (one process per shard)
    launcher = "torch.distributed.run"
    with pytest.raises(ValueError, match=launcher):
        tmg.halo_exchange(x, torch.zeros((2, 4), dtype=torch.int32),
                          torch.zeros((2, 4)))
    with pytest.raises(ValueError, match=launcher):
        tmg.halo_exchange_vjp(torch.zeros((8, 5)),
                              torch.zeros((2, 4), dtype=torch.int32),
                              torch.zeros((2, 4)), 256)
    nbr, mask = strip_graph(1024, 2)
    part = tmg.partition_graph(nbr, mask, 2)
    with pytest.raises(ValueError, match=launcher):
        tmm.prepare_mega_inputs(np.zeros((1024, 18), np.float32), part, "cpu")
    with pytest.raises(ValueError, match=launcher):
        tss.build_slide_inputs(Config(), *tss.synthetic_slide(600), 2, "cpu")


def test_slide_tables_window_contract_checked_once():
    """The slide path holds B8's window contract once per slide, when its
    blocks are built (``prepare_mega_inputs`` -> ``build_vals``), not per
    launch: a forward or transpose window base moved off its band
    raises there."""
    nbr, mask = strip_graph(2048, 1)
    part = tmg.partition_graph(nbr, mask, 1)
    tables = tmg.build_bsr_tables(part)
    assert tables.win_base is not None and tables.win_base_t is not None
    x = np.zeros((2048, 18), np.float32)
    tmm.prepare_mega_inputs(x, part, "cpu", bsr=tables)
    for name in ("win_base", "win_base_t"):
        win = getattr(tables, name)
        moved = win.copy()
        moved[..., 0] += tbsr.W_BAND
        with pytest.raises(ValueError, match="outside their super tile"):
            tmm.prepare_mega_inputs(
                x, part, "cpu",
                bsr=dataclasses.replace(tables, **{name: moved}))
