"""PyTorch port, on the CPU: B2 over live slots, and the exact statistics
reference that the card's hold of B3 and B9b is judged by.

- B2 (the wrapper on CPU tensors, i.e. its plain version, given
  ``live_slots``) against JAX's ``bsr_matmul`` in interpret mode, on f32,
  bf16 and int8 blocks, with a row tile without a live slot, one with every
  slot live and one with a dead slot inside its walk (x's rows a multiple
  of 128, as the JAX kernel takes them); the JAX suite's B2 tolerance (atol
  1e-4 in f32; in bf16 one bf16 step, 2^-7, of the result's scale);
- the wrapper refuses a ``live_slots`` of another shape or type, or none;
- the patch model's counts (``make_stage1_adj``, beside B1) equal
  ``live_slot_counts`` of each direction's ``blk_mask`` and an independent
  count;
- ``l2relu_stats_reference`` / ``l2relu_stats_lin_reference`` (f64 sums of
  the plain version's h) against JAX's ``_stats_call`` /
  ``_stats_call_lin`` and against the plain versions, at
  ``STATS_TOL`` (both sum in f32); the hold's witness of the
  wrong rounding (ii) lies beyond STATS_TOL from the reference, and its
  witness (i) within it. At 4096 rows: STATS_TOL is set for the slide's
  100352 (see its comment), and a right computation's rare rounding flips
  weigh more in a column of a few hundred rows. In bf16, B9b's reference
  is held against JAX's ``_stats_call`` on the p that JAX's lin forms
  eagerly (``lin_p``'s bits but for a few values one bf16 step off, summed
  in another order): jitted, XLA:CPU drops the bf16 rounding of p inside
  ``_stats_call_lin`` (excess precision), so its bf16 statistics are not
  the function's.

Torch runs one intra-op thread while this file runs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cgcnet_tpu.ops.pallas.assign_head as jah
import cgcnet_tpu.ops.pallas.bsr_kernel as bk
from cgcnet_tpu_torch.config import ModelConfig
from cgcnet_tpu_torch.core.convert import transpose_ell_np
from cgcnet_tpu_torch.core.graph import CellGraph
from cgcnet_tpu_torch.nn.model import make_stage1_adj
from cgcnet_tpu_torch.ops import assign_head as tah
from cgcnet_tpu_torch.ops import bsr as tbsr
from cgcnet_tpu_torch.ops.knn import radius_knn_np

T = tbsr.TILE


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


def _counts_ref(mask: np.ndarray) -> np.ndarray:
    """Slots up to and including the last live one, by a loop."""
    out = np.zeros(mask.shape[:-1], np.int32)
    for idx in np.ndindex(*mask.shape[:-1]):
        live = np.nonzero(mask[idx] > 0)[0]
        out[idx] = live[-1] + 1 if len(live) else 0
    return out


def _blocks(vdt: str, seed: int, b=2, r=4, m=5, nc=5 * T):
    """Blocks with a row tile without a live slot ((0, 1)), one with all M
    live ((1, 2)) and one with a dead slot inside its walk ((0, 3): [1, 0,
    1, 0, 0]); dead slots hold zero blocks, as B1 writes them."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, -(-nc // T), (b, r, m)).astype(np.int32)
    lens = rng.integers(1, m, (b, r))
    mask = (np.arange(m)[None, None] < lens[..., None]).astype(np.float32)
    mask[0, 1] = 0
    mask[1, 2] = 1
    mask[0, 3] = [1, 0, 1, 0, 0]
    if vdt == "int8":
        vals = rng.integers(-3, 4, (b, r, m, T, T)).astype(np.int8)
    else:
        vals = rng.normal(size=(b, r, m, T, T)).astype(np.float32)
    vals = vals * mask[..., None, None].astype(vals.dtype)
    return vals, cols, mask, nc


@pytest.mark.parametrize("vdt,xdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("int8", "bfloat16"),
                                     ("int8", "float32")])
def test_b2_live_slots_matches_pallas(vdt, xdt):
    vals, cols, mask, nc = _blocks(vdt, seed=1)
    x = np.random.default_rng(2).normal(size=(2, nc, 24)).astype(np.float32)
    jv = jnp.asarray(vals).astype(vdt)
    ref = jax.jit(bk.bsr_matmul)(jv, jnp.asarray(cols),
                                 jnp.asarray(x).astype(xdt))
    tv = torch.from_numpy(vals)
    if vdt == "bfloat16":
        tv = tv.to(torch.bfloat16)
    slots = tbsr.live_slot_counts(torch.from_numpy(mask))
    np.testing.assert_array_equal(slots.numpy(), _counts_ref(mask))
    assert slots[0, 1] == 0 and slots[1, 2] == 5 and slots[0, 3] == 3
    out = tbsr.bsr_matmul(tv, torch.from_numpy(cols),
                          torch.from_numpy(x).to(getattr(torch, xdt)), slots)
    assert out.dtype == getattr(torch, xdt) and out.shape == (2, 4 * T, 24)
    ref = np.asarray(ref, np.float32)
    tol = 1e-4 if xdt == "float32" else 2.0 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol)
    assert not out[0, T:2 * T].any()


def test_b2_refuses_other_live_slots():
    vals, cols, mask, nc = _blocks("int8", seed=3)
    args = (torch.from_numpy(vals), torch.from_numpy(cols),
            torch.zeros((2, nc, 8)))
    good = tbsr.live_slot_counts(torch.from_numpy(mask))
    tbsr.bsr_matmul(*args, good)
    for bad in (None, good.long(), good[:, :3], good[None], good.float()):
        with pytest.raises(ValueError, match="live_slots"):
            tbsr.bsr_matmul(*args, bad)


def _patch_graph(seed=0, b=2, cap=1024, k=8, kt=24):
    """A patch batch with both directions' block metadata, from the port's
    host helpers."""
    rng = np.random.default_rng(seed)
    fields = {k_: [] for k_ in ("x", "nbr", "nbr_mask", "nbr_t",
                                "nbr_t_mask", "blk_cols", "blk_mask",
                                "blk_cols_t", "blk_mask_t", "n_nodes")}
    for _ in range(b):
        n = int(rng.integers(int(cap * 0.7), cap + 1))
        pos = rng.uniform(0, 60 * np.sqrt(n), (n, 2)).astype(np.float32)
        pos = pos[np.lexsort((pos[:, 1], np.floor(pos[:, 0] / 100.0)))]
        nbr, m = radius_knn_np(pos, 100.0, k)
        nbr_t, m_t, _ = transpose_ell_np(nbr, m, kt)
        own = np.arange(n, cap, dtype=np.int32)[:, None]
        nbr = np.concatenate([nbr, np.tile(own, (1, k))])
        m = np.concatenate([m, np.zeros((cap - n, k), np.float32)])
        nbr_t = np.concatenate([nbr_t, np.tile(own, (1, kt))])
        m_t = np.concatenate([m_t, np.zeros((cap - n, kt), np.float32)])
        c, bm, _ = tbsr.bsr_block_meta(nbr, m, 8)
        ct, bmt, _ = tbsr.bsr_block_meta(nbr_t, m_t, 12)
        x = np.zeros((cap, 18), np.float32)
        x[:n] = rng.normal(size=(n, 18))
        for key, a in zip(fields, (x, nbr, m, nbr_t, m_t, c, bm, ct, bmt)):
            fields[key].append(a)
        fields["n_nodes"].append(n)
    return CellGraph(**{key: torch.from_numpy(np.asarray(v))
                        for key, v in fields.items()})


def test_patch_model_counts_both_directions():
    """The counts the patch model makes beside B1 (B2's live_slots, both
    directions) are ``live_slot_counts`` of each blk_mask and the
    independent count; without gradients there is no transpose and no
    transpose count."""
    graph = _patch_graph()
    adj = make_stage1_adj(graph, ModelConfig(), torch.float32)
    for got, mask in ((adj.slots, graph.blk_mask),
                      (adj.slots_t, graph.blk_mask_t)):
        assert got.dtype == torch.int32 and got.shape == mask.shape[:2]
        assert torch.equal(got, tbsr.live_slot_counts(mask))
        np.testing.assert_array_equal(got.numpy(), _counts_ref(mask.numpy()))
    assert (adj.slots < graph.blk_mask.shape[-1]).any()  # dead slots exist
    with torch.no_grad():
        adj = make_stage1_adj(graph, ModelConfig(), torch.float32)
    assert adj.slots is not None and adj.slots_t is None


def _stats_inputs(dt: str, seed: int, b=2, n=4096, c=204):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(b, n, c)).astype(np.float32)
    p[0, 5] = 0.0  # an all-zero row: rnorm clamps
    n_nodes = np.array([n - 37, n // 2 + 5], np.int32)
    mask = (np.arange(n)[None] < n_nodes[:, None]).astype(np.float32)
    return (torch.from_numpy(p).to(getattr(torch, dt)),
            torch.from_numpy(n_nodes), jnp.asarray(p).astype(dt),
            jnp.asarray(mask))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_stats_reference_matches_jax_and_plain(dt):
    """B3's exact reference against JAX's _stats_call and the plain
    version (f32 sums: within STATS_TOL of it); in bf16 the witness of the
    wrong rounding is beyond STATS_TOL, the right one within."""
    p, n_nodes, jp, jmask = _stats_inputs(dt, seed=4)
    ref = tah.l2relu_stats_reference(p, n_nodes)
    assert all(r.dtype == torch.float64 for r in ref)
    jax_stats = [torch.from_numpy(np.array(a))
                 for a in jax.jit(jah._stats_call)(jp, jmask)]
    assert tah.stats_distance(jax_stats, ref) <= tah.STATS_TOL
    assert tah.stats_distance(tah.l2relu_stats_plain(p, n_nodes), ref) \
        <= tah.STATS_TOL
    if dt == "bfloat16":
        w2 = tah.l2relu_stats_reference(p, n_nodes, round_h=False)
        assert tah.stats_distance(w2, ref) > tah.STATS_TOL
        w1 = tah.l2relu_stats_reference(p, n_nodes,
                                        rnorm=tah.rnorm_two_halves(p))
        assert tah.stats_distance(w1, ref) <= tah.STATS_TOL


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_stats_lin_reference_matches_jax_and_plain(dt):
    """B9b's exact reference against JAX's _stats_call_lin and the plain
    version; in bf16 the witness with p rounded once is beyond STATS_TOL
    (and differs from the reference's p), the reversed dot within."""
    rng = np.random.default_rng(5)
    n, f3, c, real = 4096, 20, 300, 3200
    x3 = np.maximum(rng.normal(size=(1, n, f3)), 0).astype(np.float32)
    kc3 = (rng.normal(size=(f3, c)) * 0.3).astype(np.float32)
    b3 = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    n_nodes = torch.tensor([real], dtype=torch.int32)
    mask = (np.arange(n) < real).astype(np.float32)[None]
    tx3 = torch.from_numpy(x3).to(getattr(torch, dt))
    tk, tb = torch.from_numpy(kc3), torch.from_numpy(b3)
    ref = tah.l2relu_stats_lin_reference(tx3, tk, tb, n_nodes)
    jx3 = jnp.asarray(x3).astype(dt)
    if dt == "float32":
        jax_stats = jax.jit(jah._stats_call_lin)(
            jx3, jnp.asarray(kc3), jnp.asarray(b3), jnp.asarray(mask))
    else:
        jdot = jnp.dot(jx3, jnp.asarray(kc3).astype(dt),
                       preferred_element_type=jnp.float32).astype(dt)
        jp = jdot + jnp.asarray(b3).astype(dt)
        # a right p by another summation order: its rounded dot is lin_p's,
        # or one bf16 step from it in a few places
        jd = torch.from_numpy(np.array(jdot, np.float32))
        td = (tx3.float() @ tk.to(tx3.dtype).float()).to(tx3.dtype).float()
        step = 2.0 ** (torch.floor(torch.log2(td.abs().clamp_min(1e-30))) - 7)
        assert ((jd - td).abs() <= step).all()
        assert (jd == td).float().mean() > 0.999
        jax_stats = jax.jit(jah._stats_call)(jp, jnp.asarray(mask))
    jax_stats = [torch.from_numpy(np.array(a)) for a in jax_stats]
    assert tah.stats_distance(jax_stats, ref) <= tah.STATS_TOL
    assert tah.stats_distance(
        tah.l2relu_stats_lin_plain(tx3, tk, tb, n_nodes), ref) <= tah.STATS_TOL
    if dt == "bfloat16":
        p1 = tah.lin_p_rounded_once(tx3, tk, tb)
        assert not torch.equal(p1, tah.lin_p(tx3, tk, tb))
        w2 = tah.l2relu_stats_reference(p1, n_nodes)
        assert tah.stats_distance(w2, ref) > tah.STATS_TOL
        w1 = tah.l2relu_stats_reference(tah.lin_p_reversed(tx3, tk, tb),
                                        n_nodes)
        assert tah.stats_distance(w1, ref) <= tah.STATS_TOL
