"""PyTorch port, whole-slide path, kernels and the autograd Functions around
them: the plain versions of B8 (``bsr_matmul_banded``), B9a
(``assign_head_softmax_pre_lin``), B9b (``l2relu_stats_lin``), B4 with
``c_out`` and the int8 B1/B2 against the Pallas functions they replace
(interpret mode on the CPU); B8's window-contract check;
``bsr_local_matmul``, ``assign_tail_train_psum``,
``assign_tail_train_chunked_lin``, the chunked pool contraction and the
fused pool aggregate, values and VJPs, against JAX (the psum'd functions
under ``shard_map`` on a one-device mesh). The CUDA kernels are held
against these plain versions on a card by tests/test_torch_cuda.py and
chip_smoke.py.

Tolerances, with their reasons:
- B8, int8 B2, ``bsr_local_matmul`` at f32: atol 2e-4 on |out| up to ~40 —
  the JAX suite's own banded-vs-streamed bound (f32 sums over 128*M block
  columns in another order);
- bf16 outputs (B8, B2, B9a, B4, the tails' S): one bf16 rounding step of
  the largest value (2^-8 relative, taken as 2^-7 of max |ref|) — the same
  f32 sums rounded once, in another order, may land on neighbouring bf16
  values;
- B9a and B4 S at f32: atol 2e-6 (tests/test_assign_head.py's B4 bound);
  B9b sums at f32: rtol 1e-5 (f32 column sums over N rows in another
  order); B9b at bf16: rtol 2e-2 of max — p is an f32 dot rounded to bf16,
  and a dot summed in another order can round p one bf16 step apart,
  moving h by ~2^-8 in a few rows;
- int8 B1: exact (0/1 sums);
- the tails' gradients: the JAX suite's atol 5e-5 / rtol 1e-4 at f32
  (tests/test_assign_head.py); the pool contraction 2e-4 of max
  (tests/test_pool_aggregate.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import cgcnet_tpu.ops.pallas.assign_head as jah
import cgcnet_tpu.ops.pallas.bsr_kernel as bk
from cgcnet_tpu.parallel import mega_model as jmm
from cgcnet_tpu_torch.ops import assign_head as tah
from cgcnet_tpu_torch.ops import bsr as tbsr
from cgcnet_tpu_torch.parallel import mega_model as tmm

T = 128


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


def _t(a, dtype=None, grad=False):
    t = torch.from_numpy(np.array(a))
    if dtype is not None:
        t = t.to(dtype)
    return t.requires_grad_(grad)


def _np(t):
    return t.detach().float().numpy()


def _jnp(a, dtype=None):
    out = jnp.asarray(np.asarray(a, np.float32) if dtype is not None else a)
    return out.astype(dtype) if dtype is not None else out


def _close(out, ref, dt, atol_f32):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    if dt == "bfloat16":
        np.testing.assert_allclose(out, ref, atol=2 ** -7 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(out, ref, atol=atol_f32)


def make_banded(rng, r=16, m=4, ns_tiles=16, halo_every=5):
    """Band-limited block structure with occasional halo columns (the JAX
    suite's generator)."""
    blk_cols = np.zeros((1, r, m), np.int32)
    blk_mask = np.zeros((1, r, m), np.float32)
    for ri in range(r):
        lo, hi = max(0, ri - 2), min(ns_tiles - 1, ri + 1)
        cand = list(range(lo, hi + 1))
        nreal = int(rng.integers(1, min(m, len(cand)) + 1))
        cols = sorted(rng.choice(cand, size=nreal, replace=False).tolist())
        if halo_every and ri % halo_every == 0 and nreal < m:
            cols, nreal = cols + [ns_tiles], nreal + 1
        blk_cols[0, ri, :nreal] = cols
        blk_mask[0, ri, :nreal] = 1.0
    vals = (rng.uniform(size=(1, r, m, T, T)) > 0.7).astype(np.int8)
    return blk_cols, blk_mask, vals * blk_mask[..., None, None].astype(np.int8)


def make_banded_big_halo(rng, r=16, m=4, ns_tiles=16, h_total=12):
    """Halo columns drifting through MANY tiles (> H_BAND_MAX) but narrow
    per super tile: the multi-shard shape (the JAX suite's generator)."""
    blk_cols = np.zeros((1, r, m), np.int32)
    blk_mask = np.zeros((1, r, m), np.float32)
    s_count = r // bk.G_BAND
    for ri in range(r):
        lo, hi = max(0, ri - 2), min(ns_tiles - 1, ri + 1)
        cols = sorted(rng.choice(range(lo, hi + 1), size=2,
                                 replace=False).tolist())
        si = ri // bk.G_BAND
        drift = (si * (h_total - 2)) // max(s_count - 1, 1)
        hcol = ns_tiles + min(drift + (ri % 2), h_total - 1)
        blk_cols[0, ri, :3] = cols + [hcol]
        blk_mask[0, ri, :3] = 1.0
    vals = (rng.uniform(size=(1, r, m, T, T)) > 0.7).astype(np.int8)
    return blk_cols, blk_mask, vals * blk_mask[..., None, None].astype(np.int8)


# ---------------------------------------------------------------------------
# B8
# ---------------------------------------------------------------------------

BANDED_CASES = ["tail_in_x", "halo", "halo_windows", "acc_split",
                "acc_halo_windows", "epilogue", "epilogue_halo_windows"]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BANDED_CASES)
def test_banded_plain_matches_pallas(dt, case):
    # a seed per case that repeats across runs (str hashes do not)
    rng = np.random.default_rng(BANDED_CASES.index(case))
    ns_tiles, f = 16, (128 if ("acc" in case or "epi" in case) else 70)
    windows = "windows" in case
    if windows:
        h_total = 12
        blk_cols, blk_mask, vals = make_banded_big_halo(rng, h_total=h_total)
        win, hwin = bk.band_window_table_halo(blk_cols[0], blk_mask[0],
                                              ns_tiles, h_total)
        hwin = hwin[None]
    else:
        h_total = 1
        blk_cols, blk_mask, vals = make_banded(rng)
        win, hwin = bk.band_window_table(blk_cols[0], blk_mask[0],
                                         ns_tiles), None
    tdt, jdt = getattr(torch, dt), getattr(jnp, dt)
    x = rng.normal(size=(1, ns_tiles * T, f)).astype(np.float32)
    halo = rng.normal(size=(1, h_total * T, f)).astype(np.float32)
    kw_t, kw_j = {}, {}
    if case == "tail_in_x":
        x = np.concatenate([x, halo], axis=1)
    else:
        kw_t["halo"], kw_j["halo"] = _t(halo, tdt), _jnp(halo, jdt)
    if windows:
        kw_t["halo_win"], kw_j["halo_win"] = _t(hwin), jnp.asarray(hwin)
    if case.startswith("acc"):
        na = (12 if case == "acc_split" else 16) * T
        acc = rng.normal(size=(1, na, f)).astype(np.float32)
        if case == "acc_split":  # acc rows + the tail rows past them
            x = np.concatenate([x, halo], axis=1)
            kw_t.pop("halo"), kw_j.pop("halo")
        kw_t["acc"], kw_j["acc"] = _t(acc, tdt), _jnp(acc, jdt)
    if case.startswith("epilogue"):
        sw = np.zeros((1, 16 * T, 128), np.float32)
        sw[0, :, 0] = rng.normal(size=16 * T)
        sw[0, :, 1] = rng.normal(size=16 * T)
        kw_t["epilogue_sw"], kw_j["epilogue_sw"] = _t(sw, tdt), _jnp(sw, jdt)
    out = tbsr.bsr_matmul_banded(
        _t(vals), _t(blk_cols), _t(win)[None], _t(x, tdt), ns_tiles * T,
        blk_mask=_t(blk_mask), **kw_t)
    ref = jax.jit(lambda *a: bk.bsr_matmul_banded(
        *a, ns_rows=ns_tiles * T, **kw_j))(
        jnp.asarray(vals), jnp.asarray(blk_cols), jnp.asarray(win)[None],
        _jnp(x, jdt))
    if isinstance(ref, (tuple, list)):
        assert isinstance(out, tuple) and len(out) == len(ref)
        for o, r in zip(out, ref):
            assert o.dtype == tdt
            _close(_np(o), r, dt, 2e-4)
    else:
        assert out.dtype == tdt and tuple(out.shape) == ref.shape
        _close(_np(out), ref, dt, 2e-4)


def test_banded_window_contract_is_checked():
    """A live block outside its super tile's window: the TPU kernel clips the
    tile offset and multiplies another x tile (its result differs from the
    block product), so the port refuses the operator — plain version and
    wrapper — naming the count; a block at the same slot with a zero value
    is harmless and passes."""
    rng = np.random.default_rng(0)
    ns_tiles, f = 32, 64
    blk_cols, blk_mask, vals = make_banded(rng, r=16, ns_tiles=ns_tiles,
                                           halo_every=0)
    win = bk.band_window_table(blk_cols[0], blk_mask[0], ns_tiles)
    # row tile 0's last slot moves to column tile 31: outside [0, 16)
    blk_cols[0, 0, 3], blk_mask[0, 0, 3] = 31, 1.0
    vals[0, 0, 3] = (rng.uniform(size=(T, T)) > 0.5).astype(np.int8)
    x = rng.normal(size=(1, ns_tiles * T, f)).astype(np.float32)
    tpu = jax.jit(lambda *a: bk.bsr_matmul_banded(*a, ns_rows=ns_tiles * T))(
        jnp.asarray(vals), jnp.asarray(blk_cols), jnp.asarray(win)[None],
        jnp.asarray(x))
    true = jax.jit(bk.bsr_matmul)(jnp.asarray(vals), jnp.asarray(blk_cols),
                                  jnp.asarray(x))
    assert not np.allclose(np.asarray(tpu), np.asarray(true), atol=1e-3)
    args = (_t(vals), _t(blk_cols), _t(win)[None], _t(x), ns_tiles * T)
    for fn in (tbsr.bsr_matmul_banded, tbsr.bsr_matmul_banded_plain):
        with pytest.raises(ValueError, match="1 live block slots"):
            fn(*args)
        with pytest.raises(ValueError, match="1 live block slots"):
            fn(*args, blk_mask=_t(blk_mask))
        # a caller that held its tables once (the slide path) skips it
        np.testing.assert_allclose(
            fn(*args, check_windows=False).numpy(), np.asarray(true),
            atol=2e-4)
    vals[0, 0, 3] = 0  # a zero block there computes nothing: accepted
    tbsr.bsr_matmul_banded(_t(vals), *args[1:])
    bad = tbsr.band_window_violations(
        _t(blk_cols), _t(blk_mask) > 0, _t(win)[None], ns_tiles, 0)
    assert bad.sum() == 1 and bool(bad[0, 0, 3])


def test_banded_rejects_bad_arguments():
    rng = np.random.default_rng(1)
    blk_cols, blk_mask, vals = make_banded(rng)
    win = _t(bk.band_window_table(blk_cols[0], blk_mask[0], 16))[None]
    x = _t(rng.normal(size=(1, 17 * T, 64)).astype(np.float32))
    args = (_t(vals), _t(blk_cols), win)
    with pytest.raises(ValueError, match="multiple of 128"):
        tbsr.bsr_matmul_banded(*args, x, 16 * T, acc=torch.zeros(1, 512, 64))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tbsr.bsr_matmul_banded(*args, x[..., :0].new_zeros(1, 17 * T, 128),
                               16 * T, acc=torch.zeros(1, 512, 128),
                               epilogue_sw=torch.zeros(1, 16 * T, 128))
    with pytest.raises(ValueError, match="resident"):
        tbsr.bsr_matmul_banded(*args, x[:, :16 * T], 16 * T,
                               halo=torch.zeros(1, 5 * T, 64))
    with pytest.raises(ValueError, match="neither"):
        tbsr.bsr_matmul_banded(_t(vals).float(), args[1], win,
                               x.to(torch.bfloat16), 16 * T)


# ---------------------------------------------------------------------------
# int8 B1 / B2, B4 with c_out, B9a, B9b
# ---------------------------------------------------------------------------

def test_int8_build_blocks_matches_pallas():
    rng = np.random.default_rng(2)
    n, k = 512, 6
    nbr = np.clip(np.arange(n)[:, None] + rng.integers(-150, 150, (n, k)),
                  0, n - 1).astype(np.int32)[None]
    w = (rng.uniform(size=(1, n, k)) > 0.3).astype(np.float32)
    cols, msk, _ = tbsr.bsr_block_meta(nbr[0], w[0], 8)
    out = tbsr.bsr_build_blocks(_t(nbr), _t(w), _t(cols)[None],
                                _t(msk)[None], torch.int8)
    ref = bk.bsr_build_blocks(jnp.asarray(nbr), jnp.asarray(w),
                              jnp.asarray(cols)[None], jnp.asarray(msk)[None],
                              jnp.int8)
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_int8_bsr_matmul_matches_pallas(dt):
    rng = np.random.default_rng(3)
    blk_cols, blk_mask, vals = make_banded(rng)
    x = rng.normal(size=(1, 17 * T, 40)).astype(np.float32)
    out = tbsr.bsr_matmul(_t(vals), _t(blk_cols), _t(x, getattr(torch, dt)),
                          tbsr.live_slot_counts(_t(blk_mask)))
    ref = jax.jit(bk.bsr_matmul)(jnp.asarray(vals), jnp.asarray(blk_cols),
                                 _jnp(x, getattr(jnp, dt)))
    _close(_np(out), ref, dt, 2e-4)


def _head(rng, n=256, c=300, f12=16, f3=12, nreal=200):
    g = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    return dict(x12=g(1, n, f12), x3=g(1, n, f3), kc3=g(f3, c, sc=0.5),
                b3=g(c, sc=0.1), k12=g(f12, c, sc=0.3), k3f=g(c, c, sc=0.1),
                const=g(c, sc=0.1), nreal=nreal, n=n)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_pre_lin_head_matches_pallas(dt):
    h = _head(np.random.default_rng(4))
    tdt, jdt = getattr(torch, dt), getattr(jnp, dt)
    mask = (np.arange(h["n"]) < h["nreal"]).astype(np.float32)[None]
    out = tah.assign_head_softmax_pre_lin(
        _t(h["x12"], tdt), _t(h["x3"], tdt), _t(h["kc3"]), _t(h["b3"]),
        _t(h["k12"]), _t(h["k3f"]), _t(h["const"]),
        torch.tensor([h["nreal"]], dtype=torch.int32))
    ref = jah._fwd_call_pre_lin(
        _jnp(h["x12"], jdt), _jnp(h["x3"], jdt), jnp.asarray(h["kc3"]),
        jnp.asarray(h["b3"]), jnp.asarray(h["k12"]), jnp.asarray(h["k3f"]),
        jnp.asarray(h["const"]), jnp.asarray(mask))
    assert out.dtype == tdt
    _close(_np(out), ref, dt, 2e-6)
    assert not out[0, h["nreal"]:].any()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_stats_lin_matches_pallas(dt):
    h = _head(np.random.default_rng(5))
    tdt, jdt = getattr(torch, dt), getattr(jnp, dt)
    mask = (np.arange(h["n"]) < h["nreal"]).astype(np.float32)[None]
    out = tah.l2relu_stats_lin(
        _t(h["x3"], tdt), _t(h["kc3"]), _t(h["b3"]),
        torch.tensor([h["nreal"]], dtype=torch.int32))
    ref = jah._stats_call_lin(_jnp(h["x3"], jdt), jnp.asarray(h["kc3"]),
                              jnp.asarray(h["b3"]), jnp.asarray(mask))
    for o, r in zip(out, ref):
        r = np.asarray(r)
        tol = (1e-5 if dt == "float32" else 2e-2) * np.abs(r).max()
        np.testing.assert_allclose(_np(o), r, rtol=1e-5, atol=tol)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_head_c_out_matches_pallas(dt):
    h = _head(np.random.default_rng(6))
    tdt, jdt = getattr(torch, dt), getattr(jnp, dt)
    p = np.asarray(h["x3"] @ h["kc3"] + h["b3"], np.float32)
    mask = (np.arange(h["n"]) < h["nreal"]).astype(np.float32)[None]
    s, s_t = tah.assign_head_softmax_pre(
        _t(h["x12"], tdt), _t(p, tdt), _t(h["k12"]), _t(h["k3f"]),
        _t(h["const"]), torch.tensor([h["nreal"]], dtype=torch.int32),
        c_out=384)
    ref, _ = jah._fwd_call_pre(
        _jnp(h["x12"], jdt), _jnp(p, jdt), jnp.asarray(h["k12"]),
        jnp.asarray(h["k3f"]), jnp.asarray(h["const"]), jnp.asarray(mask),
        c_out=384)
    assert tuple(s.shape) == (1, h["n"], 384) and s_t.shape[1] == 384
    _close(_np(s), ref, dt, 2e-6)
    assert (s[..., 300:] == 0).all()
    with pytest.raises(ValueError, match="c_out"):
        tah.assign_head_softmax_pre(
            _t(h["x12"]), _t(p), _t(h["k12"]), _t(h["k3f"]), _t(h["const"]),
            torch.tensor([h["nreal"]], dtype=torch.int32), c_out=200)


def test_pick_chunk_and_plan_match():
    for nrows, target in ((100352, 65536), (512, 384), (512, 100),
                          (300, 128), (1024, 4096)):
        assert tah.pick_chunk(nrows, target) == jah.pick_chunk(nrows, target)
    assert tah.chunk_plan(100352, 65536) == (65536, 1, 34816) == \
        jah._chunk_plan(100352, 65536)


# ---------------------------------------------------------------------------
# the tails (values and VJPs) against JAX under a one-device shard_map
# ---------------------------------------------------------------------------

def _mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("graph",))


def _tail_case(rng, n=256, c=36, f12=8, f3=12, nreal=200):
    g = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    return dict(x12=g(1, n, f12), x3=g(1, n, f3), kc3=g(f3, c, sc=0.5),
                b3=g(c, sc=0.1), k12=g(f12, c), k3=g(c, c, sc=0.2),
                lb=g(c), sc=(1.0 + g(c, sc=0.2)), bi=g(c, sc=0.1),
                ds=g(1, n, c), n=n, nreal=nreal)


def _jax_tail(fn, names, h, **kw):
    """(outputs, grads of sum(S * ds) w.r.t. ``names``) of a JAX tail run
    under a one-device shard_map over 'graph'."""
    mask = jnp.asarray((np.arange(h["n"]) < h["nreal"])[None], jnp.float32)
    ds = jnp.asarray(h["ds"])

    def run(*vals):
        args = dict(zip(names, vals))

        def body(*v):
            a = dict(zip(names, v))
            n_glob = jax.lax.psum(jnp.sum(mask), "graph")
            return fn(a, mask, n_glob)

        return jax.shard_map(body, mesh=_mesh1(), in_specs=P(),
                             out_specs=P(), check_vma=False)(
            *[args[k] for k in names])

    def loss(*v):
        outs = run(*v)
        c = ds.shape[-1]
        return jnp.sum(outs[0][..., :c].astype(jnp.float32) * ds), outs

    vals = [jnp.asarray(h[k]) for k in names]
    (_, outs), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(names))), has_aux=True))(*vals)
    return outs, grads


@pytest.mark.parametrize("c_out", [None, 128])
def test_psum_tail_matches_jax(c_out):
    rng = np.random.default_rng(7)
    h = _tail_case(rng)
    names = ("x12", "x3", "k12", "k3", "lb", "sc", "bi")
    p_of = lambda a: a["x3"] @ a.get("kc3", jnp.asarray(h["kc3"]))

    def jfn(a, mask, n_glob):
        p = a["x3"] @ jnp.asarray(h["kc3"])
        return jah.assign_tail_train_psum(
            a["x12"], p, a["k12"], a["k3"], a["lb"], a["sc"], a["bi"], mask,
            n_glob, 1e-5, "graph", c_out)

    (s_j, _, mean_j, var_j), g_j = _jax_tail(jfn, names, h)
    del p_of
    tv = {k: _t(h[k], grad=True) for k in names}
    p = tv["x3"] @ _t(h["kc3"])
    n_nodes = torch.tensor([h["nreal"]], dtype=torch.int32)
    s, mean, var = tah.assign_tail_train_psum(
        tv["x12"], p, tv["k12"], tv["k3"], tv["lb"], tv["sc"], tv["bi"],
        n_nodes, torch.tensor(float(h["nreal"])), 1e-5, c_out)
    np.testing.assert_allclose(_np(s), np.asarray(s_j), atol=2e-6)
    np.testing.assert_allclose(_np(mean), np.asarray(mean_j), atol=1e-6)
    np.testing.assert_allclose(_np(var), np.asarray(var_j), atol=1e-6)
    if c_out:
        assert (s[..., 36:] == 0).all()
    loss = torch.sum(s[..., :36] * _t(h["ds"]))
    g_t = torch.autograd.grad(loss, [tv[k] for k in names])
    for name, gt, gj in zip(names, g_t, g_j):
        np.testing.assert_allclose(_np(gt), np.asarray(gj), atol=5e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("chunk", [128, 640])
def test_chunked_lin_tail_matches_jax(chunk):
    """Values and every gradient, the absorbed lin's (dx3, dkc3, db3)
    included; 640 over 768 rows leaves a remainder chunk of 128."""
    rng = np.random.default_rng(8)
    h = _tail_case(rng, n=256 if chunk == 128 else 768,
                   nreal=200 if chunk == 128 else 700)
    names = ("x12", "x3", "kc3", "b3", "k12", "k3", "lb", "sc", "bi")

    def jfn(a, mask, n_glob):
        return jah.assign_tail_train_chunked_lin(
            a["x12"], a["x3"], a["kc3"], a["b3"], a["k12"], a["k3"], a["lb"],
            a["sc"], a["bi"], mask, n_glob, 1e-5, "graph", chunk)

    (s_j, _, mean_j, var_j), g_j = _jax_tail(jfn, names, h)
    tv = {k: _t(h[k], grad=True) for k in names}
    s, mean, var = tah.assign_tail_train_chunked_lin(
        tv["x12"], tv["x3"], tv["kc3"], tv["b3"], tv["k12"], tv["k3"],
        tv["lb"], tv["sc"], tv["bi"],
        torch.tensor([h["nreal"]], dtype=torch.int32),
        torch.tensor(float(h["nreal"])), 1e-5, chunk)
    np.testing.assert_allclose(_np(s), np.asarray(s_j), atol=2e-6)
    np.testing.assert_allclose(_np(mean), np.asarray(mean_j), atol=1e-6)
    np.testing.assert_allclose(_np(var), np.asarray(var_j), atol=1e-6)
    g_t = torch.autograd.grad(torch.sum(s * _t(h["ds"])),
                              [tv[k] for k in names])
    for name, gt, gj in zip(names, g_t, g_j):
        np.testing.assert_allclose(_np(gt), np.asarray(gj), atol=5e-5,
                                   rtol=1e-4, err_msg=name)


def test_chunked_pool_contract_matches_jax():
    rng = np.random.default_rng(9)
    n, c, f = 512, 40, 12
    s, pe, a_s = (rng.normal(size=(n, w)).astype(np.float32)
                  for w in (c, f, c))
    ct_x = rng.normal(size=(c, f)).astype(np.float32)
    ct_a = rng.normal(size=(c, c)).astype(np.float32)
    for chunk in (n, 128, 200):
        tv = [_t(a, grad=True) for a in (s, pe, a_s)]
        xp, ap = tmm.ChunkedPoolContract.apply(*tv, chunk)
        (xj, aj), vjp = jax.vjp(
            lambda *v: jmm._chunked_pool_contract(*v, chunk),
            jnp.asarray(s), jnp.asarray(pe), jnp.asarray(a_s))
        np.testing.assert_allclose(_np(xp), np.asarray(xj), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(_np(ap), np.asarray(aj), rtol=1e-5,
                                   atol=1e-4)
        g_t = torch.autograd.grad((xp, ap), tv, (_t(ct_x), _t(ct_a)))
        g_j = vjp((jnp.asarray(ct_x), jnp.asarray(ct_a)))
        for gt, gj in zip(g_t, g_j):
            gj = np.asarray(gj)
            np.testing.assert_allclose(_np(gt), gj, rtol=2e-4,
                                       atol=2e-4 * np.abs(gj).max())
