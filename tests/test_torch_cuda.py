"""PyTorch port, card only: each hand-written CUDA kernel (B1-B9b) against
its plain PyTorch version on the same CUDA tensors, and the backward
Functions around them against the CPU, at small shapes.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch; skips without a CUDA device. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances are fractions of max|plain|: f32 — B1 exact (same f32 sums in
the same slot order; int8 too), B2 1e-4, B3 1e-5, B4 1e-5, B5 1e-4, B6
1e-5, B7 1e-4, B8 1e-4, B9a 1e-5, B9b 1e-5 (sums in another order); bf16 — the two roundings of the stored result may land one bf16
step apart, up to 2^-7 of the value, so 2^-6. B9b in bf16 is also held
against the exact (f64) statistics at ops/assign_head.STATS_TOL, and B5's
rows past n_nodes are held to be exact zeros. B3's row norm is held bit
for bit to B4's on the same p, and B1 bit for bit to its plain version
computed on the CPU (on the card the plain version's scatter adds a
column's slots in no fixed order). B7 and B8's gather kernel are also
held bit for bit (``torch.equal``) on exact data: small integers and
multiples of 1/8, whose sums are exact in any order. Gradients, card vs CPU:
1e-4 of max|grad| (f32 sums in another order through the same formulas).
"""

import numpy as np
import pytest
import torch

from cgcnet_tpu_torch.core.convert import transpose_ell_np
from cgcnet_tpu_torch.ops import assign_head as ah
from cgcnet_tpu_torch.ops import bsr
from cgcnet_tpu_torch.ops.ell import bsr_matmul_precomp, bsr_spmm_factored
from cgcnet_tpu_torch.ops.knn import radius_knn_np

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _graph(seed=0, b=2, cap=1024, k=8):
    """Radius-kNN over spatially sorted random nuclei, with the norm_adj
    stage-1 weights and BSR metadata (numpy, the port's host helpers)."""
    rng = np.random.default_rng(seed)
    nbrs, ws, cols, masks, nns = [], [], [], [], []
    for _ in range(b):
        n = int(rng.integers(int(cap * 0.7), cap + 1))
        pos = rng.uniform(0, 60 * np.sqrt(n), (n, 2)).astype(np.float32)
        pos = pos[np.lexsort((pos[:, 1], np.floor(pos[:, 0] / 100.0)))]
        nbr, m = radius_knn_np(pos, 100.0, k)
        own = np.arange(n, cap, dtype=np.int32)[:, None]
        nbr = np.concatenate([nbr, np.tile(own, (1, k))])
        m = np.concatenate([m, np.zeros((cap - n, k), np.float32)])
        is_self = (nbr == np.arange(cap)[:, None]) * m
        off = m - is_self
        valid = (np.arange(cap) < n).astype(np.float32)
        scale = 0.6 / (off.sum(-1) + 1e-15) * valid
        w = (scale[:, None] * off + (0.4 * valid)[:, None] * is_self).astype(np.float32)
        c, bm, _ = bsr.bsr_block_meta(nbr, m, 8)
        for lst, a in zip((nbrs, ws, cols, masks), (nbr, w, c, bm)):
            lst.append(a)
        nns.append(n)
    return [
        torch.from_numpy(np.stack(a).astype(a[0].dtype))
        for a in (nbrs, ws, cols, masks)
    ] + [
        torch.tensor(nns, dtype=torch.int32)
    ]


def _close(out, ref, tol):
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(device, dtype):
    nbr, w, cols, masks, n_nodes = (t.to(device) for t in _graph())
    tol_mm = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    tol_head = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    launches = bsr.bsr_build_blocks.launches
    vals = bsr.bsr_build_blocks(nbr, w, cols, masks, dtype)
    assert bsr.bsr_build_blocks.launches == launches + 1
    torch.testing.assert_close(
        vals, bsr.bsr_build_blocks_plain(nbr, w, cols, masks, dtype),
        rtol=0, atol=0,
    )
    gen = torch.Generator(device=device).manual_seed(0)
    slots = bsr.live_slot_counts(masks)
    for f, extra in ((18, 0), (40, 0), (300, 0), (40, 128)):
        x = torch.randn(2, 1024 + extra, f, device=device, generator=gen).to(dtype)
        _close(bsr.bsr_matmul(vals, cols, x, slots),
               bsr.bsr_matmul_plain(vals, cols, x), tol_mm)
    c, f12 = 204, 16
    x12 = torch.randn(2, 1024, f12, device=device, generator=gen).to(dtype)
    p = torch.randn(2, 1024, c, device=device, generator=gen).to(dtype)
    p[0, 3] = 0  # all-zero row: rnorm clamps
    k12 = torch.randn(f12, c, device=device, generator=gen)
    k3f = torch.randn(c, c, device=device, generator=gen) * 0.2
    const = torch.randn(c, device=device, generator=gen)
    s, s_t = ah.assign_head_softmax_pre(x12, p, k12, k3f, const, n_nodes)
    s_ref, _ = ah.assign_head_softmax_pre_plain(x12, p, k12, k3f, const, n_nodes)
    _close(s, s_ref, tol_head)
    assert torch.equal(s_t, s.transpose(1, 2))
    for bi, nn in enumerate(n_nodes.tolist()):
        assert not s[bi, nn:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tail_kernels_match_plain(device, dtype):
    """B3 and B5 at a C that is no multiple of 128, with rows past n_nodes
    (where p is not zero) and an all-zero row."""
    tol_stats = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    tol_bwd = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    gen = torch.Generator(device=device).manual_seed(1)
    c = 204
    n_nodes = torch.tensor([1024 - 37, 517], dtype=torch.int32, device=device)
    p = torch.randn(2, 1024, c, device=device, generator=gen).to(dtype)
    p[0, 3] = 0
    launches = ah.l2relu_stats.launches
    ssum, ssq = ah.l2relu_stats(p, n_nodes)
    assert ah.l2relu_stats.launches == launches + 1
    rsum, rsq = ah.l2relu_stats_plain(p, n_nodes)
    _close(ssum, rsum, tol_stats)
    _close(ssq, rsq, tol_stats)
    # fixed reduction order: the same bits run to run
    again = ah.l2relu_stats(p, n_nodes)
    assert torch.equal(again[0], ssum) and torch.equal(again[1], ssq)
    rows = torch.arange(1024, device=device)[None, :] < n_nodes.long()[:, None]
    dh = (torch.randn(2, 1024, c, device=device, generator=gen)
          * rows[..., None]).to(dtype)
    u = torch.randn(c, device=device, generator=gen)
    w = torch.randn(c, device=device, generator=gen)
    launches = ah.assign_tail_bwd.launches
    dp = ah.assign_tail_bwd(p, dh, u, w, n_nodes)
    assert ah.assign_tail_bwd.launches == launches + 1
    assert dp.dtype == dtype
    _close(dp, ah.assign_tail_bwd_plain(p, dh, u, w, n_nodes), tol_bwd)
    assert not dp[~rows].any()


def _grads_close(outs_gpu, outs_cpu):
    for g, r in zip(outs_gpu, outs_cpu):
        _close(g.cpu(), r, 1e-4)


def test_backward_matches_cpu(device):
    """AssignTailTrain (B3 + B4 forward, B5 backward) and BsrMatmulPrecomp
    (B2 both ways) on the card against the same Functions on the CPU."""
    rng = np.random.default_rng(2)
    b, n, f12, c = 2, 1024, 16, 204
    n_nodes = np.array([1000, 613], np.int32)
    mask = (np.arange(n)[None] < n_nodes[:, None]).astype(np.float32)
    arrays = [
        rng.normal(size=(b, n, f12)).astype(np.float32) * mask[..., None],
        rng.normal(size=(b, n, c)).astype(np.float32),
        rng.normal(size=(f12, c)).astype(np.float32),
        (rng.normal(size=(c, c)) * 0.2).astype(np.float32),
        rng.normal(size=(c,)).astype(np.float32),
        rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32),
        rng.normal(size=(c,)).astype(np.float32),
    ]
    ct = rng.normal(size=(b, n, c)).astype(np.float32)

    def run(dev):
        ins = [torch.from_numpy(a).to(dev).requires_grad_(True) for a in arrays]
        nn_t = torch.from_numpy(n_nodes).to(dev)
        cnt = torch.tensor(float(n_nodes.sum()), device=dev)
        s, mean, var = ah.AssignTailTrain.apply(*ins, nn_t, cnt, 1e-5)
        torch.sum(s * torch.from_numpy(ct).to(dev)).backward()
        return [s.detach(), mean, var] + [t.grad for t in ins]

    _grads_close(run(device), run("cpu"))

    nbr, w, cols, masks, nn_ = _graph(seed=3)
    scale = torch.rand(2, 1024)
    self_w = torch.rand(2, 1024)
    x0 = torch.randn(2, 1024, 40)
    g0 = torch.randn(2, 1024, 40)

    def run_bsr(dev):
        args = [t.to(dev) for t in (nbr, w, cols, masks)]
        vals = bsr.bsr_build_blocks(*args)
        vals_t = bsr.bsr_build_blocks(args[0], (args[1] > 0).float(),
                                      args[2], args[3])
        x = x0.to(dev).requires_grad_(True)
        slots = bsr.live_slot_counts(args[3])
        out = bsr_matmul_precomp(vals, args[2], vals_t, args[2],
                                 scale.to(dev), self_w.to(dev), x, slots,
                                 slots)
        torch.sum(out * g0.to(dev)).backward()
        return [out.detach(), x.grad]

    launches = bsr.bsr_matmul.launches
    got = run_bsr(device)
    assert bsr.bsr_matmul.launches == launches + 2  # forward and backward
    _grads_close(got, run_bsr("cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b6_b7_match_plain(device, dtype):
    """B6 at a C that is no multiple of 128, rows past n_nodes exactly 0;
    B7 at every width class against its plain version and against B1 -> B2
    on the same blocks (the same f32 block sums, rounded alike)."""
    tol_head = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    tol_mm = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    gen = torch.Generator(device=device).manual_seed(3)
    n_nodes = torch.tensor([1024 - 37, 517], dtype=torch.int32, device=device)
    rows = torch.arange(1024, device=device)[None, :] < n_nodes.long()[:, None]
    c, f12 = 204, 16
    x12 = (torch.randn(2, 1024, f12, device=device, generator=gen)
           * rows[..., None]).to(dtype)
    h3a = (torch.randn(2, 1024, c, device=device, generator=gen)
           * rows[..., None]).to(dtype)
    k12 = torch.randn(f12, c, device=device, generator=gen)
    k3f = torch.randn(c, c, device=device, generator=gen) * 0.2
    const = torch.randn(c, device=device, generator=gen)
    launches = ah.assign_head_softmax.launches
    s = ah.assign_head_softmax(x12, h3a, k12, k3f, const, n_nodes)
    assert ah.assign_head_softmax.launches == launches + 1
    assert s.dtype == dtype
    _close(s, ah.assign_head_softmax_plain(x12, h3a, k12, k3f, const, n_nodes),
           tol_head)
    assert not s[~rows].any()

    nbr, w, cols, masks, _ = (t.to(device) for t in _graph(seed=4))
    off = (w > 0).float() * (nbr != torch.arange(1024, device=device)[None, :, None])
    for f, extra in ((18, 0), (40, 0), (300, 0), (40, 128)):
        x = torch.randn(2, 1024 + extra, f, device=device, generator=gen).to(dtype)
        for weights in (w, off):
            launches = bsr.bsr_gather_sum.launches
            out = bsr.bsr_gather_sum(nbr, weights, cols, masks, x)
            assert bsr.bsr_gather_sum.launches == launches + 1
            assert out.shape == (2, 1024, f) and out.dtype == dtype
            _close(out, bsr.bsr_gather_sum_plain(nbr, weights, cols, masks, x),
                   tol_mm)
            vals = bsr.bsr_build_blocks(nbr, weights, cols, masks, dtype)
            _close(out, bsr.bsr_matmul(vals, cols, x,
                                       bsr.live_slot_counts(masks)), tol_mm)


def test_b6_b7_backward_matches_cpu(device):
    """AssignHeadSoftmax (B6 forward) and BsrSpmmFactored (B7 both ways) on
    the card against the same Functions on the CPU."""
    rng = np.random.default_rng(5)
    b, n, f12, c = 2, 1024, 16, 204
    n_nodes = np.array([1000, 613], np.int32)
    mask = (np.arange(n)[None] < n_nodes[:, None]).astype(np.float32)[..., None]
    arrays = [
        rng.normal(size=(b, n, f12)).astype(np.float32) * mask,
        rng.normal(size=(b, n, c)).astype(np.float32) * mask,
        rng.normal(size=(f12, c)).astype(np.float32),
        (rng.normal(size=(c, c)) * 0.2).astype(np.float32),
        rng.normal(size=(c,)).astype(np.float32),
    ]
    ct = rng.normal(size=(b, n, c)).astype(np.float32)

    def run(dev):
        ins = [torch.from_numpy(a).to(dev).requires_grad_(True) for a in arrays]
        s = ah.AssignHeadSoftmax.apply(*ins, torch.from_numpy(n_nodes).to(dev))
        torch.sum(s * torch.from_numpy(ct).to(dev)).backward()
        return [s.detach()] + [t.grad for t in ins]

    _grads_close(run(device), run("cpu"))

    nbr, w, cols, masks, _ = _graph(seed=6)
    off = (w > 0).float()
    scale = torch.rand(2, 1024)
    self_w = torch.rand(2, 1024)
    x0 = torch.randn(2, 1024, 40)
    g0 = torch.randn(2, 1024, 40)

    def run_b7(dev):
        # the forward lists stand in for the transpose tables (card and CPU
        # get the same ones)
        args = [t.to(dev) for t in (nbr, off, cols, masks)]
        x = x0.to(dev).requires_grad_(True)
        out = bsr_spmm_factored(*args, *args, scale.to(dev), self_w.to(dev), x)
        torch.sum(out * g0.to(dev)).backward()
        return [out.detach(), x.grad]

    launches = bsr.bsr_gather_sum.launches
    got = run_b7(device)
    assert bsr.bsr_gather_sum.launches == launches + 2  # forward and backward
    _grads_close(got, run_b7("cpu"))


# ---------------------------------------------------------------------------
# the whole-slide kernels: B8, B9a, B9b, int8 B1/B2, B4 with c_out
# ---------------------------------------------------------------------------

def _banded(seed, r=16, m=4, ns_tiles=16, h_total=1):
    """Band-limited int8 blocks with halo columns in [ns_tiles, +h_total)."""
    rng = np.random.default_rng(seed)
    cols = np.zeros((1, r, m), np.int32)
    mask = np.zeros((1, r, m), np.float32)
    for ri in range(r):
        cand = list(range(max(0, ri - 2), min(ns_tiles - 1, ri + 1) + 1))
        sel = sorted(rng.choice(cand, size=min(2, len(cand)),
                                replace=False).tolist())
        sel.append(ns_tiles + (ri // 4) * (h_total - 1) // max(r // 4 - 1, 1))
        cols[0, ri, :len(sel)] = sel
        mask[0, ri, :len(sel)] = 1.0
    vals = ((rng.uniform(size=(1, r, m, 128, 128)) > 0.7)
            * mask[..., None, None]).astype(np.int8)
    return cols, mask, vals


def _close_to(out, ref, tol):
    """``_close`` with the CPU reference moved to the output's device."""
    if isinstance(out, tuple):
        for o, r in zip(out, ref):
            _close(o, r.to(o.device), tol)
    else:
        _close(out, ref.to(out.device), tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slide_kernels_match_plain(device, dtype):
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    tol9 = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen)
    # B8: resident halo tail (and the tail inside x), acc with split outputs,
    # the epilogue, halo windows
    cols, mask, vals = _banded(1)
    win = torch.from_numpy(bsr.band_window_table(cols[0], mask[0], 16))[None]
    c, m, v = (torch.from_numpy(a) for a in (cols, mask, vals))
    x, halo = rnd(1, 16 * 128, 1152).to(dtype), rnd(1, 128, 1152).to(dtype)
    acc = rnd(1, 3 * 512, 1152).to(dtype)
    sw = torch.zeros(1, 16 * 128, 128)
    sw[0, :, 0], sw[0, :, 1] = rnd(16 * 128), 0.4
    xx = torch.cat([x, halo], 1)
    cases = [
        ((v, c, win, x, 2048), {"halo": halo}),
        ((v, c, win, xx, 2048), {}),
        ((v, c, win, xx, 2048), {"acc": acc}),
        ((v, c, win, x, 2048), {"halo": halo, "epilogue_sw": sw.to(dtype)}),
    ]
    cols_h, mask_h, vals_h = _banded(2, h_total=12)
    tabs = bsr.band_window_table_halo(cols_h[0], mask_h[0], 16, 12)
    assert tabs is not None
    ch, vh = torch.from_numpy(cols_h), torch.from_numpy(vals_h)
    cases.append(((vh, ch, torch.from_numpy(tabs[0])[None], x, 2048),
                  {"halo": rnd(1, 12 * 128, 1152).to(dtype),
                   "halo_win": torch.from_numpy(tabs[1])[None]}))
    for args, kw in cases:
        ref = bsr.bsr_matmul_banded_plain(*args, **kw)
        out = bsr.bsr_matmul_banded(
            *(a.to(device) if isinstance(a, torch.Tensor) else a
              for a in args),
            **{k: t.to(device) for k, t in kw.items()})
        _close_to(out, ref, tol)
    # int8 B1 and B2
    g = _graph(3)
    nbr, w, bcols, bmask = g[:4]
    ref = bsr.bsr_build_blocks_plain(nbr, w, bcols, bmask, torch.int8)
    out = bsr.bsr_build_blocks(nbr.to(device), w.to(device),
                               bcols.to(device), bmask.to(device), torch.int8)
    _close_to(out, ref, 0.0)
    xb = rnd(*nbr.shape[:2], 40).to(dtype)
    _close_to(bsr.bsr_matmul(out, bcols.to(device), xb.to(device),
                             bsr.live_slot_counts(bmask).to(device)),
              bsr.bsr_matmul_plain(ref, bcols, xb), tol)
    # B9a, B9b, B4 with c_out
    n, f12, f3, cc = 512, 40, 20, 1140
    x12, x3 = rnd(1, n, f12).to(dtype), rnd(1, n, f3).to(dtype)
    kc3, b3 = rnd(f3, cc) * 0.3, rnd(cc) * 0.1
    k12, k3f, const = rnd(f12, cc) * 0.2, rnd(cc, cc) * 0.05, rnd(cc) * 0.1
    nn_ = torch.tensor([450], dtype=torch.int32)
    args = (x12, x3, kc3, b3, k12, k3f, const, nn_)
    dev = [a.to(device) for a in args]
    _close_to(ah.assign_head_softmax_pre_lin(*dev),
              ah.assign_head_softmax_pre_lin_plain(*args), tol9)
    for o, r in zip(ah.l2relu_stats_lin(*(dev[i] for i in (1, 2, 3, 7))),
                    ah.l2relu_stats_lin_plain(*(args[i] for i in (1, 2, 3, 7)))):
        _close_to(o, r, tol9)
    p = ah.lin_p(x3, kc3, b3)
    hargs = (x12, p, k12, k3f, const, nn_)
    s, _ = ah.assign_head_softmax_pre(*(a.to(device) for a in hargs),
                                      c_out=1152)
    _close_to(s, ah.assign_head_softmax_pre_plain(*hargs, 1152)[0], tol9)
    assert not s[..., cc:].any()


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernels (B8; B4, B6 and B9a's product) at their edges
# ---------------------------------------------------------------------------

def _kernel_names(fn, want=(), reject=(), tries: int = 3,
                  empty_tries: int = 8) -> list[str]:
    """Names of the CUDA kernels ``fn`` launches (torch.profiler trace), each
    trace from a fresh profiler after a ``torch.cuda.synchronize()``. A
    trace that names a kernel containing one of ``reject`` is returned at
    once (the caller's assertion fails on it). The profiler drops an event
    now and then, so a trace that lacks one of ``want`` (the names the
    caller asserts) is taken again, up to ``tries`` times, and a trace with
    no device event at all up to ``empty_tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    partial = empty = 0
    while True:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if any(r in n for r in reject for n in names):
            return names
        if names and all(any(w in n for n in names) for w in want):
            return names
        if names:
            partial += 1
        else:
            empty += 1
        if partial >= tries or empty >= empty_tries:
            return names


def _variants(wrapper, fn) -> dict:
    """The kernels ``wrapper`` records (its ``variants``) as launched while
    ``fn`` runs, with their counts."""
    before = dict(wrapper.variants)
    fn()
    return {k: n - before.get(k, 0) for k, n in wrapper.variants.items()
            if n != before.get(k, 0)}


@pytest.mark.parametrize("f", [1140, 1152])
def test_banded_tensor_cores_match_plain(device, f):
    """bf16 B8 at the slide's widths (16-byte copies at 1152, 8-byte at
    1140, a ragged last column chunk at 1140) against its plain version:
    dead slots after each row tile's live ones and one before a live slot,
    the live slot count given and not given, the row accumulator with split
    outputs (F a multiple of 128 only), the epilogue, halo windows."""
    tol = 2.0 ** -6
    gen = torch.Generator().manual_seed(f)
    rnd = lambda *s: torch.randn(s, generator=gen)
    cols, mask, vals = _banded(5)
    mask[0, 3, 0], vals[0, 3, 0] = 0.0, 0  # a hole before live slots
    win = torch.from_numpy(bsr.band_window_table(cols[0], mask[0], 16))[None]
    c, m, v = (torch.from_numpy(a) for a in (cols, mask, vals))
    slots = bsr.live_slot_counts(m)
    assert slots[0, 3] == 3 and int(slots.max()) < m.shape[-1]
    x, halo = rnd(1, 2048, f).bfloat16(), rnd(1, 128, f).bfloat16()
    sw = torch.zeros(1, 2048, 128)
    sw[0, :, 0], sw[0, :, 1] = rnd(2048), 0.4
    cases = [((v, c, win, x, 2048), {"halo": halo}),
             ((v, c, win, x, 2048),
              {"halo": halo, "epilogue_sw": sw.bfloat16()})]
    if f % 128 == 0:
        cases.append(((v, c, win, torch.cat([x, halo], 1), 2048),
                      {"acc": rnd(1, 3 * 512, f).bfloat16()}))
    cols_h, mask_h, vals_h = _banded(6, h_total=12)
    tabs = bsr.band_window_table_halo(cols_h[0], mask_h[0], 16, 12)
    cases.append(((torch.from_numpy(vals_h), torch.from_numpy(cols_h),
                   torch.from_numpy(tabs[0])[None], x, 2048),
                  {"halo": rnd(1, 12 * 128, f).bfloat16(),
                   "halo_win": torch.from_numpy(tabs[1])[None],
                   "blk_mask": torch.from_numpy(mask_h)}))
    for args, kw in cases:
        ref = bsr.bsr_matmul_banded_plain(*args, **kw)
        dev_args = [a.to(device) if isinstance(a, torch.Tensor) else a
                    for a in args]
        dev_kw = {k: t.to(device) for k, t in kw.items()}
        counts = [None, bsr.live_slot_counts(
            kw.get("blk_mask", m).to(device))]
        for live in counts:
            launches = bsr.bsr_matmul_banded.launches
            got = {}
            ran = _variants(bsr.bsr_matmul_banded, lambda: got.update(
                out=bsr.bsr_matmul_banded(*dev_args, **dev_kw,
                                          live_slots=live)))
            assert ran == {"banded_tc_kernel": 1}, ran
            assert bsr.bsr_matmul_banded.launches == launches + 1
            _close_to(got["out"], ref, tol)
    names = _kernel_names(lambda: bsr.bsr_matmul_banded(
        *dev_args, **dev_kw, live_slots=counts[1]), ("banded_tc_kernel",),
        ("banded_kernel",))
    assert any("banded_tc_kernel" in n for n in names), names
    assert not any("banded_kernel" in n for n in names), names


def test_banded_narrow_bf16_takes_simt(device):
    """A bf16 B8 leg narrower than 128 columns (F=64) stays on the SIMT
    kernel and agrees with its plain version."""
    gen = torch.Generator().manual_seed(7)
    cols, mask, vals = _banded(7)
    win = torch.from_numpy(bsr.band_window_table(cols[0], mask[0], 16))[None]
    c, v = torch.from_numpy(cols), torch.from_numpy(vals)
    x = torch.randn(1, 2048, 64, generator=gen).bfloat16()
    halo = torch.randn(1, 128, 64, generator=gen).bfloat16()
    ref = bsr.bsr_matmul_banded_plain(v, c, win, x, 2048, halo=halo)
    args = [a.to(device) for a in (v, c, win, x)]
    run = lambda: bsr.bsr_matmul_banded(*args, 2048, halo=halo.to(device))
    _close_to(run(), ref, 2.0 ** -6)
    assert _variants(bsr.bsr_matmul_banded, run) == {"banded_kernel": 1}
    names = _kernel_names(run, ("banded_kernel",), ("banded_tc_kernel",))
    assert any("banded_kernel" in n for n in names), names
    assert not any("banded_tc_kernel" in n for n in names), names


def test_heads_tensor_cores_match_plain(device):
    """bf16 B4 (with and without ``c_out``=1152), B6 and B9a on the tensor
    cores at C=1140 against their plain versions, with n_nodes ending
    mid-tile in both graphs: rows past n_nodes and pad columns exactly 0."""
    tol = 2.0 ** -6
    gen = torch.Generator().manual_seed(11)
    rnd = lambda *s: torch.randn(s, generator=gen)
    b, n, f12, f3, cc = 2, 512, 40, 20, 1140
    x12, x3 = rnd(b, n, f12).bfloat16(), rnd(b, n, f3).bfloat16()
    kc3, b3 = rnd(f3, cc) * 0.3, rnd(cc) * 0.1
    k12, k3f, const = rnd(f12, cc) * 0.2, rnd(cc, cc) * 0.05, rnd(cc) * 0.1
    nn_ = torch.tensor([450, 300], dtype=torch.int32)
    rows = torch.arange(n)[None, :] < nn_.long()[:, None]
    p = ah.lin_p(x3, kc3, b3)
    p[0, 7] = 0  # an all-zero row: rnorm clamps
    to = lambda *a: [t.to(device) for t in a]
    heads = [
        ("B4", ah.assign_head_softmax_pre, (x12, p, k12, k3f, const, nn_),
         lambda *a: ah.assign_head_softmax_pre_plain(*a)[0], {}),
        ("B4 c_out", ah.assign_head_softmax_pre,
         (x12, p, k12, k3f, const, nn_),
         lambda *a: ah.assign_head_softmax_pre_plain(*a, 1152)[0],
         {"c_out": 1152}),
        ("B6", ah.assign_head_softmax, (x12, p, k12, k3f, const, nn_),
         ah.assign_head_softmax_plain, {}),
        ("B9a", ah.assign_head_softmax_pre_lin,
         (x12, x3, kc3, b3, k12, k3f, const, nn_),
         ah.assign_head_softmax_pre_lin_plain, {}),
    ]
    for name, fn, args, plain, kw in heads:
        launches = fn.launches
        out = fn(*to(*args), **kw)
        out = out[0] if isinstance(out, tuple) else out
        assert fn.launches == launches + 1, name
        assert out.dtype == torch.bfloat16, name
        _close_to(out, plain(*args), tol)
        assert not out[~rows.to(device)].any(), name
        assert not out[..., cc:].any(), name
        ran = _variants(fn, lambda: fn(*to(*args), **kw))
        assert ran == {"gemm_tc_kernel": 1}, (name, ran)
        names = _kernel_names(lambda: fn(*to(*args), **kw),
                              ("gemm_tc_kernel",), ("gemm_kernel",))
        assert any("gemm_tc_kernel" in k for k in names), (name, names)
        assert not any("gemm_kernel" in k for k in names), (name, names)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heads_wide_rows_match_plain(device, dtype):
    """B4 with rows wider than the register softmax takes (C > 1536): the
    softmax's pass-per-statistic kernel, against the plain version."""
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    gen = torch.Generator().manual_seed(14)
    rnd = lambda *s: torch.randn(s, generator=gen)
    b, n, f12, cc = 1, 256, 40, 1600
    args = (rnd(b, n, f12).to(dtype), rnd(b, n, cc).to(dtype),
            rnd(f12, cc) * 0.2, rnd(cc, cc) * 0.05, rnd(cc) * 0.1,
            torch.tensor([200], dtype=torch.int32))
    out, _ = ah.assign_head_softmax_pre(*[t.to(device) for t in args])
    _close_to(out, ah.assign_head_softmax_pre_plain(*args)[0], tol)
    names = _kernel_names(lambda: ah.assign_head_softmax_pre(
        *[t.to(device) for t in args]), ("softmax_kernel",))
    assert any("softmax_kernel" in k for k in names), names


def test_heads_refuse_other_padding(device, monkeypatch):
    """The bf16 head entries check the shapes of the padded copies they are
    given against their own tiling: a weight copy or a kc3^T copy padded
    otherwise is refused with a CUDA error, not read at the wrong rows."""
    gen = torch.Generator().manual_seed(12)
    rnd = lambda *s: torch.randn(s, generator=gen).to(device)
    b, n, f12, f3, cc = 1, 256, 40, 20, 200
    x12, x3 = rnd(b, n, f12).bfloat16(), rnd(b, n, f3).bfloat16()
    kc3, b3 = rnd(f3, cc), rnd(cc)
    k12, k3f, const = rnd(f12, cc), rnd(cc, cc), rnd(cc)
    nn_ = torch.tensor([200], dtype=torch.int32, device=device)
    p = ah.lin_p(x3, kc3, b3)
    grow = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 64))
    for name, pad in (("pad_head_weights", ah.pad_head_weights),
                      ("pad_lin_kernel", ah.pad_lin_kernel)):
        with monkeypatch.context() as m:
            m.setattr(ah, name, lambda *a, pad=pad: grow(pad(*a)))
            calls = [lambda: ah.assign_head_softmax_pre_lin(
                x12, x3, kc3, b3, k12, k3f, const, nn_)]
            if name == "pad_head_weights":
                calls += [
                    lambda: ah.assign_head_softmax_pre(x12, p, k12, k3f,
                                                       const, nn_),
                    lambda: ah.assign_head_softmax(x12, p, k12, k3f, const,
                                                   nn_)]
            for call in calls:
                with pytest.raises(RuntimeError, match="CUDA error"):
                    call()
                    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the f32 heads (B4, B6, B9a) on the CUDA cores at their edges
# ---------------------------------------------------------------------------

def _f32_heads(device, cc, f12, offset=0, seed=17):
    """(name, wrapper, card args, plain, CPU args, kwargs, expected product
    kernel) of f32 B4 (with and without ``c_out``), B6 and B9a at C=cc,
    F12=f12; p (B4's and B6's operand) stored ``offset`` elements into its
    buffer on the card, which narrows the product's copies."""
    gen = torch.Generator().manual_seed(seed + cc + f12)
    rnd = lambda *s: torch.randn(s, generator=gen)
    b, n, f3 = 2, 512, 20
    x12, x3 = rnd(b, n, f12), torch.relu(rnd(b, n, f3))
    kc3, b3 = rnd(f3, cc) * 0.3, rnd(cc) * 0.1
    k12, k3f, const = rnd(f12, cc) * 0.2, rnd(cc, cc) * 0.05, rnd(cc) * 0.1
    nn_ = torch.tensor([450, 300], dtype=torch.int32)  # both end mid-tile
    p = ah.lin_p(x3, kc3, b3)
    p[0, 7] = 0  # an all-zero row: rnorm clamps
    flat = torch.empty(p.numel() + offset, device=device)
    p_dev = flat[offset:].view(p.shape)
    p_dev.copy_(p)
    to = lambda *a: [t.to(device) for t in a]
    vec = 4 if cc % 4 == 0 and not offset else 2 if cc % 2 == 0 \
        and offset % 2 == 0 else 1
    lin_vec = 4 if cc % 4 == 0 else 2 if cc % 2 == 0 else 1
    c_out = max(1152, cc + 8)
    head = (x12, p, k12, k3f, const, nn_)
    card = lambda: [x12.to(device), p_dev, *to(k12, k3f, const, nn_)]
    return [
        ("B4", ah.assign_head_softmax_pre, card, head,
         lambda *a: ah.assign_head_softmax_pre_plain(*a)[0], {},
         f"gemm_kernel<true, false, {vec}>"),
        ("B4 c_out", ah.assign_head_softmax_pre, card, head,
         lambda *a: ah.assign_head_softmax_pre_plain(*a, c_out)[0],
         {"c_out": c_out}, f"gemm_kernel<true, false, {vec}>"),
        ("B6", ah.assign_head_softmax, card, head,
         ah.assign_head_softmax_plain, {},
         f"gemm_kernel<false, false, {vec}>"),
        ("B9a", ah.assign_head_softmax_pre_lin,
         lambda: to(x12, x3, kc3, b3, k12, k3f, const, nn_),
         (x12, x3, kc3, b3, k12, k3f, const, nn_),
         ah.assign_head_softmax_pre_lin_plain, {},
         f"gemm_kernel<true, true, {lin_vec}>"),
    ], nn_, n


@pytest.mark.parametrize("f12", [18, 40])
@pytest.mark.parametrize("cc", [114, 200, 1140, 1141, 1600])
def test_heads_f32_match_plain(device, cc, f12):
    """f32 B4 (with and without ``c_out``), B6 and B9a against their plain
    versions at the TOL rule (1e-5) at the model's and the second pool's C,
    odd and wide C (a ragged last k-step and column tile; B9a's row norm in
    column slices at 1600), with n_nodes ending mid-tile in both graphs and
    an all-zero p row: rows past n_nodes and pad columns exactly 0, the same
    bits on a second call, and the f32 product kernel in the widest copies C
    and the bases allow (never the tensor cores)."""
    heads, nn_, n = _f32_heads(device, cc, f12)
    rows = (torch.arange(n)[None, :] < nn_.long()[:, None]).to(device)
    for name, fn, card, args, plain, kw, kernel in heads:
        launches = fn.launches
        out = fn(*card(), **kw)
        out = out[0] if isinstance(out, tuple) else out
        assert fn.launches == launches + 1, name
        assert out.dtype == torch.float32, name
        _close_to(out, plain(*args), 1e-5)
        assert not out[~rows].any(), name
        assert not out[..., cc:].any(), name
        again = fn(*card(), **kw)
        again = again[0] if isinstance(again, tuple) else again
        assert torch.equal(again, out), name
        ran = _variants(fn, lambda: fn(*card(), **kw))
        assert ran == {"gemm_kernel": 1}, (name, ran)
        names = _kernel_names(lambda: fn(*card(), **kw), (kernel,),
                              ("gemm_tc_kernel",))
        assert any(kernel in k for k in names), (name, kernel, names)
        assert not any("gemm_tc_kernel" in k for k in names), (name, names)


def test_heads_f32_narrow_copies(device):
    """f32 B4 and B6 with p one element into its buffer: the product reads
    p and the weights one float at a time, and agrees all the same."""
    heads, nn_, n = _f32_heads(device, 1140, 40, offset=1)
    rows = (torch.arange(n)[None, :] < nn_.long()[:, None]).to(device)
    for name, fn, card, args, plain, kw, kernel in heads[:3]:
        assert card()[1].data_ptr() % 8, name
        out = fn(*card(), **kw)
        out = out[0] if isinstance(out, tuple) else out
        _close_to(out, plain(*args), 1e-5)
        assert not out[~rows].any(), name
        ran = _variants(fn, lambda: fn(*card(), **kw))
        assert ran == {"gemm_kernel": 1}, (name, ran)
        names = _kernel_names(lambda: fn(*card(), **kw), (kernel,),
                              ("gemm_tc_kernel",))
        assert any(kernel in k for k in names), (name, kernel, names)
        assert kernel.endswith(", 1>"), kernel


@pytest.mark.parametrize("cc", [114, 1141, 1600])
def test_b9a_f32_row_norm_is_b9bs(device, cc):
    """f32 B9a's row norm (rnorm_kernel with LIN: several rows a warp
    through common.cuh's rows_rnorm, kc3 in column slices at C=1600) is
    f32 B9b's (row_rnorm<1> over lin_p) bit for bit on every real row."""
    from cgcnet_tpu_torch.ops import _cuda

    gen = torch.Generator().manual_seed(43 + cc)
    b, n, f3 = 2, 640, 20
    x3 = torch.relu(torch.randn((b, n, f3), generator=gen)).to(device)
    kc3 = (torch.randn((f3, cc), generator=gen) * 0.3).to(device)
    b3 = (torch.randn((cc,), generator=gen) * 0.1).to(device)
    nn_ = torch.tensor([600, 77], dtype=torch.int32, device=device)
    partial = torch.empty((ah.STATS_BLOCKS, 2, cc), device=device)
    out = torch.empty((2, cc), device=device)
    rn9b = torch.full((b * n,), float("nan"), device=device)
    _cuda.launch("cgc_l2relu_stats_lin", x3.data_ptr(), kc3.data_ptr(), None,
                 b3.data_ptr(), nn_.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), rn9b.data_ptr(), b, n, f3, cc, 0, 0,
                 ah.STATS_BLOCKS, 0, device.index or 0, _cuda.stream_of(x3))
    rn9a = torch.empty((b * n,), device=device)
    _cuda.launch("cgc_assign_head_rnorm", None, x3.data_ptr(), kc3.data_ptr(),
                 None, b3.data_ptr(), nn_.data_ptr(), rn9a.data_ptr(), b, n,
                 f3, cc, 0, 0, 0, device.index or 0, _cuda.stream_of(x3))
    rows = (torch.arange(n, device=device)[None]
            < nn_.long()[:, None]).reshape(-1)
    assert torch.equal(rn9b[rows], rn9a[rows])
    assert torch.isfinite(rn9a).all()  # every row's norm is formed


# ---------------------------------------------------------------------------
# B2 over live slots; bf16 B9b; B9a's p routine
# ---------------------------------------------------------------------------

def _b2_blocks(vdt, seed=21, b=2, r=6, m=5, nc=6 * 128 + 64):
    """Blocks with every kind of row tile: no live slot (tile (0, 1)), all M
    live (tile (1, 2)), a dead slot inside the walk (tile (0, 3): [1, 0, 1,
    0, 0], count 3) and random prefixes; dead slots hold zero blocks, as B1
    writes them. x has nc rows, past R*128 and not a multiple of 128."""
    gen = torch.Generator().manual_seed(seed)
    tiles = -(-nc // 128)
    cols = torch.randint(0, tiles, (b, r, m), generator=gen, dtype=torch.int32)
    lens = torch.randint(1, m, (b, r), generator=gen)
    mask = (torch.arange(m)[None, None, :] < lens[..., None]).float()
    mask[0, 1] = 0.0
    mask[1, 2] = 1.0
    mask[0, 3] = torch.tensor([1.0, 0.0, 1.0, 0.0, 0.0])
    if vdt == torch.int8:
        vals = torch.randint(-3, 4, (b, r, m, 128, 128), generator=gen,
                             dtype=torch.int8)
    else:
        vals = torch.randn((b, r, m, 128, 128), generator=gen).to(vdt)
    vals = vals * mask[..., None, None].to(vdt)
    return vals, cols, mask, nc


@pytest.mark.parametrize("f", [18, 24, 40, 1140])
@pytest.mark.parametrize("xdt,vdt", [
    (torch.bfloat16, torch.int8), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.int8), (torch.float32, torch.float32)])
def test_b2_live_slots_match_plain(device, f, xdt, vdt):
    """B2 walking only the live slots against its plain version (which sums
    every slot) at the slide's and the patch path's widths: bf16 x on the
    tensor cores, f32 x on the CUDA cores; a row tile without a live slot
    comes out exact zeros."""
    tol = 1e-4 if xdt == torch.float32 else 2.0 ** -6
    vals, cols, mask, nc = _b2_blocks(vdt)
    slots = bsr.live_slot_counts(mask)
    assert slots[0, 1] == 0 and slots[1, 2] == 5 and slots[0, 3] == 3
    x = torch.randn((2, nc, f), generator=torch.Generator().manual_seed(f))
    x = x.to(xdt)
    ref = bsr.bsr_matmul_plain(vals, cols, x)
    args = [t.to(device) for t in (vals, cols, x, slots)]
    launches = bsr.bsr_matmul.launches
    out = bsr.bsr_matmul(*args)
    assert bsr.bsr_matmul.launches == launches + 1
    assert out.dtype == xdt and out.shape == (2, 6 * 128, f)
    _close_to(out, ref, tol)
    assert not out[0, 128:256].any()
    kernels = ["bsr_matmul_tc_kernel", "bsr_matmul_f32_kernel"]
    if xdt == torch.float32:
        kernels.reverse()
    want, other = kernels
    assert _variants(bsr.bsr_matmul, lambda: bsr.bsr_matmul(*args)) \
        == {want: 1}
    names = _kernel_names(lambda: bsr.bsr_matmul(*args), (want,), (other,))
    assert any(want in k for k in names), names
    assert not any(other in k for k in names), names


def test_b2_odd_width_bf16(device):
    """bf16 B2 at an odd width: rows of x too narrow for cp.async (2-byte
    copies) and unpaired output columns."""
    vals, cols, mask, nc = _b2_blocks(torch.int8, seed=22)
    x = torch.randn((2, nc, 7), generator=torch.Generator().manual_seed(7))
    x = x.bfloat16()
    out = bsr.bsr_matmul(*(t.to(device) for t in (
        vals, cols, x, bsr.live_slot_counts(mask))))
    _close_to(out, bsr.bsr_matmul_plain(vals, cols, x), 2.0 ** -6)


def _lin_inputs(seed, n=512, f3=20, cc=1140):
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen)
    x3 = torch.relu(rnd(1, n, f3)).bfloat16()
    return x3, rnd(f3, cc) * 0.3, rnd(cc) * 0.1


def _lin_probe(x3, kc3, b3):
    """(p [B, N, C] bf16, rnorm [B, N, 1] f32) as B9a's and B9b's routines
    form them (tc.cuh lin_p_mma, lin_rnorm), through the test-only C
    entry; x3, kc3, b3 on the card."""
    from cgcnet_tpu_torch.ops import _cuda

    x = x3.reshape(-1, x3.shape[-1]).contiguous()
    kc3t = ah.pad_lin_kernel(kc3)
    bb = b3.bfloat16().contiguous()
    rows, cc = x.shape[0], kc3.shape[1]
    p = torch.empty((rows, cc), dtype=torch.bfloat16, device=x.device)
    rn = torch.empty((rows,), dtype=torch.float32, device=x.device)
    _cuda.launch("cgc_lin_p_probe", x.data_ptr(), kc3t.data_ptr(),
                 bb.data_ptr(), p.data_ptr(), rn.data_ptr(), rows, x.shape[1],
                 cc, *kc3t.shape, x.device.index or 0, _cuda.stream_of(x))
    return (p.reshape(*x3.shape[:2], cc), rn.reshape(*x3.shape[:2], 1))


def _check_b9b_bf16(device, cc):
    """bf16 B9b at the whole slide's rows (100352, n_nodes 100000: it ends
    mid-tile, and five tiles lie wholly past it; ``STATS_TOL`` is set for
    that many rows): against its plain version at the TOL rule, against the
    exact statistics at STATS_TOL, against the exact statistics of the h
    that B9a's routines form (the probe's p and row norm) at STATS_TOL; the
    tensor-core kernel ran; results repeat bit for bit."""
    x3, kc3, b3 = _lin_inputs(31, n=100352, cc=cc)
    nn_ = torch.tensor([100000], dtype=torch.int32)
    dev = [t.to(device) for t in (x3, kc3, b3, nn_)]
    launches = ah.l2relu_stats_lin.launches
    got = ah.l2relu_stats_lin(*dev)
    assert ah.l2relu_stats_lin.launches == launches + 1
    for o, r in zip(got, ah.l2relu_stats_lin_plain(*dev)):
        _close(o, r, 2.0 ** -6)
    assert ah.stats_distance(got, ah.l2relu_stats_lin_reference(*dev)) \
        <= ah.STATS_TOL
    p_mma, rn_mma = _lin_probe(*dev[:3])
    mma_exact = ah.l2relu_stats_reference(p_mma, dev[3], rnorm=rn_mma)
    assert ah.stats_distance(got, mma_exact) <= ah.STATS_TOL
    again = ah.l2relu_stats_lin(*dev)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    names = _kernel_names(lambda: ah.l2relu_stats_lin(*dev),
                          ("stats_lin_tc_kernel",))
    assert any("stats_lin_tc_kernel" in k for k in names), names


def test_b9b_bf16_matches_plain_b3_and_exact(device):
    """bf16 B9b at the model's C = 1140 (``_check_b9b_bf16``)."""
    _check_b9b_bf16(device, 1140)


@pytest.mark.parametrize("cc", [2304, 4096])
def test_b9b_bf16_wide_c(device, cc):
    """bf16 B9b at C past what fits a [64, C] p tile or kc3^T in shared
    memory (nothing C-wide is staged there)."""
    _check_b9b_bf16(device, cc)


def test_lin_p_routine_matches_plain(device):
    """The device routines that form p and its row norm for B9a's kernels
    and B9b (tc.cuh lin_p_mma, lin_rnorm), through their test-only C entry,
    against the plain version's p: the same bf16 value or one bf16 step
    from it (the dot sums in another order), and the same in all but a few
    values; the row norm against the plain row norm of that p (f32 sums in
    another order)."""
    x3, kc3, b3 = _lin_inputs(32)
    ref = ah.lin_p(x3, kc3, b3).float()
    p, rn = _lin_probe(*(t.to(device) for t in (x3, kc3, b3)))
    got = p.float().cpu()
    step = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    assert ((got - ref).abs() <= step).all()
    assert (got == ref).float().mean() > 0.99
    rn_ref, _ = ah._rnorm_h(got)
    assert torch.allclose(rn.cpu(), rn_ref, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# B5: the row held in registers
# ---------------------------------------------------------------------------

def _b5_inputs(device, seed, dtype, b, n, cc, offset=0):
    """p, dh [B, N, C] in ``dtype`` on the card (random on every row,
    padded rows too), u, w f32 [C]; p and dh ``offset`` elements into their
    storage, so their rows' base address is only that aligned."""
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen)

    def shifted(t):
        flat = torch.empty(t.numel() + offset, dtype=dtype, device=device)
        out = flat[offset:].view(t.shape)
        out.copy_(t)
        return out

    return (shifted(rnd(b, n, cc)), shifted(rnd(b, n, cc) * 0.01),
            (rnd(cc) * 0.01).to(device), (rnd(cc) * 0.01).to(device))


@pytest.mark.parametrize("b,n,cc,real,offset", [
    (2, 640, 1140, [600, 123], 0),     # the model's C, padded rows
    (2, 640, 114, [640, 77], 0),       # stage 2's C
    (2, 640, 1141, [555, 640], 0),     # an odd C: one element a vector
    (2, 640, 1140, [600, 123], 1),     # rows aligned to one element only
    (1, 192, 2304, [150], 0),          # f32: two warps a row
    (1, 128, 10300, [100], 0),         # f32: wider than registers hold
    (1, 64, 12400, [50], 0),           # bf16: wider than shared memory
    (1, 65536, 1140, [65536], 0),      # the capacity path's chunks
    (1, 34816, 1140, [34464], 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b5_matches_plain(device, dtype, b, n, cc, real, offset):
    """B5 against its plain version on the same CUDA tensors at the TOL
    rule (f32 1e-4, bf16 2^-6); rows past n_nodes exact zeros, as the plain
    version gives them; results repeat bit for bit."""
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    p, dh, u, w = _b5_inputs(device, cc + len(real), dtype, b, n, cc,
                             offset)
    if offset:
        assert p.data_ptr() % (2 * p.element_size())
    nn_ = torch.tensor(real, dtype=torch.int32, device=device)
    launches = ah.assign_tail_bwd.launches
    got = ah.assign_tail_bwd(p, dh, u, w, nn_)
    assert ah.assign_tail_bwd.launches == launches + 1
    ref = ah.assign_tail_bwd_plain(p, dh, u, w, nn_)
    _close(got, ref, tol)
    for i, r in enumerate(real):
        assert not ref[i, r:].any() and not got[i, r:].any()
    assert torch.equal(ah.assign_tail_bwd(p, dh, u, w, nn_), got)


# ---------------------------------------------------------------------------
# B3: each real row read once; B1: one block per row tile
# ---------------------------------------------------------------------------

def _b3_probe(p, n_nodes):
    """(sum, sumsq, rnorm [B*N] f32) of B3's kernel through its C entry with
    the test-only row-norm output (each real row's norm; NaN elsewhere)."""
    from cgcnet_tpu_torch.ops import _cuda

    b, n, c = p.shape
    partial = torch.empty((ah.STATS_BLOCKS, 2, c), dtype=torch.float32,
                          device=p.device)
    out = torch.empty((2, c), dtype=torch.float32, device=p.device)
    rn = torch.full((b * n,), float("nan"), device=p.device)
    _cuda.launch("cgc_l2relu_stats", p.data_ptr(), n_nodes.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), rn.data_ptr(), b, n, c,
                 ah.STATS_BLOCKS, _cuda.DTYPE_CODES[p.dtype],
                 p.device.index or 0, _cuda.stream_of(p))
    return out[0], out[1], rn


def _b4_rnorm(p):
    """B4's row norm of ``p`` [B, N, C] (its rnorm_kernel through the
    head's C entry), f32 [B*N]."""
    from cgcnet_tpu_torch.ops import _cuda

    b, n, c = p.shape
    rn = torch.empty((b * n,), dtype=torch.float32, device=p.device)
    nn_ = torch.full((b,), n, dtype=torch.int32, device=p.device)
    _cuda.launch("cgc_assign_head_rnorm", p.data_ptr(), None, None, None,
                 None, nn_.data_ptr(), rn.data_ptr(), b, n, 0, c, 0, 0,
                 _cuda.DTYPE_CODES[p.dtype], p.device.index or 0,
                 _cuda.stream_of(p))
    return rn


def _b3_input(device, dtype, b, n, cc, seed, offset=0):
    gen = torch.Generator().manual_seed(seed)
    p = torch.randn((b, n, cc), generator=gen)
    p[0, 3] = 0  # an all-zero row: the norm clamps
    flat = torch.empty(p.numel() + offset, dtype=dtype, device=device)
    out = flat[offset:].view(p.shape)
    out.copy_(p)
    return out


@pytest.mark.parametrize("b,n,cc,real", [
    (2, 640, 1140, [600, 123]),   # the model's C; n_nodes off the 64 grid
    (2, 640, 114, [640, 77]),     # stage 2's C
    (2, 640, 1141, [555, 640]),   # an odd C: one element a vector
    (2, 384, 2600, [300, 384]),   # past the 1280 columns a pass holds
    (3, 512, 1140, [0, 500, 0]),  # graphs with no real rows
    (1, 100352, 1140, [100000]),  # the slide's rows
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b3_matches_plain(device, dtype, b, n, cc, real):
    """B3 against its plain version at the TOL rule (f32 1e-5, bf16 2^-6),
    the same bits on a second call, and bf16 B3 at the slide's rows against
    the exact statistics at STATS_TOL; the new kernel ran."""
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    p = _b3_input(device, dtype, b, n, cc, seed=cc + b)
    nn_ = torch.tensor(real, dtype=torch.int32, device=device)
    launches = ah.l2relu_stats.launches
    got = ah.l2relu_stats(p, nn_)
    assert ah.l2relu_stats.launches == launches + 1
    for o, r in zip(got, ah.l2relu_stats_plain(p, nn_)):
        _close(o, r, tol)
    again = ah.l2relu_stats(p, nn_)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    if n == 100352 and dtype == torch.bfloat16:
        assert ah.stats_distance(
            got, ah.l2relu_stats_reference(p, nn_)) <= ah.STATS_TOL
    names = _kernel_names(lambda: ah.l2relu_stats(p, nn_), ("stats_kernel",),
                          ("stats_partial_kernel",))
    assert any("stats_kernel" in k for k in names), names
    assert not any("stats_partial_kernel" in k for k in names), names


@pytest.mark.parametrize("cc,offset", [(1140, 0), (114, 0), (1141, 0),
                                        (1140, 1), (2600, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b3_row_norm_is_b4s(device, dtype, cc, offset):
    """B3's row norm (read through the test-only output of its C entry) is
    B4's rnorm_kernel's on the same p, bit for bit, on every real row — so
    h = round_T(relu(p) * rnorm) is the same in the statistics and the
    head — in every vector width (p offset by one element: narrower
    vectors) and past one pass's columns."""
    p = _b3_input(device, dtype, 2, 640, cc, seed=7 + cc, offset=offset)
    if offset:
        assert p.data_ptr() % (2 * p.element_size())
    nn_ = torch.tensor([600, 77], dtype=torch.int32, device=device)
    *_, rn3 = _b3_probe(p, nn_)
    rn4 = _b4_rnorm(p)
    rows = (torch.arange(640, device=device)[None]
            < nn_.long()[:, None]).reshape(-1)
    assert torch.equal(rn3[rows], rn4[rows])
    assert torch.isnan(rn3[~rows]).all()  # rows past n_nodes: not read
    h3 = torch.clamp_min(p.float().reshape(-1, cc)[rows], 0) * rn3[rows, None]
    h4 = torch.clamp_min(p.float().reshape(-1, cc)[rows], 0) * rn4[rows, None]
    assert torch.equal(h3.to(dtype), h4.to(dtype))


def test_b9b_f32_matches_plain(device):
    """f32 B9b (B3's kernel with the LIN switch: each row's p formed once)
    against its plain version at the TOL rule (1e-5), repeatable bit for
    bit, with its row norm bit-equal to f32 B9a's (rnorm_kernel with LIN,
    through the head's C entry) on every real row."""
    from cgcnet_tpu_torch.ops import _cuda

    gen = torch.Generator().manual_seed(41)
    n, f3, cc = 4096, 20, 1140
    x3 = torch.relu(torch.randn((1, n, f3), generator=gen)).to(device)
    kc3 = (torch.randn((f3, cc), generator=gen) * 0.3).to(device)
    b3 = (torch.randn((cc,), generator=gen) * 0.1).to(device)
    nn_ = torch.tensor([4000], dtype=torch.int32, device=device)
    launches = ah.l2relu_stats_lin.launches
    got = ah.l2relu_stats_lin(x3, kc3, b3, nn_)
    assert ah.l2relu_stats_lin.launches == launches + 1
    for o, r in zip(got, ah.l2relu_stats_lin_plain(x3, kc3, b3, nn_)):
        _close(o, r, 1e-5)
    again = ah.l2relu_stats_lin(x3, kc3, b3, nn_)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    partial = torch.empty((ah.STATS_BLOCKS, 2, cc), device=device)
    out = torch.empty((2, cc), device=device)
    rn9b = torch.full((n,), float("nan"), device=device)
    _cuda.launch("cgc_l2relu_stats_lin", x3.data_ptr(), kc3.data_ptr(), None,
                 b3.data_ptr(), nn_.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), rn9b.data_ptr(), 1, n, f3, cc, 0, 0,
                 ah.STATS_BLOCKS, 0, device.index or 0, _cuda.stream_of(x3))
    assert torch.equal(out, torch.stack(got))
    rn9a = torch.empty((n,), device=device)
    _cuda.launch("cgc_assign_head_rnorm", None, x3.data_ptr(), kc3.data_ptr(),
                 None, b3.data_ptr(), nn_.data_ptr(), rn9a.data_ptr(), 1, n,
                 f3, cc, 0, 0, 0, device.index or 0, _cuda.stream_of(x3))
    assert torch.equal(rn9b[:4000], rn9a[:4000])


def _b1_inputs(seed, k, m, spread=150, b=2, n=768, dead_tile=None,
               dups=False, binary=False):
    """B1's inputs: rows' K slots within ``spread`` of the row (spatially
    local, as the kNN graphs are), f32 weights (signed; 0/1 when
    ``binary``), block metadata at M = ``m`` slots a row tile; optionally
    every slot of row tile ``dead_tile`` dead and duplicate columns in a
    row."""
    rng = np.random.default_rng(seed)
    rows = np.arange(n)[:, None]
    lo, hi = (0, n - 1) if m > 1 else (rows // 128 * 128, rows // 128 * 128
                                       + 127)  # M = 1: the row's own tile
    nbr = np.clip(rows + rng.integers(-spread, spread + 1, (b, n, k)), lo,
                  hi).astype(np.int32)
    if binary:
        w = (rng.uniform(size=(b, n, k)) > 0.3).astype(np.float32)
    else:
        w = rng.normal(size=(b, n, k)).astype(np.float32)
    if dups:
        nbr[:, 5, 3] = nbr[:, 5, 1]          # two slots name one column
        nbr[:, 200, 1:4] = nbr[:, 200, :1]   # four do
        w[:, 200, :4] = 1.0
    cols, masks = zip(*(bsr.bsr_block_meta(nbr[i], np.ones((n, k)), m)[:2]
                        for i in range(b)))
    cols, masks = np.stack(cols), np.stack(masks)
    if dead_tile is not None:
        masks[:, dead_tile] = 0
    return [torch.from_numpy(a) for a in (nbr, w, cols, masks)]


@pytest.mark.parametrize("k,m,spread,extra", [
    (9, 6, 150, {}),                   # the patch path's K
    (40, 6, 150, {}),                  # a transpose's KT past 32
    (70, 6, 150, {}),                  # past the two chunks held
    (9, 6, 150, {"dups": True}),       # duplicate columns of one row sum
    (9, 6, 150, {"dead_tile": 2}),     # a row tile whose every slot is dead
    (9, 1, 40, {}),                    # M = 1
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_b1_matches_plain_exactly(device, dtype, k, m, spread, extra):
    """B1 bit-equal to its plain version on the CPU (the same f32 sums in
    slot order, rounded or truncated once; the plain version's scatter on
    the card adds a column's slots in no fixed order), dead slots exact
    zeros, in f32, bf16 and int8 (binary weights, as the slide's
    operator)."""
    host = _b1_inputs(k + m, k, m, spread, binary=dtype == torch.int8,
                      **extra)
    args = [t.to(device) for t in host]
    masks = args[3]
    if "dead_tile" in extra:
        assert not masks[:, extra["dead_tile"]].any()
    launches = bsr.bsr_build_blocks.launches
    got = bsr.bsr_build_blocks(*args, dtype)
    assert bsr.bsr_build_blocks.launches == launches + 1
    ref = bsr.bsr_build_blocks_plain(*host, dtype).to(device)
    assert got.dtype == dtype
    assert torch.equal(got, ref)
    assert not got[masks == 0].any()
    if dtype == torch.int8 and "dups" in extra:
        assert (got > 1).any()  # the duplicates summed, then truncated


# ---------------------------------------------------------------------------
# the gathers over the nonzeros: B7, and B8 in f32 and bf16 below 128 columns
# ---------------------------------------------------------------------------

def _b7_tables(seed, table, b=2, n=1024, k=8):
    """(nbr, w, blk_cols, blk_mask) numpy of a patch batch's A (norm_adj
    weights) or A^T (its in-edge lists, weights in [0.5, 1.5)), M = 8, with
    B7's cases planted in every graph: two slots of row 5 name one column;
    row 130 names a column in a tile not listed for its row tile; row tile
    2 lists its first tile in two live slots; row tile 3's first slot is a
    hole (masked) before live ones."""
    nbr, w, cols, masks, _ = (t.numpy().copy()
                              for t in _graph(seed, b=b, cap=n, k=k))
    if table == "A^T":
        rng = np.random.default_rng(seed + 100)
        tr = [transpose_ell_np(nbr[i], (w[i] != 0).astype(np.float32), 64)
              for i in range(b)]
        kt = max(t[2] for t in tr)
        nbr = np.stack([t[0][:, :kt] for t in tr])
        mt = np.stack([t[1][:, :kt] for t in tr])
        w = (mt * rng.uniform(0.5, 1.5, mt.shape)).astype(np.float32)
        meta = [bsr.bsr_block_meta(nbr[i], mt[i], 8) for i in range(b)]
        cols = np.stack([c for c, _, _ in meta])
        masks = np.stack([m for _, m, _ in meta])
    nbr[:, 5, 1], w[:, 5, :2] = nbr[:, 5, 0], (0.75, 0.5)
    for i in range(b):
        live = set(cols[i, 1][masks[i, 1] > 0].tolist())
        far = next(c for c in range(n // 128) if c not in live)
        nbr[i, 130, 2], w[i, 130, 2] = far * 128 + 7, 1.25
        free = int(np.flatnonzero(masks[i, 2] == 0)[0])
        cols[i, 2, free], masks[i, 2, free] = cols[i, 2, 0], 1.0
    assert masks[:, 3, 0].all() and masks[:, 3, 1].all()
    masks[:, 3, 0] = 0.0
    return nbr, w, cols, masks


@pytest.mark.parametrize("f", [18, 40, 1140, 1141])
@pytest.mark.parametrize("table", ["A", "A^T"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b7_gather_matches_plain(device, dtype, table, f):
    """B7 against its plain version at TOL on a batch's A and A^T tables
    with its cases planted (``_b7_tables``) and x of fewer rows than N (the
    rows past NC read as zero), with x aligned and one element off its
    base (the narrow loads); the same bits on a second call; and on exact
    data (x small integers, weights multiples of 1/8, so every sum is exact
    in any order) bit-equal to the plain version."""
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    host = _b7_tables(f, table)
    nbr, w, cols, masks = (torch.from_numpy(a).to(device) for a in host)
    b, n = nbr.shape[:2]
    nc = n - 60  # the last tile ragged: rows past NC read as zero
    gen = torch.Generator(device=device).manual_seed(f)
    buf = torch.randn(b * nc * f + 1, generator=gen, device=device).to(dtype)
    for x in (buf[:-1].view(b, nc, f), buf[1:].view(b, nc, f)):
        launches = bsr.bsr_gather_sum.launches
        out = bsr.bsr_gather_sum(nbr, w, cols, masks, x)
        assert bsr.bsr_gather_sum.launches == launches + 1
        assert out.shape == (b, n, f) and out.dtype == dtype
        _close(out, bsr.bsr_gather_sum_plain(nbr, w, cols, masks, x), tol)
        assert torch.equal(out, bsr.bsr_gather_sum(nbr, w, cols, masks, x))
    rng = np.random.default_rng(f)
    w8 = torch.from_numpy(((host[1] != 0) * rng.integers(-8, 9, host[1].shape)
                           / 8).astype(np.float32)).to(device)
    xi = torch.from_numpy(rng.integers(-3, 4, (b, nc, f)).astype(
        np.float32)).to(device).to(dtype)
    for x in (xi, torch.cat([xi.reshape(-1)[:1], xi.reshape(-1)])[1:].view(
            b, nc, f)):
        assert torch.equal(bsr.bsr_gather_sum(nbr, w8, cols, masks, x),
                           bsr.bsr_gather_sum_plain(nbr, w8, cols, masks, x))
    if f == 1140:
        names = _kernel_names(lambda: bsr.bsr_gather_sum(nbr, w, cols, masks,
                                                         xi),
                              ("bsr_gather_kernel",))
        assert any("bsr_gather_kernel" in nm for nm in names), names


def _banded_gather_cases(f, dtype, kind, exact, gen):
    """B8 cases (args, kwargs) on CPU tensors: the resident halo tail in
    its own array and inside x, the epilogue, acc with split outputs (F a
    multiple of 128), halo windows; a hole before live slots. Blocks: int8
    (binary), binary in x's type, or dense random in x's type (``kind``);
    with ``exact`` x, halo and acc are small integers and the dense blocks
    and the epilogue's lanes multiples of 1/8."""
    def draw(*s):
        if exact:
            return torch.randint(-3, 4, s, generator=gen).float()
        return torch.randn(s, generator=gen)

    def blocks(vals, mask):
        v = torch.from_numpy(vals)
        if kind == "binary":
            return v.to(dtype)
        if kind == "dense":
            d = (torch.randint(-8, 9, v.shape, generator=gen) / 8 if exact
                 else torch.randn(v.shape, generator=gen))
            return (d * torch.from_numpy(mask)[..., None, None]).to(dtype)
        return v

    cols, mask, vals = _banded(8)
    mask[0, 3, 0], vals[0, 3, 0] = 0.0, 0  # a hole before live slots
    win = torch.from_numpy(bsr.band_window_table(cols[0], mask[0], 16))[None]
    c, v = torch.from_numpy(cols), blocks(vals, mask)
    x, halo = draw(1, 2048, f).to(dtype), draw(1, 128, f).to(dtype)
    sw = torch.zeros(1, 2048, 128)
    sw[0, :, 0] = (torch.randint(1, 9, (2048,), generator=gen) / 8 if exact
                   else torch.rand(2048, generator=gen))
    sw[0, :, 1] = 0.375 if exact else 0.4
    xx = torch.cat([x, halo], 1)
    cases = [((v, c, win, x, 2048), {"halo": halo, "blk_mask": mask}),
             ((v, c, win, xx, 2048), {"blk_mask": mask}),
             ((v, c, win, x, 2048), {"halo": halo, "blk_mask": mask,
                                     "epilogue_sw": sw.to(dtype)})]
    if f % 128 == 0:
        cases.append(((v, c, win, xx, 2048),
                      {"acc": draw(1, 3 * 512, f).to(dtype),
                       "blk_mask": mask}))
    cols_h, mask_h, vals_h = _banded(9, h_total=12)
    tabs = bsr.band_window_table_halo(cols_h[0], mask_h[0], 16, 12)
    cases.append(((blocks(vals_h, mask_h), torch.from_numpy(cols_h),
                   torch.from_numpy(tabs[0])[None], x, 2048),
                  {"halo": draw(1, 12 * 128, f).to(dtype),
                   "halo_win": torch.from_numpy(tabs[1])[None],
                   "blk_mask": mask_h}))
    return [(a, {k: torch.from_numpy(t) if isinstance(t, np.ndarray) else t
                 for k, t in kw.items()}) for a, kw in cases]


@pytest.mark.parametrize("kind", ["int8", "binary", "dense"])
@pytest.mark.parametrize("f,dtype", [(64, torch.float32),
                                     (1140, torch.float32),
                                     (1152, torch.float32),
                                     (64, torch.bfloat16)])
def test_banded_gather_matches_plain(device, f, dtype, kind):
    """B8's gather kernel (f32 at every width, bf16 below 128 columns)
    against its plain version at TOL on ``_banded_gather_cases``, with the
    live slot count given and not; the same bits on a second call; on exact
    data bit-equal to the plain version; the tensor-core kernel not
    launched."""
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    gen = torch.Generator().manual_seed(f + len(kind))
    for exact in (False, True):
        for args, kw in _banded_gather_cases(f, dtype, kind, exact, gen):
            ref = bsr.bsr_matmul_banded_plain(*args, **kw)
            dev_args = [a.to(device) if isinstance(a, torch.Tensor) else a
                        for a in args]
            dev_kw = {k: t.to(device) for k, t in kw.items()}
            for live in (None, bsr.live_slot_counts(dev_kw["blk_mask"])):
                launches = bsr.bsr_matmul_banded.launches
                out = bsr.bsr_matmul_banded(*dev_args, **dev_kw,
                                            live_slots=live)
                assert bsr.bsr_matmul_banded.launches == launches + 1
                again = bsr.bsr_matmul_banded(*dev_args, **dev_kw,
                                              live_slots=live)
                outs = out if isinstance(out, tuple) else (out,)
                refs = ref if isinstance(ref, tuple) else (ref,)
                agains = again if isinstance(again, tuple) else (again,)
                for o, r, a in zip(outs, refs, agains):
                    assert torch.equal(o, a)
                    if exact:
                        assert torch.equal(o, r.to(device))
                    else:
                        _close(o, r.to(device), tol)
    run = lambda: bsr.bsr_matmul_banded(*dev_args, **dev_kw, live_slots=live)
    assert _variants(bsr.bsr_matmul_banded, run) == {"banded_kernel": 1}
    names = _kernel_names(run, ("banded_kernel",), ("banded_tc_kernel",))
    assert any("banded_kernel" in nm for nm in names), names
    assert not any("banded_tc_kernel" in nm for nm in names), names


# ---------------------------------------------------------------------------
# the graph axis: two ranks sharing the one card
# ---------------------------------------------------------------------------

# seconds from a spawn of ranks on the card to the last rank's exit
# (tests/torch_port_util.py's RankGroup): at least 3x the slowest the
# spawn took on the card
CARD_RANKS_LIMIT = 120


def test_graph_axis_two_ranks_one_card(device, tmp_path):
    """Two ranks on one card, over gloo by the backend rule (NCCL refuses
    two ranks on one device), their collectives staged through pinned host
    memory: a bf16 halo exchange, a psum in f32 and in bf16 and an
    all_gather of CUDA tensors, each against its CPU form bit for bit (the
    halo rows gathered from the whole graph; the sums of the ranks' parts
    in rank order)."""
    import torch_multishard_worker as worker
    from cgcnet_tpu_torch.parallel.mega_graph import partition_graph
    from torch_port_util import run_ranks

    world = 2
    run_ranks(worker.card_collectives,
              (world, str(tmp_path / "init"), str(tmp_path)), world,
              tmp_path / "logs", CARD_RANKS_LIMIT)
    job = worker.card_job(world)
    part = partition_graph(job["nbr"], job["mask"], world)
    ns = job["x"].shape[0] // world
    xb = torch.tensor(job["x"]).to(torch.bfloat16).reshape(world, ns, -1)
    v = torch.tensor(job["v"])
    for r in range(world):
        res = torch.load(tmp_path / f"card{r}.pt", weights_only=False)
        assert (res["backend"], res["staged"]) == ("gloo", True), res
        assert res["device"].startswith("cuda"), res["device"]
        # rank r's halo slot e: rows req_idx[e, r] of rank e, masked
        want = torch.cat([
            xb[e][torch.tensor(part.req_idx[e, r]).long()]
            * torch.tensor(part.req_mask[e, r])[:, None].to(torch.bfloat16)
            for e in range(world)])
        assert torch.equal(res["halo"], want), r
        assert torch.equal(res["psum"], v[0] + v[1])
        assert torch.equal(res["psum_bf16"],
                           v[0].to(torch.bfloat16) + v[1].to(torch.bfloat16))
        assert torch.equal(res["all_gather"], v)


# ---------------------------------------------------------------------------
# the data axis: two ranks sharing the one card
# ---------------------------------------------------------------------------

DP_OVER = ["model.hidden_dim=8", "model.embedding_dim=8",
           "model.assign_hidden_dim=8", "model.max_num_nodes=512",
           "model.drop_out=0.0", "train.optim=sgd", "train.lr=1e-3",
           "train.momentum=0.9"]


def test_data_axis_two_ranks_one_card(device, tmp_path):
    """The data-parallel step at D = 2 ranks on one card (gloo, DDP's
    all-reduce and the statistics' psums of CUDA tensors): both ranks hold
    the same state bit for bit; per step each rank launches B1/B2/B3/B4/B5
    2/7/1/1/1, as the one-process step on the whole batch does; the loss
    and the running statistics hold against that step at atol 1e-4, rtol
    1e-3 (chip_smoke.py's card-vs-CPU loss rule: f32 sums in another
    order), the gradients at 1e-3 of each tensor's max|grad| plus 1e-5 of
    the model's largest (its gradient rule)."""
    import torch_data_parallel_worker as worker
    from cgcnet_tpu_torch.parallel.dryrun import counted, example_batch
    from cgcnet_tpu_torch.train.loop import make_train_step
    from torch_port_util import run_ranks

    batch = example_batch(4, cap=256, seed=2)
    case = dict(name="dp", kind="steps", over=DP_OVER, batch=batch, steps=2)
    torch.save([case], tmp_path / "job.pt")
    run_ranks(worker.run, (2, str(tmp_path / "init"),
                           str(tmp_path / "job.pt"), str(tmp_path), False),
              2, tmp_path / "logs", CARD_RANKS_LIMIT)
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
              for r in range(2))
    assert r0["axis"]["backend"] == "gloo"
    state = worker.state_of(case, device)
    step = make_train_step()
    graph = worker.graph_of(batch).to(device)
    want = {"B1": 2, "B2": 7, "B3": 1, "B4": 1, "B5": 1}
    nonzero = lambda d: {k: v for k, v in d.items() if v}
    for a, b in zip(r0["dp"]["steps"], r1["dp"]["steps"]):
        m, made = counted(lambda: step(state, graph))
        ref = worker._snap(state.model)
        assert nonzero(a["launches"]) == nonzero(b["launches"]) == \
            nonzero(made) == want
        assert a["loss"] == b["loss"]
        for part in ("params", "grads", "buffers"):
            for n, t in a[part].items():
                assert torch.equal(t, b[part][n]), (part, n)
        np.testing.assert_allclose(a["loss"], float(m["loss"]), atol=1e-4,
                                   rtol=1e-3)
        top = max(g.abs().max().item() for g in ref["grads"].values())
        for n, g in ref["grads"].items():
            tol = 1e-3 * g.abs().max().item() + 1e-5 * top
            assert (a["grads"][n] - g).abs().max().item() <= tol, n
        for n, t in ref["buffers"].items():
            if "running" in n:
                np.testing.assert_allclose(a["buffers"][n].numpy(),
                                           t.numpy(), atol=1e-4, rtol=1e-3,
                                           err_msg=n)


def test_sharded_checkpoint_two_ranks_one_card(device, tmp_path):
    """``train/checkpoint_sharded.py`` with CUDA ``DTensor``s on a gloo mesh
    of two ranks sharing the card (``DeviceMesh.from_group``): the layout
    round-trips, loads replicated at D = 2 and into CPU tensors of one
    process, and a training state saved at D = 2 reloads bit for bit."""
    from torch.distributed.tensor import Replicate, Shard

    import torch_data_parallel_worker as worker
    from cgcnet_tpu_torch.parallel.dryrun import example_batch
    from cgcnet_tpu_torch.train import checkpoint_sharded as cs
    from torch_port_util import run_ranks

    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    w = np.linspace(0, 1, 24, dtype=np.float32)
    train = dict(over=DP_OVER, batch=example_batch(4, cap=256, seed=3))
    torch.save([dict(name="sharded", kind="sharded", root=str(tmp_path), x=x,
                     w=w, train=train)], tmp_path / "job.pt")
    run_ranks(worker.run, (2, str(tmp_path / "init"),
                           str(tmp_path / "job.pt"), str(tmp_path), False),
              2, tmp_path / "logs", CARD_RANKS_LIMIT)
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt",
                         weights_only=False)["sharded"]
        np.testing.assert_array_equal(got["same"]["x"].numpy(),
                                      x[4 * r:4 * r + 4])
        np.testing.assert_array_equal(got["same"]["w"].numpy(), w)
        assert got["same"]["x_placements"] == [Shard(0)]
        assert got["same"]["w_placements"] == [Replicate()]
        np.testing.assert_array_equal(got["replicated"]["x"].numpy(), x)
    one = cs.load_sharded(tmp_path / "layout", {"x": torch.zeros(8, 16)})
    np.testing.assert_array_equal(one["x"].numpy(), x)
    state = worker.state_of(train, device)
    cs.load_train_state(tmp_path / "train", state.model, state.optimizer)
    loaded = worker._flat(cs.train_state(state.model, state.optimizer))
    for k, v in got["saved"].items():
        if torch.is_tensor(v):
            assert torch.equal(loaded[k].cpu(), v), k


def test_dryrun_four_ranks_one_card(device):
    """``run_dryrun(4)`` on the card: per rank the data-parallel step
    launches B1-B5 2/7/1/1/1, the 4-shard slide step and the capacity step
    (B9a, B9b) run; losses finite and the same on every rank."""
    from cgcnet_tpu_torch.parallel.dryrun import run_dryrun

    res = run_dryrun(4)
    for r in res:
        assert r["backend"] == "gloo" and r["device"].startswith("cuda")
        assert {k: v for k, v in r["dp"]["launches"].items() if v} == \
            {"B1": 2, "B2": 7, "B3": 1, "B4": 1, "B5": 1}
        cap = r["slide-capacity"]["launches"]
        assert cap["B9a"] > 0 and cap["B9b"] > 0
        for name in ("dp", "slide", "slide-capacity"):
            assert np.isfinite(r[name]["loss"])
            assert r[name]["loss"] == res[0][name]["loss"], name


@pytest.mark.parametrize("gcn,head", [("SAGE", "assign_head_softmax_pre"),
                                      ("GIN", "assign_head_softmax")])
def test_kernel_artifact_launches_kernels(device, tmp_path, gcn, head):
    """The kernel artifact (utils/export_model.py) of a small model on a
    loader batch: the program records B1, B2 and the head (B4 for SAGE, B6
    for GIN) as custom ops, and its reloaded forward launches them 1/4/1
    times a batch, at any batch size (symbolic batch) and block-slot count,
    with the eager model's logits (f32, 1e-5 of max|logit|)."""
    import dataclasses

    from cgcnet_tpu_torch.cli.predict import serving_config
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.dataflow.synthetic import generate_dataset
    from cgcnet_tpu_torch.nn.model import CGCNet
    from cgcnet_tpu_torch.utils.export_model import (
        export_forward, load_exported, save_exported)

    generate_dataset(str(tmp_path / "data"), patches_per_image=2,
                     images_per_grade=1, n_nodes=(300, 500), seed=2)
    cfg = serving_config([
        f"data.root={tmp_path / 'data'}", "data.max_num_nodes=500",
        "data.num_workers=1", "model.hidden_dim=8", "model.embedding_dim=8",
        "model.assign_hidden_dim=8", f"model.gcn_name={gcn}"])
    loader = GraphLoader(NucleiGraphDataset(cfg.data, "valid"), 4,
                         device=device, shuffle=False, num_workers=1)
    graph = dataclasses.replace(next(iter(loader.epoch(0))), y=None,
                                patch_idx=None)
    model = CGCNet(cfg.model, torch.Generator().manual_seed(3)).to(device).eval()
    program, header = export_forward(model, graph, symbolic_batch=True)
    assert header["custom_ops"] == sorted(
        f"cgcnet_tpu_torch.{n}.default"
        for n in ("bsr_build_blocks", "bsr_matmul", head))
    save_exported(program, header, tmp_path / "k.cgexp")
    fwd, _ = load_exported(tmp_path / "k.cgexp")
    wrappers = {"B1": bsr.bsr_build_blocks, "B2": bsr.bsr_matmul,
                "B4": ah.assign_head_softmax_pre, "B6": ah.assign_head_softmax}
    key = "B4" if gcn == "SAGE" else "B6"
    for b in (4, 2):
        g = dataclasses.replace(graph, **{
            f.name: getattr(graph, f.name)[:b]
            for f in dataclasses.fields(graph) if getattr(graph, f.name) is not None})
        with torch.no_grad():
            want = model(g)
        for w in wrappers.values():
            w.launches = 0
        got = fwd(g)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        assert counts == {"B1": 1, "B2": 4, "B4": 0, "B6": 0, key: 1}, counts
        _close(got, want, 1e-5)
