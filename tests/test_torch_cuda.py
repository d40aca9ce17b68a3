"""PyTorch port, card only: each hand-written CUDA kernel (B1, B2, B3, B4,
B5) against its plain PyTorch version on the same CUDA tensors, and the
backward Functions around them against the CPU, at small shapes.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch; skips without a CUDA device. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances are fractions of max|plain|: f32 — B1 exact (same f32 sums in
the same slot order), B2 1e-4, B3 1e-5, B4 1e-5, B5 1e-4 (sums in another
order); bf16 — the two roundings of the stored result may land one bf16
step apart, up to 2^-7 of the value, so 2^-6. Gradients, card vs CPU:
1e-4 of max|grad| (f32 sums in another order through the same formulas).
"""

import numpy as np
import pytest
import torch

from cgcnet_tpu_torch.ops import assign_head as ah
from cgcnet_tpu_torch.ops import bsr
from cgcnet_tpu_torch.ops.ell import bsr_matmul_precomp
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
    for f, extra in ((18, 0), (40, 0), (300, 0), (40, 128)):
        x = torch.randn(2, 1024 + extra, f, device=device, generator=gen).to(dtype)
        _close(bsr.bsr_matmul(vals, cols, x), bsr.bsr_matmul_plain(vals, cols, x),
               tol_mm)
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
        out = bsr_matmul_precomp(vals, args[2], vals_t, args[2],
                                 scale.to(dev), self_w.to(dev), x)
        torch.sum(out * g0.to(dev)).backward()
        return [out.detach(), x.grad]

    launches = bsr.bsr_matmul.launches
    got = run_bsr(device)
    assert bsr.bsr_matmul.launches == launches + 2  # forward and backward
    _grads_close(got, run_bsr("cpu"))
