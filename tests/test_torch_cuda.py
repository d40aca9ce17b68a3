"""PyTorch port, card only: each hand-written CUDA kernel (B1, B2, B4)
against its plain PyTorch version on the same CUDA tensors, at small shapes.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch; skips without a CUDA device. On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances are fractions of max|plain|: f32 — B1 exact (same f32 sums in
the same slot order), B2 1e-4, B4 1e-5 (sums in another order); bf16 — the
two roundings of the stored result may land one bf16 step apart, up to
2^-7 of the value, so 2^-6.
"""

import numpy as np
import pytest
import torch

from cgcnet_tpu_torch.ops import assign_head as ah
from cgcnet_tpu_torch.ops import bsr
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
