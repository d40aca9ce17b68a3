"""PyTorch port: the host-side inputs of the bf16 tensor-core kernels.

B8 (``bsr_matmul_banded``) walks each row tile's block slots only up to its
last live one (``live_slot_counts``), which is exact because B1 writes zero
blocks in dead slots; the assign head's bf16 product (B4, B6, B9a) reads
[K12 ; K3f] as one zero-padded copy (``pad_head_weights``) and B9a's p
product reads kc3 transposed and padded (``pad_lin_kernel``). These tests
hold those layouts on the CPU: the counts against ``blk_mask`` (live
prefixes, as ``bsr_block_meta`` writes them, and masks with holes), the
dead slots of ``bsr_build_blocks_plain`` against exact zeros, the padded
copies against the unpadded operands through the plain versions (the
same S, bit for bit: the padding is zeros placed where the kernel reads
them), and the whole-slide tables that carry the counts. The kernels
themselves are held against the plain versions on a card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from cgcnet_tpu_torch.ops import assign_head as ah
from cgcnet_tpu_torch.ops import bsr
from cgcnet_tpu_torch.ops.knn import radius_knn_np


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several test workers share
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slide_ell(seed: int, cap: int = 1024, k: int = 8):
    """A radius-kNN ELL over spatially sorted random nuclei, padded to
    ``cap`` rows with self-only padding rows."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(int(cap * 0.7), cap + 1))
    pos = rng.uniform(0, 60 * np.sqrt(n), (n, 2)).astype(np.float32)
    pos = pos[np.lexsort((pos[:, 1], np.floor(pos[:, 0] / 100.0)))]
    nbr, m = radius_knn_np(pos, 100.0, k)
    nbr = np.concatenate([nbr, np.tile(np.arange(n, cap, dtype=np.int32)[:, None],
                                       (1, k))])
    m = np.concatenate([m, np.zeros((cap - n, k), np.float32)])
    return nbr, m


def _counts_ref(mask: np.ndarray) -> np.ndarray:
    """Slots up to and including the last live one, by a loop."""
    out = np.zeros(mask.shape[:-1], np.int32)
    for idx in np.ndindex(*mask.shape[:-1]):
        live = np.nonzero(mask[idx] > 0)[0]
        out[idx] = live[-1] + 1 if len(live) else 0
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_live_slot_counts_of_block_meta(seed):
    """``bsr_block_meta`` writes each row tile's column tiles as a live
    prefix: the count is the number of live slots."""
    nbr, m = _slide_ell(seed)
    cols, mask, _ = bsr.bsr_block_meta(nbr, m, 8)
    got = bsr.live_slot_counts(torch.from_numpy(mask)[None])
    assert got.dtype == torch.int32 and got.shape == (1, mask.shape[0])
    np.testing.assert_array_equal(got[0].numpy(), (mask > 0).sum(-1))
    np.testing.assert_array_equal(got[0].numpy(), _counts_ref(mask))


def test_live_slot_counts_with_holes():
    """Masks that are no live prefix: a hole before a live slot counts up
    to the last live slot; a row tile without one counts 0."""
    rng = np.random.default_rng(3)
    mask = (rng.uniform(size=(2, 40, 9)) > 0.6).astype(np.float32)
    mask[0, 0] = 0.0
    mask[1, 5] = [0, 0, 1, 0, 0, 0, 0, 0, 1]
    got = bsr.live_slot_counts(torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), _counts_ref(mask))
    assert got[0, 0] == 0 and got[1, 5] == 9


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_dead_slots_of_built_blocks_are_zero(dtype):
    """The blocks of every slot at or past a row tile's count are exact
    zeros, so a walk that stops at the count sums the same products."""
    nbr, m = _slide_ell(4)
    cols, mask, _ = bsr.bsr_block_meta(nbr, m, 8)
    row = np.arange(nbr.shape[0])[:, None]
    w = (m * (nbr != row)).astype(np.float32)
    vals = bsr.bsr_build_blocks_plain(
        torch.from_numpy(nbr)[None], torch.from_numpy(w)[None],
        torch.from_numpy(cols)[None], torch.from_numpy(mask)[None], dtype)
    counts = bsr.live_slot_counts(torch.from_numpy(mask)[None])[0]
    slot = torch.arange(mask.shape[1])[None, :]
    dead = slot >= counts[:, None]
    assert dead.any() and (~dead).any()
    assert not vals[0][dead].any()
    assert vals[0][~dead].reshape(int((~dead).sum()), -1).ne(0).any(-1).all()


def test_banded_plain_ignores_counts_and_wrapper_checks_them():
    """The plain B8 gives the same result with and without the counts; the
    wrapper refuses counts of the wrong shape or type."""
    rng = np.random.default_rng(5)
    r, m = 16, 4  # the window table needs 16 local column tiles
    cols = np.zeros((1, r, m), np.int32)
    mask = np.zeros((1, r, m), np.float32)
    for ri in range(r):
        sel = sorted({max(0, ri - 1), ri, min(r - 1, ri + 1)})
        cols[0, ri, :len(sel)] = sel
        mask[0, ri, :len(sel)] = 1.0
    vals = ((rng.uniform(size=(1, r, m, 128, 128)) > 0.8)
            * mask[..., None, None]).astype(np.int8)
    c, v = torch.from_numpy(cols), torch.from_numpy(vals)
    win = torch.from_numpy(bsr.band_window_table(cols[0], mask[0], r))[None]
    x = torch.from_numpy(rng.normal(size=(1, r * 128, 256)).astype(np.float32))
    counts = bsr.live_slot_counts(torch.from_numpy(mask))
    base = bsr.bsr_matmul_banded(v, c, win, x, r * 128)
    assert torch.equal(bsr.bsr_matmul_banded(v, c, win, x, r * 128,
                                             live_slots=counts), base)
    with pytest.raises(ValueError, match="live_slots"):
        bsr.bsr_matmul_banded(v, c, win, x, r * 128,
                              live_slots=counts[:, :-1])
    with pytest.raises(ValueError, match="live_slots"):
        bsr.bsr_matmul_banded(v, c, win, x, r * 128,
                              live_slots=counts.long())


@pytest.mark.parametrize("f12,c", [(40, 1140), (16, 204), (40, 1152)])
def test_padded_head_weights_give_the_same_s(f12, c):
    """The padded [K12 ; K3f] copy: shapes on the kernel's tiling, zeros
    outside K12 and K3f, and — read back where the kernel reads it — the
    same S through ``assign_head_softmax_pre_plain`` (and B6's) as the
    unpadded bf16 weights, bit for bit."""
    rng = np.random.default_rng(c)
    b, n = 1, 256
    x12 = torch.from_numpy(rng.normal(size=(b, n, f12)).astype(np.float32))
    p = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32))
    k12 = torch.from_numpy(rng.normal(size=(f12, c)).astype(np.float32) * 0.2)
    k3f = torch.from_numpy(rng.normal(size=(c, c)).astype(np.float32) * 0.05)
    const = torch.from_numpy(rng.normal(size=(c,)).astype(np.float32))
    nn_ = torch.tensor([200], dtype=torch.int32)
    x12, p = x12.bfloat16(), p.bfloat16()
    w = ah.pad_head_weights(k12, k3f)
    k12p = -(-f12 // ah.HEAD_K) * ah.HEAD_K
    assert w.dtype == torch.bfloat16
    assert w.shape == (k12p + -(-c // ah.HEAD_K) * ah.HEAD_K,
                       -(-c // ah.HEAD_N) * ah.HEAD_N)
    assert (w.shape[1] * 2) % 16 == 0
    inside = torch.zeros(w.shape, dtype=torch.bool)
    inside[:f12, :c] = True
    inside[k12p:k12p + c, :c] = True
    assert not w[~inside].any()
    k12_w, k3f_w = w[:f12, :c], w[k12p:k12p + c, :c]
    for plain in (lambda *a: ah.assign_head_softmax_pre_plain(*a)[0],
                  ah.assign_head_softmax_plain):
        ref = plain(x12, p, k12.bfloat16(), k3f.bfloat16(), const, nn_)
        got = plain(x12, p, k12_w, k3f_w, const, nn_)
        assert torch.equal(got, ref)


def test_padded_lin_kernel_gives_the_same_p():
    """kc3 transposed and padded for B9a's p product: zeros past C and F3,
    and the same p (``lin_p``) and S as the unpadded kernel; F3 above the
    padded width is refused."""
    rng = np.random.default_rng(9)
    f3, c, n = 20, 1140, 256
    x3 = torch.from_numpy(rng.normal(size=(1, n, f3)).astype(np.float32))
    kc3 = torch.from_numpy(rng.normal(size=(f3, c)).astype(np.float32) * 0.3)
    b3 = torch.from_numpy(rng.normal(size=(c,)).astype(np.float32) * 0.1)
    x3 = x3.bfloat16()
    t = ah.pad_lin_kernel(kc3)
    assert t.dtype == torch.bfloat16
    assert t.shape == (-(-c // ah.HEAD_K) * ah.HEAD_K, ah.F3_PAD)
    assert not t[c:].any() and not t[:, f3:].any()
    assert torch.equal(ah.lin_p(x3, t[:c, :f3].t(), b3),
                       ah.lin_p(x3, kc3.bfloat16(), b3))
    with pytest.raises(ValueError, match="F3"):
        ah.pad_lin_kernel(torch.zeros(ah.F3_PAD + 1, c))


def test_slide_tables_carry_live_slot_counts():
    """``prepare_mega_inputs`` builds each row tile's count once per slide,
    beside the blocks, for the forward operator and its transpose; the
    stage-1 aggregation hands them to B8 and gives the same result as
    without them."""
    from cgcnet_tpu_torch.ops.ell import bsr_local_matmul
    from cgcnet_tpu_torch.parallel import mega_model as tmm
    from cgcnet_tpu_torch.parallel.mega_graph import (
        build_bsr_tables,
        partition_graph,
    )

    nbr, m = _slide_ell(6, cap=2048)
    part = partition_graph(nbr, m, 1)
    tables = build_bsr_tables(part)
    assert tables is not None and tables.win_base is not None
    inp = tmm.prepare_mega_inputs(np.zeros((2048, 18), np.float32), part,
                                  "cpu", bsr=tables)
    for counts, mask in ((inp.slots, inp.blk_mask),
                         (inp.slots_t, inp.blk_mask_t)):
        assert counts.dtype == torch.int32
        np.testing.assert_array_equal(counts.numpy(),
                                      _counts_ref(mask.numpy()))
    adj = tmm.ShardedAdj(inp, tmm.ModelConfig(), dtype=torch.bfloat16)
    tabs = adj._tables()
    assert torch.equal(tabs[-2][0], inp.slots)
    assert torch.equal(tabs[-1][0], inp.slots_t)
    rng = np.random.default_rng(7)
    ns, nc = 2048, inp.nbr_t.shape[0]
    h = torch.from_numpy(rng.normal(size=(ns, 512)).astype(np.float32))
    halo = torch.zeros((nc - ns, 512))
    h, halo = h.bfloat16(), halo.bfloat16()
    with_counts = bsr_local_matmul(*tabs[:6], h, halo, *tabs[6:])
    without = bsr_local_matmul(*tabs[:6], h, halo, *tabs[6:9])
    assert torch.equal(with_counts, without)
