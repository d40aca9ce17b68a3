"""PyTorch port, the slide capacity recipe (``model.assign_tail_chunk`` with
``mesh.remat_stage1``), held at a small size on the CPU for what it does at
1M nuclei on the card (``chip_smoke.py`` phase 14):

- its residuals: a ``saved_tensors_hooks`` count over one training-mode
  ``mega_forward`` finds exactly S and A @ S as the [N, C1]-class storages
  the backward keeps (both saved by the pool-1 contraction,
  ``ChunkedPoolContract``), and none saved by the chunked tail
  (``AssignTailTrainChunkedLin``): the JAX package's residual set
  (``cgcnet_tpu/parallel/mega_model.py`` ``_chunked_pool_contract``;
  ``cgcnet_tpu/ops/pallas/assign_head.py``: no p and no S in the chunked
  tail's residuals). The default (no-chunk) tail saves p and S beside them;
- its step: the loss, gradients and running statistics against JAX's
  ``mega_forward`` with the same recipe on the same slide, transplanted
  weights, at tests/test_torch_slide_model.py's f32 rule (the stage-1 JK
  and embed1 gradients excepted there, as in that file: JAX's jitted
  gradient is wrong for them on XLA:CPU);
- its chunk plan and phase 14's launches per capacity step at the rows of
  the 100k, 500k, 750k and 1M-nuclei slides, as arithmetic;
- B2's plain version over slices of the row tiles (how it fits beside the
  kernels at 1M nuclei) bit-equal to it over all of them at once.
"""

import pytest
import torch

import chip_smoke
import cgcnet_tpu.ops.pallas.assign_head as jah
import cgcnet_tpu.ops.pallas.bsr_kernel as bk
from cgcnet_tpu_torch.ops import assign_head as ah
from cgcnet_tpu_torch.ops import bsr
from cgcnet_tpu_torch.ops.assign_head import chunk_plan, pick_chunk
from cgcnet_tpu_torch.parallel import mega_graph as tmg
from cgcnet_tpu_torch.parallel import mega_model as tmm

from test_torch_slide_model import (
    MEGA_JIT_FAULT,
    SMALL,
    _hold,
    _models,
    _run_both,
    strip_slide,
)

# a few thousand rows in chunks of 1024: three chunks, the last one whole
ROWS, REAL, CHUNK = 3072, 3000, 1024
CAPACITY = dict(SMALL, assign_tail_chunk=CHUNK)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several test workers share
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def saved_storages(model, tcfg, tinp, tail_name, monkeypatch):
    """One training-mode ``mega_forward`` with the recipe's recompute,
    under a ``saved_tensors_hooks`` that records each tensor the backward
    keeps: (saved {storage pointer: (bytes, saved inside the tail)}, the
    pool-1 contraction's (S, A @ S), the tail's calls)."""
    saved, contract, calls = {}, [], []
    inside = [False]

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        nbytes, in_tail = saved.get(ptr, (0, False))
        saved[ptr] = (max(nbytes, t.untyped_storage().nbytes()),
                      in_tail or inside[0])
        return t

    tail = getattr(ah, tail_name)

    def tail_call(*args):
        calls.append(args)
        inside[0] = True
        try:
            return tail(*args)
        finally:
            inside[0] = False

    apply = tmm.ChunkedPoolContract.apply

    def contract_call(s, pembed, a_s, chunk):
        contract.append((s, a_s))
        return apply(s, pembed, a_s, chunk)

    monkeypatch.setattr(ah, tail_name, tail_call)
    monkeypatch.setattr(tmm.ChunkedPoolContract, "apply",
                        staticmethod(contract_call))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits = tmm.mega_forward(model, tcfg, tinp, train=True,
                                  remat_stage1=True)
    assert torch.isfinite(logits).all()
    return saved, contract, calls


@pytest.mark.parametrize("chunk", [CHUNK, 0], ids=["capacity", "default"])
def test_capacity_residuals_are_s_and_as(chunk, monkeypatch):
    """The [N, C1]-class storages one bf16 training forward saves: on the
    capacity path exactly S and A @ S, none inside the chunked tail; on
    the default path the tail's own p and S beside them."""
    _, _, tcfg, model = _models(dict(CAPACITY, assign_tail_chunk=chunk,
                                     compute_dtype="bfloat16"), seed=1)
    x, nbr, mask = strip_slide(ROWS, REAL, seed=3)
    tinp = tmm.prepare_mega_inputs(x, tmg.partition_graph(nbr, mask, 1),
                                   "cpu", n_real=REAL)
    tail_name = ("assign_tail_train_chunked_lin" if chunk
                 else "assign_tail_train_psum")
    saved, contract, calls = saved_storages(model, tcfg, tinp, tail_name,
                                            monkeypatch)
    assert len(calls) == 1 and len(contract) == 1
    c1 = tcfg.assign_dims[0]
    s, a_s = contract[0]
    assert s.shape == a_s.shape == (ROWS, c1)
    wide = {ptr: in_tail for ptr, (nbytes, in_tail) in saved.items()
            if nbytes >= ROWS * c1 * s.element_size()}
    s_ptr = s.untyped_storage().data_ptr()
    as_ptr = a_s.untyped_storage().data_ptr()
    if chunk:
        assert set(wide) == {s_ptr, as_ptr}, wide
        assert not any(wide.values()), "the chunked tail saved a [N, C1] tensor"
    else:
        # S (shared with the contraction), A @ S and the tail's p
        assert len(wide) == 3 and {s_ptr, as_ptr} < set(wide), wide
        assert wide[s_ptr] and sum(wide.values()) == 2


def test_capacity_step_matches_jax():
    """The capacity recipe's eval logits, training loss, gradients and
    running statistics (f32, gather path) against JAX's ``mega_forward``
    with the same recipe on the same slide and weights."""
    bk.set_interpret(True)
    jah.set_interpret(True)
    try:
        x, nbr, mask = strip_slide(ROWS, REAL, seed=3)
        r = _run_both(CAPACITY, x, nbr, mask, REAL, False,
                      remat_stage1=True)
    finally:
        bk.set_interpret(False)
        jah.set_interpret(False)
    assert pick_chunk(ROWS, r["tcfg"].assign_tail_chunk) == CHUNK
    _hold(r, skip=MEGA_JIT_FAULT)


# (nuclei, rows, capacity chunks) of the 100k slide of phases 8-10 and of
# phase 14's rungs
LADDER = [(100_000, 100_352, 2), (500_000, 500_224, 8),
          (750_000, 750_080, 12), (1_000_000, 1_000_448, 16)]


@pytest.mark.parametrize("nuclei,rows,chunks", LADDER,
                         ids=[f"{n // 1000}k" for n, _, _ in LADDER])
def test_ladder_chunk_plan_and_launches(nuclei, rows, chunks):
    """Rows, chunk plan and launches per capacity step at each rung:
    chunks of 65536 rows and one remainder; B9a once forward and twice a
    chunk backward, B5 once a chunk, B9b once; the A @ S leg and its
    transpose on B8 where the tables carry band windows (100k), else on
    B2 beside its eight stage-1 launches."""
    assert chip_smoke.slide_rows(nuclei) == rows
    ch = pick_chunk(rows, chip_smoke.CAP_CHUNK)
    full, rem = divmod(rows, chip_smoke.CAP_CHUNK)
    assert chunk_plan(rows, ch) == (65536, full, rem) and 0 < rem < ch
    assert full + 1 == chunks
    per = chip_smoke.capacity_per_step(rows)
    assert per == {"B2": 8, "B5": chunks, "B8": 2, "B9a": 1 + 2 * chunks,
                   "B9b": 1}
    if nuclei == chip_smoke.SLIDE_NUCLEI:
        # the 100k slide's tables carry band windows: B8 takes the wide legs
        assert nuclei in chip_smoke.BANDED_NUCLEI
        assert rows == chip_smoke.SLIDE_CAP
        assert per == chip_smoke.SLIDE_CAP_PER_STEP
    else:
        # the rungs' do not: B2 takes them, as in the JAX package
        assert nuclei not in chip_smoke.BANDED_NUCLEI
        assert nuclei in chip_smoke.LADDER_NUCLEI
        assert chip_smoke.unbanded(per) == {
            "B2": 10, "B5": chunks, "B8": 0, "B9a": 1 + 2 * chunks, "B9b": 1}


def test_f32_slide_takes_b8s_legs_on_b2():
    """Phase 15's f32 launch counts are the bf16 paths' with each B8 leg on
    B2: ``_banded_on`` serves B8 for 2-byte activations only."""
    from cgcnet_tpu_torch.ops import ell

    win = torch.zeros((1, 4, 1), dtype=torch.int32)
    x = torch.zeros((8, 1140))
    assert ell._banded_on(win, x.bfloat16()) and not ell._banded_on(win, x)

    def on_b2(per):
        return {k: v for k, v in chip_smoke.unbanded(per).items() if v}

    assert chip_smoke.F32_FORWARD == on_b2(chip_smoke.SLIDE_FORWARD)
    assert chip_smoke.F32_TRAIN_PER_STEP == on_b2(
        chip_smoke.SLIDE_TRAIN_PER_STEP)
    assert chip_smoke.F32_CAP_PER_STEP == on_b2(chip_smoke.SLIDE_CAP_PER_STEP)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_b2_row_slices_are_bit_equal(dtype, monkeypatch):
    """B2's plain version with its gather cut to a few row tiles at a time
    (``PLAIN_GATHER_BYTES``) against the same version in one gather: the
    same bits, over int8 blocks and x rows past NC read as zero."""
    gen = torch.Generator().manual_seed(0)
    b, r, m, f = 2, 12, 3, 40
    nc = r * bsr.TILE - 64
    vals = torch.randint(-1, 2, (b, r, m, bsr.TILE, bsr.TILE),
                         generator=gen).to(torch.int8)
    cols = torch.randint(0, r, (b, r, m), generator=gen, dtype=torch.int32)
    x = torch.randn((b, nc, f), generator=gen).to(dtype)
    whole = bsr.bsr_matmul_plain(vals, cols, x)
    monkeypatch.setattr(bsr, "PLAIN_GATHER_BYTES",
                        5 * b * m * bsr.TILE * f * 4)  # 5 row tiles a slice
    sliced = bsr.bsr_matmul_plain(vals, cols, x)
    assert sliced.dtype == dtype and torch.equal(sliced, whole)
