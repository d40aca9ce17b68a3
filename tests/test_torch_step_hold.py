"""PyTorch port, on the CPU: which kernel call sites ``chip_smoke.py``'s
step holds (phases 9 and 10) keep on their plain side.

The holds compare one bf16 slide step with every kernel against the same
step through the plain versions. The plain side keeps exactly the kernels
whose output, the BN statistics, the statistics hold judges
(``ops/assign_head.STATS_HELD``: B3 and B9b), so both sides read the same
statistics; every other site takes its plain version, and the f32 side is
all plain. These tests pin that routing, so that no other site is shared
without a change here.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from cgcnet_tpu_torch.ops import assign_head as ah

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several test workers share
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
KEYS = sorted({key for _, _, key, _ in CS.kernel_sites()})


def test_stats_held_names_the_statistics_sites():
    """STATS_HELD is B3 and B9b, and those ids name exactly the sites that
    call the statistics wrappers."""
    assert set(ah.STATS_HELD) == {"B3", "B9b"}
    held = {(mod.__name__, name) for mod, name, key, _ in CS.kernel_sites()
            if key in ah.STATS_HELD}
    assert held == {(ah.__name__, "l2relu_stats"),
                    (ah.__name__, "l2relu_stats_lin")}
    assert set(KEYS) == set(CS.KERNELS)


@pytest.mark.parametrize("key", KEYS)
def test_step_hold_plain_side_routes(key):
    """Under ``stats_shared`` a STATS_HELD site stays its wrapper and every
    other site is its plain version; under ``all_plain`` (the f32 side)
    every site is plain; both are undone on exit."""
    sites = [s for s in CS.kernel_sites() if s[2] == key]
    assert sites
    before = [getattr(mod, name) for mod, name, _, _ in sites]
    with CS.sites_replaced(CS.stats_shared):
        for (mod, name, _, plain), orig in zip(sites, before):
            want = orig if key in ah.STATS_HELD else plain
            assert getattr(mod, name) is want
    with CS.sites_replaced(CS.all_plain):
        for mod, name, _, plain in sites:
            assert getattr(mod, name) is plain
    assert [getattr(mod, name) for mod, name, _, _ in sites] == before


def _readout_model(x):
    """Two node readouts (torch.amax over dim 0) and one over features."""
    import torch

    return (torch.amax(x, 0).sum() + 2.0 * torch.amax(x * x, 0).sum()
            + torch.amax(x, 1).sum())


def test_readout_routing_replays_the_recorded_nodes():
    """A step replayed under ``readout_routing`` takes each node readout at
    the recorded step's maximum, and its gradient goes there (split evenly
    among the recorded ties), whatever its own maximum; other amax calls
    are left alone."""
    import torch

    rec = torch.tensor([[1.0, 5.0, 2.0], [3.0, 5.0, 0.0], [2.0, 1.0, 4.0]])
    other = rec.clone()
    other[0, 0] = 3.5  # its own maximum of column 0 moves to node 0
    routing = CS.readout_routing()
    with routing:
        _readout_model(rec.clone().requires_grad_())
    assert len(routing.masks) == 2

    x = other.clone().requires_grad_()
    with routing.replay():
        out = _readout_model(x)
    out.backward()
    # column 0 read at node 1 (3.0, not its own 3.5); column 1's tie split
    want = (torch.tensor([3.0, 5.0, 4.0]).sum()
            + 2.0 * torch.tensor([9.0, 25.0, 16.0]).sum()
            + torch.amax(other, 1).sum())
    assert torch.allclose(out, want)
    g = torch.zeros_like(other)
    g[1, 0] = 1.0 + 4.0 * 3.0
    g[0, 1] = g[1, 1] = 0.5 + 2.0 * 5.0
    g[2, 2] = 1.0 + 4.0 * 4.0
    g[torch.arange(3), other.argmax(1)] += 1.0
    assert torch.allclose(x.grad, g)
    # column 0 of both readouts moved: 3.5 vs 3.0 is 32 steps of 2^-6, 12.25
    # vs 9.0 52 steps of 2^-4
    assert routing.moves == [[(3, 1, 32.0), (3, 1, 52.0)]]

    with routing.replay():
        _readout_model(other)  # the recorded count again: no complaint
    with pytest.raises(SystemExit, match="readouts replayed"):
        with routing.replay():
            torch.amax(other, 0)


def test_readout_routing_keeps_the_recording_step():
    """On the step it recorded, the replay gives amax's values and
    gradients, bf16 included."""
    import torch

    gen = torch.Generator().manual_seed(5)
    x0 = torch.randn((64, 7), generator=gen).bfloat16()
    x0[3, 2] = x0[9, 2] = x0[:, 2].max()  # a tie
    routing = CS.readout_routing()
    with routing:
        ref = _readout_model(x0)
    a = x0.clone().float().requires_grad_()
    b = x0.clone().float().requires_grad_()
    _readout_model(a.bfloat16()).float().backward()
    with routing.replay():
        got = _readout_model(b.bfloat16())
    got.float().backward()
    assert torch.equal(got, ref)
    assert torch.allclose(b.grad, a.grad)
    assert routing.moves == [[(7, 0, 0.0), (7, 0, 0.0)]]


def test_bf16_steps_counts_steps_of_the_larger_value():
    """One bf16 step above a value is one step, at any scale and sign;
    a gap across a power of two counts in steps of the larger side."""
    import torch

    x = torch.tensor([1.0, 3.0, -5.5, 1e-3, 700.0]).bfloat16()
    up = (x.view(torch.int16) + 1).view(torch.bfloat16)  # one step outward
    steps = CS.bf16_steps((up.float() - x.float()).abs(),
                          torch.maximum(up.float().abs(), x.float().abs()))
    assert torch.equal(steps, torch.ones(5))
    # 2.0 - 1.9921875 (one step below 2 at scale 1) is half a step of 2
    assert CS.bf16_steps(torch.tensor(2.0 - 1.9921875),
                         torch.tensor(2.0)) == 0.5


def test_readout_routing_measures_a_moved_node():
    """A replay whose own maximum lies far from the recorded node reports
    the gap in bf16 steps and the moved columns; a near-tie reports a small
    gap; columns that did not move add nothing."""
    import torch

    rec = torch.zeros(100, 4)
    rec[10] = 1.0          # the recorded node of every column
    routing = CS.readout_routing()
    with routing:
        torch.amax(rec, 0)
    other = rec.clone()
    other[20, 0] = 1.0078125   # one step above the recorded 1.0
    other[30, 1] = 1.25        # 32 steps above it
    with routing.replay():
        torch.amax(other, 0)
    assert routing.moves == [[(4, 2, 32.0)]]


@pytest.mark.parametrize("field,value,fails", [
    ("loss", 1.0, False), ("loss", 1.001, True),
    ("grad", 1.0, False), ("grad", 1.5, True),
    ("steps", CS.READOUT_STEPS, False), ("steps", CS.READOUT_STEPS + 0.5, True),
    ("share", CS.READOUT_SHARE, False), ("share", CS.READOUT_SHARE + 0.05, True),
    ("finite", False, True), ("loss", float("nan"), True),
])
def test_step_verdict_limits(field, value, fails):
    """``require_step`` fails a step hold past any one of its limits (the
    loss and the routed gradients at 1 of their tolerances, the routed
    readouts' gap and moved share), on a non-finite gradient, and on NaN;
    at each limit it passes."""
    r = {"loss": 0.5, "grad": 0.5, "worst": "w", "steps": 0.0,
         "share": 0.0, "finite": True}
    r[field] = value
    assert bool(CS.step_verdict(r)) == fails
    if fails:
        with pytest.raises(SystemExit, match="step hold"):
            CS.require_step(r, "x")
    else:
        CS.require_step(r, "x")
