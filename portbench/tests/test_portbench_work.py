"""``work.py``'s operation counts against counts made another way at tiny
shapes: every dense product of the plain reference's forward counted by
torch's FlopCounterMode, plus the sparse stage-1 products counted by hand
(2 multiply-add operations per nonzero and column)."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from toy import importable

importable()

from reference import graph as ref_graph  # noqa: E402
from reference import model as ref_model  # noqa: E402
import work  # noqa: E402

WIDTHS = dict(input_dim=5, hidden=4, assign=(6, 3), classes=3, pred_hidden=7)


def tiny_model():
    return types.SimpleNamespace(
        input_dim=WIDTHS["input_dim"], hidden_dim=WIDTHS["hidden"],
        assign_dims=WIDTHS["assign"], num_classes=WIDTHS["classes"],
        pred_hidden_dims=[WIDTHS["pred_hidden"]])


def tiny_graph(rng, n):
    coords = torch.as_tensor(rng.uniform(0, 60, (n, 2)), dtype=torch.float32)
    nbr, mask = ref_graph.radius_graph(coords, 20.0, 4)
    x = torch.as_tensor(rng.normal(size=(n, WIDTHS["input_dim"])),
                        dtype=torch.float32)
    return {"x": x, "nbr": nbr, "mask": mask}


def weights(gen):
    shapes = ref_model.parameter_shapes(**WIDTHS)
    P = {k: torch.randn(s, generator=gen) * 0.3 for k, s in shapes.items()}
    B = {}
    for k, s in shapes.items():
        if ".bn" in k and k.endswith(".weight"):
            base = k[: -len(".weight")]
            B[f"{base}.running_mean"] = torch.zeros(s)
            B[f"{base}.running_var"] = torch.ones(s)
    return P, B


@pytest.mark.parametrize("sizes", [(9,), (12, 7, 10)])
def test_graph_flops_is_the_reference_forwards_products(sizes):
    rng = np.random.default_rng(3)
    graphs = [tiny_graph(rng, n) for n in sizes]
    P, B = weights(torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as fc:
        ref_model.forward(P, B, graphs, train=False)
    h, f0, c1 = WIDTHS["hidden"], WIDTHS["input_dim"], WIDTHS["assign"][0]
    sparse = 0
    expect = 0
    for g in graphs:
        n = g["x"].shape[0]
        slots = int(g["mask"].sum())          # itself and its neighbours
        nnz = slots                           # the diagonal and the edges
        # stage 1 needs x aggregated once, each block's layers 2 and 3,
        # and A @ S for the pooled adjacency
        sparse += 2 * nnz * (f0 + 4 * h + c1)
        # the reference aggregates pooled stage 2's input once for each of
        # its two blocks; the work needs it once
        expect += work.graph_flops(n, slots - n, tiny_model()) \
            + 2 * c1 * c1 * h
    assert fc.get_total_flops() + sparse == expect


def test_training_counts_the_backward_as_twice_the_forward():
    m = types.SimpleNamespace(model=tiny_model())
    sizes = [(50, 180), (30, 100)]
    assert work.call_flops(m, sizes, True) == \
        3 * work.call_flops(m, sizes, False) == \
        3 * (work.graph_flops(50, 130, tiny_model())
             + work.graph_flops(30, 70, tiny_model()))


def test_bound_is_the_larger_of_bytes_and_operations():
    assert work.bound_s(3.35e12, 1.0, "float32") == pytest.approx(1.0)
    assert work.bound_s(1.0, 67e12, "float32") == pytest.approx(1.0)
    assert work.bound_s(1.0, 989e12, "bfloat16") == pytest.approx(1.0)


def test_kernel_bound_counts_the_sparse_products_and_the_head():
    cfg = types.SimpleNamespace(model=types.SimpleNamespace(
        **vars(tiny_model()), compute_dtype="float32"))
    sizes = [(10, 40), (6, 20)]
    rows, nnz = 16, 60
    f0, h, c1 = 5, 4, 6
    by_hand = 0.0
    for f in (f0, 2 * h, 2 * h, c1, 2 * h, 2 * h, c1):
        by_hand += max((2 * rows * f * 4 + nnz) / 3.35e12,
                       2 * nnz * f / 67e12)
    by_hand += max(rows * (2 * h + c1) * 4 / 3.35e12,
                   2 * rows * (2 * h + c1) * c1 / 67e12)
    assert work.kernel_bound_s(cfg, sizes, True) == pytest.approx(by_hand)
    fwd = work.kernel_bound_s(cfg, sizes, False)
    assert fwd < work.kernel_bound_s(cfg, sizes, True)
