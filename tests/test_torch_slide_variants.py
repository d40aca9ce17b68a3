"""PyTorch port, whole-slide path, model variants: ``mega_forward`` against
JAX's (see tests/test_torch_slide_model.py for the setup, the reference
fault it works around and the tolerances) with GIN, GAT and ``norm_adj`` /
``jk`` off, on the gather path (the conv and tail options do not depend on
the stage-1 operator, which tests/test_torch_slide_model.py holds).
"""

import pytest
import torch

import cgcnet_tpu.ops.pallas.assign_head as jah
import cgcnet_tpu.ops.pallas.bsr_kernel as bk

from test_torch_slide_model import check_case


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


@pytest.mark.parametrize("case", ["gin", "gat", "plain_adj_no_jk"])
def test_mega_forward_variant_matches_jax(case):
    check_case(case)
