"""PyTorch port, the profiler script's kernel list (CPU):
``scripts/profile_torch_forward.py`` tells the port's own kernels from
everything else in a device trace by ``OWN_KERNELS``, which must name every
``__global__`` kernel under ``cgcnet_tpu_torch/csrc`` and nothing else."""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several test workers share
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "profile_torch_forward", REPO / "scripts" / "profile_torch_forward.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _global_kernels() -> set[str]:
    names = set()
    for src in sorted((REPO / "cgcnet_tpu_torch" / "csrc").glob("*.cu")):
        text = src.read_text()
        found = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                           r"\s*)?(\w+)\s*\(", text)
        assert len(found) == text.count("__global__"), src.name
        names.update(found)
    return names


def test_own_kernels_are_the_sources_kernels(script):
    kernels = _global_kernels()
    assert kernels, "no __global__ kernel found under csrc/"
    assert len(script.OWN_KERNELS) == len(set(script.OWN_KERNELS))
    assert set(script.OWN_KERNELS) == kernels


@pytest.mark.parametrize("name,own", [
    ("void (anonymous namespace)::stats_kernel<float, 4, false>(float "
     "const*, (anonymous namespace)::Lin<float>, int const*, float*, float*, "
     "int, int, int, int, int)", True),
    ("(anonymous namespace)::stats_reduce_kernel(float const*, int, int, "
     "float*)", True),
    ("void (anonymous namespace)::build_blocks_kernel<signed char>(int "
     "const*, float const*, int const*, float const*, signed char*, int, "
     "int, int, int, int, int)", True),
    ("void (anonymous namespace)::gemm_tc_kernel<true, false>(...)", True),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_128x128_32x3_nn>"
     "(Params)", False),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float, "
     "float, float, at::native::(anonymous namespace)::SoftMaxForwardEpilogue>"
     "(float*, float const*, int)", False),
    ("ampere_sgemm_128x64_nn", False),
])
def test_own_kernel_names(script, name, own):
    assert script.own_kernel(name) is own


def test_recorded_variants_are_the_sources_kernels():
    """Each kernel a wrapper records in its ``variants`` is a ``__global__``
    kernel of ``csrc/``, the two of each choice differ, and the plain
    versions on the CPU record none."""
    from cgcnet_tpu_torch.ops import assign_head as ah
    from cgcnet_tpu_torch.ops import bsr

    bf, f32 = torch.bfloat16, torch.float32
    choices = [(bsr.banded_variant(bf, 128), bsr.banded_variant(bf, 64)),
               (bsr.banded_variant(bf, 1140), bsr.banded_variant(f32, 1140)),
               (bsr.bsr_matmul_variant(bf), bsr.bsr_matmul_variant(f32)),
               (ah.head_product(bf), ah.head_product(f32))]
    kernels = _global_kernels()
    for tc, other in choices:
        assert tc != other and {tc, other} <= kernels, (tc, other)
    records = [bsr.bsr_matmul.variants, bsr.bsr_matmul_banded.variants,
               ah.assign_head_softmax_pre.variants,
               ah.assign_head_softmax.variants,
               ah.assign_head_softmax_pre_lin.variants]
    before = [dict(r) for r in records]
    b, n, f12, c = 1, 128, 8, 16
    x12, p = torch.randn(b, n, f12), torch.randn(b, n, c)
    k12, k3f, const = torch.randn(f12, c), torch.randn(c, c), torch.zeros(c)
    nn_ = torch.tensor([100], dtype=torch.int32)
    ah.assign_head_softmax_pre(x12, p, k12, k3f, const, nn_)
    ah.assign_head_softmax(x12, p, k12, k3f, const, nn_)
    assert [dict(r) for r in records] == before
