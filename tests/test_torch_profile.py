"""PyTorch port, the profiler script's kernel list (CPU):
``scripts/profile_torch_forward.py`` tells the port's own kernels from
everything else in a device trace by ``OWN_KERNELS``, which must name every
``__global__`` kernel under ``cgcnet_tpu_torch/csrc`` and nothing else."""

import importlib.util
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


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
