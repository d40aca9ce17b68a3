"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program: each module's imports compared by
their whole top-level names (``cgcnet_tpu_torch`` is not ``cgcnet_tpu``)."""

from __future__ import annotations

import ast
import types

from toy import ROOT, importable

FORBIDDEN = {"jax", "jaxlib", "flax", "cgcnet_tpu"}


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def modules(under):
    return sorted(p for p in under.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(ROOT)): top_level_imports(p) & FORBIDDEN
             for p in modules(ROOT)}
    assert not {k: v for k, v in found.items() if v}
    assert len(found) >= 20          # every module was read


def test_reference_imports_nothing_of_the_program():
    found = {str(p.relative_to(ROOT)):
             top_level_imports(p) & {"cgcnet_tpu_torch", "cellkit",
                                     "harness", "drivers"}
             for p in modules(ROOT / "reference")}
    assert not {k: v for k, v in found.items() if v}


def test_scan_compares_whole_top_level_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import cgcnet_tpu_torch.ops\nfrom jaxtyping import X\n"
                   "import jax.numpy as jnp\nfrom cgcnet_tpu.nn import m\n")
    assert top_level_imports(src) & FORBIDDEN == {"jax", "cgcnet_tpu"}


def test_run_refuses_a_process_that_loaded_jax():
    importable()
    import run

    fake = {"cgcnet_tpu_torch": types.ModuleType("a"),
            "cgcnet_tpu_torch.ops": types.ModuleType("b"),
            "jaxtyping": types.ModuleType("c")}
    assert run.forbidden_loaded(fake) == []
    fake["jax.numpy"] = types.ModuleType("d")
    fake["cgcnet_tpu.nn"] = types.ModuleType("e")
    assert run.forbidden_loaded(fake) == ["cgcnet_tpu", "jax"]
