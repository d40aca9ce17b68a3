"""PyTorch port, serving end to end: the port's predict CLI against the JAX
package's on one checkpoint, the import boundary, and device selection.

Logits are held at atol 2e-5, rtol 1e-4 (tests/test_golden.py): the JAX
CLI runs its XLA path on the CPU, the port its plain BSR path, so every
aggregation sums in another order.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import REPO


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several test workers share
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One JAX checkpoint (random init, perturbed BN statistics), served by
    both CLIs on a small synthetic split."""
    import jax
    from flax import serialization

    from cgcnet_tpu.cli.predict import main as jax_predict
    from cgcnet_tpu.config import Config as JaxConfig
    from cgcnet_tpu.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu.dataflow.loader import GraphLoader
    from cgcnet_tpu.dataflow.synthetic import generate_dataset
    from cgcnet_tpu.train.checkpoint import save_checkpoint
    from cgcnet_tpu.train.optim import make_optimizer
    from cgcnet_tpu.train.state import create_train_state
    from cgcnet_tpu_torch.cli.predict import main as port_predict
    from cgcnet_tpu_torch.config import Config
    from cgcnet_tpu_torch.train.checkpoint import (
        save_checkpoint as port_save,
        state_dict_from_flax,
    )

    tmp = tmp_path_factory.mktemp("torch_predict")
    root = tmp / "data"
    generate_dataset(str(root), patches_per_image=2, images_per_grade=2, seed=11)
    overrides = [
        f"data.root={root}", "data.max_num_nodes=500", "data.sample_ratio=0.5",
        "data.batch_size=4", "data.num_workers=2",
        "model.hidden_dim=8", "model.embedding_dim=8",
        "model.assign_hidden_dim=8", "model.drop_out=0.0",
    ]
    jcfg = JaxConfig().apply_overrides(overrides)
    jcfg = jcfg.apply_overrides(
        [f"model.max_num_nodes={jcfg.data.max_num_nodes}",
         f"model.input_dim={jcfg.data.num_features}"]
    )
    loader = GraphLoader(NucleiGraphDataset(jcfg.data, "valid"), 4, shuffle=False)
    example = next(iter(loader.epoch(0)))
    _, state = create_train_state(
        jcfg, make_optimizer(jcfg.train, steps_per_epoch=1), example
    )
    rng = np.random.default_rng(12)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.2).astype(np.float32)
        if p[-1].key == "mean"
        else rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32),
        state.batch_stats,
    )
    state = state.replace(batch_stats=stats)
    jax_ckpt = save_checkpoint(tmp / "jax", state, epoch=0)

    raw = serialization.msgpack_restore(jax_ckpt.read_bytes())
    cfg = Config().apply_overrides(overrides)
    port_ckpt = port_save(
        tmp / "port" / "model.pt",
        state_dict_from_flax({"params": raw["params"],
                              "batch_stats": raw["batch_stats"]}),
        cfg,
    )
    common = ["--reps", "2", *overrides]
    ref = jax_predict(
        ["--cpu", "--ckpt", str(jax_ckpt), "--out", str(tmp / "jax.jsonl"), *common]
    )
    ours = port_predict(
        ["--cpu", "--ckpt", str(port_ckpt), "--out", str(tmp / "port.jsonl"), *common]
    )

    def lines(name):
        return [json.loads(l) for l in (tmp / name).read_text().splitlines()]

    return ref, ours, lines("jax.jsonl"), lines("port.jsonl")


def test_predict_matches_jax_cli(served):
    ref, ours, ref_lines, our_lines = served
    assert set(ours) >= {"img_acc", "binary_acc", "patch_acc"}
    assert ours == ref
    assert len(our_lines) == len(ref_lines) == 12 + 1  # 12 patches + summary
    assert our_lines[-1] == ref_lines[-1]
    for a, b in zip(our_lines[:-1], ref_lines[:-1]):
        assert (a["patch"], a["image"], a["pred"], a["label"]) == (
            b["patch"], b["image"], b["pred"], b["label"]
        )
        np.testing.assert_allclose(a["logits"], b["logits"], atol=2e-5, rtol=1e-4)


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke.py, import with jax, flax,
    optax and the JAX package blocked."""
    code = (
        "import sys, pkgutil, importlib, importlib.util\n"
        "for name in ('jax', 'flax', 'optax', 'cgcnet_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import cgcnet_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    cgcnet_tpu_torch.__path__, 'cgcnet_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'cgcnet_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_predict_without_cpu_flag_needs_cuda(monkeypatch, tmp_path):
    """No silent CPU fallback: without --cpu and without CUDA, it raises."""
    from cgcnet_tpu_torch.cli.predict import main as port_predict

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_predict(["--ckpt", str(tmp_path / "none.pt")])
