"""PyTorch port, the serving export (``torch.export``): one case for each of
``tests/test_export.py``'s — the round trip, a symbolic batch, the shape
check, a missing field, a bad magic, the kernel artifact refused without a
card, the CLI end to end — with the portable artifact's logits held against
the JAX package's exported artifact (the whole-model rule, atol 2e-5 /
rtol 1e-4), and the kernels' custom ops on the CPU (schema and fake
implementations by ``torch.library.opcheck``; an exported program records
them and runs them after a reload). The kernel artifact itself needs a
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 12).
"""

import dataclasses
import json
import struct

import numpy as np
import pytest
import torch

import jax

from cgcnet_tpu.config import ModelConfig as JaxModelConfig
from cgcnet_tpu.nn import model as jmodel
from cgcnet_tpu.utils import export_model as jexport
from cgcnet_tpu_torch.config import ModelConfig
from cgcnet_tpu_torch.nn import model as tmodel
from cgcnet_tpu_torch.ops import assign_head as tah
from cgcnet_tpu_torch.ops import bsr as tbsr
from cgcnet_tpu_torch.train.checkpoint import state_dict_from_flax
from cgcnet_tpu_torch.utils.export_model import (
    export_forward,
    load_exported,
    read_header,
    save_exported,
)

from torch_port_util import (
    SMALL_MODEL,
    example_batch,
    jax_graph,
    random_tree,
    torch_graph,
)

MODEL_TOL = dict(atol=2e-5, rtol=1e-4)
PORTABLE = ("x", "nbr", "nbr_mask", "n_nodes")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several test workers share
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _portable(batch: dict) -> dict:
    return {k: batch[k] for k in PORTABLE}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Transplanted weights on a 256-row batch, and the portable artifact
    (symbolic batch) exported, saved and loaded back."""
    batch = _portable(example_batch(batch=2, cap=256))
    cfg = dict(SMALL_MODEL, max_num_nodes=256)
    jg = jax_graph(batch)
    net = jmodel.CGCNet(JaxModelConfig(use_pallas="never", **cfg))
    variables = random_tree(
        lambda: net.init({"params": jax.random.key(0)}, jg, train=False), 3)
    port = tmodel.CGCNet(ModelConfig(**cfg))
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    port.eval()
    program, header = export_forward(port, torch_graph(batch),
                                     symbolic_batch=True)
    path = tmp_path_factory.mktemp("exp") / "model.cgexp"
    save_exported(program, header, path)
    fwd, loaded = load_exported(path)
    return dict(batch=batch, cfg=cfg, net=net, variables=variables,
                port=port, header=header, path=path, fwd=fwd, loaded=loaded)


def _eager(port, batch):
    with torch.inference_mode():
        return port(torch_graph(batch)).numpy()


def test_export_roundtrip_matches_forward(case):
    fwd, header = case["fwd"], case["loaded"]
    assert header == case["header"]
    assert header["fields"] == list(PORTABLE)
    assert header["device"] == "cpu" and header["custom_ops"] == []
    assert header["requires"] is None
    got = fwd(torch_graph(case["batch"])).numpy()
    np.testing.assert_allclose(got, _eager(case["port"], case["batch"]),
                               atol=1e-6)


def test_portable_artifact_matches_jax_export(case, tmp_path):
    """The port's portable artifact and the JAX package's exported artifact
    of the same weights give the same logits."""
    exported, jheader = jexport.export_forward(
        case["net"], case["variables"], jax_graph(case["batch"]))
    jexport.save_exported(exported, jheader, tmp_path / "jax.cgexp")
    jfwd, _ = jexport.load_exported(tmp_path / "jax.cgexp")
    ref = np.asarray(jfwd(jax_graph(case["batch"])))
    fwd = case["fwd"]
    got = fwd(torch_graph(case["batch"])).numpy()
    assert got.shape == (2, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **MODEL_TOL)


def test_symbolic_batch_serves_any_batch(case):
    fwd, header = case["fwd"], case["loaded"]
    assert header["symbolic_batch"] and header["inputs"]["x"]["shape"][0] == "b"
    for bs, seed in ((1, 4), (3, 5)):
        b = _portable(example_batch(batch=bs, cap=256, seed=seed))
        np.testing.assert_allclose(fwd(torch_graph(b)).numpy(),
                                   _eager(case["port"], b), atol=1e-6)


def test_export_is_shape_checked(case):
    fwd = case["fwd"]
    g = torch_graph(case["batch"])
    with pytest.raises(ValueError, match="does not fit"):
        fwd(dataclasses.replace(g, x=torch.zeros((2, 128, g.x.shape[2]))))
    with pytest.raises(ValueError, match="does not fit"):
        fwd(dataclasses.replace(g, n_nodes=g.n_nodes.long()))
    with pytest.raises(ValueError, match="exported for cpu"):
        fwd(dataclasses.replace(g, x=g.x.to("meta")))


def test_export_missing_field_raises(case):
    fwd = case["fwd"]

    class _Bare:
        x = torch_graph(case["batch"]).x  # everything else absent

    with pytest.raises(ValueError, match="needs graph field"):
        fwd(_Bare())


def test_export_bad_magic_rejected(tmp_path):
    p = tmp_path / "junk.cgexp"
    head = json.dumps({"magic": "cgcnet_tpu.export.v1"}).encode()
    p.write_bytes(struct.pack("<Q", len(head)) + head + b"payload")
    with pytest.raises(ValueError, match="not a"):
        load_exported(p)
    p.write_bytes(b"\x00" * 4)
    with pytest.raises(ValueError, match="not a"):
        load_exported(p)


def test_kernel_export_rejected_without_card(case, tmp_path, monkeypatch):
    """The kernel artifact is exported on the card: without one the CLI
    raises (it writes no artifact that traced the plain versions), and a
    kernel artifact does not load."""
    from cgcnet_tpu_torch.cli.export import main as export_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_main(["--ckpt", "x.pt", "-o", str(tmp_path / "y.cgexp")])
    assert not (tmp_path / "y.cgexp").exists()
    header, payload = read_header(case["path"])
    head = json.dumps({**header, "device": "cuda"}).encode()
    (tmp_path / "k.cgexp").write_bytes(
        struct.pack("<Q", len(head)) + head + payload)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        load_exported(tmp_path / "k.cgexp")


def test_export_cli_end_to_end(tmp_path):
    """Train one synthetic epoch on the CPU -> export the checkpoint's
    portable artifact -> serve a loader batch with the logits of the
    checkpoint's eager model."""
    from cgcnet_tpu_torch.cli.export import main as export_main
    from cgcnet_tpu_torch.cli.predict import build_model, serving_config
    from cgcnet_tpu_torch.cli.train import main as train_main
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.train.checkpoint import load_checkpoint

    small = ["model.hidden_dim=8", "model.embedding_dim=8",
             "model.assign_hidden_dim=8", "data.num_workers=2"]
    result = train_main(["--cpu", "--synthetic", "train.num_epochs=1",
                         "train.test_epoch=1", f"train.ckpt_dir={tmp_path}",
                         *small])
    ckpt = next(tmp_path.rglob("model_best.pt"))
    cfg_json = json.loads((tmp_path.rglob("config.json").__next__()).read_text())
    over = [*small, "data.max_num_nodes=512", f"data.root={cfg_json['data']['root']}"]
    out = tmp_path / "model.cgexp"
    res = export_main(["--cpu", "--ckpt", str(ckpt), "-o", str(out),
                       "--batch", "4", *over])
    assert out.exists() and res["bytes"] > 0 and res["device"] == "cpu"
    fwd, header = load_exported(out)
    b, cap, _ = header["inputs"]["x"]["shape"]
    assert b == 4 and cap % 128 == 0
    cfg = serving_config(over)
    loader = GraphLoader(NucleiGraphDataset(cfg.data, "valid"), 4,
                         device="cpu", shuffle=False, num_workers=1)
    graph = next(iter(loader.epoch(0)))
    assert graph.capacity == cap
    model = build_model(cfg, load_checkpoint(ckpt)[0], torch.device("cpu"))
    with torch.inference_mode():
        want = model(dataclasses.replace(
            graph, nbr_t=None, nbr_t_mask=None, blk_cols=None, blk_mask=None,
            blk_cols_t=None, blk_mask_t=None)).numpy()
    got = fwd(graph).numpy()
    assert got.shape == (4, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert "img_acc" in result


# ---------------------------------------------------------------------------
# the kernels' custom ops, on the CPU
# ---------------------------------------------------------------------------

def _op_inputs(seed=0):
    """Small inputs of B1, B2, B4 and B6 (one 128-row tile, two slots)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    nbr = t(rng.integers(0, 256, (1, 128, 4)).astype(np.int32))
    w = t(rng.uniform(0, 1, (1, 128, 4)).astype(np.float32))
    blk_cols = t(np.array([[[0, 1]]], np.int32))
    blk_mask = t(np.ones((1, 1, 2), np.float32))
    vals = tbsr.bsr_build_blocks_plain(nbr, w, blk_cols, blk_mask)
    x = t(rng.normal(size=(1, 256, 8)).astype(np.float32))
    slots = tbsr.live_slot_counts(blk_mask)
    n_nodes = t(np.array([100], np.int32))
    head = [t(rng.normal(size=s).astype(np.float32))
            for s in ((1, 128, 6), (1, 128, 10), (6, 10), (10, 10), (10,))]
    return {
        "bsr_build_blocks": (nbr, w, blk_cols, blk_mask, torch.float32),
        "bsr_matmul": (vals, blk_cols, x, slots),
        "assign_head_softmax_pre": (*head, n_nodes, None),
        "assign_head_softmax": (*head, n_nodes),
    }


PLAIN = {
    "bsr_build_blocks": tbsr.bsr_build_blocks_plain,
    "bsr_matmul": tbsr.bsr_matmul_plain,
    "assign_head_softmax_pre": lambda *a: tah.assign_head_softmax_pre_plain(*a)[0],
    "assign_head_softmax": tah.assign_head_softmax_plain,
}


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_custom_op_matches_plain(name):
    """``torch.ops.cgcnet_tpu_torch.<name>`` on CPU tensors gives the plain
    version's values, and its schema and fake implementation pass
    ``torch.library.opcheck``."""
    args = _op_inputs()[name]
    op = getattr(torch.ops.cgcnet_tpu_torch, name)
    torch.testing.assert_close(op(*args), PLAIN[name](*args), rtol=0, atol=0)
    torch.library.opcheck(op.default, args)


def test_exported_program_records_and_runs_the_ops(tmp_path):
    """A program exported with the ops records them by name, survives
    torch.export.save / load, and runs them (here: the plain versions)."""
    ins = _op_inputs(1)

    class Ops(torch.nn.Module):
        def forward(self, nbr, w, blk_cols, blk_mask, x, slots, x12, p, k12,
                    k3f, const, n_nodes):
            ops = torch.ops.cgcnet_tpu_torch
            vals = ops.bsr_build_blocks(nbr, w, blk_cols, blk_mask,
                                        torch.float32)
            y = ops.bsr_matmul(vals, blk_cols, x, slots)
            s = ops.assign_head_softmax_pre(x12, p, k12, k3f, const, n_nodes)
            s6 = ops.assign_head_softmax(x12, p, k12, k3f, const, n_nodes)
            return y, s, s6

    args = (*ins["bsr_build_blocks"][:4], *ins["bsr_matmul"][2:],
            *ins["assign_head_softmax"])
    program = torch.export.export(Ops(), args)
    names = sorted(str(n.target) for n in program.graph.nodes
                   if str(n.target).startswith("cgcnet_tpu_torch."))
    assert names == [f"cgcnet_tpu_torch.{n}.default" for n in sorted(PLAIN)]
    torch.export.save(program, tmp_path / "ops.pt2")
    got = torch.export.load(tmp_path / "ops.pt2").module()(*args)
    want = Ops()(*args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
