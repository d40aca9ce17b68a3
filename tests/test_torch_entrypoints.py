"""PyTorch port, the remaining entry points and host code against the JAX
package: the random graph sampler and the fixed-epoch index files (bit for
bit), datasets and loaders with ``use_fixed``, ``graph_sampler='random'``
and ``dynamic_buckets`` (the same capacities and arrays), a train step on a
bucketed batch and the collected assignments S1, S2 (the whole-model rule,
atol 2e-5 / rtol 1e-4), the GEXF dump (read back with networkx), the
nucleus features on OpenCV's and scipy's branches, the preprocess CLIs'
protos, the analytics, ``StepTimer``, the profiler's trace, ``debug_nans``
and the cross-validation driver.
"""

import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import networkx as nx

import cgcnet_tpu.ops.pallas.assign_head as jah
import cgcnet_tpu.ops.pallas.bsr_kernel as jbk
from cgcnet_tpu.config import Config as JaxConfig
from cgcnet_tpu.config import ModelConfig as JaxModelConfig
from cgcnet_tpu.dataflow import fixed_epochs as jfixed
from cgcnet_tpu.dataflow import random_graph as jrandom
from cgcnet_tpu.dataflow.dataset import NucleiGraphDataset as JaxDataset
from cgcnet_tpu.dataflow.loader import GraphLoader as JaxLoader
from cgcnet_tpu.dataflow.proto import list_protos as jax_list_protos
from cgcnet_tpu.dataflow.proto import load_proto as jax_load_proto
from cgcnet_tpu.nn import model as jmodel
from cgcnet_tpu.preprocess import features as jfeat
from cgcnet_tpu.utils import analytics as janalytics
from cgcnet_tpu.utils import gexf as jgexf
from cgcnet_tpu.utils.profiling import StepTimer as JaxStepTimer
from cgcnet_tpu_torch.config import Config, ModelConfig
from cgcnet_tpu_torch.dataflow import fixed_epochs as tfixed
from cgcnet_tpu_torch.dataflow import random_graph as trandom
from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
from cgcnet_tpu_torch.dataflow.loader import GraphLoader
from cgcnet_tpu_torch.dataflow.synthetic import generate_dataset
from cgcnet_tpu_torch.nn import model as tmodel
from cgcnet_tpu_torch.preprocess import features as tfeat
from cgcnet_tpu_torch.train.checkpoint import state_dict_from_flax
from cgcnet_tpu_torch.train.loop import make_train_step
from cgcnet_tpu_torch.train.state import create_train_state
from cgcnet_tpu_torch.utils import analytics as tanalytics
from cgcnet_tpu_torch.utils import gexf as tgexf
from cgcnet_tpu_torch.utils import profiling as tprof

from torch_port_util import (
    SMALL_MODEL,
    example_batch,
    jax_graph,
    random_tree,
    torch_graph,
)

FIELDS = ("x", "nbr", "nbr_mask", "nbr_t", "nbr_t_mask", "n_nodes", "y",
          "patch_idx", "blk_cols", "blk_mask", "blk_cols_t", "blk_mask_t")
MODEL_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
# patches of 150..600 nuclei sampled at 0.5: 75..300 rows, so the bucketed
# batches pad to 128, 256 or 512 rows
BUCKET_DATA = dict(patches_per_image=2, images_per_grade=1, n_nodes=(150, 600),
                   seed=3)
DATA_OVER = ["data.max_num_nodes=600", "data.num_workers=1",
             "data.min_nodes_no_subsample=50"]


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
    jbk.set_interpret(True)
    jah.set_interpret(True)
    yield
    jbk.set_interpret(False)
    jah.set_interpret(False)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("entry_data") / "data"
    generate_dataset(str(root), **BUCKET_DATA)
    return root


def _port_batches(loader, epochs=(0,)):
    return [{k: getattr(g, k).numpy() for k in FIELDS if getattr(g, k) is not None}
            for e in epochs for g in loader.epoch(e)]


def _jax_batches(loader, epochs=(0,)):
    return [{k: np.asarray(getattr(g, k)) for k in FIELDS
             if getattr(g, k) is not None}
            for e in epochs for g in loader.epoch(e)]


def _assert_batches_equal(ours, ref):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# the numpy modules, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_sample", [3, 8])
def test_random_graph_bit_equal(n_sample):
    pos = np.random.default_rng(1).uniform(0, 400, (160, 2)).astype(np.float32)
    ours = trandom.random_distance_graph_ell(
        pos, 100.0, n_sample, np.random.default_rng(9))
    ref = jrandom.random_distance_graph_ell(
        pos, 100.0, n_sample, np.random.default_rng(9))
    assert ours[0].shape == (160, 2 * n_sample + 1)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _fixed_tree(data_root, tmp_path, pkg):
    root = tmp_path / f"fixed_{pkg}"
    shutil.copytree(data_root, root)
    cfg = (Config if pkg == "port" else JaxConfig)().apply_overrides(
        [f"data.root={root}", *DATA_OVER]).data
    (tfixed if pkg == "port" else jfixed).generate_fixed_epochs(
        cfg, num_epochs=2, processes=1)
    return root, cfg


def test_fixed_epoch_files_bit_equal(data_root, tmp_path):
    """generate_fixed_epochs writes the same index files (same layout, same
    indices) as the JAX package's."""
    ours, cfg = _fixed_tree(data_root, tmp_path, "port")
    ref, _ = _fixed_tree(data_root, tmp_path, "jax")
    files = sorted(p.relative_to(ours) for p in
                   tfixed.fixed_dir(ours, cfg.sampling_method).rglob("*.npy"))
    assert files == sorted(p.relative_to(ref) for p in
                           jfixed.fixed_dir(ref, cfg.sampling_method).rglob("*.npy"))
    assert len(files) == 2 * len(jax_list_protos(
        ours, ["fold_1", "fold_2", "fold_3"]))
    for rel in files:
        a, b = np.load(ours / rel), np.load(ref / rel)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_use_fixed_batches_match_jax_and_online(data_root, tmp_path):
    """use_fixed loaders give the JAX loader's batches, and each replayed
    training batch equals the online-sampled one bit for bit."""
    ours_root, _ = _fixed_tree(data_root, tmp_path, "port")
    ref_root, _ = _fixed_tree(data_root, tmp_path, "jax")
    fixed = ["data.use_fixed=true", "data.num_fixed_epochs=2"]
    cfg = Config().apply_overrides([f"data.root={ours_root}", *DATA_OVER, *fixed])
    jcfg = JaxConfig().apply_overrides([f"data.root={ref_root}", *DATA_OVER, *fixed])
    replay = GraphLoader(NucleiGraphDataset(cfg.data, "train"), 4,
                         device="cpu", shuffle=False, num_workers=1)
    ours = _port_batches(replay, epochs=(0, 1, 2))
    ref = _jax_batches(JaxLoader(JaxDataset(jcfg.data, "train"), 4,
                                 shuffle=False, num_workers=1, wire=False),
                       epochs=(0, 1, 2))
    _assert_batches_equal(ours, ref)
    online_cfg = Config().apply_overrides([f"data.root={ours_root}", *DATA_OVER])
    online = GraphLoader(NucleiGraphDataset(online_cfg.data, "train"), 4,
                         device="cpu", shuffle=False, num_workers=1)
    _assert_batches_equal(ours[:6], _port_batches(online, epochs=(0, 1)))


def test_random_sampler_batches_match_jax(data_root):
    over = [f"data.root={data_root}", *DATA_OVER, "data.graph_sampler=random",
            "data.max_neighbours=4"]
    ours = _port_batches(GraphLoader(
        NucleiGraphDataset(Config().apply_overrides(over).data, "valid"), 4,
        device="cpu", shuffle=False, num_workers=1))
    ref = _jax_batches(JaxLoader(
        JaxDataset(JaxConfig().apply_overrides(over).data, "valid"), 4,
        shuffle=False, num_workers=1, wire=False))
    _assert_batches_equal(ours, ref)
    assert ours[0]["nbr"].shape[-1] == 2 * 4 + 1


@pytest.fixture(scope="module")
def bucketed(data_root):
    """Port and JAX batches of the training split with dynamic buckets."""
    over = [f"data.root={data_root}", *DATA_OVER, "data.dynamic_buckets=true"]
    cfg = Config().apply_overrides(over)
    loader = GraphLoader(NucleiGraphDataset(cfg.data, "train"), 2,
                         device="cpu", shuffle=True, num_workers=1, seed=3,
                         dynamic_buckets=True)
    jloader = JaxLoader(JaxDataset(JaxConfig().apply_overrides(over).data, "train"),
                        2, shuffle=True, num_workers=1, seed=3, wire=False,
                        dynamic_buckets=True)
    return _port_batches(loader, (0, 1)), _jax_batches(jloader, (0, 1))


def test_dynamic_bucket_batches_match_jax(bucketed):
    ours, ref = bucketed
    _assert_batches_equal(ours, ref)
    caps = {b["x"].shape[1] for b in ours}
    assert len(caps) >= 2, caps          # at least two buckets
    for b in ours:
        cap = b["x"].shape[1]
        assert cap & (cap - 1) == 0 and cap >= b["n_nodes"].max() > cap // 2
        assert b["blk_cols"].shape[1] == cap // 128


def test_bucketed_train_step_matches_jax(bucketed):
    """One training step (loss, logits, every gradient) on the smallest
    bucket's batch, the port's plain versions of B1-B5 against JAX's
    Pallas path in interpret mode."""
    ours, _ = bucketed
    b = min(ours, key=lambda a: a["x"].shape[1])
    jg = jax_graph({k: b[k] for k in FIELDS if k != "patch_idx"})
    net = jmodel.CGCNet(JaxModelConfig(use_pallas="always", **SMALL_MODEL))
    variables = random_tree(
        lambda: net.init({"params": jax.random.key(0)}, jg, train=False), 2)

    def loss_fn(params):
        out, _ = net.apply({**variables, "params": params}, jg, train=True,
                           mutable=["batch_stats"])
        return jmodel.cross_entropy_loss(out, jg.y), out

    (ref_loss, ref_logits), ref_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    port = tmodel.CGCNet(ModelConfig(**SMALL_MODEL))
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    port.train()
    tg = torch_graph({k: b[k] for k in FIELDS if k != "patch_idx"})
    logits = port(tg)
    loss = tmodel.cross_entropy_loss(logits, tg.y)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), **MODEL_TOL)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits),
                               **MODEL_TOL)
    ref_grads = state_dict_from_flax({"params": ref_grads})
    for k, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[k].numpy(),
                                   err_msg=k, **GRAD_TOL)


# ---------------------------------------------------------------------------
# visualize: collect_assign and the GEXF dump
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def assign_case():
    jbk.set_interpret(True)
    jah.set_interpret(True)
    batch = example_batch(batch=2, cap=1024)
    jg = jax_graph(batch)
    net = jmodel.CGCNet(JaxModelConfig(use_pallas="always", **SMALL_MODEL))
    variables = random_tree(
        lambda: net.init({"params": jax.random.key(0)}, jg, train=False), 1)
    ref_logits, ref_s = jax.jit(
        lambda v, g: net.apply(v, g, train=False, collect_assign=True)
    )(variables, jg)
    port = tmodel.CGCNet(ModelConfig(**SMALL_MODEL))
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.inference_mode():
        logits, s = port.eval()(torch_graph(batch), collect_assign=True)
    return batch, (logits.numpy(), [a.numpy() for a in s]), (
        np.asarray(ref_logits), [np.asarray(a) for a in ref_s])


def test_collect_assign_matches_jax(assign_case):
    """S1 (the fused "pre" head's output, B4's plain version against JAX's
    Pallas kernel) and S2 within the whole-model rule."""
    batch, (logits, s), (ref_logits, ref_s) = assign_case
    np.testing.assert_allclose(logits, ref_logits, **MODEL_TOL)
    assert [a.shape for a in s] == [(2, 1024, 204), (2, 204, 20)]
    for a, r in zip(s, ref_s):
        np.testing.assert_allclose(a, r, **MODEL_TOL)


def test_gexf_matches_jax(assign_case, tmp_path):
    """The port's GEXF (xml.etree) and JAX's (networkx) of the same patch
    read back as the same graph: nodes, attributes, edges."""
    batch, (_, s), _ = assign_case
    n = int(batch["n_nodes"][0])
    args = (batch["x"][0, :, -2:], batch["nbr"][0], batch["nbr_mask"][0],
            [a[0] for a in s])
    tgexf.assignments_to_gexf(*args, tmp_path / "ours.gexf", n_nodes=n)
    jgexf.assignments_to_gexf(*args, tmp_path / "ref.gexf", n_nodes=n)
    ours = nx.read_gexf(tmp_path / "ours.gexf")
    ref = nx.read_gexf(tmp_path / "ref.gexf")
    assert ours.number_of_nodes() == n and ours.number_of_edges() > n
    assert list(ours.nodes(data=True)) == list(ref.nodes(data=True))
    assert list(ours.edges(data=True)) == list(ref.edges(data=True))


# ---------------------------------------------------------------------------
# preprocess: features and the CLIs
# ---------------------------------------------------------------------------

def _tile(rng, h=96, w=96, step=24, r=5):
    mask = np.zeros((h, w), np.int64)
    lab = 1
    y, x = np.ogrid[:h, :w]
    for cy in range(12, h, step):
        for cx in range(12, w, step):
            ry, rx = r + rng.integers(0, 3), r + rng.integers(0, 3)
            mask[((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 <= 1] = lab
            lab += 1
    return mask, rng.integers(40, 200, (h, w)).astype(np.uint8)


@pytest.mark.parametrize("branch", ["cv2", "scipy"])
def test_features_match_jax(monkeypatch, branch):
    """extract_patch_features on OpenCV's branch and, with the modules'
    cv2 set to None in both packages, on scipy's."""
    if branch == "scipy":
        monkeypatch.setattr(tfeat, "cv2", None)
        monkeypatch.setattr(jfeat, "cv2", None)
    else:
        assert tfeat.cv2 is not None and jfeat.cv2 is not None
    mask, gray = _tile(np.random.default_rng(4))
    ours = tfeat.extract_patch_features(mask, gray)
    ref = jfeat.extract_patch_features(mask, gray)
    assert ours[0].shape == (16, 16)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tfeat.local_entropy(gray),
                                  jfeat.local_entropy(gray))


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    """Instance masks with PNG images (for both packages) and the same
    images as .npy (the port's reader without OpenCV)."""
    import cv2

    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("raw")
    for fold in ("fold_1", "fold_3"):
        for gdir in ("1_normal", "3_high_grade"):
            for d in ("masks", "images", "npy_images"):
                (root / d / fold / gdir).mkdir(parents=True)
            mask, gray = _tile(rng)
            np.save(root / "masks" / fold / gdir / "img0_grade_1_0.npy", mask)
            cv2.imwrite(str(root / "images" / fold / gdir / "img0_grade_1_0.png"),
                        np.repeat(gray[..., None], 3, -1))
            np.save(root / "npy_images" / fold / gdir / "img0_grade_1_0.npy", gray)
    _reference_tree(root / "reference", rng)
    return root


class _FakeData:
    """Stands in for a torch_geometric Data pickle (x, pos, y)."""

    def __init__(self, x, pos, y):
        self.x, self.pos, self.y = x, pos, y


def _reference_tree(root, rng):
    """The reference's on-disk layouts: feature/coordinate .npy pairs
    under proto/, and a torch-pickled Data proto (x with the coordinates
    appended)."""
    for fold in ("fold_1", "fold_3"):
        for grade in ("1_normal", "3_high_grade"):
            n = int(rng.integers(60, 120))
            rel = Path(fold) / grade / "img0_grade_x_0"
            for kind, width in (("feature", 16), ("coordinate", 2)):
                p = root / "proto" / kind / "colorectal" / rel
                p.parent.mkdir(parents=True, exist_ok=True)
                np.save(str(p) + ".npy",
                        rng.uniform(0, 3584, (n, width)).astype(np.float32))
    feats = rng.normal(size=(80, 16)).astype(np.float32)
    coords = rng.uniform(0, 3584, (80, 2)).astype(np.float32)
    p = root / "fold_2" / "2_low_grade" / "imgZ_grade_2_0.pt"
    p.parent.mkdir(parents=True)
    torch.save(_FakeData(torch.from_numpy(np.concatenate([feats, coords], -1)),
                         torch.from_numpy(coords), torch.tensor([1])), p)


def _protos(root, folds=("fold_1", "fold_2", "fold_3")):
    names = jax_list_protos(root, list(folds))
    return {n: jax_load_proto(root, n) for n in names}


def _same_protos(ours, ref):
    a, b = _protos(ours), _protos(ref)
    assert sorted(a) == sorted(b) and a
    for n in a:
        np.testing.assert_array_equal(a[n].features, b[n].features)
        np.testing.assert_array_equal(a[n].coords, b[n].coords)
        assert a[n].label == b[n].label


def test_preprocess_cli_matches_jax(raw_tree, tmp_path):
    """features (PNG images; .npy images without OpenCV), fixed and
    import-reference write the JAX CLI's protos and index files."""
    from cgcnet_tpu.cli.preprocess import main as jmain
    from cgcnet_tpu_torch.cli.preprocess import main as tmain

    for main, out in ((tmain, "ours"), (jmain, "ref")):
        assert main(["features", "--masks", str(raw_tree / "masks"),
                     "--images", str(raw_tree / "images"),
                     "--out", str(tmp_path / out), "--processes", "1"]) == 0
        assert main(["fixed", "--root", str(tmp_path / out), "--epochs", "2",
                     "--processes", "1", "data.min_nodes_no_subsample=4"]) == 0
        assert main(["import-reference", "--src", str(raw_tree / "reference"),
                     "--dst", str(tmp_path / f"{out}_imported")]) == 0
    _same_protos(tmp_path / "ours", tmp_path / "ref")
    _same_protos(tmp_path / "ours_imported", tmp_path / "ref_imported")
    assert len(_protos(tmp_path / "ours_imported")) == 5
    fixed = sorted((tmp_path / "ours" / "proto").glob("fixed_*/*/*/*/*.npy"))
    assert len(fixed) == 2 * 4
    for p in fixed:
        rel = p.relative_to(tmp_path / "ours")
        np.testing.assert_array_equal(np.load(p), np.load(tmp_path / "ref" / rel))
    assert tmain(["features", "--masks", str(raw_tree / "masks"),
                  "--images", str(raw_tree / "npy_images"),
                  "--out", str(tmp_path / "npy"), "--processes", "1"]) == 0
    _same_protos(tmp_path / "npy", tmp_path / "ours")
    ds = NucleiGraphDataset(Config().apply_overrides([
        f"data.root={tmp_path / 'npy'}", "data.max_num_nodes=64",
        "data.min_nodes_no_subsample=4"]).data, "train")
    assert ds.get(0).n_nodes > 0


def test_preprocess_without_cv2_names_it(raw_tree, tmp_path, monkeypatch):
    """Without OpenCV a PNG image cannot be read: the CLI raises an
    ImportError naming cv2 instead of zeroing the intensity features."""
    from cgcnet_tpu_torch.cli.preprocess import main

    monkeypatch.setattr(tfeat, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        main(["features", "--masks", str(raw_tree / "masks"),
              "--images", str(raw_tree / "images"),
              "--out", str(tmp_path / "x"), "--processes", "1"])


# ---------------------------------------------------------------------------
# analytics, profiling, debug_nans, crossval
# ---------------------------------------------------------------------------

def test_analytics_match_jax(data_root):
    folds = ["fold_1", "fold_2", "fold_3"]
    assert tanalytics.max_nodes_in_dataset(str(data_root), folds) == \
        janalytics.max_nodes_in_dataset(str(data_root), folds)
    for a, b in zip(tanalytics.dataset_feature_stats(str(data_root), folds),
                    janalytics.dataset_feature_stats(str(data_root), folds)):
        np.testing.assert_array_equal(a, b)


def test_step_timer_matches_jax(monkeypatch):
    """The same clock readings give the same step means and edges/s."""
    readings = np.cumsum([0.5, 0.25, 0.5, 1.0, 0.125]).tolist()
    results = []
    for cls in (tprof.StepTimer, JaxStepTimer):
        it = iter(readings)
        monkeypatch.setattr(time, "perf_counter", lambda: next(it))
        timer = cls(window=3)
        timer.start()
        for e in (10, 20, 30, 40):
            timer.update(e)
        results.append((timer.mean_step_s, timer.edges_per_s))
    assert results[0] == results[1] and results[0][0] > 0


def test_trace_context_writes_a_trace(tmp_path):
    with tprof.trace_context(tmp_path / "prof") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    trace = (tmp_path / "prof" / tprof.TRACE_NAME).read_text()
    assert "aten::mm" in trace
    with tprof.trace_context(None) as none:
        assert none is None


def test_debug_nans_raises_on_a_planted_nan(data_root, tmp_path):
    """A clean step passes; a NaN planted in x raises (anomaly mode in the
    backward, or the finite check of the loss)."""
    cfg = Config().apply_overrides([
        f"data.root={data_root}", *DATA_OVER, "data.sample_ratio=1.0",
        "data.max_num_nodes=128", "model.max_num_nodes=128",
        "model.hidden_dim=8", "model.embedding_dim=8",
        "model.assign_hidden_dim=8", "train.debug_nans=true"])
    graph = torch_graph({k: v for k, v in example_batch(2, 256).items()})
    state = create_train_state(cfg, "cpu")
    step = make_train_step(debug_nans=True)
    with tprof.enable_debug_checks(True):
        assert np.isfinite(float(step(state, graph)["loss"]))
        bad = graph.x.clone()
        bad[0, 3, 2] = float("nan")
        import dataclasses

        with pytest.raises((FloatingPointError, RuntimeError), match="nan|finite"):
            step(state, dataclasses.replace(graph, x=bad))
    with pytest.raises(FloatingPointError, match="gradient of w"):
        tprof.assert_finite({"loss": torch.tensor(1.0),
                             "gradient of w": torch.tensor([0.0, np.inf])})


def test_crossval_aggregates_folds(monkeypatch):
    """Three folds through cli.train.main with the flags passed through;
    the mean of each metric is the folds' mean."""
    from cgcnet_tpu_torch.cli import crossval
    from cgcnet_tpu_torch.cli import train as train_cli

    calls = []

    def fake_train(argv):
        calls.append(argv)
        fold = int(argv[-1].split("=")[1])
        return {"img_acc": fold / 4, "binary_acc": 1 - fold / 8,
                "patch_acc": 0.5, "run_dir": f"r{fold}"}

    monkeypatch.setattr(train_cli, "main", fake_train)
    out = crossval.main(["--cpu", "--synthetic", "train.num_epochs=1"])
    assert [c[-1] for c in calls] == [f"data.cross_val={f}" for f in (1, 2, 3)]
    assert all(c[:3] == ["--cpu", "--synthetic", "train.num_epochs=1"]
               for c in calls)
    assert out["mean"] == {"img_acc": 0.5, "binary_acc": 0.75, "patch_acc": 0.5}
    assert sorted(out["folds"]) == [1, 2, 3]


def test_crossval_runs_three_folds(tmp_path):
    """The driver end to end on the CPU: one short epoch per fold, finite
    fold results, the mean of each metric."""
    from cgcnet_tpu_torch.cli import crossval

    out = crossval.main([
        "--cpu", "--synthetic", "train.num_epochs=1", "train.test_epoch=1",
        f"train.ckpt_dir={tmp_path}", "model.hidden_dim=8",
        "model.embedding_dim=8", "model.assign_hidden_dim=8",
        "data.num_workers=2"])
    for key, mean in out["mean"].items():
        vals = [out["folds"][f][key] for f in (1, 2, 3)]
        assert np.isfinite(vals).all()
        assert mean == pytest.approx(float(np.mean(vals)))
    assert len({out["folds"][f]["run_dir"] for f in (1, 2, 3)}) == 3
