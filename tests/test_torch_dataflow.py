"""PyTorch port, dataflow: the port's config, host numpy helpers, dataset,
collate/BSR metadata and loader against the JAX package's, bit for bit."""

import json

import numpy as np
import pytest

import cgcnet_tpu.dataflow.native as jax_native
from cgcnet_tpu.config import Config as JaxConfig
from cgcnet_tpu.core.convert import transpose_ell_np as jax_transpose
from cgcnet_tpu.dataflow.dataset import NucleiGraphDataset as JaxDataset
from cgcnet_tpu.dataflow.loader import GraphLoader as JaxLoader
from cgcnet_tpu.dataflow.synthetic import generate_dataset
from cgcnet_tpu.ops import fps as jax_fps
from cgcnet_tpu.ops import knn as jax_knn
from cgcnet_tpu.ops.pallas import bsr_kernel as jax_bsr
import cgcnet_tpu_torch.dataflow.native as port_native
from cgcnet_tpu_torch.config import Config
from cgcnet_tpu_torch.core.convert import transpose_ell_np
from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
from cgcnet_tpu_torch.dataflow.loader import GraphLoader
from cgcnet_tpu_torch.ops import bsr as port_bsr
from cgcnet_tpu_torch.ops.fps import farthest_point_sample_np, fuse_sample_np
from cgcnet_tpu_torch.ops.knn import radius_knn_np

FIELDS = ("x", "nbr", "nbr_mask", "nbr_t", "nbr_t_mask", "n_nodes", "y",
          "patch_idx", "blk_cols", "blk_mask", "blk_cols_t", "blk_mask_t")


def test_config_json_from_jax_loads_unchanged():
    jcfg = JaxConfig().apply_overrides(
        ["model.hidden_dim=8", "data.sample_ratio=0.25", "model.use_pallas=never",
         "model.pred_hidden_dims=[32, 16]", "train.lr=0.01"]
    )
    cfg = Config.from_json(jcfg.to_json())
    assert json.loads(cfg.to_json()) == json.loads(jcfg.to_json())
    assert cfg.model.pred_hidden_dims == (32, 16)
    assert cfg.run_id() == jcfg.run_id()
    with pytest.raises(KeyError):
        cfg.apply_overrides(["model.typo=1"])


def test_host_helpers_match(rng):
    pos = rng.uniform(0, 600, (300, 2)).astype(np.float32)
    for scan in (False, True):
        for a, b in zip(radius_knn_np(pos, 100.0, 8, scan_order=scan),
                        jax_knn.radius_knn_np(pos, 100.0, 8, scan_order=scan)):
            np.testing.assert_array_equal(a, b)
    nbr, mask = radius_knn_np(pos, 100.0, 8)
    for a, b in zip(transpose_ell_np(nbr, mask, 24), jax_transpose(nbr, mask, 24)):
        np.testing.assert_array_equal(a, b)
    dist = np.sqrt(((pos[:, None] - pos[None]) ** 2).sum(-1)).astype(np.float32)
    np.testing.assert_array_equal(
        farthest_point_sample_np(dist, 40, np.random.default_rng(3)),
        jax_fps.farthest_point_sample_np(dist, 40, np.random.default_rng(3)),
    )
    np.testing.assert_array_equal(
        fuse_sample_np(dist, 50, np.random.default_rng(4)),
        jax_fps.fuse_sample_np(dist, 50, np.random.default_rng(4)),
    )
    order = np.lexsort((pos[:, 1], np.floor(pos[:, 0] / 100.0)))
    nbr, mask = radius_knn_np(pos[order][:256], 100.0, 8)
    assert port_bsr.bsr_blocks_needed(nbr, mask) == jax_bsr.bsr_blocks_needed(nbr, mask)
    for a, b in zip(port_bsr.bsr_block_meta(nbr, mask, 4),
                    jax_bsr.bsr_block_meta(nbr, mask, 4)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dataflow") / "data"
    generate_dataset(str(root), patches_per_image=2, images_per_grade=1, seed=5)
    return root


def _overrides(root):
    return [f"data.root={root}", "data.max_num_nodes=500",
            "data.sample_ratio=0.5", "data.num_workers=2", "data.bsr_blocks=16"]


def _port_batches(root, split, epochs):
    cfg = Config().apply_overrides(_overrides(root))
    loader = GraphLoader(NucleiGraphDataset(cfg.data, split), 3, device="cpu",
                         shuffle=True, seed=7)
    return [
        {k: getattr(g, k).numpy() for k in FIELDS}
        for e in epochs for g in loader.epoch(e)
    ]


def _jax_batches(root, split, epochs):
    cfg = JaxConfig().apply_overrides(_overrides(root))
    loader = JaxLoader(JaxDataset(cfg.data, split), 3, shuffle=True, seed=7)
    return [
        {k: np.asarray(getattr(g, k)) for k in FIELDS}
        for e in epochs for g in loader.epoch(e)
    ]


@pytest.mark.parametrize("native", [True, False])
def test_batches_bit_equal(data_root, monkeypatch, native):
    """Same (seed, patch, epoch) -> the same padded ELL, transpose tables
    and BSR metadata, on the native fast path and on the numpy path."""
    if native:
        assert jax_native.available() == port_native.available()
    else:
        for mod in (jax_native, port_native):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_TRIED", True)
    split, epochs = ("train", (0, 1)) if native else ("valid", (0,))
    ours, ref = _port_batches(data_root, split, epochs), _jax_batches(
        data_root, split, epochs
    )
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        for k in FIELDS:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
