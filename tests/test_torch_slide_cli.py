"""PyTorch port, whole-slide CLI (``cgcnet_tpu_torch/cli/slide.py``) on the
CPU: grading a synthetic slide with JAX weights carried over (against JAX's
``mega_forward`` on JAX's own build of the same slide), the ``--slides``
stream with sticky caps, the ``--train-epochs``/``--out``/``--ckpt`` round
trip, ``load_partial``'s skipping, and the refusals (no card without
``--cpu``, more than one shard without the launcher's process group).

Logits are held at atol 2e-5, rtol 1e-4 (the golden tolerance); the round
trip exactly (the same weights through the same deterministic forward).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cgcnet_tpu.config import Config as JaxConfig
from cgcnet_tpu.core.graph import CellGraph as JaxCellGraph
from cgcnet_tpu.nn.model import CGCNet as JaxCGCNet
from cgcnet_tpu.parallel import mega_model as jmm
from cgcnet_tpu.parallel import slide_setup as jss
from cgcnet_tpu.parallel.mesh import make_mesh
from cgcnet_tpu_torch.cli import slide as slide_cli
from cgcnet_tpu_torch.config import Config
from cgcnet_tpu_torch.nn.model import CGCNet
from cgcnet_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    state_dict_from_flax,
)

from torch_port_util import random_tree

NUCLEI = 1500
OVERRIDES = ["model.max_num_nodes=1280", "model.drop_out=0.0"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several test workers share
    the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """(JAX variables, a port checkpoint of the same weights)."""
    jcfg = JaxConfig().apply_overrides(OVERRIDES).model
    k = 8
    g = JaxCellGraph(
        x=jnp.zeros((1, 256, jcfg.input_dim)),
        nbr=jnp.zeros((1, 256, k), jnp.int32), nbr_mask=jnp.zeros((1, 256, k)),
        n_nodes=jnp.asarray([256], jnp.int32),
    )
    variables = random_tree(
        lambda: JaxCGCNet(jcfg).init({"params": jax.random.key(0)}, g,
                                     train=False), 3)
    cfg = Config().apply_overrides(OVERRIDES)
    model = CGCNet(cfg.model)
    model.load_state_dict(state_dict_from_flax(variables))
    path = save_checkpoint(tmp_path_factory.mktemp("w") / "jax_weights.pt",
                           model.state_dict(), cfg, {"origin": "JAX"})
    return variables, path


def test_slide_cli_grades_like_jax(jax_weights):
    variables, ckpt = jax_weights
    res = slide_cli.main(["--cpu", "--synthetic", "--nuclei", str(NUCLEI),
                          "--ckpt", str(ckpt), *OVERRIDES])
    assert not res["bsr"] and res["n"] == NUCLEI and res["cap"] == 1536
    jcfg = JaxConfig().apply_overrides(OVERRIDES)
    feats, coords = jss.synthetic_slide(NUCLEI)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    build = jss.build_slide_inputs(jcfg, feats, coords, 1, mesh)
    ref = jax.jit(lambda v: jmm.mega_forward(v, jcfg.model, build.inputs,
                                             mesh, train=False,
                                             halo_overlap=True))(variables)
    np.testing.assert_allclose(res["logits"], np.asarray(ref), atol=2e-5,
                               rtol=1e-4)
    assert res["pred"] == int(np.argmax(np.asarray(ref)))


def test_slide_cli_stream_sticky_caps(jax_weights):
    _, ckpt = jax_weights
    res = slide_cli.main(["--cpu", "--synthetic", "--nuclei", str(NUCLEI),
                          "--ckpt", str(ckpt), "--slides", "3", *OVERRIDES])
    assert len(res["stream_preds"]) == 3
    assert res["shape_sets"] == 1 and res["slides_per_s"] > 0
    assert np.isfinite(res["logits"]).all()


def test_slide_cli_finetune_roundtrip(jax_weights, tmp_path):
    _, ckpt = jax_weights
    out = tmp_path / "finetuned.pt"
    res = slide_cli.main(["--cpu", "--synthetic", "--nuclei", str(NUCLEI),
                          "--ckpt", str(ckpt), "--train-epochs", "2",
                          "--out", str(out), *OVERRIDES])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert out.is_file()
    sd, cfg, meta = load_checkpoint(out)
    assert meta["slide_epochs"] == 2 and cfg.model.max_num_nodes == 1280
    back = slide_cli.main(["--cpu", "--synthetic", "--nuclei", str(NUCLEI),
                           "--ckpt", str(out), *OVERRIDES])
    np.testing.assert_array_equal(back["logits"], res["logits_finetuned"])
    assert not np.array_equal(back["logits"], res["logits"])


def test_load_partial_skips_mismatched(jax_weights, tmp_path):
    _, ckpt = jax_weights
    sd, cfg, _ = load_checkpoint(ckpt)
    sd["pred_out.weight"] = torch.zeros(7, 3)         # wrong shape
    sd["not_a_module.weight"] = torch.zeros(2)        # unknown
    path = save_checkpoint(tmp_path / "odd.pt", sd, cfg)
    model = CGCNet(Config().apply_overrides(OVERRIDES).model)
    copied, skipped = slide_cli.load_partial(model, path)
    assert set(skipped) == {"pred_out.weight", "not_a_module.weight"}
    assert len(copied) == len(sd) - 2
    torch.testing.assert_close(model.state_dict()["pool1.lin.weight"],
                               sd["pool1.lin.weight"])


def test_slide_cli_refuses(jax_weights):
    _, ckpt = jax_weights
    # more than one shard without the launcher's group: refused, naming it
    with pytest.raises(ValueError, match="torch.distributed.run"):
        slide_cli.main(["--cpu", "--synthetic", "--nuclei", "600",
                        "--shards", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--cpu"):
            slide_cli.main(["--synthetic", "--nuclei", "600"])
