"""PyTorch port, training entry points: ``cli.train`` end to end on a
synthetic split (JSONL records with the JAX package's kinds and keys,
checkpoints, ``--eval-only`` from the best checkpoint), an exact resume,
the loader's training options against the JAX loader, and no CPU fallback.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cgcnet_tpu.config import Config as JaxConfig
from cgcnet_tpu.dataflow.dataset import NucleiGraphDataset as JaxDataset
from cgcnet_tpu.dataflow.loader import GraphLoader as JaxLoader
from cgcnet_tpu_torch.cli import train as train_cli
from cgcnet_tpu_torch.config import Config
from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
from cgcnet_tpu_torch.dataflow.loader import GraphLoader
from cgcnet_tpu_torch.dataflow.synthetic import generate_dataset
from cgcnet_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_train_checkpoint,
    resolve_resume_path,
)
from cgcnet_tpu_torch.train.loop import (
    Trainer,
    evaluate,
    make_train_step,
    resume_state,
)
from cgcnet_tpu_torch.train.state import create_train_state

SMALL = ["model.hidden_dim=8", "model.embedding_dim=8",
         "model.assign_hidden_dim=8", "data.num_workers=2"]
# the records cgcnet_tpu/train/loop.py writes: "val" :256, "train" :289-297,
# "epoch" :319-327
JAX_RECORDS = {
    "train": {"kind", "epoch", "batch", "loss", "acc"},
    "val": {"kind", "epoch", "img_acc", "binary_acc", "patch_acc"},
    "epoch": {"kind", "epoch", "avg_loss", "time_s", "edges_per_s"},
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on the same cores, and torch's default of one thread per core
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """Two epochs of ``cli.train --cpu --synthetic`` (48 training patches,
    12 batches an epoch) with validation every 5 batches."""
    tmp = tmp_path_factory.mktemp("torch_trainer")
    result = train_cli.main([
        "--cpu", "--synthetic", "train.num_epochs=2", f"train.ckpt_dir={tmp}",
        "train.eval_every_batches=5", "train.log_every=4", "train.test_epoch=1",
        *SMALL,
    ])
    return Path(result["run_dir"]), result


def test_cli_train_synthetic_runs(cli_run):
    run_dir, result = cli_run
    assert {"img_acc", "binary_acc", "patch_acc"} <= set(result)
    records = [json.loads(line)
               for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    kinds = [r["kind"] for r in records]
    # per epoch: train records at batches 3, 7, 11; validation after
    # batches 4 and 9 and at the epoch's end
    assert kinds.count("train") == 6 and kinds.count("epoch") == 2
    assert kinds.count("val") == 6
    for r in records:
        assert set(r) == JAX_RECORDS[r["kind"]], r
        assert all(np.isfinite(v) for v in r.values() if not isinstance(v, str))
    assert [r["batch"] for r in records if r["kind"] == "train"] == [3, 7, 11] * 2
    for name in ("weight.pt", "model_best.pt", "config.json"):
        assert (run_dir / name).is_file()
    # a training checkpoint still serves (cli.predict's loader)
    state_dict, cfg, meta = load_checkpoint(run_dir / "weight.pt")
    assert meta["epoch"] == 1 and cfg.train.num_epochs == 2
    assert "pool1.lin.weight" in state_dict


def test_cli_eval_only_from_best(cli_run):
    run_dir, _ = cli_run
    out = train_cli.main([
        "--cpu", "--eval-only", "--config", str(run_dir / "config.json"),
        "train.resume=best",
    ])
    assert out["run_dir"] == str(run_dir)
    assert {"img_acc", "binary_acc", "patch_acc"} <= set(out)


def test_resume_restores_exactly(cli_run, tmp_path):
    """An epoch through ``Trainer``; a fresh state resumed from its
    checkpoint holds the same step, parameters, optimizer moments, schedule
    and dropout generator, so the next step (dropout on) is bit-identical."""
    run_dir, _ = cli_run
    cfg = Config.from_json((run_dir / "config.json").read_text()).apply_overrides(
        [f"train.ckpt_dir={tmp_path}", "train.num_epochs=1", "train.log_every=100",
         "train.step_size=1", "train.gamma=0.5"]
    )
    loader = GraphLoader(NucleiGraphDataset(cfg.data, "train"), 4, device="cpu",
                         shuffle=True, num_workers=2, seed=cfg.data.seed,
                         drop_last=True)
    trainer = Trainer(cfg, create_train_state(cfg, "cpu"), loader)
    trainer.train()
    live = trainer.state
    resumed, start = resume_state(
        cfg.apply_overrides(["train.resume=weight"]),
        create_train_state(cfg, "cpu", seed=99),
    )
    assert start == 1 and resumed.step == live.step == loader.batches_per_epoch()
    assert resumed.scheduler.get_last_lr() == live.scheduler.get_last_lr() == [5e-4]
    assert torch.equal(resumed.generator.get_state(), live.generator.get_state())
    graph = next(iter(loader.epoch(1)))
    step = make_train_step()
    for st in (live, resumed):
        step(st, graph)
    for (name, a), b in zip(live.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = live.optimizer.state_dict(), resumed.optimizer.state_dict()
    for k in sa["state"]:
        for key, v in sa["state"][k].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb["state"][k][key]))


def test_resume_path_names(tmp_path):
    assert resolve_resume_path(tmp_path, "best") == tmp_path / "model_best.pt"
    assert resolve_resume_path(tmp_path, "weight") == tmp_path / "weight.pt"
    assert resolve_resume_path(tmp_path, "/x/y.pt") == Path("/x/y.pt")
    state = create_train_state(Config().apply_overrides(SMALL), "cpu")
    with pytest.raises(FileNotFoundError):
        load_train_checkpoint(tmp_path / "weight.pt", state)


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_trainer_data") / "data"
    generate_dataset(str(root), patches_per_image=2, images_per_grade=1, seed=5)
    return root


def test_loader_training_options_match_jax(small_root):
    """drop_last and batches_per_epoch as the JAX loader has them; the
    shuffled batch composition is bit-equal for the same (seed, epoch)."""
    over = [f"data.root={small_root}", "data.max_num_nodes=500",
            "data.num_workers=2"]
    ours = GraphLoader(NucleiGraphDataset(Config().apply_overrides(over).data, "train"),
                       5, device="cpu", shuffle=True, seed=7, drop_last=True)
    ref = JaxLoader(JaxDataset(JaxConfig().apply_overrides(over).data, "train"),
                    5, shuffle=True, seed=7, drop_last=True)
    assert ours.batches_per_epoch() == ref.batches_per_epoch() == 12 // 5
    for epoch in (0, 1):
        a = [g.patch_idx.numpy() for g in ours.epoch(epoch)]
        b = [np.asarray(g.patch_idx) for g in ref.epoch(epoch)]
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_no_cpu_fallback(monkeypatch, small_root):
    """Without --cpu and without CUDA the CLI raises, and the loader
    defaults to the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--synthetic", "train.num_epochs=1"])
    cfg = Config().apply_overrides([f"data.root={small_root}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphLoader(NucleiGraphDataset(cfg.data, "valid"), 4)


def test_unported_options_raise(small_root, tmp_path):
    cfg = Config().apply_overrides(
        [f"data.root={small_root}", f"train.ckpt_dir={tmp_path}", *SMALL])
    ds = NucleiGraphDataset(cfg.data, "valid")
    with pytest.raises(NotImplementedError, match="dynamic_buckets"):
        GraphLoader(ds, 4, device="cpu", dynamic_buckets=True)
    loader = GraphLoader(ds, 4, device="cpu")
    state = create_train_state(cfg, "cpu")
    for key in ("profile", "tensorboard", "debug_nans"):
        with pytest.raises(NotImplementedError, match=key):
            Trainer(cfg.apply_overrides([f"train.{key}=true"]), state, loader)
    with pytest.raises(NotImplementedError, match="visualize"):
        evaluate(state, loader, visualize_dir=tmp_path)
    with pytest.raises(NotImplementedError, match="visualize"):
        train_cli.main(["--cpu", "--visualize"])
