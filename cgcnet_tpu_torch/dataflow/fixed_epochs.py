"""Offline fixed-epoch sampling (reference prepare_cv_dataset.py). Port of
``cgcnet_tpu/dataflow/fixed_epochs.py``, writing the same files.

The reference pre-bakes 30 epochs of subsampled graph copies to disk
(prepare_cv_dataset.py:94-109) because its sampling is not reproducible
online. Here sampling is a pure function of (seed, patch, epoch), so the
runtime never needs these files; the tool exists for workflow parity and to
take the farthest-point sampling out of the loader: it stores only the
chosen node indices per (patch, epoch), and the dataset replays them when
``DataConfig.use_fixed`` is set.

Layout: <root>/proto/fixed_<method>/<epoch>/<patch>.npy  (int32 indices)
"""

from __future__ import annotations

import dataclasses
from multiprocessing import Pool
from pathlib import Path

import numpy as np

from cgcnet_tpu_torch.config import DataConfig
from cgcnet_tpu_torch.dataflow.proto import list_protos, load_proto
from cgcnet_tpu_torch.dataflow.rng import patch_rng


def fixed_dir(root: str | Path, method: str) -> Path:
    return Path(root) / "proto" / f"fixed_{method}"


def choice_path(root: str | Path, method: str, epoch: int, name: str) -> Path:
    return fixed_dir(root, method) / str(epoch) / f"{name}.npy"


def _gen_one(args) -> str:
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset

    cfg_dict, name, num_epochs = args
    cfg = DataConfig(**cfg_dict)
    ds = NucleiGraphDataset.__new__(NucleiGraphDataset)  # sampling only
    ds.cfg = cfg
    ds.capacity = 1 << 30
    proto = load_proto(cfg.root, name, cfg.dataset)
    for epoch in range(num_epochs):
        rng = patch_rng(cfg.seed, name, epoch, "train")
        # the sampling path of NucleiGraphDataset.get (fused native first),
        # so a use_fixed replay is bit-identical to online sampling
        choice = ds._subsample_sorted(proto.num_nodes, proto.coords, rng)
        if choice is None:
            choice = ds._subsample(proto.num_nodes, proto.coords, rng)
        if choice is None:
            choice = np.arange(proto.num_nodes, dtype=np.int32)
        out = choice_path(cfg.root, cfg.sampling_method, epoch, name)
        out.parent.mkdir(parents=True, exist_ok=True)
        np.save(out, choice.astype(np.int32))
    return name


def generate_fixed_epochs(
    cfg: DataConfig,
    num_epochs: int | None = None,
    folds: tuple[str, ...] = ("fold_1", "fold_2", "fold_3"),
    processes: int = 8,
) -> list[str]:
    """Write the sampled-index files of every patch and epoch (the
    reference's Pool fan-out, prepare_cv_dataset.py:150-153)."""
    num_epochs = num_epochs or cfg.num_fixed_epochs
    names = list_protos(cfg.root, list(folds), cfg.dataset)
    args = [(dataclasses.asdict(cfg), n, num_epochs) for n in names]
    if processes <= 1:
        return [_gen_one(a) for a in args]
    with Pool(processes) as pool:
        return pool.map(_gen_one, args)


def load_fixed_choice(
    cfg: DataConfig, name: str, epoch: int
) -> np.ndarray | None:
    p = choice_path(cfg.root, cfg.sampling_method, epoch, name)
    if not p.exists():
        return None
    return np.load(p)
