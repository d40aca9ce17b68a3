"""Checkpoints of the PyTorch package, and weight carry-over from JAX.

Format: one ``torch.save`` file holding the model ``state_dict``, the config
as JSON and free-form metadata; it loads with ``weights_only=True`` (no
pickled code runs). Training checkpoints (``save_train_checkpoint``) add the
optimizer, scheduler, step and dropout-generator states, and still load as
serving checkpoints. ``state_dict_from_flax`` turns the JAX package's
``{"params", "batch_stats"}`` variable trees (nested dicts of arrays, as
``flax.serialization.msgpack_restore`` returns them) into this package's
``state_dict``: [in, out] kernels become [out, in] weights, BN
``scale``/``mean``/``var`` become ``weight``/``running_mean``/
``running_var``, and the JK LSTM keeps torch's own names. Every other path
keeps the JAX package's module names (SAGE ``lin``, GIN ``mlp_0`` and
``mlp_1``, GAT ``q``, ``k`` and ``v``; GAT's head count changes no
parameter).

In a multi-process run (a ``torch.distributed`` default group joined) only
rank 0 writes: a data-parallel run's parameters and optimizer state are
the same on every rank, and the other ranks return the path rank 0 writes
(``cgcnet_tpu/train/checkpoint.py``'s process-0 rule). Sharded state goes
through ``train/checkpoint_sharded.py``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist

from cgcnet_tpu_torch.config import Config


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, Any]:
    out: dict[tuple, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def state_dict_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` of the JAX ``CGCNet`` ->
    ``state_dict`` of this package's ``CGCNet``."""
    sd: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(variables.get("params", {})).items():
        arr = np.array(leaf, dtype=np.float32, copy=True)
        *mods, name = path
        if name == "kernel":
            name, arr = "weight", np.ascontiguousarray(arr.T)
        elif name == "scale":
            name = "weight"
        sd[".".join((*mods, name))] = torch.from_numpy(arr)
    stat_names = {"mean": "running_mean", "var": "running_var"}
    for path, leaf in _flatten(variables.get("batch_stats", {})).items():
        *mods, name = path
        arr = np.array(leaf, dtype=np.float32, copy=True)
        sd[".".join((*mods, stat_names[name]))] = torch.from_numpy(arr)
    return sd


def writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of the default group
    when one is joined, else always."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def save_checkpoint(
    path: str | Path,
    state_dict: Mapping[str, torch.Tensor],
    cfg: Config,
    meta: dict | None = None,
    extra: dict | None = None,
) -> Path:
    """Write a checkpoint; ``extra`` adds entries (the training state).
    Only rank 0 writes when a default group is joined (:func:`writes`); the
    others return the path."""
    path = Path(path)
    if not writes():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(
        {
            "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
            "config": cfg.to_json(),
            "meta": json.dumps(meta or {}),
            **(extra or {}),
        },
        path,
    )
    return path


def load_checkpoint(path: str | Path) -> tuple[dict, Config, dict]:
    """(state_dict on the CPU, Config, meta) of a checkpoint file."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"=> No checkpoint found at '{path}'")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return (
        blob["state_dict"],
        Config.from_json(blob["config"]),
        json.loads(blob["meta"]),
    )


def save_train_checkpoint(
    ckpt_dir: str | Path,
    state,
    cfg: Config,
    *,
    epoch: int,
    metrics: dict | None = None,
    is_best: bool = False,
    name: str = "weight",
) -> Path:
    """``<ckpt_dir>/<name>.pt`` with everything a resume needs (a
    ``train.state.TrainState``); ``is_best`` also copies it to
    ``model_best.pt`` (reference common/utils.py:82-94). Rank 0 only, as
    :func:`save_checkpoint`."""
    ckpt_dir = Path(ckpt_dir)
    path = save_checkpoint(
        ckpt_dir / f"{name}.pt", state.model.state_dict(), cfg,
        {"epoch": epoch, "metrics": metrics or {}},
        extra={
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "step": state.step,
            "generator": state.generator.get_state(),
        },
    )
    if is_best and writes():
        shutil.copy(path, ckpt_dir / "model_best.pt")
    return path


def load_train_checkpoint(path: str | Path, state) -> dict:
    """Restore a ``TrainState`` in place from a training checkpoint;
    returns its metadata (``epoch``, ``metrics``)."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"=> No checkpoint found at '{path}'")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    missing = {"optimizer", "scheduler", "step", "generator"} - set(blob)
    if missing:
        raise ValueError(
            f"checkpoint '{path}' holds no training state ({sorted(missing)} "
            "missing): it can serve, not resume"
        )
    state.model.load_state_dict(blob["state_dict"], strict=True)
    state.optimizer.load_state_dict(blob["optimizer"])
    state.scheduler.load_state_dict(blob["scheduler"])
    state.step = int(blob["step"])
    state.generator.set_state(blob["generator"])
    return json.loads(blob["meta"])


def resolve_resume_path(ckpt_dir: str | Path, resume: str) -> Path:
    """``train.resume``: 'best' -> model_best.pt, 'weight' -> weight.pt,
    anything else is a path."""
    ckpt_dir = Path(ckpt_dir)
    if resume == "best":
        return ckpt_dir / "model_best.pt"
    if resume == "weight":
        return ckpt_dir / "weight.pt"
    return Path(resume)
