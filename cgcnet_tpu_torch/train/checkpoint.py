"""Checkpoints of the PyTorch package, and weight carry-over from JAX.

Format: one ``torch.save`` file holding the model ``state_dict``, the config
as JSON and free-form metadata; it loads with ``weights_only=True`` (no
pickled code runs). ``state_dict_from_flax`` turns the JAX package's
``{"params", "batch_stats"}`` variable trees (nested dicts of arrays, as
``flax.serialization.msgpack_restore`` returns them) into this package's
``state_dict``: [in, out] kernels become [out, in] weights, BN
``scale``/``mean``/``var`` become ``weight``/``running_mean``/
``running_var``, and the JK LSTM keeps torch's own names.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

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


def save_checkpoint(
    path: str | Path,
    state_dict: Mapping[str, torch.Tensor],
    cfg: Config,
    meta: dict | None = None,
) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(
        {
            "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
            "config": cfg.to_json(),
            "meta": json.dumps(meta or {}),
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
