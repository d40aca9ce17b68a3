"""Sharded (multi-process) checkpoints through ``torch.distributed.checkpoint``.

Port of ``cgcnet_tpu/train/checkpoint_sharded.py`` (orbax there).
``train/checkpoint.py`` covers replicated parameters with one writer; this
module handles state whose leaves are sharded over the ranks of an axis:
``DTensor``s on a device mesh built from the axis's own group
(:func:`device_mesh`; ``DeviceMesh.from_group``, so a gloo group of CUDA
ranks sharing one card keeps its backend), beside plain tensors and
Python values.

- every rank writes only its own shards (a replicated leaf is written
  once, by one rank);
- :func:`load_sharded` fills a ``target`` of the same structure whose
  leaves fix the layout: a state saved sharded over D ranks loads
  replicated, at another D, or into plain tensors of one process —
  resharding happens on read.

A training state (model ``state_dict`` plus the optimizer's) round-trips
through :func:`train_state` / :func:`load_train_state`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import torch
import torch.distributed.checkpoint as dcp

from cgcnet_tpu_torch.parallel.mesh import GraphAxis


def device_mesh(axis: GraphAxis):
    """The one-dimensional device mesh of ``axis``'s ranks over its group."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh.from_group(axis.group, axis.device.type)


def shard_rows(local: torch.Tensor, axis: GraphAxis):
    """A ``DTensor`` whose rows are split over ``axis`` in rank order, this
    rank holding ``local`` (equal row counts on every rank)."""
    from torch.distributed.tensor import DTensor, Shard

    return DTensor.from_local(local, device_mesh(axis), [Shard(0)],
                              run_check=False)


def replicate(value: torch.Tensor, axis: GraphAxis):
    """A ``DTensor`` replicated over ``axis`` (``value`` the same on every
    rank)."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(value, device_mesh(axis), [Replicate()],
                              run_check=False)


def save_sharded(path: str | Path, state: Any) -> Path:
    """Write ``state`` (a nested dict of tensors, ``DTensor``s and Python
    values) to the directory ``path`` collectively: every rank of the
    default group calls it, and each writes only its own shards. Returns
    the absolute path once every rank's write is done."""
    path = Path(path).absolute()
    dcp.save(state, checkpoint_id=str(path))
    return path


def load_sharded(path: str | Path, target: Any) -> Any:
    """Restore a state saved by :func:`save_sharded` into ``target`` (same
    keys; each leaf's shape and placement fix what this rank reads) and
    return it. Collective over the default group when one is joined."""
    dcp.load(target, checkpoint_id=str(Path(path).absolute()))
    return target


def train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer
                ) -> dict:
    """``{"model": ..., "optim": ...}``: the model's ``state_dict`` and the
    optimizer's keyed by parameter name (``torch.distributed.checkpoint.
    state_dict``), the optimizer's state made if no step has run yet — a
    state to save and a target to load into."""
    from torch.distributed.checkpoint.state_dict import get_state_dict

    model_sd, optim_sd = get_state_dict(model, optimizer)
    return {"model": model_sd, "optim": optim_sd}


def load_train_state(path: str | Path, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> None:
    """Restore a :func:`train_state` saved by :func:`save_sharded` into
    ``model`` and ``optimizer`` in place."""
    from torch.distributed.checkpoint.state_dict import set_state_dict

    state = load_sharded(path, train_state(model, optimizer))
    set_state_dict(model, optimizer, model_state_dict=state["model"],
                   optim_state_dict=state["optim"])
