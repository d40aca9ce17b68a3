"""Optimizers and the LR schedule (reference common/utils.py:119-127 and
train.py:147): torch's own Adam, SGD and RMSprop with weight decay coupled
into the gradient (not AdamW), and StepLR stepped once per epoch.

Port of ``cgcnet_tpu/train/optim.py``, which composes optax transforms to
match exactly these torch update rules: RMSprop with alpha 0.99 and eps
1e-8 outside the square root, and the schedule
``lr * gamma ** (epoch // step_size)`` with ``epoch = step // steps_per_epoch``
— here the scheduler steps at each epoch's end. ``train.flatten_opt`` (an
optax layout option) has no effect here.
"""

from __future__ import annotations

from typing import Iterable

import torch

from cgcnet_tpu_torch.config import TrainConfig


def make_optimizer(
    cfg: TrainConfig, params: Iterable[torch.nn.Parameter]
) -> torch.optim.Optimizer:
    if cfg.optim == "adam":
        return torch.optim.Adam(
            params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay,
        )
    if cfg.optim == "sgd":
        return torch.optim.SGD(
            params, lr=cfg.lr, momentum=cfg.momentum,
            weight_decay=cfg.weight_decay,
        )
    if cfg.optim == "rmsprop":
        return torch.optim.RMSprop(
            params, lr=cfg.lr, alpha=0.99, eps=1e-8, momentum=cfg.momentum,
            weight_decay=cfg.weight_decay,
        )
    raise KeyError(f"Unsupported optim: {cfg.optim}")


def make_scheduler(
    cfg: TrainConfig, optimizer: torch.optim.Optimizer
) -> torch.optim.lr_scheduler.StepLR:
    """StepLR over epochs; ``step_size <= 0`` keeps the rate constant."""
    if cfg.step_size > 0:
        return torch.optim.lr_scheduler.StepLR(
            optimizer, step_size=cfg.step_size, gamma=cfg.gamma
        )
    return torch.optim.lr_scheduler.StepLR(optimizer, step_size=1, gamma=1.0)
