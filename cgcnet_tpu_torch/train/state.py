"""Training state: the model, its optimizer and LR scheduler, the step
count and the generator that draws the dropout masks (port of
``cgcnet_tpu/train/state.py``'s ``TrainState``)."""

from __future__ import annotations

import dataclasses

import torch

from cgcnet_tpu_torch.config import Config
from cgcnet_tpu_torch.nn.model import CGCNet
from cgcnet_tpu_torch.train.optim import make_optimizer, make_scheduler


@dataclasses.dataclass
class TrainState:
    model: CGCNet
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.StepLR
    step: int
    generator: torch.Generator  # on the model's device


def create_train_state(
    cfg: Config, device: torch.device | str, seed: int | None = None
) -> TrainState:
    """Seeded CGCNet on ``device`` (torch-default init from a CPU generator
    seeded with ``seed``, ``cfg.train.seed`` by default), with TF32 off so
    f32 stays f32 on the card, and its optimizer, scheduler and dropout
    generator (seeded with ``seed + 1``)."""
    seed = cfg.train.seed if seed is None else seed
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = CGCNet(cfg.model, torch.Generator().manual_seed(seed)).to(device)
    optimizer = make_optimizer(cfg.train, model.parameters())
    return TrainState(
        model=model,
        optimizer=optimizer,
        scheduler=make_scheduler(cfg.train, optimizer),
        step=0,
        generator=torch.Generator(device=device).manual_seed(seed + 1),
    )
