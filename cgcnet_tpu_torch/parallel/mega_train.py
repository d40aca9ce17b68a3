"""Slide-level training: fine-tune CGCNet's parameters on whole slides.

Port of ``cgcnet_tpu/parallel/mega_train.py``. The reference trains on
subsampled patches only; this trains the same parameters on an unsampled
slide through ``mega_forward``: BatchNorm uses the whole graph's batch
statistics and tracks running statistics (momentum 0.1), the head applies
dropout drawn per step from a seed, and Adam takes optax's defaults
(b1 0.9, b2 0.999, eps 1e-8 — the same update as ``optax.adam``).

Over D shards (one process each) the gradient follows JAX's ``shard_map``
transpose, which this package has to write out: each rank backpropagates
loss / D (the loss is replicated), the collectives' backwards route the
cotangents across ranks (``psum``: the sum of the cotangents;
``all_gather``: each rank's slice summed; the halo exchange: the reverse
all-to-all), and after the backward every parameter's gradient is summed
over the graph axis (:func:`reduce_grads`). Every sum over the axis is
fixed in order and bit-identical on every rank, and dropout draws the same
mask on every rank, so after each step every rank holds the same
parameters, Adam state and running statistics.
"""

from __future__ import annotations

import torch

from cgcnet_tpu_torch.config import ModelConfig
from cgcnet_tpu_torch.parallel.mega_graph import psum
from cgcnet_tpu_torch.parallel.mega_model import (
    MegaInputs,
    apply_stats,
    mega_forward,
)
from cgcnet_tpu_torch.parallel.mesh import GraphAxis


def make_optimizer(model, lr: float) -> torch.optim.Optimizer:
    """Adam over every parameter with optax.adam's constants."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def reduce_grads(model, axis: GraphAxis) -> None:
    """Sum every parameter's gradient over the graph axis, one collective
    per gradient dtype (nothing to do for one shard)."""
    if axis.size == 1:
        return
    by_dtype: dict = {}
    for prm in model.parameters():
        if prm.grad is not None:
            by_dtype.setdefault(prm.grad.dtype, []).append(prm.grad)
    for grads in by_dtype.values():
        flat = psum(torch.cat([g.reshape(-1) for g in grads]), axis)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def make_slide_train_step(
    model,
    cfg: ModelConfig,
    optimizer: torch.optim.Optimizer,
    halo_overlap: bool = False,
    remat: bool = False,
    remat_stage1: bool = False,
):
    """step(inputs, label, generator=None) -> loss (a 0-d tensor): one
    forward in training mode, -log softmax(logits)[label], backward (over D
    shards of loss / D, then :func:`reduce_grads`), an optimizer step, then
    the running statistics written into the model."""

    def step(inputs: MegaInputs, label: int, generator=None):
        optimizer.zero_grad(set_to_none=True)
        logits, new_stats = mega_forward(
            model, cfg, inputs, train=True, halo_overlap=halo_overlap,
            remat=remat, remat_stage1=remat_stage1, return_stats=True,
            generator=generator,
        )
        loss = -torch.log_softmax(logits, dim=-1)[int(label)]
        shards = inputs.axis.size
        (loss / shards if shards > 1 else loss).backward()
        reduce_grads(model, inputs.axis)
        optimizer.step()
        apply_stats(model, new_stats)
        return loss.detach()

    return step


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The head-dropout generator of training step ``step`` under ``seed``."""
    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + step
    )


def train_slides(
    model,
    cfg: ModelConfig,
    slides: list[tuple[MegaInputs, int]],
    *,
    lr: float = 1e-3,
    epochs: int = 1,
    seed: int = 0,
    remat: bool = False,
    remat_stage1: bool = False,
) -> tuple[torch.nn.Module, list[float]]:
    """Fine-tune ``model`` in place on (inputs, label) slides for
    ``epochs`` epochs; returns (model, per-step losses). Head dropout
    (cfg.drop_out) draws from a generator seeded per step from ``seed``."""
    model.train()
    step = make_slide_train_step(model, cfg, make_optimizer(model, lr),
                                 remat=remat, remat_stage1=remat_stage1)
    losses = []
    try:
        for epoch in range(epochs):
            for si, (inputs, label) in enumerate(slides):
                gen = step_generator(inputs.device, seed,
                                     epoch * len(slides) + si)
                losses.append(float(step(inputs, label, gen)))
    finally:
        model.eval()
    return model, losses
