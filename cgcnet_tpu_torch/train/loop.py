"""Training and evaluation loops (reference train.py:21-244).

Port of ``cgcnet_tpu/train/loop.py``:

- one optimization step = forward in training mode (BN batch statistics,
  head dropout from the state's generator), CE loss, backward, optimizer
  step; its metrics stay on the device, so no step waits for the host
  beyond the ``log_every`` records;
- mid-epoch validation every ``eval_every_batches`` batches with
  best-checkpoint tracking keyed on image-level accuracy (train.py:185-207,
  including the ``> best - 1e-7`` tie-forgiveness);
- evaluation with test-time multi-sampling: ``test_epoch`` resamplings of
  each patch's graph, logits summed before argmax (train.py:27-36,83-88);
- metrics stream to JSONL with the JAX package's record kinds and keys.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from cgcnet_tpu_torch.config import Config
from cgcnet_tpu_torch.core.graph import CellGraph
from cgcnet_tpu_torch.dataflow.loader import GraphLoader
from cgcnet_tpu_torch.nn.model import cross_entropy_loss
from cgcnet_tpu_torch.train.checkpoint import (
    load_train_checkpoint,
    resolve_resume_path,
    save_train_checkpoint,
)
from cgcnet_tpu_torch.train.metrics import ImageLevelMetric
from cgcnet_tpu_torch.train.state import TrainState

UTILS_SLICE = "not ported yet (utils, remaining entry points and host code)"


def make_train_step():
    """``train_step(state, graph) -> metrics``: one optimizer step on
    ``graph``; ``metrics`` holds device scalars (loss, acc, edges)."""

    def train_step(state: TrainState, graph: CellGraph) -> dict:
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = model(graph, generator=state.generator)
        loss = cross_entropy_loss(logits, graph.y)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {
            "loss": loss.detach(),
            "acc": torch.mean((torch.argmax(logits.detach(), -1)
                               == graph.y.long()).float()),
            "edges": graph.num_edges(),
        }

    return train_step


def make_eval_step():
    """``eval_step(state, graph) -> logits`` in eval mode, no gradients."""

    def eval_step(state: TrainState, graph: CellGraph) -> torch.Tensor:
        model = state.model.eval()
        with torch.no_grad():
            return model(graph)

    return eval_step


def evaluate(
    state: TrainState,
    loader: GraphLoader,
    *,
    test_time: int = 1,
    visualize_dir: str | Path | None = None,
    vote_per_repeat: bool = True,
    max_num_examples: int | None = None,
) -> dict[str, float]:
    """Multi-sampling evaluation -> patch/image/binary accuracy.

    ``vote_per_repeat``: one image-level vote per patch per repeat, as the
    reference does (train.py:32-57); False votes once on the summed logits.
    Patch accuracy always uses the summed logits (train.py:83-90).
    ``max_num_examples``: per-repeat truncation after ceil(max/batch)
    batches (train.py:60-62)."""
    if visualize_dir is not None:
        raise NotImplementedError(f"visualize_dir: {UTILS_SLICE}")
    eval_step = make_eval_step()
    logit_sum: dict[int, np.ndarray] = {}
    labels: dict[int, int] = {}
    metric = ImageLevelMetric()
    names = loader.dataset.names

    def account(pending):
        logits, y, pidx = (t.cpu().numpy() for t in pending)
        for i, p in enumerate(pidx):
            p = int(p)
            logit_sum[p] = logit_sum.get(p, 0.0) + logits[i]
            labels[p] = int(y[i])
            if vote_per_repeat:
                metric.add_batch([names[p]], [int(np.argmax(logits[i]))],
                                 [int(y[i])])

    for rep in range(test_time):
        # one-batch delay: the next batch's forward is queued on the device
        # before the previous batch's logits are copied back
        pending = None
        for batch_idx, graph in enumerate(loader.epoch(rep)):
            cur = (eval_step(state, graph), graph.y, graph.patch_idx)
            if pending is not None:
                account(pending)
            pending = cur
            if (
                max_num_examples is not None
                and (batch_idx + 1) * graph.x.shape[0] > max_num_examples
            ):
                break
        if pending is not None:
            account(pending)
    preds, gts = [], []
    for p, ls in logit_sum.items():
        pred = int(np.argmax(ls))
        preds.append(pred)
        gts.append(labels[p])
        if not vote_per_repeat:
            metric.add_batch([names[p]], [pred], [labels[p]])
    out = metric.result()
    out["patch_acc"] = (
        float(np.mean(np.asarray(preds) == np.asarray(gts))) if gts else 0.0
    )
    return out


class Trainer:
    def __init__(
        self,
        cfg: Config,
        state: TrainState,
        train_loader: GraphLoader,
        val_loader: Optional[GraphLoader] = None,
        start_epoch: int = 0,
    ):
        for key in ("profile", "tensorboard", "debug_nans"):
            if getattr(cfg.train, key):
                raise NotImplementedError(f"train.{key}: {UTILS_SLICE}")
        self.cfg = cfg
        self.state = state
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.start_epoch = start_epoch
        self._train_step = make_train_step()
        self.run_dir = Path(cfg.train.ckpt_dir) / cfg.run_id()
        self.run_dir.mkdir(parents=True, exist_ok=True)
        (self.run_dir / "config.json").write_text(cfg.to_json())
        self.log_path = self.run_dir / "metrics.jsonl"
        self.best = {"img_acc": 0.0, "patch_acc": 0.0, "epoch": -1}

    def _log(self, record: dict) -> None:
        with self.log_path.open("a") as f:
            f.write(json.dumps(record) + "\n")

    def _maybe_validate(self, epoch: int) -> None:
        if self.val_loader is None:
            return
        multi_sample = (
            self.cfg.data.sample_ratio < 1.0
            and not self.cfg.data.full_test_graph
        )
        result = evaluate(
            self.state,
            self.val_loader,
            test_time=self.cfg.train.test_epoch if multi_sample else 1,
            vote_per_repeat=self.cfg.train.vote_per_repeat,
            max_num_examples=self.cfg.train.eval_max_examples or None,
        )
        self._log({"kind": "val", "epoch": epoch, **result})
        # best tracking with the reference's 1e-7 tie forgiveness (train.py:188)
        if result["img_acc"] > self.best["img_acc"] - 1e-7:
            self.best = {**result, "epoch": epoch}
            save_train_checkpoint(
                self.run_dir, self.state, self.cfg, epoch=epoch,
                metrics=result, is_best=True,
            )

    def train(self) -> dict:
        for epoch in range(self.start_epoch, self.cfg.train.num_epochs):
            self._run_epoch(epoch)
        return self.best

    def _run_epoch(self, epoch: int) -> None:
        cfg = self.cfg.train
        t0 = time.perf_counter()
        losses, edge_counts = [], []
        for bi, graph in enumerate(self.train_loader.epoch(epoch)):
            metrics = self._train_step(self.state, graph)
            if (bi + 1) % cfg.log_every == 0:
                self._log({
                    "kind": "train",
                    "epoch": epoch,
                    "batch": bi,
                    "loss": float(metrics["loss"]),
                    "acc": float(metrics["acc"]),
                })
            # device scalars, reduced once at the epoch's end
            losses.append(metrics["loss"])
            edge_counts.append(metrics["edges"])
            if (
                cfg.eval_every_batches > 0
                and (bi + 1) % cfg.eval_every_batches == 0
            ):
                self._maybe_validate(epoch)
        avg_loss = float(torch.stack(losses).mean()) if losses else 0.0
        edges = int(torch.stack(edge_counts).long().sum()) if edge_counts else 0
        dt = time.perf_counter() - t0
        self._log({
            "kind": "epoch",
            "epoch": epoch,
            "avg_loss": avg_loss,
            "time_s": dt,
            "edges_per_s": edges / dt if dt > 0 else 0.0,
        })
        self.state.scheduler.step()  # StepLR counts epochs
        self._maybe_validate(epoch)
        save_train_checkpoint(
            self.run_dir, self.state, self.cfg, epoch=epoch,
            metrics={"avg_loss": avg_loss},
        )


def resume_state(cfg: Config, state: TrainState) -> tuple[TrainState, int]:
    """Restore ``state`` per ``cfg.train.resume`` ('best' / 'weight' /
    path); returns it with the epoch to start from."""
    run_dir = Path(cfg.train.ckpt_dir) / cfg.run_id()
    meta = load_train_checkpoint(
        resolve_resume_path(run_dir, cfg.train.resume), state
    )
    return state, int(meta.get("epoch", -1)) + 1
