"""Training and evaluation loops (reference train.py:21-244).

Port of ``cgcnet_tpu/train/loop.py``:

- one optimization step = forward in training mode (BN batch statistics,
  head dropout from the state's generator), CE loss, backward, optimizer
  step; its metrics stay on the device, so no step waits for the host
  beyond the ``log_every`` records; over a data axis of ranks the same
  step of the global batch (``make_train_step(data_axis=)``);
- mid-epoch validation every ``eval_every_batches`` batches with
  best-checkpoint tracking keyed on image-level accuracy (train.py:185-207,
  including the ``> best - 1e-7`` tie-forgiveness);
- evaluation with test-time multi-sampling: ``test_epoch`` resamplings of
  each patch's graph, logits summed before argmax (train.py:27-36,83-88);
- metrics stream to JSONL with the JAX package's record kinds and keys
  (mirrored to TensorBoard with ``train.tensorboard``);
- ``train.profile`` traces the first epoch with ``torch.profiler``,
  ``train.debug_nans`` stops at the first non-finite loss or gradient, and
  ``evaluate(visualize_dir=)`` writes each patch's composed DiffPool
  clusters as GEXF.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from cgcnet_tpu_torch.config import Config
from cgcnet_tpu_torch.core.graph import CellGraph
from cgcnet_tpu_torch.dataflow.loader import GraphLoader
from cgcnet_tpu_torch.nn.model import cross_entropy_loss
from cgcnet_tpu_torch.parallel.mega_graph import psum
from cgcnet_tpu_torch.parallel.mesh import GraphAxis, own_group
from cgcnet_tpu_torch.train.checkpoint import (
    load_train_checkpoint,
    resolve_resume_path,
    save_train_checkpoint,
)
from cgcnet_tpu_torch.train.metrics import ImageLevelMetric
from cgcnet_tpu_torch.train.state import TrainState
from cgcnet_tpu_torch.utils.profiling import (
    assert_finite,
    enable_debug_checks,
    trace_context,
)


def make_train_step(debug_nans: bool = False,
                    data_axis: Optional[GraphAxis] = None):
    """``train_step(state, graph) -> metrics``: one optimizer step on
    ``graph``; ``metrics`` holds device scalars (loss, acc, edges).
    ``debug_nans``: before the optimizer step, raise naming the loss or the
    first parameter whose gradient is not finite (one host sync a step).

    ``data_axis`` (D > 1 ranks, every rank calling ``make_train_step`` and
    then each step at the same point): ``graph`` is this rank's rows of the
    global batch (``parallel.mesh.shard_batch``, or a process-sharded
    ``GraphLoader``), and the step computes the JAX package's global
    program on it. The model's batch statistics are summed over the axis on
    a group of their own (``mesh.own_group``), and the model is wrapped in
    ``DistributedDataParallel`` over ``data_axis.group``, whose all-reduce
    averages each rank's gradient of its local mean loss; with the
    statistics' psum (whose VJP sums the cotangents over the axis) that
    average is the gradient of the global mean loss. The metrics are the
    global batch's (loss and accuracy averaged, edges summed: one
    collective). Dropout draws from each rank's own generator, so only a
    ``drop_out=0`` step is the JAX package's function."""
    if data_axis is None or data_axis.size == 1:
        return _local_step(debug_nans)
    stats_axis = own_group(data_axis)
    wrapped: dict = {}

    def replica(model) -> DistributedDataParallel:
        # one wrapper per model, made at its first step (on every rank)
        if id(model) not in wrapped:
            model.set_data_axis(stats_axis)
            wrapped[id(model)] = DistributedDataParallel(
                model, process_group=data_axis.group,
                # running statistics are equal on every rank by construction
                broadcast_buffers=False)
        return wrapped[id(model)]

    def train_step(state: TrainState, graph: CellGraph) -> dict:
        model = state.model.train()
        metrics = _step(state, replica(model), graph, debug_nans)
        # loss and accuracy are means over equal per-rank batches
        local = torch.stack([metrics["loss"], metrics["acc"],
                             metrics["edges"].float()])
        total = psum(local, data_axis)
        return {"loss": total[0] / data_axis.size,
                "acc": total[1] / data_axis.size,
                "edges": total[2].to(torch.int32)}

    return train_step


def _local_step(debug_nans: bool):
    def train_step(state: TrainState, graph: CellGraph) -> dict:
        return _step(state, state.model.train(), graph, debug_nans)

    return train_step


def _step(state: TrainState, net, graph: CellGraph, debug_nans: bool) -> dict:
    """Forward through ``net`` (the model or its DDP wrapper), CE loss,
    backward, optimizer step; this process's metrics."""
    model = state.model
    state.optimizer.zero_grad(set_to_none=True)
    logits = net(graph, generator=state.generator)
    loss = cross_entropy_loss(logits, graph.y)
    loss.backward()
    if debug_nans:
        assert_finite({"loss": loss, **{
            f"gradient of {n}": p.grad
            for n, p in model.named_parameters()}})
    state.optimizer.step()
    state.step += 1
    return {
        "loss": loss.detach(),
        "acc": torch.mean((torch.argmax(logits.detach(), -1)
                           == graph.y.long()).float()),
        "edges": graph.num_edges(),
    }


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
    visualize_max: int = 50,
    vote_per_repeat: bool = True,
    max_num_examples: int | None = None,
) -> dict[str, float]:
    """Multi-sampling evaluation -> patch/image/binary accuracy.

    ``vote_per_repeat``: one image-level vote per patch per repeat, as the
    reference does (train.py:32-57); False votes once on the summed logits.
    Patch accuracy always uses the summed logits (train.py:83-90).
    ``max_num_examples``: per-repeat truncation after ceil(max/batch)
    batches (train.py:60-62).

    ``visualize_dir``: one GEXF file per patch, for the first
    ``visualize_max`` patches of the first repeat, with the composed
    DiffPool cluster ids (reference --visualization, train.py:64-76); the
    last two feature columns are the normalized centroid coordinates."""
    eval_step = make_eval_step()
    visualized = 0
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
            if visualize_dir is not None and rep == 0 \
                    and visualized < visualize_max:
                logits, visualized = _visualize(
                    state, graph, names, Path(visualize_dir),
                    visualize_max - visualized, visualized)
                cur = (logits, graph.y, graph.patch_idx)
            else:
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


def _visualize(state, graph, names, out_dir: Path, budget: int, done: int):
    """The eval forward with the assignments collected; GEXF files of up to
    ``budget`` of the batch's patches. Returns (logits, patches written so
    far)."""
    from cgcnet_tpu_torch.utils.gexf import assignments_to_gexf

    model = state.model.eval()
    with torch.no_grad():
        logits, assigns = model(graph, collect_assign=True)
    x = graph.x[..., -2:].cpu().numpy()
    nbr, nbr_mask = graph.nbr.cpu().numpy(), graph.nbr_mask.cpu().numpy()
    assigns = [a.float().cpu().numpy() for a in assigns]
    for i in range(min(budget, x.shape[0])):
        name = names[int(graph.patch_idx[i])]
        assignments_to_gexf(
            x[i], nbr[i], nbr_mask[i], [a[i] for a in assigns],
            out_dir / (name.replace("/", "_") + ".gexf"),
            n_nodes=int(graph.n_nodes[i]),
        )
        done += 1
    return logits, done


def summary_writer(log_dir: Path):
    """``torch.utils.tensorboard.SummaryWriter`` on ``log_dir``; raises an
    ImportError naming the ``tensorboard`` package where it is missing."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise ImportError(
            "train.tensorboard=true needs the `tensorboard` package "
            "(torch.utils.tensorboard writes through it), which is not "
            f"installed: {e}"
        ) from e
    return SummaryWriter(str(log_dir))


class Trainer:
    def __init__(
        self,
        cfg: Config,
        state: TrainState,
        train_loader: GraphLoader,
        val_loader: Optional[GraphLoader] = None,
        start_epoch: int = 0,
    ):
        self.cfg = cfg
        self.state = state
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.start_epoch = start_epoch
        self._train_step = make_train_step(cfg.train.debug_nans)
        self.run_dir = Path(cfg.train.ckpt_dir) / cfg.run_id()
        self.run_dir.mkdir(parents=True, exist_ok=True)
        (self.run_dir / "config.json").write_text(cfg.to_json())
        self.log_path = self.run_dir / "metrics.jsonl"
        self.best = {"img_acc": 0.0, "patch_acc": 0.0, "epoch": -1}
        # the reference logs through tensorboardX (train.py:225-235); here
        # the JSONL stream is mirrored into TensorBoard event files
        self._tb = (summary_writer(self.run_dir / "tb")
                    if cfg.train.tensorboard else None)

    def _log(self, record: dict) -> None:
        with self.log_path.open("a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            step = record.get("epoch", 0)
            kind = record.get("kind", "")
            for key, val in record.items():
                if isinstance(val, (int, float)) and key not in ("epoch", "batch"):
                    self._tb.add_scalar(f"{kind}/{key}", float(val), step)
            self._tb.flush()

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
        cfg = self.cfg.train
        for epoch in range(self.start_epoch, cfg.num_epochs):
            profile_dir = (
                self.run_dir / "profile"
                if cfg.profile and epoch == self.start_epoch else None
            )
            with trace_context(profile_dir), \
                    enable_debug_checks(cfg.debug_nans):
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
