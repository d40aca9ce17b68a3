"""Patch training: a closed loop of ``train.loop.make_train_step`` steps, as
``cli.train`` runs them, round robin over a pool of batches that the port's
``GraphLoader`` built in set-up from the train split of the seeded
synthetic tree (the traffic's ``epochs`` epochs, sampling resampled every
epoch), so the step and not the loader sets the pace. The pool stays on
the host, pinned, as the loader hands its batches over; each step copies
its batch to the card as the loader's consumer does, so the device holds
one batch at a time and the copy is in the step.

Set-up makes the tree, the weights, the pool and the train state, and
drives that state through the traffic's ``check_steps`` first steps with
the window's own call and feed; the window then continues the same state
over the rest of the pool, round after round. The check:
the reference follows those first steps from the same weights, patches and
dropout generator, and the loss of each step, the first gradient (read
from Adam's first moment after step 1) and each parameter's change over
the steps are compared leaf by leaf (``reference/train.py``); the
program's batches must hold the patches the loader's stated order gives.
"""

from __future__ import annotations

import time

import torch

import cellkit
from harness import Outcome, free_device
from reference import train as ref_train
from work import batch_sizes, traced_work

TRAIN_FOLDS = {1: ["fold_1", "fold_2"], 2: ["fold_1", "fold_3"],
               3: ["fold_2", "fold_3"]}


def stated_batches(names, batch, seed, steps) -> list:
    """(epoch, patch names) of the first ``steps`` steps: the loader's
    stated order, epoch after epoch."""
    per_epoch = len(names) // batch
    out = []
    for i in range(steps):
        order = cellkit.loader_batches(names, batch, seed, i // per_epoch,
                                       True, True)
        out.append((i // per_epoch, order[i % per_epoch]))
    return out


def run(r) -> Outcome:
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.train.loop import make_train_step
    from cgcnet_tpu_torch.train.state import create_train_state

    t = r.traffic
    tree = cellkit.PatchTree(r)
    try:
        cfg = cellkit.program_config(r, tree.root)
        P, B = cellkit.make_weights(r.seed, r.device, running_stats=False,
                                shapes=cellkit.model_shapes(r.config))
        drop_seed = cellkit.sub_seed(r.seed, cellkit.DROPOUT)
        names = tree.names(TRAIN_FOLDS[cfg.data.cross_val])
        stated = stated_batches(names, t["batch"], r.seed,
                                int(t["check_steps"]))
        if r.control:
            r.stats["setup_s"] = time.perf_counter() - r.t0
            prog = _reference(r, tree, cfg, P, B, stated, names, drop_seed,
                              r.control)
            ref = _reference(r, tree, cfg, P, B, stated, names, drop_seed)
            return Outcome(attempted=len(stated), failed=0, values={},
                           record={}, checks=cellkit.train_checks(r, prog, ref, P))

        ds = NucleiGraphDataset(cfg.data, "train")
        loader = GraphLoader(ds, t["batch"], device="cpu", shuffle=True,
                             num_workers=cfg.data.num_workers, seed=r.seed,
                             drop_last=True)
        pool, seen = [], []
        for epoch in range(int(t["epochs"])):
            for g in loader.epoch(epoch):
                pool.append(cellkit.host_pool(g, r.device))
                seen.append((epoch, [ds.names[int(j)] for j in g.patch_idx]))
        state = create_train_state(cfg, r.device)
        cellkit.load_into(state.model, P, B)
        state.generator = torch.Generator(device=r.device).manual_seed(
            drop_seed)
        step = make_train_step()
        losses, grad1 = [], None
        for i in range(len(stated)):
            losses.append(float(step(state, cellkit.to_device(
                pool[i], r.device))["loss"]))
            if i == 0:
                grad1 = cellkit.first_gradient(state.optimizer, state.model)
        prog = {"losses": losses, "grad1": grad1,
                "params": {k: v.detach().clone()
                           for k, v in state.model.named_parameters()}}
        sizes = [batch_sizes(g) for g in pool]
        first = len(stated)

        def request(i):
            with r.span("step"):
                step(state, cellkit.to_device(pool[(first + i) % len(pool)],
                                              r.device))

        r.stats["setup_s"] = time.perf_counter() - r.t0
        rec = r.window(request)
        r.read_peak()
        if r.trace:
            rec.update(traced_work(
                cfg, [sizes[(first + i) % len(pool)]
                      for i in range(rec["calls"])], True))
        del state, step, loader, ds, pool
        free_device()

        ref = _reference(r, tree, cfg, P, B, stated, names, drop_seed)
        checks = cellkit.train_checks(r, prog, ref, P)
        order = stated_batches(names, t["batch"], r.seed, len(seen))
        checks["batch_mismatch"] = (float(sum(a != b for a, b in
                                              zip(seen, order))), 0.0)
        step_ms = rec["wall_s"] / rec["calls"] * 1e3
        return Outcome(attempted=rec["calls"], failed=0,
                       values={"train_step_ms": step_ms}, record=rec,
                       checks=checks)
    finally:
        tree.close()


def _reference(r, tree, cfg, P, B, stated, names, drop_seed,
               control="identity") -> dict:
    batches = [cellkit.reference_patches(tree, cfg, batch, names, epoch,
                                         "train", r.device)
               for epoch, batch in stated]
    gen = torch.Generator(device=r.device).manual_seed(drop_seed)
    return ref_train.adam_steps(
        P, B, batches, [gen] * len(batches), lr=cfg.train.lr,
        weight_decay=cfg.train.weight_decay, **cellkit.stand_in(control))
