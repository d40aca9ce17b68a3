"""Patch grading: a closed loop of eval forwards of ``CGCNet`` under
``inference_mode``, logits copied to the host as ``cli.predict`` does, one
batch a request, round robin over a pool of batches that the port's
``GraphLoader`` built in set-up from the valid split (the traffic's
``passes`` test-time resampling passes; every batch warmed once). The pool
stays on the host, pinned, as the loader hands its batches over; each
request copies its batch to the card as the loader's consumer does.

The check: the reference works out each pool batch's patches, sampled
nuclei and graphs again and grades them; every answer of the window is
compared with its batch's (``reference/train.py: logit_gap``).
"""

from __future__ import annotations

import time

import torch

import cellkit
from harness import Outcome, free_device, percentile
from reference import model as ref_model
from reference.train import logit_gap
from work import batch_sizes, traced_work

VALID_FOLDS = {1: ["fold_3"], 2: ["fold_2"], 3: ["fold_1"]}


def run(r) -> Outcome:
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.nn.model import CGCNet

    t = r.traffic
    tree = cellkit.PatchTree(r)
    try:
        cfg = cellkit.program_config(r, tree.root)
        P, B = cellkit.make_weights(r.seed, r.device, running_stats=True,
                                shapes=cellkit.model_shapes(r.config))
        names = tree.names(VALID_FOLDS[cfg.data.cross_val])
        stated = [(rep, b) for rep in range(t["passes"])
                  for b in cellkit.loader_batches(names, t["batch"], r.seed,
                                                  rep, False, False)]
        if r.control:
            r.stats["setup_s"] = time.perf_counter() - r.t0
            answers = {i: [_reference(r, tree, cfg, P, B, names, *stated[i],
                                      r.control)] for i in range(len(stated))}
            return _judge(r, tree, cfg, P, B, names, stated, answers, 1, {})

        ds = NucleiGraphDataset(cfg.data, "valid")
        loader = GraphLoader(ds, t["batch"], device="cpu", shuffle=False,
                             num_workers=cfg.data.num_workers)
        pool, seen = [], []
        for rep in range(t["passes"]):
            for g in loader.epoch(rep):
                pool.append(cellkit.host_pool(g, r.device))
                seen.append((rep, [ds.names[int(j)] for j in g.patch_idx]))
        nuclei = [int(g.n_nodes.sum()) for g in pool]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model = CGCNet(cfg.model)
        cellkit.load_into(model, P, B)
        model = model.to(r.device).eval()

        def grade(g):
            with torch.inference_mode():
                return model(cellkit.to_device(g, r.device)).cpu()

        for g in pool:
            grade(g)
        answers, done = {}, []

        def request(i):
            k = i % len(pool)
            t0 = time.perf_counter()
            with r.span("forward"):
                answers.setdefault(k, []).append(grade(pool[k]))
            done.append(nuclei[k])
            return time.perf_counter() - t0

        r.stats["setup_s"] = time.perf_counter() - r.t0
        rec = r.window(request)
        r.read_peak()
        if r.trace:
            calls = [pool[i % len(pool)] for i in range(rec["calls"])]
            rec.update(traced_work(cfg, [batch_sizes(g) for g in calls],
                                   False))
        values = {"grade_nuclei_per_s": sum(done) / rec["wall_s"],
                  "grade_p95_ms": percentile(rec["latencies"], 95) * 1e3}
        del model, pool, loader, ds
        free_device()
        mismatch = float(sum(a != b for a, b in zip(seen, stated)))
        return _judge(r, tree, cfg, P, B, names, stated, answers,
                      rec["calls"], values, rec, mismatch)
    finally:
        tree.close()


def _reference(r, tree, cfg, P, B, names, rep, batch, control="identity"):
    graphs, _ = cellkit.reference_patches(tree, cfg, batch, names, rep, "val",
                                          r.device)
    with torch.no_grad():
        return ref_model.forward(P, B, graphs, train=False,
                                 **ref_model.CONTROLS[control]).cpu()


def _judge(r, tree, cfg, P, B, names, stated, answers, calls, values,
           rec=None, mismatch=0.0) -> Outcome:
    """Every answer of the window against the reference of its batch."""
    gaps = []
    for i in sorted(answers):
        ref = _reference(r, tree, cfg, P, B, names, *stated[i])
        gaps.append(max(logit_gap(a, ref) for a in answers[i]))
    r.stats["details"] = {"logit_gaps": gaps}
    checks = {"logit_gap": (max(gaps) if gaps else float("inf"),
                            r.limits["logit_gap"]),
              "batch_mismatch": (mismatch, 0.0)}
    return Outcome(attempted=calls, failed=0, values=values,
                   record=rec or {}, checks=checks)
