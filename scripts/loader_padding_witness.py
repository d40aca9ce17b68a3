#!/usr/bin/env python3
"""Whether a patch batch's padding widths change its training steps, on
the CPU: the block metadata padded past the batch's cap with empty slots,
and the transpose tables widened with empty slots. These are the two
widths that a threaded loader sharing grow-only state across its workers
could give one batch differently from run to run (the sticky BSR caps and
the nominal transpose width; ``dataflow/loader.py`` now updates both in
yield order).

    python3 scripts/loader_padding_witness.py   # from the repository root

It builds a synthetic training split of 750..1500-row patches, takes its
first 4-graph batch, and runs 3 SGD steps of a narrow SAGE model from one
seed on the batch as the loader gives it and on each padded form, then
prints each form's losses and whether every loss and every parameter
after the steps is the same bits as the unpadded run's (~15 s).
"""

from __future__ import annotations

import dataclasses
import sys
import tempfile
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OVER = ["data.max_num_nodes=3000", "data.min_nodes_no_subsample=50",
        "data.bsr_blocks=16", "model.max_num_nodes=512", "model.hidden_dim=8",
        "model.embedding_dim=8", "model.assign_hidden_dim=8",
        "model.drop_out=0.0", "train.optim=sgd", "train.lr=1e-3"]
STEPS = 3


def main() -> int:
    sys.path.insert(0, str(REPO))
    import torch
    from cgcnet_tpu_torch.config import Config
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.dataflow.synthetic import generate_dataset
    from cgcnet_tpu_torch.train.loop import make_train_step
    from cgcnet_tpu_torch.train.state import create_train_state

    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    with tempfile.TemporaryDirectory() as root:
        generate_dataset(root, patches_per_image=2, images_per_grade=1,
                         n_nodes=(1500, 3000), seed=3)
        cfg = Config().apply_overrides([f"data.root={root}", *OVER])
        loader = GraphLoader(NucleiGraphDataset(cfg.data, "train"), 4,
                             device="cpu", num_workers=1, seed=8,
                             drop_last=True)
        graph = next(iter(loader.epoch(0)))

    def slots(g, cap):
        def pad(t):
            out = torch.zeros(t.shape[:-1] + (cap,), dtype=t.dtype)
            out[..., :t.shape[-1]] = t
            return out
        return dataclasses.replace(
            g, **{k: pad(getattr(g, k)) for k in
                  ("blk_cols", "blk_mask", "blk_cols_t", "blk_mask_t")})

    def transpose(g, width):
        b, n, k = g.nbr_t.shape
        idx = torch.arange(n, dtype=g.nbr_t.dtype)[None, :, None]
        nbr_t = idx.expand(b, n, width).clone()
        nbr_t[..., :k] = g.nbr_t
        mask_t = torch.zeros(b, n, width)
        mask_t[..., :k] = g.nbr_t_mask
        return dataclasses.replace(g, nbr_t=nbr_t, nbr_t_mask=mask_t)

    def run(g):
        state = create_train_state(cfg, "cpu", seed=0)
        step = make_train_step()
        losses = [float(step(state, g)["loss"]) for _ in range(STEPS)]
        return losses, {n: p.detach().clone()
                        for n, p in state.model.named_parameters()}

    cap, width = graph.blk_cols.shape[-1], graph.nbr_t.shape[-1]
    base, params = run(graph)
    print(f"as loaded: block slots {cap}, transpose width {width}; losses "
          f"{base}")
    for what, g in ((f"block slots {cap} -> 6", slots(graph, 6)),
                    (f"block slots {cap} -> 8", slots(graph, 8)),
                    (f"transpose width {width} -> {2 * width}",
                     transpose(graph, 2 * width))):
        losses, p = run(g)
        same = all(torch.equal(p[n], params[n]) for n in params)
        print(f"{what}: losses {losses}; the same bits: losses "
              f"{losses == base}, parameters {same}; largest loss change "
              f"{max(abs(a - b) for a, b in zip(losses, base)):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
