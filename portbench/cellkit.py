"""Set-up that the drivers share: seeds, weights made on the device, the
program's configuration, the synthetic patch tree on disk, and the
reference's copy of each input.

Every input is a function of ``--seed`` and of the traffic file: the
weights (one ``torch.rand`` call on the run's device), the patches'
features (NumPy generators keyed by the seed), the dropout generators and
the order of the training batches come from the seed; the patches' nuclei
counts and positions and the loader's sampling stream come from the
traffic's ``layout_seed``, so every run builds the same graphs, the same
work, and only their content and order change with the seed. The program
and the reference get the same raw inputs; the reference works out
everything else again.
"""

from __future__ import annotations

import dataclasses
import sys
import tempfile

import numpy as np
import torch

from reference import graph as ref_graph
from reference import model as ref_model
from reference import train as ref_train
from traffic import synthetic

# seed streams, one key each
WEIGHTS, DROPOUT = 2, 3
MASK64 = (1 << 64) - 1


def sub_seed(seed: int, key: int) -> int:
    """A 63-bit seed of its own for ``key`` (torch generators take it)."""
    ss = np.random.SeedSequence([int(seed) & MASK64, key])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def model_shapes(config: dict) -> dict:
    """The reference's parameter shapes at the configuration file's widths
    (the cluster counts worked out as the published model does:
    int(max nodes x ratio), then int(that x ratio))."""
    m = config["program"]["model"]
    c1 = int(m["max_num_nodes"] * m["assign_ratio"])
    return ref_model.parameter_shapes(
        input_dim=m["input_dim"], hidden=m["hidden_dim"],
        assign=(c1, int(c1 * m["assign_ratio"])), classes=m["num_classes"],
        pred_hidden=m["pred_hidden_dims"][0])


def make_weights(seed: int, device, running_stats: bool,
                 shapes: dict) -> tuple[dict, dict]:
    """(parameters, running moments) by the reference's names: every
    linear and LSTM weight U(-b, b) at torch's default bound, BatchNorm's
    affine at 1 and 0; with ``running_stats`` the moments of a trained
    model's range (mean U(0, 0.3), var U(0.01, 0.1)), else 0 and 1. One
    ``torch.rand`` on ``device`` from a generator seeded by ``seed``."""
    bounds = {k: ref_model.init_bound(k, shapes) for k in shapes}
    sizes = {k: int(np.prod(s)) for k, s in shapes.items()}
    bn = [k for k in shapes if bounds[k] is None]
    total = sum(sizes[k] for k in shapes if bounds[k] is not None)
    stat_n = sum(sizes[k] for k in bn if k.endswith(".weight"))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    flat = torch.rand(total + 2 * stat_n, generator=gen, device=device)
    P, B, o = {}, {}, 0
    for k, shape in shapes.items():
        if bounds[k] is None:
            fill = 1.0 if k.endswith(".weight") else 0.0
            P[k] = torch.full(shape, fill, device=device)
            continue
        P[k] = (flat[o:o + sizes[k]] * 2 - 1).view(shape) * bounds[k]
        o += sizes[k]
    for k in bn:
        if not k.endswith(".weight"):
            continue
        base, n = k[: -len(".weight")], sizes[k]
        if running_stats:
            B[f"{base}.running_mean"] = flat[o:o + n] * 0.3
            B[f"{base}.running_var"] = 0.01 + flat[o + n:o + 2 * n] * 0.09
        else:
            B[f"{base}.running_mean"] = torch.zeros(n, device=device)
            B[f"{base}.running_var"] = torch.ones(n, device=device)
        o += 2 * n
    return P, B


def load_into(model, P: dict, B: dict) -> None:
    """Copy the benchmark's weights into the program's module (every name
    must match)."""
    sd = model.state_dict()
    missing = set(sd) - set(P) - set(B)
    if missing:
        raise KeyError(f"the program has tensors the benchmark does not "
                       f"make: {sorted(missing)[:5]}")
    with torch.no_grad():
        for k, v in sd.items():
            v.copy_((P.get(k) if k in P else B[k]).to(v.device, v.dtype))


def program_config(run, root: str | None = None):
    """The port's ``Config`` from the configuration file's ``program``
    section (every key named there replaces the default)."""
    from cgcnet_tpu_torch.config import Config

    d = Config().to_dict()
    for section, keys in run.config["program"].items():
        d[section].update(keys)
    if root is not None:
        d["data"]["root"] = root
    d["data"]["seed"] = int(run.traffic["layout_seed"])
    return Config.from_dict(d)


class PatchTree:
    """The traffic's synthetic cross-validation tree, its layout from the
    traffic's ``layout_seed`` and its features from the run's seed, written in the program's proto format under a temporary
    directory (removed by :meth:`close`); ``raw`` keeps each patch's
    arrays for the reference."""

    def __init__(self, run):
        from cgcnet_tpu_torch.dataflow.proto import PatchProto, save_proto

        t = run.traffic
        self._tmp = tempfile.TemporaryDirectory(prefix="portbench-")
        self.root = self._tmp.name
        self.patches = synthetic.patch_set(
            t["layout_seed"], run.seed, t["folds"], t["images_per_grade"],
            t["patches_per_image"], tuple(t["nuclei"]))
        for name, feats, coords, label in self.patches:
            save_proto(self.root, PatchProto(name=name, features=feats,
                                             coords=coords, label=label))
        self.raw = {p[0]: p for p in self.patches}

    def names(self, folds) -> list:
        """The split's patches in the loader's order (sorted by name)."""
        return sorted(n for n in self.raw if n.split("/")[0] in folds)

    def close(self) -> None:
        self._tmp.cleanup()


def host_pool(graph, device):
    """A loader-built batch kept on the host, as the loader hands it to its
    consumer: every tensor pinned when the run's device is a card, so that
    :func:`to_device` copies it without blocking."""
    if device.type != "cuda":
        return graph
    return type(graph)(**{f.name: None if v is None else v.pin_memory()
                          for f in dataclasses.fields(graph)
                          for v in (getattr(graph, f.name),)})


def to_device(graph, device):
    """The batch on the run's device, copied as the loader's consumer copies
    it (``non_blocking`` from pinned memory)."""
    return graph.to(device, non_blocking=device.type == "cuda")


def loader_batches(names: list, batch: int, seed, epoch: int, shuffle: bool,
                   drop_last: bool) -> list:
    """The loader's stated batch composition: the split in name order,
    shuffled by ``default_rng((seed, epoch))``, cut into ``batch``-sized
    runs."""
    idx = np.arange(len(names))
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(idx)
    if drop_last:
        idx = idx[: len(idx) // batch * batch]
    return [[names[i] for i in idx[j:j + batch]]
            for j in range(0, len(idx), batch)]


def reference_patches(tree: PatchTree, cfg, names: list, stat_names: list,
                      epoch: int, purpose: str, device) -> tuple:
    """The reference's graphs and labels of one batch of patches."""
    mean, std = ref_graph.dataset_stats(
        [np.concatenate([tree.raw[n][1], tree.raw[n][2]], -1)
         for n in stat_names])
    d = cfg.data
    cap = -(-(int(d.max_num_nodes * d.sample_ratio) + 1) // 128) * 128
    graphs = ref_graph.patch_graphs(
        [(n, tree.raw[n][1], tree.raw[n][2]) for n in names],
        seed=d.seed, epoch=epoch, purpose=purpose,
        sample_ratio=d.sample_ratio, far_fraction=d.fuse_far_fraction,
        radius=d.max_edge_distance, k=d.max_neighbours, capacity=cap,
        mean=mean, std=std, device=device)
    y = torch.tensor([tree.raw[n][3] for n in names], device=device)
    return graphs, y


FAULTS = ("half_batch",)


def stand_in(name: str) -> dict:
    """The reference's arguments when it stands in the program's place:
    a control's precision (``reference/model.py: CONTROLS``), or a planted
    fault (``half_batch``: the loss over the first half of each batch)."""
    if name in FAULTS:
        return {"control": "identity", name: True}
    return {"control": name}


def train_checks(run, prog: dict, ref: dict, p0: dict) -> dict:
    """The numbers the cell's limits name, each beside its limit; every
    number, the worst leaves and both sides' losses go to standard error
    and ``run.stats``."""
    gaps = ref_train.train_gaps(prog, ref, p0)
    run.stats["details"] = {**gaps, "losses": prog["losses"],
                            "ref_losses": ref["losses"]}
    print(f"worst leaves: gradient {gaps['grad_leaf']}, change "
          f"{gaps['change_leaf']}; {gaps['left_out']} leaves left out of "
          f"the change; losses {prog['losses']} vs {ref['losses']}; "
          + ", ".join(f"{k} {v!r}" for k, v in gaps.items()
                      if isinstance(v, float)), file=sys.stderr)
    return {k: (gaps[k], lim) for k, lim in run.limits.items()
            if k in gaps}


def first_gradient(optimizer, model) -> dict:
    """Each parameter's gradient as Adam received it at step 1, worked out
    from its first moment (m = (1 - beta1) g); zeros where the step left
    no state."""
    b1 = optimizer.param_groups[0]["betas"][0]
    out = {}
    for k, p in model.named_parameters():
        m = optimizer.state.get(p, {}).get("exp_avg")
        out[k] = torch.zeros_like(p) if m is None else m / (1 - b1)
    return out
