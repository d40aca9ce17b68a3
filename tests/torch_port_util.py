"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Every input is made from a numpy seed and handed to both packages as numpy
arrays: the JAX reference gets jnp arrays, the port gets CPU tensors.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

GRAPH_FIELDS = (
    "x", "nbr", "nbr_mask", "n_nodes", "y", "nbr_t", "nbr_t_mask",
    "blk_cols", "blk_mask", "blk_cols_t", "blk_mask_t",
)

# small canonical-shaped model: SAGE, relu, BN, JK, norm_adj, folded tail;
# max_num_nodes 2048 -> pool-1 204 clusters, pool-2 20
SMALL_MODEL = dict(
    hidden_dim=8, embedding_dim=8, assign_hidden_dim=8,
    max_num_nodes=2048, drop_out=0.0,
)


def example_batch(batch: int = 2, cap: int = 1024, seed: int = 0) -> dict:
    """``__graft_entry__._example_graph`` (radius-kNN over spatially sorted
    nuclei, transpose tables, BSR metadata) as a dict of numpy arrays."""
    from __graft_entry__ import _example_graph

    g = _example_graph(batch=batch, cap=cap, seed=seed)
    return {k: np.array(getattr(g, k)) for k in GRAPH_FIELDS}


def jax_graph(batch: dict):
    import jax.numpy as jnp
    from cgcnet_tpu.core.graph import CellGraph

    return CellGraph(**{k: jnp.asarray(v) for k, v in batch.items()})


def torch_graph(batch: dict):
    import torch
    from cgcnet_tpu_torch.core.graph import CellGraph

    return CellGraph(**{k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


def random_tree(init_fn, seed: int) -> dict:
    """Flax {"params", "batch_stats"} with the structure ``init_fn`` (a
    flax ``init`` call) would make, every leaf drawn from a numpy seed:
    weights ~ U(-0.5, 0.5), BN scale ~ U(0.5, 1.5), running mean ~
    N(0, 0.2), running var ~ U(0.5, 1.5) — so BN does real work (a fresh
    init leaves it at mean 0, var 1)."""
    import jax

    shapes = jax.eval_shape(init_fn)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "mean":
            return (rng.normal(size=s.shape) * 0.2).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, size=s.shape).astype(np.float32)
        return rng.uniform(-0.5, 0.5, size=s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def stage1_weights(batch: dict, self_weight: float = 0.4) -> np.ndarray:
    """Forward ELL weights of the norm_adj stage-1 operator (what
    nn/model.py:make_stage1_adj feeds the block build)."""
    nbr, m = batch["nbr"], batch["nbr_mask"]
    n = nbr.shape[1]
    is_self = (nbr == np.arange(n)[None, :, None]) * m
    off = m - is_self
    deg = off.sum(-1)
    valid = (np.arange(n)[None, :] < batch["n_nodes"][:, None]).astype(np.float32)
    scale = (1.0 - self_weight) / (deg + 1e-15) * valid
    return (
        scale[..., None] * off + (self_weight * valid)[..., None] * is_self
    ).astype(np.float32)
