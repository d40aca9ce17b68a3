"""Deterministic RNG streams for the input pipeline.

The reference seeds the *global* NumPy RNG ad hoc (np.random.seed(1024) for
val splits, dataflow/data.py:137-140; unseeded for train) — irreproducible
across workers and hosts. Here every stochastic decision (FPS start, fuse
random remainder, random-graph edges) draws from a Generator keyed by
(base_seed, patch_id, epoch, purpose), so any patch's epoch-e graph is
reproducible on any host, in any worker, in any order (SURVEY.md §7 hard
part 4).
"""

from __future__ import annotations

import hashlib

import numpy as np


def patch_rng(base_seed: int, patch_name: str, epoch: int, purpose: str = "sample") -> np.random.Generator:
    key = f"{base_seed}|{patch_name}|{epoch}|{purpose}".encode()
    digest = hashlib.blake2b(key, digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(digest, "little"))
