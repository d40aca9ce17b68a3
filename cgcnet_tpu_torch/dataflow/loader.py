"""Threaded prefetching loader yielding ``CellGraph`` batches of tensors.

Worker threads run the numpy pipeline (proto load, sampling, kNN, ELL
transpose, BSR metadata — the native path releases the GIL) and wrap each
collated batch as CPU tensors, pinned when the target is a CUDA device; the
consumer copies them to the device with ``non_blocking=True``, so the copy of
batch i+1 overlaps the model's work on batch i.

Determinism: batch composition is a pure function of (seed, epoch) and each
sample's graph content of (seed, patch, epoch), whatever the thread
scheduling. The one scheduling-dependent quantity is padding width: the
grow-only sticky BSR caps mean a batch's block-slot count can differ from
run to run (the extra slots are zero blocks; numerics are unaffected).

Process-sharded mode (``rank``/``world``, one process per rank of a data
axis): every rank computes the same epoch order from (seed, epoch) and
builds only its rows ``b[r·per:(r+1)·per]`` of each global batch of
``batch_size`` graphs, with the JAX loader's ``process_shard`` rules: the
batch splits evenly, ``drop_last``, one fixed capacity, a transpose-width
overflow raises instead of widening one rank's shapes, and the block
metadata is neither quantized nor sticky (a function of the rank's rows
alone).
Port of ``cgcnet_tpu/dataflow/loader.py`` without the JAX wire packing.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from cgcnet_tpu_torch.core.graph import CellGraph
from cgcnet_tpu_torch.dataflow.dataset import (
    NucleiGraphDataset,
    attach_bsr_meta,
    collate,
)


class GraphLoader:
    """Iterate device-resident CellGraph batches, one epoch at a time.

    Batches go to the CUDA device unless ``device`` names another (the
    tests pass ``device="cpu"``). ``drop_last`` drops the ragged final
    batch (training). ``dynamic_buckets`` pads each batch to 128 x the next
    power of two over its largest sampled graph instead of the dataset
    capacity (fewer padded rows for small batches, a bounded set of
    shapes). ``world`` > 1: the process-sharded mode of rank ``rank``
    (module docstring); ``batch_size`` stays the global batch's."""

    def __init__(
        self,
        dataset: NucleiGraphDataset,
        batch_size: int,
        *,
        device: torch.device | str = "cuda",
        shuffle: bool = True,
        num_workers: int = 0,
        drop_last: bool = False,
        seed: int = 0,
        dynamic_buckets: bool = False,
        rank: int = 0,
        world: int = 1,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "GraphLoader: no CUDA device — pass device='cpu' to load for "
                "the CPU"
            )
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} of a world of {world}")
        if world > 1:
            if batch_size % world:
                raise ValueError(f"process-sharded loading: batch_size "
                                 f"{batch_size} does not split over {world} "
                                 "ranks")
            # a ragged final batch cannot be split evenly across ranks
            if not drop_last:
                raise ValueError("process-sharded loading requires drop_last")
            # a bucket capacity computed from each rank's rows would diverge
            if dynamic_buckets:
                raise ValueError("process-sharded loading requires a fixed "
                                 "node capacity (no dynamic buckets)")
        self.rank, self.world = rank, world
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        # 0 = auto: one worker per usable core (the CPU affinity set, not
        # os.cpu_count()) — the native per-patch build is GIL-free — shared
        # by the ranks of a process-sharded run on one host
        if num_workers <= 0:
            try:
                cores = len(os.sched_getaffinity(0))
            except AttributeError:  # non-Linux
                cores = os.cpu_count() or 1
            self.num_workers = max(1, cores // world)
        else:
            self.num_workers = num_workers
        self.seed = seed
        # fixed capacity unless dynamic bucketing is on (then per batch)
        self.capacity = None if dynamic_buckets else dataset.capacity
        self.bsr_blocks = dataset.cfg.bsr_blocks
        # grow-only per-direction BSR cap floors shared by all batches
        self._sticky_caps: dict = {}

    def _epoch_order(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        return idx

    def batches_per_epoch(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def bucket_capacity(self, idxs, epoch: int) -> int:
        """A dynamic bucket: 128 x the next power of two over the batch's
        sampled node counts (collate's quantization, so the fast and the
        numpy paths give the same shapes)."""
        need = max(self.dataset.sampled_count(int(i), epoch) for i in idxs)
        cap = 128
        while cap < need:
            cap *= 2
        return cap

    def build_batch(self, idxs, epoch: int) -> dict[str, np.ndarray]:
        """Collated numpy batch (with BSR metadata) of dataset items
        ``idxs`` at ``epoch``."""
        ds = self.dataset
        sharded = self.world > 1
        if not ds.supports_fast_path():
            batch = collate([ds.get(int(i), epoch) for i in idxs], self.capacity, 0)
        else:
            batch = self._build_fast(idxs, epoch)
        if self.bsr_blocks > 0:
            attach_bsr_meta(batch, self.bsr_blocks, not sharded,
                            sticky_caps=None if sharded else self._sticky_caps)
        return batch

    def _build_fast(self, idxs, epoch: int) -> dict[str, np.ndarray]:
        # every patch is ONE GIL-free native call writing straight into the
        # batch buffers (dataset.fill_into)
        ds = self.dataset
        b = len(idxs)
        cap = self.capacity or self.bucket_capacity(idxs, epoch)
        k, kt = ds.cfg.max_neighbours, ds.transpose_width
        f = ds.cfg.num_features
        batch = {
            "x": np.empty((b, cap, f), np.float32),
            "nbr": np.empty((b, cap, k), np.int32),
            "nbr_mask": np.empty((b, cap, k), np.float32),
            "nbr_t": np.empty((b, cap, kt), np.int32),
            "nbr_t_mask": np.empty((b, cap, kt), np.float32),
            "n_nodes": np.empty(b, np.int32),
            "y": np.empty(b, np.int32),
            "patch_idx": np.asarray([int(i) for i in idxs], np.int32),
        }
        for bi, i in enumerate(idxs):
            n, y = ds.fill_into(
                int(i), epoch,
                batch["x"][bi], batch["nbr"][bi], batch["nbr_mask"][bi],
                batch["nbr_t"][bi], batch["nbr_t_mask"][bi],
            )
            if n < 0:
                if self.world > 1:
                    raise RuntimeError(
                        "transpose width overflow in process-sharded "
                        "loading; raise dataset.transpose_width so every "
                        "rank builds the same shapes")
                # transpose width overflow: the numpy path widens this batch;
                # widen the nominal width so later batches stay fast
                ds.transpose_width = min(kt * 2, 1024)
                return collate(
                    [ds.get(int(j), epoch) for j in idxs], self.capacity, 0
                )
            batch["n_nodes"][bi] = n
            batch["y"][bi] = y
        return batch

    def epoch(self, epoch: int = 0) -> Iterator[CellGraph]:
        """Yield the batches of ``epoch`` (the epoch selects the sampling
        stream, the analog of the reference's set_epoch)."""
        order = self._epoch_order(epoch)
        if self.drop_last:
            order = order[: (len(order) // self.batch_size) * self.batch_size]
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.world > 1:
            # only this rank's rows of each global batch
            per = self.batch_size // self.world
            batches = [b[self.rank * per:(self.rank + 1) * per]
                       for b in batches]
        pin = self.device.type == "cuda"

        def task(idxs) -> CellGraph:
            return CellGraph.from_numpy(self.build_batch(idxs, epoch), pin=pin)

        # batches in flight: every worker busy, and at least 3 so the copy
        # of batch i+1 is queued while the model runs batch i
        window = max(self.num_workers, 3)
        with ThreadPoolExecutor(self.num_workers) as ex:
            futs: deque = deque()
            submitted = 0
            for _ in range(len(batches)):
                while submitted < len(batches) and len(futs) < window:
                    futs.append(ex.submit(task, batches[submitted]))
                    submitted += 1
                host = futs.popleft().result()
                yield host.to(self.device, non_blocking=pin)
