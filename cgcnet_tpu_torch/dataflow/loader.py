"""Threaded prefetching loader yielding ``CellGraph`` batches of tensors.

Worker threads run the numpy pipeline (proto load, sampling, kNN, ELL
transpose, BSR metadata — the native path releases the GIL) and wrap each
collated batch as CPU tensors, pinned when the target is a CUDA device; the
consumer copies them to the device with ``non_blocking=True``, so the copy of
batch i+1 overlaps the model's work on batch i.

Determinism: batch composition is a pure function of (seed, epoch) and each
sample's graph content of (seed, patch, epoch), and every array of a batch,
its padding widths included, is a pure function of the seed and of the
(epoch, position) sequence the loader has yielded up to it — whatever
``num_workers`` and the thread scheduling. Batches share two pieces of
grow-only state: the sticky BSR caps and the dataset's nominal transpose
width. Workers never change either; the consumer updates both in yield
order (``_in_order``): it finishes each batch's block metadata there, and
it builds again a batch that a worker built at a width an earlier batch
has since widened. So a batch at any worker count equals the one worker's
batch bit for bit.

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

import dataclasses
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from cgcnet_tpu_torch.core.graph import CellGraph
from cgcnet_tpu_torch.dataflow.dataset import (
    NucleiGraphDataset,
    collate,
    finish_bsr_meta,
    scan_bsr_meta,
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

    def build_batch(self, idxs, epoch: int, width: int) -> tuple | None:
        """A worker's half of the batch of dataset items ``idxs`` at
        ``epoch``: the collated numpy arrays at transpose width ``width``
        and the scan of their block metadata (``scan_bsr_meta``, or None
        without ``bsr_blocks``); None when ``width`` overflows on the fast
        path. A function of its arguments alone."""
        ds = self.dataset
        if not ds.supports_fast_path():
            batch = collate([ds.get(int(i), epoch) for i in idxs], self.capacity, 0)
        else:
            batch = self._build_fast(idxs, epoch, width)
            if batch is None:
                return None
        return batch, self._scan(batch)

    def _scan(self, batch: dict) -> list | None:
        if self.bsr_blocks <= 0:
            return None
        return scan_bsr_meta(batch, self.bsr_blocks, self.world == 1)

    def _host(self, idxs, epoch: int, width: int, pin: bool):
        """:meth:`build_batch` with its arrays as CPU tensors (pinned when
        ``pin``); None on overflow."""
        built = self.build_batch(idxs, epoch, width)
        return built and (_tensors(built[0], pin), built[1])

    def _build_fast(self, idxs, epoch: int, kt: int) -> dict | None:
        # every patch is ONE GIL-free native call writing straight into the
        # batch buffers (dataset.fill_into)
        ds = self.dataset
        b = len(idxs)
        cap = self.capacity or self.bucket_capacity(idxs, epoch)
        k, f = ds.cfg.max_neighbours, ds.cfg.num_features
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
                return None
            batch["n_nodes"][bi] = n
            batch["y"][bi] = y
        return batch

    def _in_order(self, built, idxs, epoch: int, width: int, pin: bool):
        """The consumer's half of a batch, called in yield order: the
        shared state changes here only (module docstring)."""
        ds = self.dataset
        if width != ds.transpose_width and ds.supports_fast_path():
            # submitted before an earlier batch widened the width
            width = ds.transpose_width
            built = self._host(idxs, epoch, width, pin)
        if built is None:
            # transpose width overflow: widen the nominal width so later
            # batches stay fast, and take this one by the numpy path
            ds.transpose_width = min(width * 2, 1024)
            batch = collate([ds.get(int(j), epoch) for j in idxs],
                            self.capacity, 0)
            built = _tensors(batch, pin), self._scan(batch)
        host, scan = built
        if scan is not None:
            host.update(_tensors(finish_bsr_meta(
                scan, self.bsr_blocks, self.world == 1,
                self._sticky_caps if self.world == 1 else None), pin))
        return CellGraph(**host)

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
        ds = self.dataset
        # batches in flight: every worker busy, and at least 3 so the copy
        # of batch i+1 is queued while the model runs batch i
        window = max(self.num_workers, 3)
        with ThreadPoolExecutor(self.num_workers) as ex:
            futs: deque = deque()
            submitted = 0
            for idxs in batches:
                while submitted < len(batches) and len(futs) < window:
                    width = ds.transpose_width
                    futs.append((ex.submit(self._host, batches[submitted],
                                           epoch, width, pin), width))
                    submitted += 1
                fut, width = futs.popleft()
                host = self._in_order(fut.result(), idxs, epoch, width, pin)
                yield host.to(self.device, non_blocking=pin)


def _tensors(arrays: dict, pin: bool) -> dict:
    """CPU tensors of the ``CellGraph`` fields among ``arrays``, pinned when
    ``pin`` (for a later non-blocking device copy)."""
    names = {f.name for f in dataclasses.fields(CellGraph)}
    out = {}
    for k, a in arrays.items():
        if k in names:
            t = torch.from_numpy(a)
            out[k] = t.pin_memory() if pin else t
    return out
