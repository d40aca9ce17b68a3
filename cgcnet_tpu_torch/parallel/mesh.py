"""The axes of the port's process groups: the graph axis of the whole-slide
path and the data axis of the patch training step, one process per rank.

Port of ``cgcnet_tpu/parallel/mesh.py``. The JAX package splits one program
over the mesh axes ``graph`` (a slide's nodes) and ``data`` (a batch's
graphs); here each rank is a process of a ``torch.distributed`` group, and
``parallel/mega_graph.py`` runs the collectives over the group.
:class:`GraphAxis` is what either axis carries: the group, this process's
rank and the rank count, and the device the rank computes on. Its
one-member form (:data:`ONE`) needs no ``torch.distributed`` at all; every
one-rank path runs on it.

The data axis (:func:`shard_batch`, :func:`multihost_init`,
:func:`own_group`): rank r holds rows [r·B/D, (r+1)·B/D) of every global
batch of B graphs. The JAX package's data-parallel step is the global
program's, so every batch statistic (BN moments, the assign tail's B3
sums) is taken over the whole batch: ``train.loop.make_train_step`` sums
them over the axis and averages the gradients with
``DistributedDataParallel``.

The backend is chosen by a stated rule (:func:`backend_for`), never by
trying one and catching its error: ``gloo`` on the CPU; on CUDA ``nccl``
when every rank owns a card of its own (world size <= device count), and
otherwise ``gloo`` with rank r on ``cuda:(local_rank % device_count)`` —
how several ranks share one card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def launcher(shards: int) -> str:
    """The command that runs the slide CLI as one process per shard."""
    return (f"python -m torch.distributed.run --standalone --nproc-per-node "
            f"{shards} -m cgcnet_tpu_torch.cli.slide --shards {shards} ...")


@dataclasses.dataclass(frozen=True)
class GraphAxis:
    """An axis (the graph axis or the data axis) as this process sees it:
    rank ``rank`` of ``size``, computing on ``device``, its collectives
    over ``group`` (None for one member) on ``backend``."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    group: Optional[object] = None
    backend: Optional[str] = None

    @property
    def staged(self) -> bool:
        """The collectives move CUDA tensors through pinned host memory:
        gloo with ranks on a card."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def check(self, shards: int) -> None:
        """ValueError unless tables built for ``shards`` shards run here:
        one rank per shard."""
        if shards != self.size:
            raise ValueError(
                f"tables built for {shards} shards run in a graph axis of "
                f"{self.size} rank(s); run one process per shard: "
                f"{launcher(shards)}")


# one shard, no process group: the collectives are identities (its device
# is not read; the caller places the tensors)
ONE = GraphAxis()


def backend_for(device_type: str, world_size: int, device_count: int) -> str:
    """gloo on the CPU; on CUDA nccl when every rank owns its own card,
    else gloo (ranks share cards)."""
    if device_type == "cpu":
        return "gloo"
    return "nccl" if world_size <= device_count else "gloo"


def rank_device(device_type: str, local_rank: int,
                device_count: int) -> torch.device:
    """The device of a rank: the CPU, or card local_rank % device_count."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % device_count)


def _device_type(cpu: bool) -> tuple[str, int]:
    if cpu:
        return "cpu", 0
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass --cpu to run the plain PyTorch path on the CPU")
    return "cuda", torch.cuda.device_count()


def init_graph_axis(rank: int, world_size: int, *, cpu: bool,
                    init_method: str = "env://",
                    local_rank: Optional[int] = None,
                    timeout: Optional[datetime.timedelta] = None) -> GraphAxis:
    """Join a ``world_size``-rank group as shard ``rank`` (backend and
    device by :func:`backend_for` / :func:`rank_device`); ``init_method``
    as ``torch.distributed.init_process_group`` takes it (the launcher's
    ``env://``, or ``file://`` / ``tcp://``). ``timeout``: how long a
    collective waits for the other ranks before it raises (the backend's
    default when None)."""
    dtype_, count = _device_type(cpu)
    backend = backend_for(dtype_, world_size, count)
    device = rank_device(dtype_, rank if local_rank is None else local_rank,
                         count)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return GraphAxis(rank, world_size, device, dist.group.WORLD, backend)


def _joined(cpu: bool) -> GraphAxis:
    """The axis of the default group this process already joined."""
    dtype_, count = _device_type(cpu)
    rank, size = dist.get_rank(), dist.get_world_size()
    local = int(os.environ.get("LOCAL_RANK", rank))
    return GraphAxis(rank, size, rank_device(dtype_, local, count),
                     dist.group.WORLD, dist.get_backend())


def _env_rank() -> tuple[int, int, int]:
    """(rank, world size, local rank) from the launcher's environment
    (``torch.distributed.run`` sets ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``)."""
    try:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    except KeyError as e:
        raise RuntimeError(
            f"{e.args[0]} is not set: start the processes with a launcher "
            "(python -m torch.distributed.run --nproc-per-node N ...) or "
            "set RANK and WORLD_SIZE") from None
    return rank, world, int(os.environ.get("LOCAL_RANK", rank))


def multihost_init(coordinator: Optional[str] = None, *, cpu: bool = False,
                   timeout: Optional[datetime.timedelta] = None) -> GraphAxis:
    """Join the default group as one process of a multi-process run and
    return the data axis over it. Rank, world size and local rank come
    from the launcher's environment; the rendezvous is the launcher's
    (``env://``) or, with ``coordinator`` (``host:port``), a TCP store
    there (``tcp://host:port``, rank 0 serving it). Backend and device by
    :func:`backend_for` / :func:`rank_device`."""
    rank, world, local = _env_rank()
    init = f"tcp://{coordinator}" if coordinator else "env://"
    return init_graph_axis(rank, world, cpu=cpu, init_method=init,
                           local_rank=local, timeout=timeout)


def own_group(axis: GraphAxis) -> GraphAxis:
    """The same ranks over a group of their own (``dist.new_group``, the
    axis's backend): the batch statistics' sums run inside the forward and
    the backward, and on a group apart they never interleave with
    ``DistributedDataParallel``'s bucket all-reduces, which run
    asynchronously during the backward. Every rank calls it at the same
    point; one member needs no group."""
    if axis.size == 1:
        return axis
    group = dist.new_group(list(range(axis.size)), backend=axis.backend)
    return dataclasses.replace(axis, group=group)


def shard_batch(graph, axis: GraphAxis):
    """This rank's slice of a global batch: rows [r·B/D, (r+1)·B/D) of
    every batch-axis field of a ``CellGraph`` (``shard_batch_graph``'s
    counterpart); the graph itself for one rank."""
    if axis.size == 1:
        return graph
    b = graph.x.shape[0]
    if b % axis.size:
        raise ValueError(f"a batch of {b} graphs does not split over "
                         f"{axis.size} ranks")
    per = b // axis.size
    rows = slice(axis.rank * per, (axis.rank + 1) * per)
    return dataclasses.replace(graph, **{
        f.name: getattr(graph, f.name)[rows]
        for f in dataclasses.fields(graph)
        if getattr(graph, f.name) is not None})


@contextlib.contextmanager
def launched_axis(cpu: bool):
    """The graph axis of this process: the default group when one is
    joined already, else the launcher's (``torch.distributed.run`` sets
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), joined here and left on
    exit; one member on the device of one process without either."""
    if dist.is_available() and dist.is_initialized():
        yield _joined(cpu)
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        dtype_, _ = _device_type(cpu)
        yield dataclasses.replace(
            ONE, device=(torch.device("cpu") if dtype_ == "cpu" else
                         torch.device("cuda", torch.cuda.current_device())))
        return
    axis = multihost_init(cpu=cpu)
    try:
        yield axis
    finally:
        dist.destroy_process_group()
