"""The graph axis of the whole-slide path: one process per shard.

Port of the graph axis of ``cgcnet_tpu/parallel/mesh.py``. The JAX package
node-partitions a slide over the mesh axis ``graph`` of one program; here
each shard is a process (a rank of a ``torch.distributed`` group) that
holds its own rows, and ``parallel/mega_graph.py`` runs the graph axis's
collectives over the group. :class:`GraphAxis` is what the slide path
carries: the group, this process's shard index and the shard count, and
the device the rank computes on. Its one-member form (:data:`ONE`) needs no
``torch.distributed`` at all; every one-shard path runs on it.

The backend is chosen by a stated rule (:func:`backend_for`), never by
trying one and catching its error: ``gloo`` on the CPU; on CUDA ``nccl``
when every rank owns a card of its own (world size <= device count), and
otherwise ``gloo`` with rank r on ``cuda:(local_rank % device_count)`` —
how several ranks share one card (NCCL refuses two ranks on one device).

The data axis of the JAX mesh (data parallelism) is not ported here.
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
    """The graph axis as this process sees it: shard ``rank`` of ``size``,
    computing on ``device``, its collectives over ``group`` (None for one
    member) on ``backend``."""

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
    axis = init_graph_axis(int(os.environ["RANK"]), world, cpu=cpu,
                           local_rank=int(os.environ.get("LOCAL_RANK", "0")))
    try:
        yield axis
    finally:
        dist.destroy_process_group()
