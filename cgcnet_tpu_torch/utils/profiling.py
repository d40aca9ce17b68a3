"""Profiling and throughput instrumentation. Port of
``cgcnet_tpu/utils/profiling.py``.

The reference's only instrumentation is wall-clock accumulation per batch
(train.py:177,211-212). Here: a ``torch.profiler`` trace behind a flag (the
host's activity and the card's kernels, written as a Chrome trace), a step
timer with edges/s, and a debug mode that stops at the first non-finite
value (the counterpart of ``jax_debug_nans``).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace_context(logdir: str | Path | None):
    """Trace what runs inside with ``torch.profiler`` (CPU activity, and the
    CUDA kernels when a card is present); on exit the Chrome trace is
    written to ``<logdir>/trace.json``. Yields the profiler (None when
    ``logdir`` is empty: nothing is traced)."""
    if not logdir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / TRACE_NAME))


@contextlib.contextmanager
def enable_debug_checks(nans: bool = True):
    """Autograd's anomaly mode inside the block when ``nans`` (the
    counterpart of ``jax_debug_nans``): a backward that makes a NaN raises,
    naming its function. The train step's finite check of the loss and
    gradients is :func:`assert_finite`."""
    if not nans:
        yield
        return
    with torch.autograd.detect_anomaly(check_nan=True):
        yield


def assert_finite(named: dict[str, torch.Tensor | None]) -> None:
    """Raise ``FloatingPointError`` naming the first tensor of ``named``
    (in its order) that holds a NaN or an infinity. One host sync for all
    of them; meant for debug runs only."""
    items = [(k, t) for k, t in named.items() if t is not None]
    if not items:
        return
    flags = torch.stack([torch.isfinite(t).all() for _, t in items])
    if bool(flags.all()):
        return
    bad = next(k for (k, _), ok in zip(items, flags.tolist()) if not ok)
    raise FloatingPointError(f"debug_nans: {bad} is not finite")


class StepTimer:
    """Rolling step timing + edges/s. ``update`` once per step."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._edges: list[int] = []
        self._last = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def update(self, edges: int = 0) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            self._edges.append(edges)
            if len(self._times) > self.window:
                self._times.pop(0)
                self._edges.pop(0)
        self._last = now

    @property
    def mean_step_s(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    @property
    def edges_per_s(self) -> float:
        t = sum(self._times)
        return sum(self._edges) / t if t > 0 else 0.0
