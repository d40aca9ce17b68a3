"""What every driver shares: the run's context, the timed window, the traced
window and the reading of its trace, and the device facts of the result.

A driver gets a :class:`Run`, builds its cell in set-up, calls
:meth:`Run.window` with one request (or step) as a function, and returns a
:class:`Outcome`. The window runs untraced for ``--seconds`` with
``--trace 0``; with ``--trace 1`` it runs under ``torch.profiler`` for the
traffic's ``trace_steps`` requests (at most ``--seconds``), and the trace is
reduced to the device's busy intervals, its kernels and its idle gaps,
each gap named by the benchmark span the host was in.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent          # portbench/
REPO = ROOT.parent                              # the checkout

# every __global__ kernel under cgcnet_tpu_torch/csrc (copied from
# scripts/profile_torch_forward.py), by the file it lives in
OWN_KERNELS = (
    # assign_head.cu: B4, B6, B9a
    "rnorm_kernel", "rnorm_lin_tc_kernel", "gemm_kernel", "gemm_tc_kernel",
    "softmax_kernel", "softmax_rows_kernel", "lin_p_probe_kernel",
    # assign_tail.cu: B3, B9b, B5
    "stats_kernel", "stats_lin_tc_kernel", "stats_reduce_kernel",
    "tail_bwd_kernel", "tail_bwd_staged_kernel",
    # bsr_banded.cu: B8
    "banded_kernel", "banded_tc_kernel",
    # bsr_build.cu: B1
    "build_blocks_kernel",
    # bsr_gather.cu: B7
    "bsr_gather_kernel",
    # bsr_matmul.cu: B2
    "bsr_matmul_f32_kernel", "bsr_matmul_tc_kernel",
)


def own_kernel(name: str) -> bool:
    """Whether a profiler kernel name (demangled, with its namespace and
    template arguments) is one of ``OWN_KERNELS``."""
    return any(f"::{k}<" in name or f"::{k}(" in name or name == k
               or name.startswith((f"{k}<", f"{k}(")) for k in OWN_KERNELS)


@dataclasses.dataclass
class Run:
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    limits: dict            # workloads/<cell>.json "limits"
    t0: float               # process start (perf_counter)
    control: str = ""       # "": the program; else the control's name
    spans: dict = dataclasses.field(default_factory=dict)
    stats: dict = dataclasses.field(default_factory=dict)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        """A benchmark span around a call into one layer: host seconds
        summed under ``name``, and a profiler range of that name."""
        t = time.perf_counter()
        with torch.profiler.record_function(f"portbench.{name}"):
            yield
        self.spans.setdefault(name, []).append(time.perf_counter() - t)

    def read_peak(self) -> int:
        """The device's peak allocation so far, kept for the result (read
        before the reference runs, which would raise it)."""
        peak = (int(torch.cuda.max_memory_allocated(self.device))
                if self.device.type == "cuda" else 0)
        self.stats["peak_bytes"] = peak
        return peak

    def window(self, request) -> dict:
        """Call ``request(i)`` until the window closes: ``--seconds`` of
        wall time (untraced), or the traffic's ``trace_steps`` calls under
        the profiler. Each call returns the latency it measured (or None);
        the window ends with a device synchronize. Returns the calls
        made, the window's wall seconds, the latencies and, traced, the
        reduced trace."""
        self.spans.clear()
        limit = self.seconds
        steps_cap = int(self.traffic.get("trace_steps", 10)) if self.trace \
            else None
        prof = None
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        lat = []
        n = 0
        self.sync()
        t0 = time.perf_counter()
        try:
            while True:
                out = request(n)
                n += 1
                if out is not None:
                    lat.append(out)
                if steps_cap is not None and n >= steps_cap:
                    break
                if time.perf_counter() - t0 >= limit:
                    break
            self.sync()
            wall = time.perf_counter() - t0
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        rec = {"calls": n, "wall_s": wall, "latencies": lat,
               "spans": {k: list(v) for k, v in self.spans.items()}}
        if prof is not None:
            rec["trace"] = reduce_trace(prof, wall)
        return rec


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: requests attempted and failed, its
    end-to-end values (``--trace 0``), the record its per-layer metrics
    read (``--trace 1``), and the numbers compared with their limits."""
    attempted: int
    failed: int
    values: dict
    record: dict
    checks: dict            # name -> (value, limit)


def reduce_trace(prof, wall_s: float) -> dict:
    """Kernels, busy seconds (the union of the device's intervals), the
    top device ops and the longest idle gaps of a profiled window; each
    gap named by the innermost benchmark span open at its middle."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    kernels, device, spans = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "kernel":
            kernels.append((e["name"], float(e["ts"]), float(e["dur"])))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                           e["name"]))
        elif cat == "user_annotation" and e["name"].startswith("portbench."):
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                          e["name"][len("portbench."):]))
    device.sort()
    busy, gaps, end = 0.0, [], None
    for s, t, _ in device:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    by_name: dict = {}
    for name, _, dur in kernels:
        by_name[name] = by_name.get(name, 0.0) + dur * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    def host_at(t):
        inner = [sp for sp in spans if sp[0] <= t <= sp[1]]
        return min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner else "host"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    idle = [[host_at((a + b) / 2), (b - a) * 1e-6] for a, b in longest]
    return {"kernels": len(kernels), "busy_s": busy * 1e-6,
            "window_s": wall_s, "device_ops": [[k, v] for k, v in top],
            "idle_gaps": idle,
            "own_kernel_s": sum(v for k, v in by_name.items()
                                if own_kernel(k)),
            "kernel_s": by_name}


def device_facts(device: torch.device, chips: int, peak: int) -> dict:
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": kind, "count": chips, "memory_peak_bytes": peak}


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between ranks."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def free_device() -> None:
    """Return what the program's dropped state held before the reference
    runs (the caller deletes its references first)."""
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
