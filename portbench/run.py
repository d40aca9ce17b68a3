#!/usr/bin/env python3
"""The benchmark of cgcnet_tpu_torch, the PyTorch/CUDA port of CGC-Net.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` and the port.
Runs one cell once: set-up (inputs and weights from the seed, the cell's
shapes warmed), a window of ``--seconds`` (``--trace 1``: a profiled
window of the traffic's ``trace_steps`` requests), then the check of what
the window produced against the plain reference. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared beside its limit); the numbers
compared are also the last lines of standard error.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``portbench/configs/<config>.json``, its traffic in
``portbench/traffic/<traffic>.json`` (which names the driver,
``portbench/drivers/<driver>.py``), its limits in
``portbench/workloads/<cell>.json``, each per-layer metric's reader in
``portbench/metrics/<metric>.py`` (or, for the parts of a split metric
such as ``mfu.train`` and ``mfu.grade``, the reader they share,
``metrics/mfu.py``).

``--control <name>`` puts the reference in the program's place, rounded
to a lower precision (``tf32``) or with a planted fault (``half_batch``),
and prints the readings its outputs give, for setting the limits; the
benchmark's own runs never use it.

Exits non-zero without a result when there is no CUDA device (or fewer
than the cell asks for), when the port is not in the checkout, and when
``jax``, ``jaxlib``, ``flax`` or ``cgcnet_tpu`` were loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cgcnet_tpu")
GIB = float(1 << 30)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, name: str) -> tuple:
    """(workload entry, configuration, traffic, limits) of cell ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    cfg = read_json(ROOT / "configs" / f"{w['config']}.json")
    traffic = read_json(ROOT / "traffic" / f"{w['traffic']}.json")
    limits = read_json(ROOT / "workloads" / f"{name}.json")["limits"]
    return w, cfg, traffic, limits


def merge(into: dict, over: dict) -> None:
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            merge(into[k], v)
        else:
            into[k] = v


def applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether a metric is read in ``cell``: listed there, or (without a
    ``workloads`` key) moving an end-to-end metric the cell reports."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_reader(name: str):
    """``read`` of ``metrics/<name>.py``, else of the reader its split
    shares (``mfu.train`` -> ``metrics/mfu.py``)."""
    path = ROOT / "metrics" / f"{name}.py"
    if not path.is_file():
        path = ROOT / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded(modules=None) -> list:
    """Top-level names of ``FORBIDDEN`` among the loaded modules (default
    ``sys.modules``), each compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def set_environment() -> None:
    """Build caches at fixed paths inside the checkout; keep libraries
    from loading JAX."""
    build = REPO / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device=None, control: str = "", overrides: dict | None = None,
             bench: dict | None = None, t_start: float | None = None,
             details: dict | None = None) -> dict:
    """Run cell ``name`` once; returns the result line's object.
    ``device`` (default the first card), ``overrides`` ({"config": {...},
    "traffic": {...}, "limits": {...}} merged over the files) and
    ``bench`` serve the tests, which run the drivers at toy sizes on the
    CPU; ``details`` (a dict) receives the check's particulars (the worst
    leaves, each step's losses, each request's gap)."""
    import torch

    import harness

    bench = bench if bench is not None else read_json(REPO / "BENCHMARK.json")
    entry, cfg, traffic, limits = cell_files(bench, name)
    for key, into in (("config", cfg), ("traffic", traffic),
                      ("limits", limits)):
        merge(into, (overrides or {}).get(key) or {})
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", 0)
    run = harness.Run(workload=name, seed=seed, seconds=seconds, trace=trace,
                      device=dev, config=cfg, traffic=traffic, limits=limits,
                      t0=T_START if t_start is None else t_start,
                      control=control)
    # the native graph library is built and loaded here, once, before any
    # loader thread asks for it: a thread that asks while another builds it
    # is served by the NumPy paths, which sample other nuclei (PERF.md)
    from cgcnet_tpu_torch.dataflow import native

    native.available()
    driver = importlib.import_module(f"drivers.{traffic['driver']}")
    out = driver.run(run)
    if details is not None:
        details.update(run.stats.get("details", {}))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    values = dict(out.values)
    values["setup_s"] = run.stats["setup_s"]
    values["peak_mem_gib"] = run.stats.get("peak_bytes", 0) / GIB
    reported = {k for k, m in e2e.items()
                if k in values and ("workloads" not in m
                                    or name in m["workloads"])}
    metrics = {}
    result = {"correct": all(v <= lim for v, lim in out.checks.values())
              and out.failed == 0 and out.attempted > 0 and bool(out.checks),
              "attempted": out.attempted, "failed": out.failed}
    if trace:
        for m in bench["per_layer"]:
            if not applies(m, name, reported):
                continue
            v = load_reader(m["name"])(out.record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for k in sorted(reported):
            metrics[k] = {"value": values[k], "unit": e2e[k]["unit"]}
    result["metrics"] = metrics
    result["device"] = harness.device_facts(dev, entry["chips"],
                                            run.stats.get("peak_bytes", 0))
    tr = out.record.get("trace")
    if trace and tr is not None:
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out.checks.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default="",
                   help="the reference in the program's place at a lower "
                        "precision (tf32) or with a fault (half_batch): "
                        "limit-setting only")
    args = p.parse_args(argv)
    set_environment()
    bench_path = REPO / "BENCHMARK.json"
    if not bench_path.is_file() or not (REPO / "cgcnet_tpu_torch").is_dir():
        print("no BENCHMARK.json or no cgcnet_tpu_torch beside portbench/",
              file=sys.stderr)
        return 2
    bench = read_json(bench_path)
    entry = cell_files(bench, args.workload)[0]
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    sys.path.insert(0, str(REPO))
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), control=args.control, bench=bench)
    bad = forbidden_loaded()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port alone",
              file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
