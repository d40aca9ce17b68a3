"""Each driver at its toy size on the CPU prints a well-formed result: the
contract's keys, the cell's end-to-end metrics (``--trace 0``) or the
per-layer metrics its readers find (``--trace 1``), each with the unit
``BENCHMARK.json`` gives, and the compared numbers last, each beside its
limit."""

from __future__ import annotations

import json
import math

import pytest

from toy import OVERRIDES, bench, run_toy

BENCH = bench()
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
PER_LAYER = {m["name"]: m for m in BENCH["per_layer"]}


def reported(cell: str) -> set:
    return {k for k, m in E2E.items()
            if "workloads" not in m or cell in m["workloads"]}


def well_formed(line: dict, cell: str, trace: bool) -> None:
    json.loads(json.dumps(line))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks" and line["checks"]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    table = PER_LAYER if trace else E2E
    for name, m in line["metrics"].items():
        assert name in table and m["unit"] == table[name]["unit"]
        assert isinstance(m["value"], float) and math.isfinite(m["value"])
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        ops = line["breakdown"]
        assert len(ops["device_ops"]) <= 10 and len(ops["idle_gaps"]) <= 10
        for name in line["metrics"]:
            assert cell in PER_LAYER[name]["workloads"]
    else:
        assert set(line["metrics"]) == reported(cell)
        assert line["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", sorted(OVERRIDES))
def test_driver_prints_a_well_formed_line(cell, trace):
    line = run_toy(cell, seed=2**31 + 11, trace=trace)
    well_formed(line, cell, trace)
    assert line["correct"] is True, line["checks"]
