"""The harness finds everything by the names in ``BENCHMARK.json``, and a
later change adds a cell, a traffic mix, a configuration or a per-layer
metric by adding files alone (and entries to ``BENCHMARK.json``)."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

from toy import OVERRIDES, REPO, ROOT, importable

importable()

import run  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contracts_shape():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["portbench"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def test_every_name_resolves_to_its_files():
    for w in BENCH["workloads"]:
        entry, cfg, traffic, limits = run.cell_files(BENCH, w["name"])
        assert entry is w and cfg["name"] == w["config"]
        assert (ROOT / "drivers" / f"{traffic['driver']}.py").is_file()
        assert limits
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).is_file()
    for m in BENCH["per_layer"]:
        assert callable(run.load_reader(m["name"]))


def test_a_cell_and_a_metric_added_as_files_run(tmp_path):
    """A copy of the checkout's benchmark with a new traffic mix, a new
    cell and a new per-layer metric, each its own new file, runs its new
    cell at the toy size on the CPU and reports the new metric."""
    shutil.copytree(ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for d in ("cgcnet_tpu_torch", "native"):
        os.symlink(REPO / d, tmp_path / d)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "patch_grade_b8", "config": "cgcnet_patch",
        "traffic": "grade_b8", "chips": 1,
        "why": "grading at half the batch"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "patch_grade_b16" in m.get("workloads", []):
            m["workloads"].append("patch_grade_b8")
    bench["per_layer"].append({
        "name": "requests_per_s.grade", "unit": "requests/s",
        "better": "higher", "source": "host_clock", "layer": "model step",
        "moves": "grade_nuclei_per_s", "workloads": ["patch_grade_b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = tmp_path / "portbench"
    traffic = json.loads((ROOT / "traffic" / "grade_b16.json").read_text())
    (pb / "traffic" / "grade_b8.json").write_text(
        json.dumps({**traffic, "batch": 8}))
    shutil.copy(ROOT / "workloads" / "patch_grade_b16.json",
                pb / "workloads" / "patch_grade_b8.json")
    (pb / "metrics" / "requests_per_s.grade.py").write_text(
        "def read(rec):\n"
        "    return rec['calls'] / rec['wall_s'] if rec.get('calls') "
        "else None\n")
    over = json.loads(json.dumps(OVERRIDES["patch_grade_b16"]))
    over["traffic"].pop("batch")
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(pb)!r}]\n"
        "import run\n"
        f"out = run.run_cell('patch_grade_b8', 5, 0.5, True, device='cpu', "
        f"overrides={over!r})\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["requests_per_s.grade"]["value"] > 0


def test_run_refuses_without_a_card_or_without_the_port(tmp_path):
    """No CUDA device, or a directory with only BENCHMARK.json and
    portbench/: a non-zero exit and no result line."""
    cmd = [sys.executable, "portbench/run.py", "--workload",
           "patch_grade_b16", "--seed", str(2**33 + 1), "--seconds", "1",
           "--trace", "0"]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    here = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=env)
    assert here.returncode != 0 and not here.stdout.strip()
    shutil.copytree(ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    alone = subprocess.run(cmd, cwd=tmp_path, capture_output=True,
                           text=True, timeout=300, env=env)
    assert alone.returncode != 0 and not alone.stdout.strip()
