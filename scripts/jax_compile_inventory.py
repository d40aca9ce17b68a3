#!/usr/bin/env python3
"""What the JAX reference programs of a pytest run cost, test by test: a
pytest plugin that records every XLA compile (seconds, and a fingerprint
of the program's text) and every lowering (seconds), and a report of the
records.

    PYTHONPATH=scripts python -m pytest tests/test_torch_*.py \\
        -p jax_compile_inventory [-n 6 --dist loadfile] --junitxml=run.xml
    python3 scripts/jax_compile_inventory.py [--junit run.xml]

Each process appends its records to ``build/jax_inventory/<pid>.jsonl``
(remove the folder between runs). The report prints one JSON line: the
compiles, their seconds, the lowering seconds, the seconds spent compiling
a program some process had compiled before (``repeat_compile_s``; the
same text compiled with other options counts as a repeat too), by file;
with ``--junit``, each test file's junit seconds beside them.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import time
from pathlib import Path

OUT = Path(__file__).resolve().parent.parent / "build" / "jax_inventory"
_CURRENT = {"test": "collect"}
_SINK: list = []


def _log(record: dict) -> None:
    if not _SINK:
        OUT.mkdir(parents=True, exist_ok=True)
        _SINK.append(open(OUT / f"{os.getpid()}.jsonl", "a"))
    record["test"] = _CURRENT["test"]
    _SINK[0].write(json.dumps(record) + "\n")
    _SINK[0].flush()


def pytest_configure(config):
    try:
        from jax._src import compiler
        from jax._src.interpreters import pxla
    except ImportError:
        return
    compile_or_get_cached = compiler.compile_or_get_cached
    lower = pxla.lower_sharding_computation

    def timed_compile(backend, computation, *args, **kwargs):
        t0 = time.perf_counter()
        out = compile_or_get_cached(backend, computation, *args, **kwargs)
        secs = time.perf_counter() - t0
        text = computation.operation.get_asm(enable_debug_info=False)
        _log({"kind": "compile", "s": secs,
              "fp": hashlib.sha1(text.encode()).hexdigest()[:16]})
        return out

    def timed_lower(*args, **kwargs):
        t0 = time.perf_counter()
        out = lower(*args, **kwargs)
        _log({"kind": "lower", "s": time.perf_counter() - t0})
        return out

    compiler.compile_or_get_cached = timed_compile
    pxla.lower_sharding_computation = timed_lower


def pytest_runtest_protocol(item, nextitem):
    _CURRENT["test"] = item.nodeid


def _file(nodeid: str) -> str:
    return nodeid.split("::")[0].rsplit("/", 1)[-1].removesuffix(".py")


def report(junit: str | None) -> dict:
    records = [json.loads(line) for path in sorted(OUT.glob("*.jsonl"))
               for line in path.read_text().splitlines()]
    compiles = [r for r in records if r["kind"] == "compile"]
    lowers = [r for r in records if r["kind"] == "lower"]
    by_fp = collections.defaultdict(list)
    for r in compiles:
        by_fp[r["fp"]].append(r["s"])
    files = collections.defaultdict(lambda: collections.Counter())
    for r in records:
        files[_file(r["test"])][r["kind"]] += r["s"]
    if junit:
        import xml.etree.ElementTree as ET

        root = ET.parse(junit).getroot()
        suite = root if root.tag == "testsuite" else root.find("testsuite")
        for case in suite.iter("testcase"):
            mods = [p for p in case.get("classname", "").split(".")
                    if p.startswith("test_")]
            if mods:
                files[mods[0]]["junit"] += float(case.get("time", 0.0))
    return {
        "compiles": len(compiles),
        "compile_s": round(sum(r["s"] for r in compiles), 1),
        "lower_s": round(sum(r["s"] for r in lowers), 1),
        "repeat_compile_s": round(sum(sum(sorted(v)[:-1])
                                      for v in by_fp.values()), 1),
        "files": {f: {k: round(v, 1) for k, v in c.items()}
                  for f, c in sorted(files.items(),
                                     key=lambda kv: -kv[1]["compile"])},
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--junit")
    print(json.dumps(report(ap.parse_args().junit)))


if __name__ == "__main__":
    main()
