#!/usr/bin/env python3
"""Test-seconds of a pytest junit XML, split between the port's test files
(``tests/test_torch_*.py``) and the rest.

    python3 scripts/junit_seconds.py RUN.xml [RUN.xml ...] [--top N]

One JSON line a file: the run's wall (``time``), passed, skipped by
reason, the summed test-seconds of all files, of the port's files and of
each port file, and the longest test with its seconds; ``--top N`` adds
the N slowest port tests.
"""

from __future__ import annotations

import argparse
import collections
import json
import xml.etree.ElementTree as ET


def module_of(classname: str) -> str:
    parts = [p for p in classname.split(".") if p.startswith("test_")]
    return parts[0] if parts else classname


def summary(path: str, top: int) -> dict:
    root = ET.parse(path).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    files: collections.Counter = collections.Counter()
    skips: collections.Counter = collections.Counter()
    tests = []
    for case in suite.iter("testcase"):
        mod, secs = module_of(case.get("classname", "")), float(
            case.get("time", 0.0))
        files[mod] += secs
        tests.append((secs, f"{mod}::{case.get('name')}"))
        skipped = case.find("skipped")
        if skipped is not None:
            skips[skipped.get("message", "")[:80]] += 1
    attrs = {k: int(suite.get(k, 0))
             for k in ("tests", "errors", "failures", "skipped")}
    port = {m: round(s, 1) for m, s in files.most_common()
            if m.startswith("test_torch_")}
    longest = max(tests)
    out = {
        "file": path, "wall": float(suite.get("time", 0.0)),
        "passed": attrs["tests"] - attrs["errors"] - attrs["failures"]
        - attrs["skipped"],
        "failed": attrs["failures"] + attrs["errors"], "skipped": dict(skips),
        "test_seconds": round(sum(files.values()), 1),
        "port_test_seconds": round(sum(port.values()), 1),
        "longest": [longest[1], round(longest[0], 1)], "port_files": port,
    }
    if top:
        out["port_slowest"] = [[n, round(s, 1)] for s, n in sorted(
            tests, reverse=True) if n.startswith("test_torch_")][:top]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="+")
    ap.add_argument("--top", type=int, default=0)
    args = ap.parse_args()
    for path in args.runs:
        print(json.dumps(summary(path, args.top)))


if __name__ == "__main__":
    main()
