"""The port's binding builds the shared native library once and
atomically: six processes that load it at the same moment from a tree
with no ``libcgraph.so`` all load one whole library (one builds it under
the lock, in a private directory, and moves it into place), get the NumPy
builder's graph from it, and leave no build files behind.

The trial is ``scripts/native_build_race.py``'s, which also runs it
against another checkout's binding (the parent's loses processes)."""

import importlib.util
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "native_build_race", REPO / "scripts" / "native_build_race.py")
race = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(race)


def test_concurrent_processes_build_and_load_one_library(tmp_path):
    res = race.trial(REPO / "cgcnet_tpu_torch" / "dataflow" / "native.py",
                     6, tmp_path)
    assert res == dict(lost=0, wrong=0, left=[], rcs=[0] * 6), res
    assert list(tmp_path.iterdir()) == []
