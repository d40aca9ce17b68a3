"""The check that decides ``correct`` fails what it must: each cell's
control (the reference at the next lower precision in the program's
place) and each fault the cell can have, planted in the program at the
toy size on the CPU, with the rest of the run driven as the harness
drives it (the look for a chip skipped). A sound run reads correct."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from toy import bench, importable, run_toy

importable()

CONTROL = {"patch_train_b16": "tf32", "patch_grade_b16": "tf32"}


@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_control_is_not_correct(cell):
    line = run_toy(cell, control=CONTROL[cell])
    assert line["correct"] is False, line["checks"]


def _unchanged(monkeypatch):
    """The optimizer's step leaves the parameters and its state as they
    were: a training step that returns its state unchanged."""
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    """The loss over the first half of the batch alone."""
    import cgcnet_tpu_torch.train.loop as loop

    def half(logits, labels):
        k = logits.shape[0] // 2
        return F.cross_entropy(logits[:k].float(), labels[:k].long())

    monkeypatch.setattr(loop, "cross_entropy_loss", half)


def _altered(out):
    """The first answer's highest and lowest logits swapped."""
    out = out.clone()
    row = out.reshape(-1, out.shape[-1])[0]
    hi, lo = int(row.argmax()), int(row.argmin())
    row[hi], row[lo] = row[lo].clone(), row[hi].clone()
    return out


def _patch_answer_altered(monkeypatch):
    from cgcnet_tpu_torch.nn.model import CGCNet

    orig = CGCNet.forward
    monkeypatch.setattr(CGCNet, "forward",
                        lambda self, *a, **k: _altered(orig(self, *a, **k)))


def _patch_half_answered(monkeypatch):
    from cgcnet_tpu_torch.nn.model import CGCNet

    orig = CGCNet.forward

    def half(self, *a, **k):
        out = orig(self, *a, **k)
        return out[: out.shape[0] // 2]

    monkeypatch.setattr(CGCNet, "forward", half)


FAULTS = {
    ("patch_train_b16", "state_unchanged"): _unchanged,
    ("patch_train_b16", "half_batch"): _half_batch,
    ("patch_grade_b16", "answer_altered"): _patch_answer_altered,
    ("patch_grade_b16", "half_batch"): _patch_half_answered,
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS),
                         ids=[f"{c}-{f}" for c, f in sorted(FAULTS)])
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[cell, fault](monkeypatch)
    line = run_toy(cell)
    assert line["correct"] is False, line["checks"]


def test_every_cell_has_its_faults_planted():
    """The faults a cell can have: training loses its step or half its
    batch, grading alters an answer or loses half of a batch; one card, so
    no exchange between chips."""
    assert {c for c, _ in FAULTS} == set(CONTROL)
    assert set(CONTROL) == {w["name"] for w in bench()["workloads"]}
