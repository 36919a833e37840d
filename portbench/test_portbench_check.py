"""`correct` at a CPU size: a sound run passes; the control (the
reference on TF32 operands in the program's place) fails; and a run
with the timed path broken underneath fails, once for each fault a cell
can have: a step that returns its state unchanged, a group of steps
that is skipped, half of the batch left out where the group is staged
(the mean taken over the rest), an answer altered where it is produced.
(A one-chip cell has no exchange between chips to leave out.)
"""

import pytest
import torch

from portbench import run
from portbench.conftest import ALL_CELLS, SEED, shrink
from reviews4rec_torch.train import evaluate, loop

CPU = torch.device("cpu")
TRAIN = [c for c in ALL_CELLS if c.endswith(".train")]
RANK = [c for c in ALL_CELLS if c.endswith(".rank")]


def _run(bench_all, cell, control=False):
    return run.run_cell(bench_all, cell, SEED, 0.2, False, CPU, 0.0,
                        control=control, shrink=shrink,
                        log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_sound_run_passes_and_control_fails(bench_all, cell):
    result = _run(bench_all, cell, control=True)
    assert result["correct"] is True, result["checks"]
    assert result["control"]["correct"] is False, result["control"]


@pytest.mark.parametrize("cell", TRAIN)
def test_step_that_keeps_its_state_fails(bench_all, cell, monkeypatch):
    step = loop.train_step

    def unchanged(model, *a, **kw):
        before = [p.detach().clone() for p in model.parameters()]
        out = step(model, *a, **kw)
        with torch.no_grad():
            for p, v in zip(model.parameters(), before):
                p.copy_(v)
        return out

    monkeypatch.setattr(loop, "train_step", unchanged)
    result = _run(bench_all, cell)
    assert result["correct"] is False
    assert result["checks"]["update_median_gap"]["value"] > 0.5


@pytest.mark.parametrize("cell", TRAIN)
def test_skipped_group_fails(bench_all, cell, monkeypatch):
    run_group = loop.ScanSteps.run

    def skipped(self, group):
        if len(group) < self.steps:
            run_group(self, group)

    monkeypatch.setattr(loop.ScanSteps, "run", skipped)
    result = _run(bench_all, cell)
    assert result["correct"] is False
    assert result["checks"]["update_median_gap"]["value"] > 0.5


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_left_out_fails(bench_all, cell, monkeypatch):
    stage = loop.ScanSteps._stage

    def half(self, group):
        halved = []
        for batch in group:
            w = batch["weight"].copy()
            w[len(w) // 2:] = 0.0
            halved.append({**batch, "weight": w})
        stage(self, halved)

    monkeypatch.setattr(loop.ScanSteps, "_stage", half)
    assert _run(bench_all, cell)["correct"] is False


@pytest.mark.parametrize("cell", RANK)
def test_altered_grid_score_fails(bench_all, cell, monkeypatch):
    score_grid = evaluate.score_grid

    def altered(*a, **kw):
        out = score_grid(*a, **kw)
        out[0, 1] += 0.05
        return out

    monkeypatch.setattr(evaluate, "score_grid", altered)
    result = _run(bench_all, cell)
    assert result["correct"] is False
    assert result["checks"]["score_gap"]["value"] > 0.01
