"""The readers of the program's spans and counter: each gives its
formula's value on a synthetic record and nothing where its span or
counter is absent; a shrunk CPU traced run of each cell reports them."""

import math

import pytest
import torch

from portbench import run
from portbench.conftest import SEED, shrink
from reviews4rec_torch.train import profiler

HOST = {"score_grid.place": 0.150, "score_grid.assemble": 0.004,
        "score_grid.fetch": 0.025, "score_grid.forward": 0.030,
        "eval_ranking": 0.240, "scan.ring_wait": 0.50,
        "scan.stage": 0.02, "scan.replay": 0.01}
RECORD = {"trace": {"window_s": 0.270, "host": HOST},
          "slice": {"units": 10, "steps": 725}}
# metric -> (span, divisor): 1e3 x host[span] / slice[divisor]
PER = {"entry.place_ms_per_call.rank": ("score_grid.place", "units"),
       "entry.assemble_ms_per_call.rank": ("score_grid.assemble", "units"),
       "entry.fetch_ms_per_call.rank": ("score_grid.fetch", "units"),
       "model.host_ms_per_call.rank": ("score_grid.forward", "units"),
       "trainer.ring_wait_ms_per_step.train": ("scan.ring_wait", "steps"),
       "trainer.stage_ms_per_step.train": ("scan.stage", "steps"),
       "trainer.replay_ms_per_step.train": ("scan.replay", "steps")}
RANK = list(PER)[:4] + ["entry.outside_ms_per_call.rank"]


def _without(span):
    host = {k: v for k, v in HOST.items() if k != span}
    return {"trace": {"window_s": 0.270, "host": host},
            "slice": RECORD["slice"]}


@pytest.mark.parametrize("metric", list(PER))
def test_span_reader_gives_its_formula(metric):
    span, per = PER[metric]
    got = run.reader(metric).read(RECORD)
    assert got == pytest.approx(1e3 * HOST[span] / RECORD["slice"][per])
    assert run.reader(metric).read(_without(span)) is None


def test_outside_reader_gives_the_wall_outside_the_calls():
    read = run.reader("entry.outside_ms_per_call.rank").read
    assert read(RECORD) == pytest.approx(1e3 * (0.270 - 0.240) / 10)
    assert read(_without("eval_ranking")) is None


def test_recapture_reader_reads_the_counter(monkeypatch):
    read = run.reader("trainer.graph_recaptures.train").read
    monkeypatch.setattr(profiler, "counters", {})
    assert read(RECORD) is None
    monkeypatch.setattr(profiler, "counters", {"scan.captures": 1})
    assert read(RECORD) == 0
    monkeypatch.setattr(profiler, "counters", {"scan.captures": 3})
    assert read(RECORD) == 2
    monkeypatch.delattr(profiler, "counters")
    assert read(RECORD) is None


def _traced(bench, cell):
    return run.run_cell(bench, cell, SEED, 0.2, True, torch.device("cpu"),
                        0.0, shrink=shrink, log=lambda *a, **k: None)


def test_traced_rank_run_reports_the_rank_span_metrics(bench):
    metrics = _traced(bench, "deepconn.rank")["metrics"]
    for name in RANK:
        v = metrics[name]["value"]
        assert math.isfinite(v) and v >= 0, (name, v)


def test_traced_train_run_reports_the_stage_metric(bench):
    metrics = _traced(bench, "deepconn.train")["metrics"]
    v = metrics["trainer.stage_ms_per_step.train"]["value"]
    assert math.isfinite(v) and v > 0
    # no ring, no graph on the CPU: their readers find nothing
    for name in ("trainer.ring_wait_ms_per_step.train",
                 "trainer.replay_ms_per_step.train",
                 "trainer.graph_recaptures.train"):
        assert name not in metrics
