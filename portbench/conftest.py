"""Shared pieces of the benchmark's CPU tests: the benchmark file, the
same with the cells held out of it (`portbench/held_out.json`: their
harness code stays tested), and a shrink that cuts a cell to a size the
CPU runs in seconds (the widths too: these tests exercise the harness,
not the model's numbers)."""

import copy

import pytest

from portbench import models, run

HELD_OUT = run.load_json(run.HERE, "held_out.json")


def shrink(cfg, traffic):
    cfg["corpus"].update(users=60, items=40, reviews=400, vocab=500,
                         review_words_median=12, review_words_max=60)
    cfg["hp"].update(batch_size=16, input_length=64, scan_steps=4)
    # a model's own sizes, where its file names a cut of them
    cfg["hp"].update(getattr(models.load(cfg["model"]), "SHRUNK_HP", {}))
    if traffic["entry"] == "rank":
        traffic.update(rows_per_call=8, grid_batch=4, negatives=9,
                       trace_units=2)


def with_held_out(bench):
    """`bench` with the held-out cells and their own per-layer metrics,
    each cell reporting the metrics of the cell it is like."""
    out = copy.deepcopy(bench)
    for part in ("configs", "workloads", "per_layer"):
        out[part] += copy.deepcopy(HELD_OUT.get(part, []))
    for cell, like in HELD_OUT["like"].items():
        for m in out["end_to_end"] + out["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    return out


BENCH = run.load_json(run.ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
ALL_CELLS = CELLS + [w["name"] for w in HELD_OUT["workloads"]]
SEED = 2 ** 31 + 977   # larger than 32 signed bits hold


@pytest.fixture(scope="session")
def bench():
    return copy.deepcopy(BENCH)


@pytest.fixture(scope="session")
def bench_all():
    return with_held_out(BENCH)
