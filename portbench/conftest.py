"""Shared pieces of the benchmark's CPU tests: the benchmark file, the
same with the cells held out of it (their harness code stays tested),
and a shrink that cuts a cell to a size the CPU runs in seconds (the
widths too: these tests exercise the harness, not the model's
numbers)."""

import copy

import pytest

from portbench import run

# held out of BENCHMARK.json until the program's fault on the card is
# repaired (PERF.md, Open questions); the same entries put it back
HELD_OUT = {
    "configs": [{
        "name": "narre-videogames5",
        "source": "reviews4rec reference, Sachdeva and McAuley, SIGIR 2020, "
                  "https://arxiv.org/abs/2005.12210, hyper_params.py:56-80 "
                  "(NARRE)",
        "file": "portbench/configs/narre-videogames5.json", "reduced": [],
        "why": "NARRE (WWW 2018) at the reference's 10 reviews x 100 words "
               "a side: the same kernels at B=2560, T=100, plus review "
               "attention and doc-row gathers"}],
    "workloads": [{
        "name": "narre.train", "config": "narre-videogames5",
        "traffic": "train", "chips": 1,
        "why": "the same trainer and cache on NARRE: B=256 x 10 reviews of "
               "T=100 a tower, review attention and doc-row gathers"}],
    "like": {"narre.train": "deepconn.train"},
}


def shrink(cfg, traffic):
    cfg["corpus"].update(users=60, items=40, reviews=400, vocab=500,
                         review_words_median=12, review_words_max=60)
    cfg["hp"].update(batch_size=16, input_length=64, scan_steps=4)
    if cfg["model"] == "NARRE":
        cfg["hp"].update(narre_num_words=16)
    if traffic["entry"] == "rank":
        traffic.update(rows_per_call=8, grid_batch=4, negatives=9,
                       trace_units=2)


def with_held_out(bench):
    """`bench` with the held-out cells, each reporting the metrics of
    the cell it is like."""
    out = copy.deepcopy(bench)
    out["configs"] += HELD_OUT["configs"]
    out["workloads"] += HELD_OUT["workloads"]
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
