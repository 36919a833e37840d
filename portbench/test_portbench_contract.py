"""The benchmark's files against the contract it is built to: every
file found by name, names and units, what each per-layer metric moves,
no run without a card, and nothing of JAX in the harness's process."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.conftest import ALL_CELLS, CELLS, SEED, shrink

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"top": {"command", "paths", "run_seconds", "configs", "workloads",
                "end_to_end", "per_layer"},
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_cell_files_load_by_name(bench_all, cell):
    wl, cfg, traffic, limits = run.cell_files(bench_all, cell)
    assert cfg["name"] == wl["config"]
    assert traffic["entry"] in ("train", "rank")
    assert limits and all(v >= 0 for v in limits.values())


def test_readers_load_by_name(bench):
    for m in bench["per_layer"]:
        assert callable(run.reader(m["name"]).read), m["name"]


@pytest.mark.parametrize("which", ["file", "with_held_out"])
def test_keys_names_and_units(bench, bench_all, which):
    bench = bench if which == "file" else bench_all
    assert set(bench) == KEYS["top"]
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[part]:
            assert set(entry) - {"workloads"} == KEYS[part], entry["name"]
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(run.ROOT, c["file"]))
    names = [e["name"] for p in ("end_to_end", "per_layer")
             for e in bench[p]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("which", ["file", "with_held_out"])
def test_moves_is_an_end_to_end_metric_of_each_cell(bench, bench_all, which):
    bench, cells = ((bench, CELLS) if which == "file"
                    else (bench_all, ALL_CELLS))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        for cell in m.get("workloads", cells):
            assert run.applies(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        has = [m["name"] for m in bench["end_to_end"] if run.applies(m, cell)]
        assert "setup_s" in has and len(has) >= 2, cell
        assert any(run.applies(m, cell) for m in bench["per_layer"]), cell


def test_a_run_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=run.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert got.returncode != 0
    assert not [line for line in got.stdout.splitlines()
                if line.startswith("{")]


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_harness_file_imports_jax():
    here = os.path.join(run.ROOT, "portbench")
    for root, _, files in os.walk(here):
        for f in files:
            if f.endswith(".py"):
                roots = set(_imported_roots(os.path.join(root, f)))
                assert not roots & set(run.FORBIDDEN), (f, roots)


def test_no_forbidden_module_in_a_run(bench):
    """A whole run on the CPU in a fresh process: after it, no loaded
    module's top-level name (compared whole) is JAX's or the JAX
    package's, while the port's, which begins with the same letters, is
    loaded."""
    code = (
        "import json, sys, time, torch\n"
        "from portbench import run\n"
        "from portbench.conftest import shrink\n"
        "bench = run.load_json(run.ROOT, 'BENCHMARK.json')\n"
        f"run.run_cell(bench, {CELLS[0]!r}, {SEED}, 0.2, True,\n"
        "             torch.device('cpu'), time.time(), shrink=shrink)\n"
        "roots = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([roots, run.forbidden_modules()]))\n")
    got = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-2000:]
    roots, forbidden = json.loads(got.stdout.strip().splitlines()[-1])
    assert forbidden == []
    assert "reviews4rec_torch" in roots
    assert not set(roots) & set(run.FORBIDDEN)


def test_forbidden_is_matched_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlike_pkg", object())
    monkeypatch.setitem(sys.modules, "reviews4rec_tpu_x.y", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax.numpy"]


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_traced_run_reports_its_per_layer_metrics(bench_all, cell):
    bench = bench_all
    result = run.run_cell(bench, cell, SEED, 0.2, True, torch.device("cpu"),
                          0.0, shrink=shrink)
    listed = {m["name"] for m in bench["per_layer"] if run.applies(m, cell)}
    assert set(result["metrics"]) <= listed
    assert list(result)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(result["device"])
