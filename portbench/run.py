"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of `workloads` in
`BENCHMARK.json`; its configuration file, `portbench/traffic/<mix>.json`
and `portbench/limits/<cell>.json` are found by name, the harness's
part of the configuration's model is `portbench/models/<model>.py`
(`portbench.models`), and each per-layer metric's reader is
`portbench/metrics/<name>.py` (or, failing that, the file of the name
without its last `.part`: `mfu.train` -> `metrics/mfu.py`).

A run: the corpus and the weights from the seed, the program's set-up
and warm-up (`portbench.drivers`), then units of the window until
`--seconds` have passed; with `--trace 1` first `trace_units` units run
under `torch.profiler` and are read, then a whole window runs untraced
(the per-layer metrics that need rates read it).
`setup_s` runs from the process's start to the window's. After the window the program's state
is freed and the plain reference (`portbench.reference`) judges what
the window's path produced (`portbench.check`). The last line of
standard output is the result's JSON; the numbers compared, each beside
its limit, close standard error and the result line.

`--control 1` also judges the control, the reference computed on
operands rounded to TF32, in the program's place; it prints its
numbers on standard error and does not change the result.

Kernels build into the program's `build/kernels/` inside the checkout;
the run writes nothing else there. Without a CUDA card, or with fewer
than the cell asks for, it exits 2 and prints no result; if `jax`,
`jaxlib`, `flax` or `reviews4rec_tpu` is loaded when the window has
closed, it exits 3 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

START = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, corpus, drivers, reference, weights  # noqa: E402
from portbench import trace as tr  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "reviews4rec_tpu")
RATE = {"train": "train_examples_per_s", "rank": "rank_pairs_per_s"}


def process_start() -> float:
    """The wall time this process started, from /proc; the module's
    import time where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return START


def load_json(*parts: str):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_files(bench: dict, name: str):
    """(workload entry, configuration, traffic mix, limits) of a cell of
    `bench`, or of one held out of it (`portbench/held_out.json`)."""
    held = load_json(HERE, "held_out.json")
    wl = next((w for w in bench["workloads"] + held["workloads"]
               if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] + held.get("configs", [])
                if c["name"] == wl["config"])
    return (wl, load_json(ROOT, conf["file"]),
            load_json(HERE, "traffic", wl["traffic"] + ".json"),
            load_json(HERE, "limits", name + ".json"))


def reader(name: str):
    """The module whose `read(record)` gives per-layer metric `name`."""
    stem = name
    while stem:
        path = os.path.join(HERE, "metrics", stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                "portbench_metric_" + stem.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
        stem = stem.rpartition(".")[0]
    raise FileNotFoundError(f"no reader for per-layer metric {name!r}")


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench: dict, name: str, seed: int, seconds: float, traced: bool,
             device, start: float, control: bool = False, shrink=None,
             log=print):
    """One run of cell `name`; returns the result dict. `shrink(cfg,
    traffic)` may cut the sizes in place (the CPU tests do)."""
    wl, cfg, traffic, limits = cell_files(bench, name)
    if shrink is not None:
        shrink(cfg, traffic)
    data = corpus.generate(cfg, seed, device)
    w = weights.make(cfg, data.num_users, data.num_items, seed, device)
    session = drivers.ENTRIES[traffic["entry"]](cfg, traffic, data, w, seed,
                                                device)
    _sync(device)
    setup_s = time.time() - start

    record = {"entry": traffic["entry"]}
    t0 = time.perf_counter()
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            ts = time.perf_counter()
            for _ in range(traffic["trace_units"]):
                session.unit()
            _sync(device)
            slice_s = time.perf_counter() - ts
        record["trace"] = tr.summarize(prof, slice_s)
        del prof
        units = traffic["trace_units"]
        record["slice"] = {"units": units,
                           "steps": units * session.steps_per_unit,
                           "fwd_bound_s": session.fwd_bound_s}
        session.flop = session.fwd_bound_s = 0.0
        # reading the profile takes seconds: the rest of the window
        # starts after it, so that a traced run's rest is a whole window
        t0 = time.perf_counter()
    t_rest, units, work = time.perf_counter(), 0, 0
    ends = []
    while True:
        work += session.unit()
        units += 1
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= seconds:
            break
    _sync(device)
    elapsed = time.perf_counter() - t0
    rest_s = time.perf_counter() - t_rest
    log(f"aside unit_s {np.round(np.diff([t_rest] + ends), 4).tolist()}",
        file=sys.stderr)
    record["rest"] = {"seconds": rest_s, "units": units, "work": work,
                      "flop": session.flop}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    entry = traffic["entry"]
    e2e = {RATE[entry]: work / elapsed, "setup_s": setup_s}
    metrics, breakdown = {}, None
    if traced:
        for m in bench["per_layer"]:
            if applies(m, name):
                v = reader(m["name"]).read(record)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": tr.top(record["trace"]["kernels"]),
                     "idle_gaps": record["trace"]["idle_gaps"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, name):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}

    # --- the check: what the window's path produced, against the reference
    out = judge_inputs(session, entry, seed)
    if hasattr(session, "close"):
        session.close()
    del session
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check_numbers(cfg, traffic, data, w, device, out, limits,
                            tf32=False)
    ok, checks, asides = check.judge(numbers, limits)
    for k, v in asides.items():
        log(f"aside {k} {v!r}", file=sys.stderr)
    ctrl_result = None
    if control:
        ctrl = check_numbers(cfg, traffic, data, w, device, out, limits,
                             tf32=True)
        c_ok, c_checks, c_asides = check.judge(ctrl, limits)
        for k, v in c_asides.items():
            log(f"control aside {k} {v!r}", file=sys.stderr)
        for k, v in c_checks.items():
            log(f"control {k} {v['value']!r} limit {v['limit']!r}",
                file=sys.stderr)
        log(f"control correct {c_ok}", file=sys.stderr)
        ctrl_result = {"correct": c_ok, "checks": c_checks}

    result = {"correct": ok, "attempted": units if not traced
              else units + traffic["trace_units"],
              "failed": 0 if ok else sum(
                  not c["value"] <= c["limit"] for c in checks.values()),
              "metrics": metrics,
              "device": device_record(device, wl["chips"], peak)}
    if traced:
        result["device"]["busy_s"] = record["trace"]["busy_s"]
        result["device"]["window_s"] = record["trace"]["window_s"]
        result["breakdown"] = breakdown
    if ctrl_result is not None:
        result["control"] = ctrl_result
    result["checks"] = checks
    return result


def judge_inputs(session, entry: str, seed: int) -> dict:
    """What the check compares, taken from the session before it is
    freed: the first group of steps, or a call drawn from the seed among
    the window's calls."""
    if entry == "train":
        return dict(session.outputs)
    j = int(corpus.stream(seed, "sample").integers(0, len(session.done)))
    recs = session.records(session.done[j])
    return {"users": recs["user"][:, 0], "grid": recs["item"],
            "scores": session.scores[j], "metrics": session.metrics[j]}


def check_numbers(cfg, traffic, data, w, device, out, limits, tf32: bool):
    """The numbers compared; with `tf32` the control's, the reference on
    TF32 operands standing in the program's place."""
    ref = reference.Reference(cfg, data, w, device)
    entry = traffic["entry"]
    tu, ti, tr = data.splits["train"]
    if entry == "train":
        batches = [(tu[r], ti[r], tr[r]) for r in out["rows"]]
        want = check.reference_train(ref.train(batches, out["gen_seed"]))
        if tf32:
            got = check.reference_train(reference.Reference(
                cfg, data, w, device, tf32=True).train(batches,
                                                       out["gen_seed"]))
        else:
            got = {"loss": out["loss"], "exp_avg": out["exp_avg"],
                   "params": out["p_end"]}
        return check.train_numbers(got, want, w)

    ks = traffic["ks"]
    want = ref.rank_scores(out["users"], out["grid"])
    if tf32:
        ctrl = reference.Reference(cfg, data, w, device, tf32=True)
        got = ctrl.rank_scores(out["users"], out["grid"])
        return check.rank_numbers(got, check.harness_rank_metrics(got, ks),
                                  want, ks, limits["score_gap"])
    return check.rank_numbers(out["scores"], out["metrics"], want, ks,
                              limits["score_gap"])


def device_record(device, chips: int, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": int(peak)}


def card_line() -> str:
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return got.stdout.strip() or got.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    start = process_start()
    bench = load_json(ROOT, "BENCHMARK.json")
    wl = cell_files(bench, args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: the cell needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), start,
                      control=bool(args.control))
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
