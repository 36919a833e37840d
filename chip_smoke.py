#!/usr/bin/env python3
"""Smoke run of the PyTorch port (reviews4rec_torch) on one CUDA card.

    python3 chip_smoke.py

1. Builds every CUDA kernel of the package from `reviews4rec_torch/csrc`
   (one nvcc per source, all at once) and prints the build seconds.
2. Holds each kernel against its plain PyTorch version on the card at
   the serving shapes and the edge cases (out within 1e-4 absolute, idx
   equal), then times kernel, plain version and a PyTorch library call
   that computes the same function, beside the kernel's bound.
3. Serves deepconn and deepconn++ at full width (T=1000, E=64, F=100,
   batch 256) on the committed e2e corpus with the JAX package's
   weights from `tests/torch_fixtures/e2e_ref.npz`: `predict`,
   `finalize` and the grid and factorized top-k. The kernel launch
   counts are set to 0 just before and read just after. Outputs are
   held against the JAX outputs the fixture stores.
4. Prints the card, one JSON line of kernel numbers and, last, the
   result line. Any failed check raises and the exit code is not 0.

It needs CUDA and the checkout around it; without either it exits
with an error and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CORPUS_DIR = ROOT / "data" / "e2e" / "5_core"
FIXTURE = ROOT / "tests" / "torch_fixtures" / "e2e_ref.npz"
SERVE_SHAPE = dict(b=256, t=1000, e=64, f=100, w=3)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


# ---------------------------------------------------------------------
# kernel vs plain version
# ---------------------------------------------------------------------
def _random_case(torch, b, t, e, f, w, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, e, generator=g)
    k = torch.randn(w * e, f, generator=g) / (w * e) ** 0.5
    bias = torch.randn(f, generator=g)
    return x, k, bias


def _tie_case(torch, b, t, e, f, w, seed):
    """Integer-valued inputs, exact in f32 in any summation order:
    repeated words make exact ties between windows, row 0 is all
    zeros."""
    g = torch.Generator().manual_seed(seed)
    words = torch.randint(-2, 3, (4, e), generator=g).float()
    x = words[torch.randint(0, 4, (b, t), generator=g)]
    x[0] = 0.0
    k = torch.randint(-1, 2, (w * e, f), generator=g).float()
    bias = torch.randint(-3, 4, (f,), generator=g).float()
    return x, k, bias


def check_textcnn(torch, textcnn) -> float:
    """Kernel vs plain version on the card; returns the largest |out|
    error over the cases."""
    s = SERVE_SHAPE
    cases = [
        ("serve B=256 T=1000 E=64 F=100 W=3", _random_case,
         (s["b"], s["t"], s["e"], s["f"], s["w"]), None),
        ("B=37", _random_case, (37, s["t"], s["e"], s["f"], s["w"]), None),
        ("T=100", _random_case, (64, 100, s["e"], s["f"], s["w"]), None),
        ("forced ties", _tie_case, (8, 300, s["e"], s["f"], s["w"]), None),
        ("skip spans", _random_case, (5, s["t"], s["e"], s["f"], s["w"]),
         [[10, 300], [0, 0], [900, 500], [0, 1000], [1, 1]]),
        ("E=32 W=5", _random_case, (16, 200, 32, s["f"], 5), None),
        # tiling edges: one word and one filter; odd E, a third filter
        # tile holding one filter, the widest window
        ("T=1 F=1", _random_case, (3, 1, s["e"], 1, s["w"]), None),
        ("E=5 F=129 W=8", _random_case, (7, 130, 5, 129, 8), None),
    ]
    worst = 0.0
    for j, (name, make, (b, t, e, f, w), skip) in enumerate(cases):
        x, k, bias = (a.cuda() for a in make(torch, b, t, e, f, w, seed=j))
        sk = (torch.tensor(skip, dtype=torch.int32, device="cuda")
              if skip is not None else None)
        out, idx = textcnn.textcnn_pool(x, k, bias, w, sk)
        ref_out, ref_idx = textcnn.textcnn_pool_reference(x, k, bias, w, sk)
        torch.cuda.synchronize()
        err = (out - ref_out).abs().max().item()
        bad_idx = int((idx != ref_idx).sum().item())
        print(f"textcnn_pool_fwd {name}: max|out err| {err:.3e}, "
              f"idx mismatches {bad_idx} of {idx.numel()}")
        if not err <= 1e-4 or bad_idx:
            raise AssertionError(f"kernel disagrees with the plain version "
                                 f"({name})")
        worst = max(worst, err)
    return worst


def _median_ms(torch, fn, n: int = 30, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return sorted(times)[n // 2]


def time_textcnn(torch, textcnn) -> dict:
    """Median of 30 single calls at the serving shape, CUDA events."""
    import torch.nn.functional as F

    b, t, e, f, w = (SERVE_SHAPE[k] for k in "btefw")
    x, k, bias = (a.cuda() for a in _random_case(torch, b, t, e, f, w, 0))
    # the library yardstick: cuDNN's conv1d (channels-first operands
    # prepared outside the timing), ReLU, max over time
    x_cf = x.transpose(1, 2).contiguous()
    k_cf = k.reshape(w, e, f).permute(2, 1, 0).contiguous()

    def library():
        return torch.relu(F.conv1d(x_cf, k_cf, bias, padding=w - 1)).max(2)

    lib_out = library().values
    ref_out, _ = textcnn.textcnn_pool_reference(x, k, bias, w)
    if not (lib_out - ref_out).abs().max().item() <= 1e-4:
        raise AssertionError("the library yardstick computes another "
                             "function")
    ms = _median_ms(torch, lambda: textcnn.textcnn_pool(x, k, bias, w))
    plain_ms = _median_ms(
        torch, lambda: textcnn.textcnn_pool_reference(x, k, bias, w))
    library_ms = _median_ms(torch, library)
    flops = 2.0 * b * (t + w - 1) * w * e * f
    nbytes = 4.0 * (b * t * e + w * e * f + f) + 8.0 * b * f
    t_ops, t_bytes = flops / PEAK_F32_FLOP_S, nbytes / PEAK_BYTES_S
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6}


# ---------------------------------------------------------------------
# serving at full width, held against the JAX fixture
# ---------------------------------------------------------------------
def _near_tie_rows(scores, tol=1e-4):
    import numpy as np
    return np.any(np.abs(scores[:, 1:] - scores[:, :1]) <= tol, axis=1)


def _check_ranks(name, got_scores, ref_scores):
    """Per-row positive ranks must equal the fixture's, except on rows
    where the fixture shows a candidate within 1e-4 of the positive."""
    import numpy as np
    err = float(np.max(np.abs(got_scores - ref_scores)))
    if not err <= 1e-3:
        raise AssertionError(f"{name} scores off by {err}")
    got = np.sum(got_scores[:, 1:] > got_scores[:, :1], axis=1)
    ref = np.sum(ref_scores[:, 1:] > ref_scores[:, :1], axis=1)
    near = _near_tie_rows(ref_scores)
    moved = got != ref
    if np.any(moved & ~near):
        raise AssertionError(f"{name}: ranks differ off near-ties")
    print(f"  {name}: max|score err| {err:.3e}, near-tie rows "
          f"{int(near.sum())}, rank changes {int(moved.sum())}")
    return int(moved.sum())


def _check_topk(name, ids, scores, ref_ids, ref_scores, tol=1e-4):
    """Top-k lists must agree in score at every position; an id may
    differ only where the reference scores tie within `tol`."""
    import numpy as np
    if not (np.isfinite(scores).all() and ids.shape == ref_ids.shape):
        raise AssertionError(f"{name}: bad top-k output")
    err = float(np.max(np.abs(scores - ref_scores)))
    if not err <= 1e-3:
        raise AssertionError(f"{name}: top-k scores off by {err}")
    swaps = 0
    k = ids.shape[1]
    for r, j in zip(*np.nonzero(ids != ref_ids)):
        nb = [ref_scores[r, i] for i in (j - 1, j + 1) if 0 <= i < k]
        if not (j == k - 1 or any(abs(ref_scores[r, j] - v) <= tol
                                  for v in nb)):
            raise AssertionError(f"{name}: top-k ids differ off near-ties")
        swaps += 1
    print(f"  {name}: max|score err| {err:.3e}, id swaps at near-ties "
          f"{swaps}")


def serve(torch, textcnn, device) -> int:
    import numpy as np

    from reviews4rec_torch.api import finalize
    from reviews4rec_torch.config import HyperParams
    from reviews4rec_torch.data import ReviewDataset
    from reviews4rec_torch.models import build_model
    from reviews4rec_torch.serve import (FactorizedRecommender, Recommender,
                                         predict)
    from reviews4rec_torch.train.evaluate import score_grid
    from reviews4rec_torch.utils.io import load_npz
    from reviews4rec_torch.weights import load_flax_params, tree_from_flat

    t0 = time.perf_counter()
    ds = ReviewDataset.load(str(CORPUS_DIR))
    sizes = (ds.num_users, ds.num_items, ds.word_vectors.shape,
             len(ds.splits["test"]))
    if sizes != (2500, 1515, (8921, 64), 9948):
        raise AssertionError(f"unexpected e2e corpus sizes {sizes}")
    ref = load_npz(str(FIXTURE))
    geom = json.loads(str(ref["geometry"]))
    users = ref["serve_users"]
    print(f"corpus loaded in {time.perf_counter() - t0:.2f} s: "
          f"{sizes[0]} users, {sizes[1]} items, word table {sizes[2]}, "
          f"{sizes[3]} test examples")

    models = {}
    for mt in ("deepconn", "deepconn++"):
        hp = ds.apply_to(HyperParams(model_type=mt, **geom))
        model = build_model(hp, ds.word_vectors, device=device)
        prefix = f"{mt}/params/"
        load_flax_params(model, tree_from_flat(
            {k[len(prefix):]: v for k, v in ref.items()
             if k.startswith(prefix)}))
        models[mt] = (hp, model)

    # warm the host caches of the materialized records, so the timed
    # path below measures serving, not the first materialization
    for hp, _ in list(models.values())[:1]:
        ds.materialize(hp, "test")
        ds.materialize_negs(hp)
        ds.materialize_wide_negs(hp, hp.eval_num_negs, seed=hp.seed)

    textcnn.launches = 0
    results = {}
    for mt, (hp, model) in models.items():
        r = results[mt] = {}
        for phase, fn in (
                ("predict", lambda: predict(hp, ds, "test", model=model,
                                            device=device)),
                ("finalize", lambda: finalize(hp, model, ds, device=device)),
                ("grid_topk", lambda: Recommender(
                    hp, ds, model=model, device=device).topk(users, k=10)),
                ("factorized_topk", lambda: FactorizedRecommender(
                    hp, ds, model=model, device=device).topk(users, k=10))):
            before = textcnn.launches
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r[phase] = fn()
            torch.cuda.synchronize()
            r[phase + "_s"] = time.perf_counter() - t1
            r[phase + "_launches"] = textcnn.launches - before
    launches = textcnn.launches
    print(f"main path: textcnn_pool_fwd launches {launches}")
    if launches == 0:
        raise AssertionError("the serving path launched no kernel")

    # the host share of a grid top-k query: its candidate records alone
    hp = models["deepconn"][0]
    t1 = time.perf_counter()
    for s in range(0, ds.num_items, 512):
        ds.candidate_grid_records(hp, users, np.arange(
            s, min(s + 512, ds.num_items), dtype=np.int32))
    print(f"host records of one grid top-10 query ({len(users)} users x "
          f"{ds.num_items} items): {time.perf_counter() - t1:.3f} s")

    for mt, (hp, model) in models.items():
        r = results[mt]
        n_test = len(ds.splits["test"])
        print(f"{mt}: predict {r['predict_s']:.3f} s "
              f"({n_test / r['predict_s']:.0f} examples/s, "
              f"{r['predict_launches']} launches), finalize "
              f"{r['finalize_s']:.3f} s ({r['finalize_launches']}), grid "
              f"top-10 of {len(users)} users {r['grid_topk_s']:.3f} s "
              f"({r['grid_topk_launches']}), factorized (index build + "
              f"query) {r['factorized_topk_s']:.3f} s "
              f"({r['factorized_topk_launches']})")
        pred = r["predict"]
        want = ref[f"{mt}/test_pred"]
        if pred.shape != want.shape or not np.isfinite(pred).all():
            raise AssertionError(f"{mt}: bad predictions")
        perr = float(np.max(np.abs(pred - want)))
        if not perr <= 1e-3:
            raise AssertionError(f"{mt}: predictions off by {perr}")
        metrics, ucm, icm = r["finalize"]
        ref_metrics = json.loads(str(ref[f"{mt}/metrics"]))
        print(f"  predictions max|err| {perr:.3e}; metrics {metrics}; "
              f"JAX {ref_metrics}")
        if not abs(metrics["MSE"] - ref_metrics["MSE"]) <= 1e-4 + 1e-9:
            raise AssertionError(f"{mt}: MSE differs")
        if (sorted(ucm) != ref[f"{mt}/user_count_keys"].tolist()
                or sorted(icm) != ref[f"{mt}/item_count_keys"].tolist()):
            raise AssertionError(f"{mt}: count-map keys differ")
        moved = _check_ranks(f"{mt} 1+5 grids", score_grid(
            model, ds.materialize_negs(hp), 64, device),
            ref[f"{mt}/narrow_scores"])
        moved += _check_ranks(f"{mt} 1+{hp.eval_num_negs} grids", score_grid(
            model, ds.materialize_wide_negs(hp, hp.eval_num_negs,
                                            seed=hp.seed),
            16, device), ref[f"{mt}/wide_scores"])
        for key in ("HR@1", "HR@10", "NDCG@10"):
            if moved == 0 and metrics[key] != ref_metrics[key]:
                raise AssertionError(f"{mt}: {key} differs")
        gi, gs = r["grid_topk"]
        fi, fs = r["factorized_topk"]
        _check_topk(f"{mt} grid top-10 vs JAX", gi, gs,
                    ref[f"{mt}/topk_ids"], ref[f"{mt}/topk_scores"])
        _check_topk(f"{mt} factorized vs grid top-10", fi, fs, gi, gs)
    return launches


def profile_predict(torch) -> None:
    """Device time by kernel over one deepconn `predict` pass."""
    from torch.profiler import ProfilerActivity, profile

    from reviews4rec_torch.config import HyperParams
    from reviews4rec_torch.data import ReviewDataset
    from reviews4rec_torch.models import build_model
    from reviews4rec_torch.serve import predict

    ds = ReviewDataset.load(str(CORPUS_DIR))
    hp = ds.apply_to(HyperParams(model_type="deepconn", dataset="e2e",
                                 latent_size=10, batch_size=256))
    model = build_model(hp, ds.word_vectors)
    predict(hp, ds, "test", model=model)            # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict(hp, ds, "test", model=model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profile deepconn predict (9948 examples): wall {wall * 1e3:.1f} "
          f"ms, device busy {total / 1e3:.1f} ms "
          f"({100 * total / 1e3 / (wall * 1e3):.1f}% of wall)")
    for us, key, count in rows[:8]:
        print(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available; this smoke run needs a GPU")
    sys.path.insert(0, str(ROOT))
    try:
        from reviews4rec_torch.ops import _build, textcnn
    except ImportError as exc:
        fail(f"the reviews4rec_torch package is not beside this script "
             f"({exc})")
    for need in (CORPUS_DIR / "corpus.npz", FIXTURE):
        if not need.exists():
            fail(f"missing {need.relative_to(ROOT)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    seconds = _build.build(_build.sources())
    print(f"build: {time.perf_counter() - t0:.2f} s wall; per source "
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    print(_build.library_path(textcnn.KERNEL).with_suffix(".log")
          .read_text().strip().splitlines()[-1])

    max_err = check_textcnn(torch, textcnn)
    timing = time_textcnn(torch, textcnn)
    print(f"textcnn_pool_fwd at B=256 T=1000 E=64 F=100 W=3 f32: kernel "
          f"{timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f} ms, "
          f"conv1d+relu+max {timing['library_ms']:.4f} ms, bound "
          f"{timing['bound_ms']:.4f} ms ({timing['bound_by']}; "
          f"{timing['gflop']:.2f} GFLOP, {timing['mbytes']:.1f} MB)")

    launches = serve(torch, textcnn, torch.device("cuda"))
    try:
        profile_predict(torch)
    except Exception as exc:  # the trace is a report, not a check
        print(f"profile: not measured ({type(exc).__name__}: {exc})")

    kernels = [{
        "name": textcnn.KERNEL, "route": "cuda",
        "source": "reviews4rec_torch/csrc/textcnn_pool_fwd.cu",
        "replaces": "reviews4rec_tpu/ops/textcnn_pallas.py:153",
        "also_replaces": "reviews4rec_tpu/ops/textcnn_pallas.py:47",
        "launches": launches, "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
