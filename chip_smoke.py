#!/usr/bin/env python3
"""Smoke run of the PyTorch port (reviews4rec_torch) on one CUDA card.

    python3 chip_smoke.py

1. Builds every CUDA kernel of the package from `reviews4rec_torch/csrc`
   (one nvcc per source, all at once) and prints the build seconds.
2. Holds each kernel against its plain PyTorch version on the card at
   the main path's shapes and the edge cases (forward: out within 1e-4
   absolute, idx equal; backward: dK within 1e-4 * max(1, max|dK|), db
   within 1e-4, dx within 1e-5 absolute, all exact on integer inputs),
   then times kernel, plain version and a PyTorch library call that
   computes the same function, beside the kernel's bound.
3. Serves deepconn and deepconn++ at full width (T=1000, E=64, F=100,
   batch 256) on the committed e2e corpus with the JAX package's
   weights from `tests/torch_fixtures/e2e_ref.npz`: `predict`,
   `finalize` and the grid and factorized top-k, held against the JAX
   outputs the fixture stores.
4. Trains both heads 8 steps at dropout 0 from the same weights and
   holds losses, step-1 gradients and final params against the JAX
   trainer's in `tests/torch_fixtures/train_ref.npz`.
5. Trains deepconn at full width through `api.run` (2 epochs, dropout
   0.6), restores the saved checkpoint and serves it, then profiles 50
   training steps.
6. Trains a full-width TextCNN tower over a trainable word table, the
   path whose input needs a gradient (dx kernel), and holds its first
   step's gradients against the same step on the CPU.
7. Prints the card, one JSON line of kernel numbers and, last, the
   result line. Any failed check raises and the exit code is not 0.

The kernel launch counts are set to 0 just before each path (serving,
3; training, 5; input gradient, 6) and read just after. Without CUDA or
the checkout around it, the script exits with an error and prints no
result.
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
TRAIN_FIXTURE = ROOT / "tests" / "torch_fixtures" / "train_ref.npz"
SERVE_SHAPE = dict(b=256, t=1000, e=64, f=100, w=3)
# untrained deepconn's test MSE on the e2e corpus (e2e_ref.npz): two
# epochs of training must land below it
UNTRAINED_MSE = 1.524
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


def _cases():
    """(name, maker, (B, T, E, F, W), skip spans) at the main path's
    shape and the edges."""
    s = SERVE_SHAPE
    return [
        ("B=256 T=1000 E=64 F=100 W=3", _random_case,
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


def check_textcnn(torch, textcnn) -> float:
    """Forward kernel vs plain version on the card; returns the largest
    |out| error over the cases."""
    cases = _cases()
    worst = 0.0
    for j, (name, make, (b, t, e, f, w), skip) in enumerate(cases):
        x, k, bias = (a.cuda() for a in make(torch, b, t, e, f, w, seed=j))
        sk = (torch.tensor(skip, dtype=torch.int32, device="cuda")
              if skip is not None else None)
        out, idx = textcnn.textcnn_pool_forward(x, k, bias, w, sk)
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
    ms = _median_ms(torch, lambda: textcnn.textcnn_pool_forward(x, k, bias, w))
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


def _reset(textcnn) -> None:
    for name in textcnn.launches:
        textcnn.launches[name] = 0


def serve(torch, textcnn, ds, device) -> dict:
    import numpy as np

    from reviews4rec_torch.api import finalize
    from reviews4rec_torch.config import HyperParams
    from reviews4rec_torch.models import build_model
    from reviews4rec_torch.serve import (FactorizedRecommender, Recommender,
                                         predict)
    from reviews4rec_torch.train.evaluate import score_grid
    from reviews4rec_torch.utils.io import load_npz
    from reviews4rec_torch.weights import load_flax_params

    ref = load_npz(str(FIXTURE))
    geom = json.loads(str(ref["geometry"]))
    users = ref["serve_users"]

    models = {}
    for mt in ("deepconn", "deepconn++"):
        hp = ds.apply_to(HyperParams(model_type=mt, **geom))
        model = build_model(hp, ds.word_vectors, device=device)
        load_flax_params(model, _subtree(ref, f"{mt}/params/"))
        models[mt] = (hp, model)

    # warm the host caches of the materialized records, so the timed
    # path below measures serving, not the first materialization
    for hp, _ in list(models.values())[:1]:
        ds.materialize(hp, "test")
        ds.materialize_negs(hp)
        ds.materialize_wide_negs(hp, hp.eval_num_negs, seed=hp.seed)

    _reset(textcnn)
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
            before = textcnn.launches[textcnn.FWD]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r[phase] = fn()
            torch.cuda.synchronize()
            r[phase + "_s"] = time.perf_counter() - t1
            r[phase + "_launches"] = textcnn.launches[textcnn.FWD] - before
    launches = dict(textcnn.launches)
    print(f"serving path: launches {launches}")
    if launches[textcnn.FWD] == 0:
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


def _subtree(flat, prefix: str) -> dict:
    """The params tree stored under `prefix` in a fixture."""
    from reviews4rec_torch.weights import tree_from_flat
    return tree_from_flat({k[len(prefix):]: v for k, v in flat.items()
                           if k.startswith(prefix)})


# ---------------------------------------------------------------------
# backward kernels vs plain version
# ---------------------------------------------------------------------
def check_backward(torch, textcnn) -> dict:
    """Both backward kernels through the op's autograd function (x, K
    and b all needing gradients) against the plain backward on the same
    out, idx and cotangent. Returns the largest dK and dx errors."""
    s = SERVE_SHAPE
    cases = [c + (0.0,) for c in _cases()] + [
        ("g zero on a third", _random_case,
         (64, 300, s["e"], s["f"], s["w"]), None, 1 / 3)]
    worst = {"dg": 0.0, "dx": 0.0}
    for j, (name, make, (b, t, e, f, w), skip, zero) in enumerate(cases):
        x, k, bias = (a.cuda() for a in make(torch, b, t, e, f, w, seed=j))
        gen = torch.Generator().manual_seed(100 + j)
        exact = make is _tie_case
        g = (torch.randint(-3, 4, (b, f), generator=gen).float() if exact
             else torch.randn(b, f, generator=gen))
        g[torch.rand(b, f, generator=gen) < zero] = 0.0
        g = g.cuda()
        sk = (torch.tensor(skip, dtype=torch.int32, device="cuda")
              if skip is not None else None)
        xr, kr, br = (a.clone().requires_grad_() for a in (x, k, bias))
        out, idx = textcnn.textcnn_pool(xr, kr, br, w, sk)
        out.backward(g)
        gated = torch.where(out.detach() > 0, g, 0.0)
        dx, dk, db = textcnn.textcnn_pool_backward_reference(
            x, k, gated, idx, w, sk, need_dx=True)
        torch.cuda.synchronize()
        dk_err = (kr.grad - dk).abs().max().item()
        dx_err = (xr.grad - dx).abs().max().item()
        db_err = (br.grad - db).abs().max().item()
        dk_tol = 0.0 if exact else 1e-4 * max(1.0, dk.abs().max().item())
        dx_tol, db_tol = (0.0, 0.0) if exact else (1e-5, 1e-4)
        print(f"textcnn_pool backward {name}: max|dK err| {dk_err:.3e} "
              f"(limit {dk_tol:.1e}), max|dx err| {dx_err:.3e}, max|db "
              f"err| {db_err:.3e}, gated-off g {int((gated == 0).sum())} "
              f"of {g.numel()}")
        if not (dk_err <= dk_tol and dx_err <= dx_tol and db_err <= db_tol):
            raise AssertionError(f"backward kernels disagree with the plain "
                                 f"version ({name})")
        worst["dg"] = max(worst["dg"], dk_err)
        worst["dx"] = max(worst["dx"], dx_err)
    return worst


def _bound(flops: float, nbytes: float) -> dict:
    t_ops, t_bytes = flops / PEAK_F32_FLOP_S, nbytes / PEAK_BYTES_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "mflop": flops / 1e6, "mbytes": nbytes / 1e6}


def time_backward(torch, textcnn) -> dict:
    """Medians of 30 single calls at the training shape (CUDA events) of
    each backward kernel, its plain version and the library yardstick:
    `torch.autograd.grad` through cuDNN's conv1d + ReLU + max, with
    respect to (K, b) for dG and x for dx (the backward alone)."""
    import torch.nn.functional as F

    b, t, e, f, w = (SERVE_SHAPE[k] for k in "btefw")
    halo = w - 1
    x, k, bias = (a.cuda() for a in _random_case(torch, b, t, e, f, w, 0))
    out, idx = textcnn.textcnn_pool_forward(x, k, bias, w)
    g = torch.randn(b, f, generator=torch.Generator().manual_seed(7)).cuda()
    g = torch.where(out > 0, g, 0.0)

    x_cf = x.transpose(1, 2).contiguous().requires_grad_()
    k_cf = k.reshape(w, e, f).permute(2, 1, 0).contiguous().requires_grad_()
    b_cf = bias.clone().requires_grad_()
    y = torch.relu(F.conv1d(x_cf, k_cf, b_cf, padding=halo)).max(2).values

    def lib_dg():
        return torch.autograd.grad(y, (k_cf, b_cf), g, retain_graph=True)

    def lib_dx():
        return torch.autograd.grad(y, (x_cf,), g, retain_graph=True)

    ref_dx, ref_dk, _ = textcnn.textcnn_pool_backward_reference(
        x, k, g, idx, w, need_dx=True)
    got_dk = lib_dg()[0].permute(2, 1, 0).reshape(w * e, f)
    got_dx = lib_dx()[0].transpose(1, 2)
    if not ((got_dk - ref_dk).abs().max().item()
            <= 1e-4 * max(1.0, ref_dk.abs().max().item())
            and (got_dx - ref_dx).abs().max().item() <= 1e-5):
        raise AssertionError("the library yardstick computes another "
                             "backward")

    # the work this run's data needs: FMAs of the non-zero g, and the
    # distinct doc rows that the winning windows of those g cover
    nz = g != 0
    pos = idx.long()[:, :, None] + torch.arange(w, device="cuda")
    rows_b = torch.arange(b, device="cuda")[:, None, None].expand_as(pos)
    sel = nz[:, :, None].expand_as(pos)
    covered = torch.zeros(b, t + 2 * halo, dtype=torch.bool, device="cuda")
    covered[rows_b[sel], pos[sel]] = True
    rows = int(covered[:, halo:halo + t].sum())
    flops = 2.0 * int(nz.sum()) * w * e
    small = 4.0 * (2 * b * f + w * e * f)        # g, idx, K or dK
    res = {
        "dg": dict(_bound(flops, 4.0 * rows * e + small), rows=rows,
                   ms=_median_ms(torch, lambda: textcnn.textcnn_pool_bwd_dg(
                       x, g, idx, w)),
                   plain_ms=_median_ms(torch, lambda: textcnn._dg_reference(
                       x, g, idx, w, None)),
                   library_ms=_median_ms(torch, lib_dg)),
        "dx": dict(_bound(flops, 4.0 * b * t * e + small),
                   ms=_median_ms(torch, lambda: textcnn.textcnn_pool_bwd_dx(
                       g, idx, k, t, w)),
                   plain_ms=_median_ms(torch, lambda: textcnn._dx_reference(
                       g, idx, k, t, w, None)),
                   library_ms=_median_ms(torch, lib_dx)),
    }
    res["gated_off"] = int((~nz).sum())
    return res


# ---------------------------------------------------------------------
# training held against the JAX trainer
# ---------------------------------------------------------------------
def train_vs_jax(torch, ds, device) -> None:
    """8 steps of both heads from the e2e_ref.npz weights at dropout 0,
    against train_ref.npz: losses within 1e-4 relative, step-1 gradients
    within 1e-4 of each tensor's max |grad|, final params within 5e-4
    absolute (Adam turns f32 rounding of near-zero gradients into up to
    a few percent of lr per step; tests/test_torch_train.py)."""
    import numpy as np

    from reviews4rec_torch.config import HyperParams
    from reviews4rec_torch.data import Batcher
    from reviews4rec_torch.models import build_model
    from reviews4rec_torch.train.loop import make_optimizer, train_step
    from reviews4rec_torch.utils.device import to_device
    from reviews4rec_torch.utils.io import load_npz
    from reviews4rec_torch.weights import load_flax_params, params_from_flax

    ref = load_npz(str(TRAIN_FIXTURE))
    init = load_npz(str(FIXTURE))
    geom = json.loads(str(ref["geometry"]))
    steps = geom.pop("steps")
    for mt in ("deepconn", "deepconn++"):
        hp = ds.apply_to(HyperParams(model_type=mt, **geom))
        model = build_model(hp, ds.word_vectors, device=device)
        load_flax_params(model, _subtree(init, f"{mt}/params/"))
        opt = make_optimizer(hp, model)
        grads = {}

        def grab(_opt, _args, _kwargs):
            if not grads:
                grads.update({n: p.grad.detach().clone()
                              for n, p in model.named_parameters()})

        hook = opt.register_step_pre_hook(grab)
        model.train()
        t0 = time.perf_counter()
        losses = [train_step(model, opt, to_device(batch, device))[0]
                  for batch, _ in zip(Batcher(ds.materialize(hp, "train"),
                                              hp.batch_size), range(steps))]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        hook.remove()
        losses = torch.stack(losses).cpu().numpy()
        want = ref[f"{mt}/loss"]
        loss_err = float(np.max(np.abs(losses - want) / np.abs(want)))
        grad_err = 0.0
        for name, wg in params_from_flax(_subtree(ref, f"{mt}/grad1/")).items():
            err = (grads[name].cpu() - wg).abs().max().item()
            grad_err = max(grad_err, err / max(wg.abs().max().item(), 1e-30))
        state = model.state_dict()
        want_p = params_from_flax(_subtree(ref, f"{mt}/params/"))
        worst = max(want_p, key=lambda n: (state[n].cpu() - want_p[n])
                    .abs().max().item())
        p_err = (state[worst].cpu() - want_p[worst]).abs().max().item()
        print(f"{mt} {steps} training steps vs JAX ({secs:.2f} s): losses "
              f"{np.round(losses, 5).tolist()}; max loss err {loss_err:.2e} "
              f"(relative), step-1 grad err {grad_err:.2e} (of each max), "
              f"final params max|err| {p_err:.2e} ({worst})")
        if not (loss_err <= 1e-4 and grad_err <= 1e-4 and p_err <= 5e-4):
            raise AssertionError(f"{mt}: training differs from the JAX "
                                 f"trainer")


# ---------------------------------------------------------------------
# the product path: api.run at full width, restore, serve, profile
# ---------------------------------------------------------------------
def _device_rows(torch, prof):
    """(device us, name, count) of the kernels and copies, and of the
    named ranges that the profiler mirrors on the device's timeline
    (they span kernels, so they are kept out of the busy sum)."""
    rows, ranges = [], []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            (ranges if getattr(ev, "is_user_annotation", False)
             else rows).append((dev_us, ev.key, ev.count))
    return sorted(rows, reverse=True), sorted(ranges, reverse=True)


def _print_profile(torch, prof, what: str, wall: float, top: int,
                   host_top: int = 0) -> None:
    rows, ranges = _device_rows(torch, prof)
    total = sum(r[0] for r in rows)
    if total <= 0:
        raise AssertionError(f"the profile of {what} shows no device time")
    print(f"profile {what}: wall {wall * 1e3:.1f} ms, device busy "
          f"{total / 1e3:.1f} ms ({100 * total / 1e3 / (wall * 1e3):.1f}% "
          f"of wall)")
    for us, key, count in rows[:top]:
        print(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    for us, key, count in ranges:
        print(f"  range {key[:60]} x{count}: {us / 1e3:.3f} ms on the "
              f"device timeline")
    if host_top:
        cpu = sorted((ev for ev in prof.key_averages()
                      if ev.device_type == torch.autograd.DeviceType.CPU),
                     key=lambda ev: ev.self_cpu_time_total, reverse=True)
        print(f"  host, by self CPU time:")
        for ev in cpu[:host_top]:
            print(f"  {ev.self_cpu_time_total / 1e3:9.3f} ms  "
                  f"x{ev.count:<5d} {ev.key[:80]}")


def train_product(torch, textcnn, ds, device) -> dict:
    """`api.run` for deepconn at full width, 2 epochs, dropout 0.6,
    checkpoint in a temporary directory; then `restore_model` + serve.
    Returns the launches of the run."""
    import math
    import re
    import tempfile

    import numpy as np

    from reviews4rec_torch.api import finalize, run
    from reviews4rec_torch.config import HyperParams
    from reviews4rec_torch.serve import predict, restore_model

    with tempfile.TemporaryDirectory() as tmp:
        hp = ds.apply_to(HyperParams(
            model_type="deepconn", dataset="e2e", latent_size=10,
            batch_size=256, eval_num_negs=99, epochs=2, log_dir=tmp,
            model_dir=tmp))
        steps = hp.epochs * math.ceil(len(ds.splits["train"]) /
                                      hp.batch_size)
        _reset(textcnn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, _, _ = run(hp, ds, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(textcnn.launches)
        banners = re.findall(
            r"end of epoch (\d+) \| time: *([\d.]+)s \| MSE = ([\d.]+) "
            r"\| examples_per_s = ([\d.]+)", open(hp.log_file()).read())
        print(f"training path: api.run deepconn, {hp.epochs} epochs of "
              f"{steps // hp.epochs} steps, {wall:.1f} s: launches "
              f"{launches}")
        n_train = len(ds.splits["train"])
        for ep, secs, mse, eps in banners:
            per_step = 1e3 * n_train / float(eps) / (steps // hp.epochs)
            print(f"  epoch {ep}: {float(eps):.1f} train examples/s, "
                  f"{per_step:.3f} ms per step, val MSE {mse}, epoch "
                  f"{secs} s with val")
        print(f"  test: {metrics}")
        if launches[textcnn.BWD_DG] != 2 * steps:
            raise AssertionError(f"expected 2 dG launches per step, "
                                 f"{2 * steps} in all")
        if launches[textcnn.FWD] < 2 * steps:
            raise AssertionError("expected 2 forward launches per step")
        if launches[textcnn.BWD_DX] != 0:
            raise AssertionError("a tower over the frozen table computed dx")
        vals = [float(m) for _, _, m, _ in banners]
        numbers = [metrics[k] for k in ("MSE", "HR@1", "HR@10", "NDCG@10",
                                        "train_examples_per_s")]
        if len(vals) != hp.epochs or not np.isfinite(vals + numbers).all():
            raise AssertionError("missing or non-finite training metrics")
        if not vals[-1] < UNTRAINED_MSE:
            raise AssertionError(f"val MSE {vals[-1]} after training is not "
                                 f"below the untrained {UNTRAINED_MSE}")

        restored = restore_model(hp, ds, device=device)
        pred = predict(hp, ds, "test", model=restored, device=device)
        again = predict(hp, ds, "test", device=device)  # restores itself
        gap = float(np.max(np.abs(again - pred)))
        test_mse = float(np.mean((pred - ds.splits["test"].rating) ** 2))
        scored, _, _ = finalize(hp, restored, ds, device=device)
        print(f"  restored: test MSE from predict {test_mse:.6f} (run "
              f"{metrics['MSE']}), restoring predict vs restored model "
              f"{gap:.1e}, finalize {scored}")
        if not (gap <= 1e-6 and abs(test_mse - metrics["MSE"]) <= 5e-5
                and all(scored[k] == metrics[k] for k in scored)):
            raise AssertionError("the restored model serves another "
                                 "model than the run's")
    return launches


def profile_train(torch, ds, device) -> None:
    """Device time by kernel over 50 warm deepconn training steps at full
    width, through the port's own `trace`."""
    import tempfile

    from reviews4rec_torch.config import HyperParams
    from reviews4rec_torch.data import Batcher
    from reviews4rec_torch.models import build_model
    from reviews4rec_torch.train.loop import (epoch_generator,
                                              make_optimizer, train_epoch)
    from reviews4rec_torch.train.profiler import trace

    hp = ds.apply_to(HyperParams(model_type="deepconn", dataset="e2e",
                                 latent_size=10, batch_size=256))
    recs = ds.materialize(hp, "train")
    keys = ("user", "item", "rating", "user_doc", "item_doc")
    model = build_model(hp, ds.word_vectors, device=device)
    opt = make_optimizer(hp, model)
    gen = epoch_generator(hp.seed, 1, device)

    def batches(lo, hi):
        return Batcher({k: recs[k][lo * 256:hi * 256] for k in keys}, 256)

    train_epoch(model, opt, batches(0, 5), gen, device)      # warm
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            t0 = time.perf_counter()
            train_epoch(model, opt, batches(5, 55), gen, device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    _print_profile(torch, prof, "50 deepconn training steps (B=256, "
                   "T=1000)", wall, top=12, host_top=12)


def train_input_grad(torch, textcnn, ds, device, steps: int = 3) -> dict:
    """The op's full backward where a path needs it: a full-width
    TextCNN tower (E=64, F=100, W=3, latent 10) over a trainable copy of
    the e2e word table, so x = table[ids] needs a gradient (the JAX op's
    need_dx=True), trained `steps` Adam steps on the first train batches
    of user docs against their ratings. Step 1's gradients are held
    against the same step on the CPU, through the plain versions, within
    1e-4 of each tensor's max |grad|. Returns the launches of the run."""
    import numpy as np

    from reviews4rec_torch.config import HyperParams
    from reviews4rec_torch.models.layers import TextCNN

    hp = ds.apply_to(HyperParams(model_type="deepconn", dataset="e2e",
                                 latent_size=10, batch_size=256))
    recs = ds.materialize(hp, "train")
    bs = hp.batch_size

    def make(dev):
        tower = TextCNN(ds.word_vectors.shape[1], hp.latent_size,
                        dropout=0.0,
                        generator=torch.Generator().manual_seed(0)).to(dev)
        table = torch.nn.Parameter(torch.tensor(
            ds.word_vectors, dtype=torch.float32, device=dev))
        return tower, table

    def step(tower, table, s, dev):
        rows = np.arange(s * bs, (s + 1) * bs) % len(recs["rating"])
        ids = torch.from_numpy(recs["user_doc"][rows]).to(dev)
        y = torch.from_numpy(recs["rating"][rows]).to(dev)
        loss = torch.mean((tower(ids, table=table).sum(-1) - y) ** 2)
        loss.backward()
        grads = {n: p.grad.detach().clone()
                 for n, p in tower.named_parameters()}
        grads["table"] = table.grad.detach().clone()
        return loss.detach(), grads

    cpu = torch.device("cpu")
    tower, table = make(cpu)
    _, want = step(tower, table, 0, cpu)

    tower, table = make(device)
    opt = torch.optim.Adam([table, *tower.parameters()], lr=hp.lr)
    _reset(textcnn)
    losses = []
    for s in range(steps):
        loss, grads = step(tower, table, s, device)
        if s == 0:
            got = grads
        losses.append(loss)
        opt.step()
        opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    launches = dict(textcnn.launches)
    losses = torch.stack(losses).cpu()
    errs = {n: (got[n].cpu() - want[n]).abs().max().item()
            / max(want[n].abs().max().item(), 1e-30) for n in want}
    worst = max(errs, key=errs.get)
    print(f"input-gradient path: TextCNN over a trainable word table, "
          f"{steps} steps at B=256 T=1000: launches {launches}; losses "
          f"{[round(v, 5) for v in losses.tolist()]}; step-1 grad err vs "
          f"CPU {errs[worst]:.2e} of the max ({worst})")
    if not torch.isfinite(losses).all() or errs[worst] > 1e-4:
        raise AssertionError("the input-gradient path differs from the "
                             "plain versions")
    if any(launches[name] != steps for name in textcnn.KERNELS):
        raise AssertionError(f"expected {steps} launches of each kernel")
    return launches


def profile_predict(torch, ds) -> None:
    """Device time by kernel over one deepconn `predict` pass."""
    from torch.profiler import ProfilerActivity, profile

    from reviews4rec_torch.config import HyperParams
    from reviews4rec_torch.models import build_model
    from reviews4rec_torch.serve import predict

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
    _print_profile(torch, prof, "deepconn predict (9948 examples)", wall,
                   top=8)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available; this smoke run needs a GPU")
    sys.path.insert(0, str(ROOT))
    try:
        from reviews4rec_torch.data import ReviewDataset
        from reviews4rec_torch.ops import _build, textcnn
    except ImportError as exc:
        fail(f"the reviews4rec_torch package is not beside this script "
             f"({exc})")
    for need in (CORPUS_DIR / "corpus.npz", FIXTURE, TRAIN_FIXTURE):
        if not need.exists():
            fail(f"missing {need.relative_to(ROOT)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    seconds = _build.build(_build.sources())
    print(f"build: {time.perf_counter() - t0:.2f} s wall; per source "
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    for name in textcnn.KERNELS:
        print(f"  {name}: " + _build.library_path(name).with_suffix(".log")
              .read_text().strip().splitlines()[-1].strip())

    fwd_err = check_textcnn(torch, textcnn)
    fwd = time_textcnn(torch, textcnn)
    print(f"textcnn_pool_fwd at B=256 T=1000 E=64 F=100 W=3 f32: kernel "
          f"{fwd['ms']:.4f} ms, plain {fwd['plain_ms']:.4f} ms, "
          f"conv1d+relu+max {fwd['library_ms']:.4f} ms, bound "
          f"{fwd['bound_ms']:.4f} ms ({fwd['bound_by']}; "
          f"{fwd['gflop']:.2f} GFLOP, {fwd['mbytes']:.1f} MB)")
    bwd_err = check_backward(torch, textcnn)
    bwd = time_backward(torch, textcnn)
    for key, name in (("dg", textcnn.BWD_DG), ("dx", textcnn.BWD_DX)):
        r = bwd[key]
        print(f"{name} at B=256 T=1000 E=64 F=100 W=3 f32 ({bwd['gated_off']}"
              f" of 25600 g gated off): kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, autograd of conv1d+relu+max "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; {r['mflop']:.2f} MFLOP, "
              f"{r['mbytes']:.2f} MB" + (f", {r['rows']} distinct doc rows"
                                         if "rows" in r else "") + ")")

    t0 = time.perf_counter()
    ds = ReviewDataset.load(str(CORPUS_DIR))
    sizes = (ds.num_users, ds.num_items, ds.word_vectors.shape,
             len(ds.splits["train"]), len(ds.splits["test"]))
    if sizes != (2500, 1515, (8921, 64), 79577, 9948):
        raise AssertionError(f"unexpected e2e corpus sizes {sizes}")
    print(f"corpus loaded in {time.perf_counter() - t0:.2f} s: "
          f"{sizes[0]} users, {sizes[1]} items, word table {sizes[2]}, "
          f"{sizes[3]} train and {sizes[4]} test examples")

    serve_launches = serve(torch, textcnn, ds, device)
    profile_predict(torch, ds)
    train_vs_jax(torch, ds, device)
    train_launches = train_product(torch, textcnn, ds, device)
    profile_train(torch, ds, device)
    grad_launches = train_input_grad(torch, textcnn, ds, device)

    # launches on each path; dx runs only where the input needs a
    # gradient: the deepconn towers read the frozen word table
    paths = {name: {"serve": serve_launches[name],
                    "train": train_launches[name],
                    "input_grad": grad_launches[name]}
             for name in textcnn.KERNELS}
    src = "reviews4rec_torch/csrc/{}.cu"
    pallas = "reviews4rec_tpu/ops/textcnn_pallas.py:{}"
    kernels = []
    for name, numbers, err, line in (
            (textcnn.FWD, fwd, fwd_err, 153),
            (textcnn.BWD_DG, bwd["dg"], bwd_err["dg"], 448),
            (textcnn.BWD_DX, bwd["dx"], bwd_err["dx"], 380)):
        kernels.append({
            "name": name, "route": "cuda", "source": src.format(name),
            "replaces": pallas.format(line),
            "launches": sum(paths[name].values()),
            "launches_by_path": paths[name],
            "max_abs_err": err, "ms": numbers["ms"],
            "plain_ms": numbers["plain_ms"], "bound_ms": numbers["bound_ms"],
            "bound_by": numbers["bound_by"],
            "library_ms": numbers["library_ms"]})
    kernels[0]["also_replaces"] = pallas.format(47)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
