"""Write the JAX package's reference outputs of the bf16 TextCNN and of the
non-SGD families on the committed e2e corpus, so that the port can be
held against JAX on a machine that has no JAX (`chip_smoke.py`):

- `neighbors_ref.npz`: for baseline, SVD, SVD++, NMF and kNN at the e2e
  runner's flags (surprise defaults, latent 10, `eval_num_negs` 99):
  `<model>/init/<key>` the state JAX's fit draws from `hp.seed`
  (`_sgd_fit`: zero biases and N(0, 0.1) p, q, y from the keys it
  splits; `_nmf_fit`: U(0, 1) p, q), `<model>/final/<key>` the fitted
  state, `<model>/test_pred` the test predictions and `<model>/metrics`
  `run_neighbor`'s metrics as JSON.
- `hft_ref.npz`: HFT at the e2e runner's flags (latent 10,
  `latent_reg` 4.0, lambda 0.1): `init/<key>` the params after
  `init_params`, `background`, `counts/<key>` the counts of the fit's
  first E-step (from the key `HFTTrainer.fit` splits), `values` the
  energy at the start of each iteration of the first M-step
  (`hft_grad_iters` L-BFGS iterations by `optax.lbfgs()`, as
  `make_m_step`), `m_step/<key>` its result, and `energy` and
  `grad/<key>` at that result; `values_f64` the same M-step's values in
  float64 (JAX under `enable_x64`, from the same f32 values).
- `bf16_ref.npz`: deepconn and deepconn++ at `compute_dtype="bfloat16"`
  (the XLA TextCNN branch), full width, from the init params of
  `e2e_ref.npz`: `<model>/serve_pred`, their predictions of the first
  `SERVE_ROWS` test examples (the JAX `Batcher`, batch 256); for
  deepconn++ `loss`, `grad1/<path>` (the gradient of step 1) and
  `params/<path>` after `STEPS` Adam steps at dropout 0 on the first
  `STEPS` train batches.
- `fp16_ref.npz`: the same at `compute_dtype="float16"`, and the library
  layers no model builds, at a small width: `lib/ln/x`, `lib/ln/params/
  <path>` (moved off the init) and `lib/ln/out` of `LayerNorm`, the same
  under `lib/ffn/` for `PosFFN`, and `lib/pe/<length>_<dim>_<zero_pad>_
  <scale>` tables of `positional_encoding`.

It runs on the CPU:

    python tests/torch_fixtures/make_nonsgd_ref.py [neighbors] [hft] \
        [bf16] [fp16]

(no argument: all four). neighbors takes about 2 minutes, hft about
1 minute and bf16 and fp16 a few minutes each.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from reviews4rec_tpu.config import HyperParams  # noqa: E402
from reviews4rec_tpu.data.batcher import Batcher  # noqa: E402
from reviews4rec_tpu.data.corpus import ReviewDataset  # noqa: E402
from reviews4rec_tpu.models import build_model, hft, neighbors  # noqa: E402
from reviews4rec_tpu.models.layers import (LayerNorm, PosFFN,  # noqa: E402
                                           positional_encoding)
from reviews4rec_tpu.train.evaluate import make_apply_fn  # noqa: E402
from reviews4rec_tpu.train.loop import (TrainState, _batch_loss,  # noqa: E402
                                        make_optimizer, make_train_step)

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from make_e2e_ref import MODELS, _flat  # noqa: E402
from make_train_ref import _init_params  # noqa: E402

GEOM = dict(dataset="e2e", latent_size=10, batch_size=256, eval_num_negs=99,
            seed=0)
NEIGHBORS = ("baseline", "SVD", "SVD++", "NMF", "kNN")
HFT_FLAGS = dict(latent_reg=4.0)
HALF = dict(input_length=1000, dropout=0.0)
SERVE_ROWS = 512
STEPS = 8
OUT = {"neighbors": HERE / "neighbors_ref.npz", "hft": HERE / "hft_ref.npz",
       "bf16": HERE / "bf16_ref.npz", "fp16": HERE / "fp16_ref.npz"}
# the library layers' shapes: LayerNorm's and PosFFN's x, PosFFN's hidden
# width, positional_encoding's (length, dim, zero_pad, scale)
LIB_X, LIB_HIDDEN = (2, 20, 64), 64
LIB_PE = ((128, 64, False, False), (64, 64, True, True), (37, 15, False,
                                                            True))


def jax_init(mt: str, hp: HyperParams, U: int, I: int) -> dict:
    """The init `_sgd_fit` / `_nmf_fit` draw from `hp.seed`."""
    rng = jax.random.PRNGKey(hp.seed)
    K = hp.latent_size
    if mt == "NMF":
        k1, k2 = jax.random.split(rng)
        return {"p": jax.random.uniform(k1, (U, K)),
                "q": jax.random.uniform(k2, (I, K))}
    k1, k2, k3 = jax.random.split(rng, 3)
    out = {"bu": jnp.zeros(U), "bi": jnp.zeros(I)}
    if mt in ("SVD", "SVD++"):
        out["p"] = 0.1 * jax.random.normal(k1, (U, K))
        out["q"] = 0.1 * jax.random.normal(k2, (I, K))
    if mt == "SVD++":
        out["y"] = 0.1 * jax.random.normal(k3, (I, K))
    return out


def make_neighbors(ds) -> dict:
    arrays = {"geometry": np.asarray(json.dumps(GEOM))}
    te = ds.splits["test"]
    U, I = ds.num_users, ds.num_items
    for mt in NEIGHBORS:
        t0 = time.time()
        hp = ds.apply_to(HyperParams(model_type=mt, **GEOM))
        if mt != "kNN":
            for k, v in jax_init(mt, hp, U, I).items():
                arrays[f"{mt}/init/{k}"] = np.asarray(v, np.float32)
        users, items, ratings = neighbors._train_arrays(ds)
        mu = float(ds.splits["train"].rating.mean())
        if mt == "NMF":
            p, q = neighbors._nmf_fit(users, items, ratings, U, I,
                                      epochs=hp.nmf_epochs,
                                      factors=hp.latent_size, seed=hp.seed)
            arrays[f"{mt}/final/p"] = np.asarray(p)
            arrays[f"{mt}/final/q"] = np.asarray(q)
        elif mt != "kNN":
            kw = {}
            if mt == "SVD++":
                maxI = max(1, int(ds.user_count.max()))
                pad = np.zeros((U, maxI), np.int32)
                tr = ds.splits["train"]
                order = np.argsort(tr.user, kind="stable")
                su = tr.user[order].astype(np.int64)
                counts = np.bincount(su, minlength=U)
                col = np.arange(len(su)) - np.repeat(
                    np.cumsum(counts) - counts, counts)
                pad[su, col] = tr.item[order]
                kw = {"rated_pad": jnp.asarray(pad),
                      "rated_count": jnp.asarray(counts.astype(np.float32))}
            state = neighbors._sgd_fit(
                users, items, ratings, U, I, mu, epochs=hp.surprise_epochs,
                variant=mt, factors=hp.latent_size,
                lr=0.007 if mt == "SVD++" else hp.surprise_lr,
                reg=hp.surprise_reg, seed=hp.seed, **kw)
            for k, v in state.items():
                arrays[f"{mt}/final/{k}"] = np.asarray(v)
        arrays[f"{mt}/test_pred"] = np.asarray(
            neighbors.fit(hp, ds)(te.user, te.item), np.float32)
        metrics, _, _ = neighbors.run_neighbor(hp, ds)
        arrays[f"{mt}/metrics"] = np.asarray(json.dumps(metrics))
        print(mt, metrics, f"{time.time() - t0:.1f}s", flush=True)
    return arrays


def make_hft(ds) -> dict:
    hp = ds.apply_to(HyperParams(model_type="HFT", **GEOM, **HFT_FLAGS))
    arrays = {"geometry": np.asarray(json.dumps(dict(GEOM, **HFT_FLAGS)))}
    data = hft.build_hft_data(hp, ds)
    params, background = hft.init_params(data, hp, print)
    _, r0 = jax.random.split(jax.random.PRNGKey(hp.seed))
    counts = hft.e_step(params, background, data.tok_word, data.tok_item,
                        hp.latent_size, r0, tok_weight=data.tok_weight)
    for k, v in params.items():
        arrays[f"init/{k}"] = np.asarray(v, np.float32)
    arrays["background"] = np.asarray(background)
    for k in ("word_topic", "item_topic", "topic_counts"):
        arrays[f"counts/{k}"] = np.asarray(counts[k])
    energy = hft.make_energy(data, hp)
    fn = lambda p: energy(p, counts, background)
    opt = optax.lbfgs()
    state = opt.init(params)
    value_and_grad = optax.value_and_grad_from_state(fn)
    values = []
    p = params
    t0 = time.time()
    for _ in range(hp.hft_grad_iters):
        value, grad = value_and_grad(p, state=state)
        updates, state = opt.update(grad, state, p, value=value, grad=grad,
                                    value_fn=fn)
        p = optax.apply_updates(p, updates)
        values.append(float(value))
    arrays["values"] = np.asarray(values, np.float32)
    for k, v in p.items():
        arrays[f"m_step/{k}"] = np.asarray(v, np.float32)
    # the same M-step in float64 (x64; the f32 data's values are exact)
    with jax.enable_x64(True):
        c64 = {k: jnp.asarray(np.asarray(v, np.float64))
               for k, v in counts.items()}
        bg64 = jnp.asarray(np.asarray(background, np.float64))
        p = {k: jnp.asarray(np.asarray(v, np.float64))
             for k, v in params.items()}
        fn64 = lambda q: energy(q, c64, bg64)
        state = opt.init(p)
        value_and_grad = optax.value_and_grad_from_state(fn64)
        values64 = []
        for _ in range(hp.hft_grad_iters):
            value, grad = value_and_grad(p, state=state)
            updates, state = opt.update(grad, state, p, value=value,
                                        grad=grad, value_fn=fn64)
            p = optax.apply_updates(p, updates)
            values64.append(float(value))
    arrays["values_f64"] = np.asarray(values64, np.float64)
    p = {k: jnp.asarray(arrays[f"m_step/{k}"]) for k in params}
    value, grad = jax.value_and_grad(fn)(p)
    arrays["energy"] = np.asarray(value, np.float32)
    for k, v in grad.items():
        arrays[f"grad/{k}"] = np.asarray(v, np.float32)
    print("HFT M-step values", values, f"{time.time() - t0:.1f}s", flush=True)
    return arrays


def make_half(ds, compute_dtype: str) -> dict:
    """deepconn and deepconn++ at the 16-bit `compute_dtype`."""
    ref = dict(np.load(HERE / "e2e_ref.npz"))
    half = dict(HALF, compute_dtype=compute_dtype)
    arrays = {"geometry": np.asarray(json.dumps(
        dict(GEOM, **half, serve_rows=SERVE_ROWS, steps=STEPS)))}
    for mt in MODELS:
        t0 = time.time()
        hp = ds.apply_to(HyperParams(model_type=mt, **GEOM, **half))
        model = build_model(hp, ds.word_vectors)
        apply_fn = make_apply_fn(model)
        params = _init_params(ref, mt, ds.word_vectors)
        preds = []
        for b, _ in zip(Batcher(ds.materialize(hp, "test"), hp.batch_size),
                        range(SERVE_ROWS // hp.batch_size)):
            preds.append(np.asarray(model.apply(
                {"params": params}, jax.tree_util.tree_map(jnp.asarray, b),
                train=False)))
        arrays[f"{mt}/serve_pred"] = np.concatenate(preds).astype(np.float32)
        if mt == "deepconn++":
            batches = [jax.tree_util.tree_map(jnp.asarray, b)
                       for b, _ in zip(Batcher(ds.materialize(hp, "train"),
                                               hp.batch_size), range(STEPS))]
            rng = jax.random.PRNGKey(0)
            grad1 = jax.grad(lambda p: _batch_loss(
                apply_fn(p, batches[0], True, rng), batches[0], mt)[0])(
                    params)
            for path, v in _flat(grad1).items():
                arrays[f"{mt}/grad1/{path}"] = v
            opt = make_optimizer(hp)
            state = TrainState(params, opt.init(params),
                               jnp.zeros((), jnp.int32))
            step = make_train_step(apply_fn, opt, mt)
            losses = []
            for batch in batches:
                state, m = step(state, batch, jax.random.PRNGKey(0))
                losses.append(float(m["loss"]))
            arrays[f"{mt}/loss"] = np.asarray(losses, np.float32)
            for path, v in _flat(state.params).items():
                arrays[f"{mt}/params/{path}"] = v
            print(mt, "losses", losses, flush=True)
        print(mt, f"{time.time() - t0:.1f}s", flush=True)
    return arrays


def make_library() -> dict:
    """LayerNorm, PosFFN and positional_encoding at a small width, their
    params moved off the init so that every one of them matters."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=LIB_X).astype(np.float32) * 2.0 + 0.5)
    arrays = {}
    for name, mod in (("ln", LayerNorm()), ("ffn", PosFFN(hidden=LIB_HIDDEN))):
        params = mod.init(jax.random.PRNGKey(0), x)["params"]
        params = jax.tree_util.tree_map(
            lambda v: v + jnp.asarray(0.3 * rng.normal(size=v.shape),
                                      jnp.float32), params)
        arrays[f"lib/{name}/x"] = np.asarray(x)
        for path, v in _flat(params).items():
            arrays[f"lib/{name}/params/{path}"] = v
        arrays[f"lib/{name}/out"] = np.asarray(mod.apply({"params": params},
                                                         x))
    for length, dim, zero_pad, scale in LIB_PE:
        arrays[f"lib/pe/{length}_{dim}_{int(zero_pad)}_{int(scale)}"] = \
            np.asarray(positional_encoding(length, dim, zero_pad, scale))
    return arrays


def make_fp16(ds) -> dict:
    return {**make_half(ds, "float16"), **make_library()}


def main(argv) -> None:
    os.chdir(ROOT)
    parts = argv or list(OUT)
    ds = ReviewDataset.load(HyperParams(**GEOM).data_dir())
    make = {"neighbors": make_neighbors, "hft": make_hft,
            "bf16": lambda d: make_half(d, "bfloat16"), "fp16": make_fp16}
    for part in parts:
        arrays = make[part](ds)
        np.savez_compressed(OUT[part], **arrays)
        print(f"wrote {OUT[part]} ({OUT[part].stat().st_size} bytes)",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
