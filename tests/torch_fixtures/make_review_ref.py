"""Write the JAX package's outputs for NARRE, transnet and transnet++ at
full width on the committed e2e corpus (E=64, F=100, W=3, latent 10;
NARRE 10 reviews of 100 words, transnet 1000 words), so that the port
can be held against JAX on a machine that has no JAX
(`chip_smoke.py`'s review phases). Three files:

- `review_ref.npz`, serving. Each model's flax init from a fixed seed
  (no training), under `<model>/...`: `params/<path>` (every param but
  `word_vectors`); `test_pred` (`serve.predict` on test); `metrics`
  (`api._finalize`'s, JSON) and the keys of its count-vs-MSE maps;
  `narrow_scores` / `wide_scores` (the 1+5 and 1+eval_num_negs grids
  `_finalize` ranks, by the source net for transnet); `topk_ids` /
  `topk_scores` (`serve.Recommender.topk` of `serve_users`, k=10).
- `review_train_ref.npz`: from those params, `STEPS` Adam steps of
  `train.loop.make_train_step` at dropout 0 on the first `STEPS`
  batches of the train split (batch 256, no shuffle): `<model>/loss`
  per step, `<model>/grad1/<path>` (step 1's gradient) and
  `<model>/params/<path>` after the last step.
- `review_entity_ref.npz`: the same over the entity doc cache
  (`train.loop.build_entity_tables` + `materialize_entity`, rows
  0..STEPS*256-1 in order) through `make_cached_train_step`.

The TextCNN runs the XLA branch (use_pallas=False), f32, on the CPU; the
script takes several minutes and a few GB of memory:

    python tests/torch_fixtures/make_review_ref.py
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

from reviews4rec_tpu import serve  # noqa: E402
from reviews4rec_tpu.api import _finalize  # noqa: E402
from reviews4rec_tpu.config import HyperParams  # noqa: E402
from reviews4rec_tpu.data.batcher import Batcher  # noqa: E402
from reviews4rec_tpu.data.corpus import ReviewDataset  # noqa: E402
from reviews4rec_tpu.models import build_model  # noqa: E402
from reviews4rec_tpu.train.evaluate import (make_apply_fn,  # noqa: E402
                                            ranks_to_metrics, split_eval_ks)
from reviews4rec_tpu.train.loop import (EntityCache, TrainState,  # noqa: E402
                                        _batch_loss, build_entity_tables,
                                        gather_cached_batch,
                                        make_cached_train_step,
                                        make_optimizer, make_train_step)

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from make_e2e_ref import _flat  # noqa: E402
from make_train_ref import _init_params  # noqa: E402

MODELS = ("NARRE", "transnet", "transnet++")
GEOM = dict(dataset="e2e", latent_size=10, batch_size=256, eval_num_negs=99,
            input_length=1000, seed=0)
INIT_SEED = {"NARRE": 21, "transnet": 22, "transnet++": 23}
NUM_USERS = 8
STEPS = 8
OUT = HERE / "review_ref.npz"
TRAIN_OUT = HERE / "review_train_ref.npz"
ENTITY_OUT = HERE / "review_entity_ref.npz"


def _sample(hp):
    """A two-example batch of zeros in `hp`'s record layout."""
    z = np.zeros(2, np.int32)
    s = {"user": z, "item": z}
    if hp.model_type == "NARRE":
        doc = np.zeros((2, hp.narre_num_reviews, hp.narre_num_words),
                       np.int32)
        s.update(users_who_gave=np.zeros((2, 10), np.int32),
                 items_reviewed=np.zeros((2, 10), np.int32))
    else:
        doc = np.zeros((2, hp.input_length), np.int32)
        s["this_doc"] = doc
    s.update(user_doc=doc, item_doc=doc)
    return s


def _source(preds):
    return preds[0] if isinstance(preds, tuple) else preds


def _grid_scores(model, params, recs, batch_size):
    apply = jax.jit(lambda p, b: _source(model.apply({"params": p}, b,
                                                     train=False)))
    scores, weights = [], []
    for batch in Batcher(recs, batch_size):
        weights.append(batch["weight"].astype(bool))
        scores.append(np.asarray(apply(
            params, jax.tree_util.tree_map(jnp.asarray, batch))))
    return np.concatenate([s[w] for s, w in zip(scores, weights)])


def serving(ds, mt, arrays):
    hp = ds.apply_to(HyperParams(model_type=mt, **GEOM))
    model = build_model(hp, ds.word_vectors)
    key = jax.random.PRNGKey(INIT_SEED[mt])
    params = model.init({"params": key, "dropout": key},
                        jax.tree_util.tree_map(jnp.asarray, _sample(hp)),
                        train=False)["params"]
    for path, v in _flat(params).items():
        arrays[f"{mt}/params/{path}"] = v
    arrays[f"{mt}/test_pred"] = np.asarray(
        serve.predict(hp, ds, "test", params=params, model=model),
        np.float32)
    metrics, ucm, icm = _finalize(hp, model, params, ds, True)
    arrays[f"{mt}/metrics"] = np.asarray(json.dumps(metrics))
    arrays[f"{mt}/user_count_keys"] = np.asarray(sorted(ucm), np.int64)
    arrays[f"{mt}/item_count_keys"] = np.asarray(sorted(icm), np.int64)

    narrow = _grid_scores(model, params, ds.materialize_negs(hp), 64)
    wide = _grid_scores(model, params, ds.materialize_wide_negs(
        hp, hp.eval_num_negs, seed=hp.seed), 4)
    narrow_ks, wide_ks = split_eval_ks(hp)
    check = {}
    for scores, ks in ((narrow, narrow_ks), (wide, wide_ks)):
        ranks = np.sum(scores[:, 1:] > scores[:, :1], axis=1)
        check.update(ranks_to_metrics(ranks, ks))
    assert all(check[k] == metrics[k] for k in check), (check, metrics)
    arrays[f"{mt}/narrow_scores"] = narrow.astype(np.float32)
    arrays[f"{mt}/wide_scores"] = wide.astype(np.float32)

    ids, scores = serve.Recommender(
        hp, ds, params=params, model=model, item_chunk=64).topk(
            arrays["serve_users"], k=10)
    arrays[f"{mt}/topk_ids"] = ids.astype(np.int32)
    arrays[f"{mt}/topk_scores"] = scores.astype(np.float32)
    print(mt, metrics, flush=True)


def _steps(model, hp, mt, params, batches, step_fn, arrays):
    """Step-1 gradient, per-step losses and final params of `STEPS`
    steps; `batches` are (jit step arguments, loss batch) pairs."""
    apply_fn = make_apply_fn(model)
    rng = jax.random.PRNGKey(0)
    b0 = batches[0][1]
    grad1 = jax.grad(lambda p: _batch_loss(
        apply_fn(p, b0, True, rng), b0, mt)[0])(params)
    for path, v in _flat(grad1).items():
        arrays[f"{mt}/grad1/{path}"] = v
    opt = make_optimizer(hp)
    state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    step = step_fn(apply_fn, opt, mt)
    losses = []
    for args, _ in batches:
        state, m = step(state, *args, rng)
        losses.append(float(m["loss"]))
    arrays[f"{mt}/loss"] = np.asarray(losses, np.float32)
    for path, v in _flat(state.params).items():
        arrays[f"{mt}/params/{path}"] = v
    print(mt, "losses", losses, flush=True)


def training(ds, mt, ref, arrays, entity_arrays):
    geom = dict(GEOM, dropout=0.0)
    hp = ds.apply_to(HyperParams(model_type=mt, **geom))
    model = build_model(hp, ds.word_vectors)
    params = _init_params(ref, mt, ds.word_vectors)
    recs = ds.materialize(hp, "train")
    batches = []
    for b, _ in zip(Batcher(recs, hp.batch_size), range(STEPS)):
        b = jax.tree_util.tree_map(jnp.asarray, b)
        batches.append(((b,), b))
    _steps(model, hp, mt, params, batches, make_train_step, arrays)

    ehp = ds.apply_to(HyperParams(model_type=mt, cache_doc_embeds=True,
                                  cache_entity=True, **geom))
    cache = EntityCache(
        example={k: jnp.asarray(v)
                 for k, v in ds.materialize_entity(ehp, "train").items()},
        tables=build_entity_tables(ehp, ds))
    bs = hp.batch_size
    weight = jnp.ones(bs, jnp.float32)
    batches = []
    for s in range(STEPS):
        rows = jnp.arange(s * bs, (s + 1) * bs, dtype=jnp.int32)
        batches.append(((cache, rows, weight),
                        gather_cached_batch(cache, rows, weight)))
    _steps(model, ehp, mt, params, batches, make_cached_train_step,
           entity_arrays)


def main() -> None:
    os.chdir(ROOT)
    t0 = time.time()
    ds = ReviewDataset.load(HyperParams(**GEOM).data_dir())
    arrays = {"serve_users": ds.neg_users[:NUM_USERS].astype(np.int32),
              "geometry": np.asarray(json.dumps(GEOM))}
    for mt in MODELS:
        serving(ds, mt, arrays)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)", flush=True)
    ref = dict(np.load(OUT))
    geom = json.dumps(dict(GEOM, dropout=0.0, steps=STEPS))
    train = {"geometry": np.asarray(geom)}
    entity = {"geometry": np.asarray(geom)}
    for mt in MODELS:
        training(ds, mt, ref, train, entity)
    for path, out in ((TRAIN_OUT, train), (ENTITY_OUT, entity)):
        np.savez_compressed(path, **out)
        print(f"wrote {path} ({path.stat().st_size} bytes)")
    print(f"done in {time.time() - t0:.0f} s")


if __name__ == "__main__":
    main()
