"""Write `e2e_ref.npz`: the JAX package's outputs for deepconn and
deepconn++ at full width on the committed e2e corpus, so that the port
can be held against JAX on a machine that has no JAX
(`chip_smoke.py`).

For each model the script initializes the flax model from a fixed seed
(no training), then stores, under `<model>/...`:

- `params/<path>`: every param as numpy, except `word_vectors` (the
  corpus holds the table);
- `test_pred`: `serve.predict` on the test split;
- `metrics`: `api._finalize`'s metrics as JSON, and the keys of its
  user/item count-vs-MSE maps;
- `narrow_scores` / `wide_scores`: the model's scores of the 1+5 and
  1+eval_num_negs ranking grids `_finalize` ranks (positive first);
- `topk_ids` / `topk_scores`: `serve.Recommender.topk` of the users in
  `serve_users`, k=10.

It runs on the CPU through the XLA path, f32, and takes a few minutes:

    python tests/torch_fixtures/make_e2e_ref.py
"""

from __future__ import annotations

import json
import os
import sys
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
from reviews4rec_tpu.train.evaluate import (ranks_to_metrics,  # noqa: E402
                                            split_eval_ks)

MODELS = ("deepconn", "deepconn++")
GEOM = dict(dataset="e2e", latent_size=10, batch_size=256, eval_num_negs=99,
            input_length=1000, seed=0)
INIT_SEED = {"deepconn": 11, "deepconn++": 12}
NUM_USERS = 8
OUT = Path(__file__).resolve().parent / "e2e_ref.npz"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif k != "word_vectors":
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _grid_scores(model, params, recs, batch_size):
    apply = jax.jit(lambda p, b: model.apply({"params": p}, b, train=False))
    scores, weights = [], []
    for batch in Batcher(recs, batch_size):
        weights.append(batch["weight"].astype(bool))
        scores.append(np.asarray(apply(
            params, jax.tree_util.tree_map(jnp.asarray, batch))))
    return np.concatenate([s[w] for s, w in zip(scores, weights)])


def main() -> None:
    os.chdir(ROOT)
    ds = ReviewDataset.load(HyperParams(**GEOM).data_dir())
    users = ds.neg_users[:NUM_USERS].astype(np.int32)
    arrays = {"serve_users": users,
              "geometry": np.asarray(json.dumps(GEOM))}
    for mt in MODELS:
        hp = ds.apply_to(HyperParams(model_type=mt, **GEOM))
        model = build_model(hp, ds.word_vectors)
        t = hp.input_length
        sample = {"user": np.zeros(2, np.int32), "item": np.zeros(2, np.int32),
                  "user_doc": np.zeros((2, t), np.int32),
                  "item_doc": np.zeros((2, t), np.int32)}
        key = jax.random.PRNGKey(INIT_SEED[mt])
        params = model.init({"params": key, "dropout": key},
                            jax.tree_util.tree_map(jnp.asarray, sample),
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
            hp, hp.eval_num_negs, seed=hp.seed), 16)
        narrow_ks, wide_ks = split_eval_ks(hp)
        check = {}
        for scores, ks in ((narrow, narrow_ks), (wide, wide_ks)):
            ranks = np.sum(scores[:, 1:] > scores[:, :1], axis=1)
            check.update(ranks_to_metrics(ranks, ks))
        assert all(check[k] == metrics[k] for k in check), (check, metrics)
        arrays[f"{mt}/narrow_scores"] = narrow.astype(np.float32)
        arrays[f"{mt}/wide_scores"] = wide.astype(np.float32)

        ids, scores = serve.Recommender(
            hp, ds, params=params, model=model, item_chunk=128).topk(
                users, k=10)
        arrays[f"{mt}/topk_ids"] = ids.astype(np.int32)
        arrays[f"{mt}/topk_scores"] = scores.astype(np.float32)
        print(mt, metrics, flush=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
