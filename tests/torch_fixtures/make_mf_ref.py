"""Write `mf_ref.npz`: the JAX package's outputs for the id models
(bias_only, MF_dot, MF, GMF, MLP, NeuMF) at full width on the committed
e2e corpus (latent 10, batch 256, eval_num_negs 99), so that the port
can be held against JAX on a machine that has no JAX (`chip_smoke.py`'s
`mf_serve` and `mf_train` phases).

Each model's params are its flax init from a fixed seed, with the user
and item bias tables moved off their constant 0.1 by a fixed normal draw
(sd 0.3): with every bias equal, bias_only would score every pair alike
and its rankings would be ties. Stored under `<model>/...`:

- `params/<path>`: those params;
- `test_pred`: `serve.predict` on the test split;
- `metrics`: `api._finalize`'s metrics as JSON, and the keys of its
  count-vs-MSE maps;
- `narrow_scores` / `wide_scores`: the 1+5 and 1+eval_num_negs grids
  `_finalize` ranks (positive first);
- `topk_ids` / `topk_scores`: `serve.Recommender.topk` of
  `serve_users`, k=10.

Under `steps/<model>/...`, from those params, `STEPS` Adam steps of
`train.loop.make_train_step` at dropout 0 on the first `STEPS` batches
of the train split (batch 256, no shuffle): `loss` per step,
`grad1/<path>` (step 1's gradient) and `params/<path>` after the last
step. Under `warm/params/<path>`: `models.mf.neumf_warm_start` of the
stored NeuMF, GMF and MLP params.

It runs on the CPU in about a minute:

    python tests/torch_fixtures/make_mf_ref.py
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
from reviews4rec_tpu.models.mf import neumf_warm_start  # noqa: E402
from reviews4rec_tpu.train.evaluate import (ranks_to_metrics,  # noqa: E402
                                            split_eval_ks)
from reviews4rec_tpu.train.loop import make_train_step  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from make_e2e_ref import _flat  # noqa: E402
from make_review_ref import _grid_scores, _steps  # noqa: E402

MODELS = ("bias_only", "MF_dot", "MF", "GMF", "MLP", "NeuMF")
GEOM = dict(dataset="e2e", latent_size=10, batch_size=256, eval_num_negs=99,
            seed=0)
INIT_SEED = {mt: 31 + j for j, mt in enumerate(MODELS)}
BIAS_SD = 0.3
NUM_USERS = 8
STEPS = 8
OUT = HERE / "mf_ref.npz"


def init_params(ds, mt):
    """`mt`'s flax init from INIT_SEED, its bias tables moved by a
    normal draw of sd BIAS_SD from the same seed."""
    hp = ds.apply_to(HyperParams(model_type=mt, **GEOM))
    model = build_model(hp)
    key = jax.random.PRNGKey(INIT_SEED[mt])
    z = jnp.zeros(2, jnp.int32)
    params = dict(model.init({"params": key, "dropout": key},
                             {"user": z, "item": z}, train=False)["params"])
    rng = np.random.default_rng(INIT_SEED[mt])
    for name in ("user_bias", "item_bias"):
        params[name] = params[name] + jnp.asarray(
            rng.normal(0.0, BIAS_SD, params[name].shape), jnp.float32)
    return hp, model, params


def serving(ds, mt, arrays):
    hp, model, params = init_params(ds, mt)
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
        hp, ds, params=params, model=model, item_chunk=512).topk(
            arrays["serve_users"], k=10)
    arrays[f"{mt}/topk_ids"] = ids.astype(np.int32)
    arrays[f"{mt}/topk_scores"] = scores.astype(np.float32)
    print(mt, metrics, flush=True)
    return params


def training(ds, mt, params, arrays):
    hp = ds.apply_to(HyperParams(model_type=mt, dropout=0.0, **GEOM))
    model = build_model(hp)
    batches = []
    for b, _ in zip(Batcher(ds.materialize(hp, "train"), hp.batch_size),
                    range(STEPS)):
        b = jax.tree_util.tree_map(jnp.asarray, b)
        batches.append(((b,), b))
    out = {}
    _steps(model, hp, mt, params, batches, make_train_step, out)
    arrays.update({f"steps/{k}": v for k, v in out.items()})


def main() -> None:
    os.chdir(ROOT)
    ds = ReviewDataset.load(HyperParams(**GEOM).data_dir())
    arrays = {"serve_users": ds.neg_users[:NUM_USERS].astype(np.int32),
              "geometry": np.asarray(json.dumps(dict(GEOM, steps=STEPS)))}
    params = {mt: serving(ds, mt, arrays) for mt in MODELS}
    for mt in MODELS:
        training(ds, mt, params[mt], arrays)
    warm = neumf_warm_start(params["NeuMF"], params["GMF"], params["MLP"])
    for path, v in _flat(warm).items():
        arrays[f"warm/params/{path}"] = v
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
