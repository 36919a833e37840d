"""Write `mpcn_ref.npz`: the JAX package's outputs for MPCN and for the
ranking losses at full width on the committed e2e corpus (latent 10,
batch 256, eval_num_negs 99; MPCN at dmax 20, smax 30 over the corpus's
8921 x 64 word table, NBOW / FM / FC, one head), so that the port can be
held against JAX on a machine that has no JAX (`chip_smoke.py`'s
`mpcn_serve`, `mpcn_train` and `rank_train` phases).

MPCN's params are its flax init from a fixed seed with `fm_lin`'s bias
set to FM_BIAS, so that its predictions spread over the rating scale
rather than sit at the clip. Stored under `MPCN/...`:

- `params/<path>`: those params;
- `test_pred`: `serve.predict` on the test split;
- `metrics`: `api._finalize`'s metrics as JSON, and the keys of its
  count-vs-MSE maps;
- `narrow_scores` / `wide_scores`: the 1+5 and 1+eval_num_negs grids
  `_finalize` ranks (positive first);
- `topk_ids` / `topk_scores`: `serve.Recommender.topk` of
  `serve_users`, k=10.

Under `steps/<case>/...`, from stored params, STEPS steps of
`train.loop.make_train_step` at dropout 0 on the first STEPS batches
(batch 256, no shuffle): `loss` per step, `grad1/<path>` (step 1's
gradient) and `params/<path>` after the last step. The cases:

- `MPCN`: RAW_MSE on the train split (mpcn_l2 1e-4, as the reference's
  e2e flags);
- `CE/deepconn++`, `BPR/MF_dot`, `HINGE/MPCN`: the ranking losses on the
  grids of `materialize_train_negs(hp, "val", seed=0)` (B x 6
  candidates), deepconn++ from `e2e_ref.npz`'s params and MF_dot from
  `mf_ref.npz`'s (stored again under `steps/<case>/init/`).

MPCN's Gumbel pointer draws fixed uniforms: JAX's `gumbel_softmax` is
replaced in this process by one that reads `steps/<case>/u0` and `u1`
([B or B*6, dmax], the two sides of the head) in call order. The word
table's step-1 gradient and final rows are stored for the rows
`table_rows` only (a fixed random 1024 of 8921), to keep the file small.

It runs on the CPU in a few minutes:

    python tests/torch_fixtures/make_mpcn_ref.py
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
from reviews4rec_tpu.models import att, build_model  # noqa: E402
from reviews4rec_tpu.train.evaluate import (make_apply_fn,  # noqa: E402
                                            ranks_to_metrics, split_eval_ks)
from reviews4rec_tpu.train.loop import (TrainState, _batch_loss,  # noqa: E402
                                        make_optimizer, make_train_step)

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from make_e2e_ref import _flat  # noqa: E402
from make_review_ref import _grid_scores  # noqa: E402

GEOM = dict(dataset="e2e", latent_size=10, batch_size=256, eval_num_negs=99,
            seed=0)
MPCN_L2 = 1e-4
INIT_SEED = 51
FM_BIAS = 2.5
NUM_USERS = 8
STEPS = 8
TABLE_ROWS = 1024
# (case, model, loss, split of the batches, the fixture of its params)
CASES = (("MPCN", "MPCN", "RAW_MSE", "train", None),
         ("CE/deepconn++", "deepconn++", "CE", "val", "e2e_ref.npz"),
         ("BPR/MF_dot", "MF_dot", "BPR", "val", "mf_ref.npz"),
         ("HINGE/MPCN", "MPCN", "HINGE", "val", None))
OUT = HERE / "mpcn_ref.npz"


def _hp(ds, mt, **kw):
    return ds.apply_to(HyperParams(model_type=mt, mpcn_l2=MPCN_L2,
                                   **dict(GEOM, **kw)))


def mpcn_params(ds):
    hp = _hp(ds, "MPCN")
    model = build_model(hp, ds.word_vectors)
    key = jax.random.PRNGKey(INIT_SEED)
    sample = next(iter(Batcher(ds.materialize(hp, "test"), 2)))
    params = dict(model.init({"params": key, "dropout": key},
                             jax.tree_util.tree_map(jnp.asarray, sample),
                             train=False)["params"])
    params["fm_lin"] = dict(params["fm_lin"],
                            bias=jnp.full((1,), FM_BIAS, jnp.float32))
    return hp, model, params


def serving(ds, arrays):
    hp, model, params = mpcn_params(ds)
    for path, v in _flat(params).items():
        arrays[f"MPCN/params/{path}"] = v
    arrays["MPCN/test_pred"] = np.asarray(
        serve.predict(hp, ds, "test", params=params, model=model),
        np.float32)
    metrics, ucm, icm = _finalize(hp, model, params, ds, True)
    arrays["MPCN/metrics"] = np.asarray(json.dumps(metrics))
    arrays["MPCN/user_count_keys"] = np.asarray(sorted(ucm), np.int64)
    arrays["MPCN/item_count_keys"] = np.asarray(sorted(icm), np.int64)
    narrow = _grid_scores(model, params, ds.materialize_negs(hp), 64)
    wide = _grid_scores(model, params, ds.materialize_wide_negs(
        hp, hp.eval_num_negs, seed=hp.seed), 16)
    narrow_ks, wide_ks = split_eval_ks(hp)
    check = {}
    for scores, ks in ((narrow, narrow_ks), (wide, wide_ks)):
        ranks = np.sum(scores[:, 1:] > scores[:, :1], axis=1)
        check.update(ranks_to_metrics(ranks, ks))
    assert all(check[k] == metrics[k] for k in check), (check, metrics)
    arrays["MPCN/narrow_scores"] = narrow.astype(np.float32)
    arrays["MPCN/wide_scores"] = wide.astype(np.float32)
    ids, scores = serve.Recommender(
        hp, ds, params=params, model=model, item_chunk=512).topk(
            arrays["serve_users"], k=10)
    arrays["MPCN/topk_ids"] = ids.astype(np.int32)
    arrays["MPCN/topk_scores"] = scores.astype(np.float32)
    print("MPCN", metrics, flush=True)
    return params


def _tree(arrays, prefix):
    tree = {}
    for k, v in arrays.items():
        if not k.startswith(prefix):
            continue
        node = tree
        *parents, leaf = k[len(prefix):].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _fixed_gumbel(us):
    """JAX's pointer at the fixed uniforms `us`, in call order."""
    calls = []

    def fixed(logits, _rng, temperature, hard=True):
        u = jnp.asarray(us[len(calls) % len(us)])
        calls.append(1)
        g = -jnp.log(-jnp.log(u))
        y = jax.nn.softmax((logits + g) / temperature, axis=-1)
        y_hard = (y == jnp.max(y, axis=-1, keepdims=True)).astype(y.dtype)
        return jax.lax.stop_gradient(y_hard - y) + y

    return fixed


def _store(arrays, prefix, tree, rows):
    for path, v in _flat(tree).items():
        arrays[f"{prefix}/{path}"] = (
            v[rows] if rows is not None and path == "word_embedding" else v)


def training(ds, case, mt, loss, split, source, mpcn, arrays):
    hp = _hp(ds, mt, dropout=0.0, mpcn_dropout_keep=1.0, loss=loss)
    model = build_model(hp, ds.word_vectors if mt != "MF_dot" else None)
    if source is None:
        params = mpcn
    else:
        ref = np.load(HERE / source)
        prefix = f"{mt}/params/" if mt != "MF_dot" else "MF_dot/params/"
        params = _tree(ref, prefix)
        if mt != "MF_dot":
            params["word_vectors"] = jnp.asarray(ds.word_vectors)
        _store(arrays, f"steps/{case}/init", params, None)
    recs = (ds.materialize(hp, split) if loss == "RAW_MSE"
            else ds.materialize_train_negs(hp, split, seed=hp.seed))
    batches = [jax.tree_util.tree_map(jnp.asarray, b) for b, _ in zip(
        Batcher(recs, hp.batch_size), range(STEPS))]
    rows = arrays["table_rows"]
    real = att.gumbel_softmax
    if mt == "MPCN":
        lead = int(np.prod(batches[0]["item"].shape))
        rng = np.random.default_rng([INIT_SEED, len(loss)])
        us = [rng.uniform(1e-6, 1.0, (lead, hp.mpcn_dmax)).astype(np.float32)
              for _ in range(2)]
        arrays[f"steps/{case}/u0"], arrays[f"steps/{case}/u1"] = us
        att.gumbel_softmax = _fixed_gumbel(us)
    try:
        apply_fn = make_apply_fn(model)
        rng = jax.random.PRNGKey(0)
        b0 = batches[0]
        grad1 = jax.grad(lambda p: _batch_loss(
            apply_fn(p, b0, True, rng), b0, mt, loss,
            hp.hinge_margin)[0])(params)
        _store(arrays, f"steps/{case}/grad1", grad1, rows)
        opt = make_optimizer(hp)
        state = TrainState(params, opt.init(params),
                           jnp.zeros((), jnp.int32))
        step = make_train_step(apply_fn, opt, mt, loss, hp.hinge_margin)
        losses = []
        for b in batches:
            state, m = step(state, b, rng)
            losses.append(float(m["loss"]))
    finally:
        att.gumbel_softmax = real
    arrays[f"steps/{case}/loss"] = np.asarray(losses, np.float32)
    _store(arrays, f"steps/{case}/params", state.params, rows)
    print(case, "losses", losses, flush=True)


def main() -> None:
    os.chdir(ROOT)
    ds = ReviewDataset.load(HyperParams(**GEOM).data_dir())
    rows = np.sort(np.random.default_rng(INIT_SEED).choice(
        ds.word_vectors.shape[0], TABLE_ROWS, replace=False))
    arrays = {"serve_users": ds.neg_users[:NUM_USERS].astype(np.int32),
              "table_rows": rows.astype(np.int64),
              "geometry": np.asarray(json.dumps(dict(
                  GEOM, steps=STEPS, mpcn_l2=MPCN_L2)))}
    mpcn = serving(ds, arrays)
    for case in CASES:
        training(ds, *case, mpcn, arrays)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
