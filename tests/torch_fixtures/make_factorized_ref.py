"""Write `factorized_ref.npz`: the JAX package's factorized top-k
(`serve.FactorizedRecommender.topk`, k=10, item_chunk 1024) of the users
in `serve_users` over the whole catalog of the committed e2e corpus, for
the seven models it factorizes, so that the port's index can be held
against JAX on a machine that has no JAX (`chip_smoke.py`'s `factorized`
phase). The params are the other fixtures': bias_only and MF_dot from
`mf_ref.npz`, deepconn and deepconn++ from `e2e_ref.npz`, NARRE,
transnet and transnet++ from `review_ref.npz`. Stored per model:
`<model>/topk_ids`, `<model>/topk_scores`.

The towers run the XLA TextCNN, f32, on the CPU; the script takes a few
minutes and a few GB of memory:

    python tests/torch_fixtures/make_factorized_ref.py
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

import numpy as np  # noqa: E402

from reviews4rec_tpu import serve  # noqa: E402
from reviews4rec_tpu.config import HyperParams  # noqa: E402
from reviews4rec_tpu.data.corpus import ReviewDataset  # noqa: E402
from reviews4rec_tpu.models import build_model  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from make_train_ref import _init_params  # noqa: E402

# the fixture each model's params come from
SOURCES = {"bias_only": "mf_ref.npz", "MF_dot": "mf_ref.npz",
           "deepconn": "e2e_ref.npz", "deepconn++": "e2e_ref.npz",
           "NARRE": "review_ref.npz", "transnet": "review_ref.npz",
           "transnet++": "review_ref.npz"}
GEOM = dict(dataset="e2e", latent_size=10, batch_size=256, eval_num_negs=99,
            input_length=1000, seed=0)
NUM_USERS = 8
ITEM_CHUNK = 1024
OUT = HERE / "factorized_ref.npz"


def main() -> None:
    os.chdir(ROOT)
    ds = ReviewDataset.load(HyperParams(**GEOM).data_dir())
    users = ds.neg_users[:NUM_USERS].astype(np.int32)
    arrays = {"serve_users": users,
              "geometry": np.asarray(json.dumps(dict(
                  GEOM, item_chunk=ITEM_CHUNK)))}
    for mt, src in SOURCES.items():
        ref = dict(np.load(HERE / src))
        assert np.array_equal(ref["serve_users"], users), src
        hp = ds.apply_to(HyperParams(model_type=mt, **GEOM))
        model = build_model(hp, ds.word_vectors)
        params = _init_params(ref, mt, ds.word_vectors)
        ids, scores = serve.FactorizedRecommender(
            hp, ds, params=params, model=model,
            item_chunk=ITEM_CHUNK).topk(users, k=10)
        arrays[f"{mt}/topk_ids"] = np.asarray(ids, np.int32)
        arrays[f"{mt}/topk_scores"] = np.asarray(scores, np.float32)
        print(mt, np.asarray(ids)[0].tolist(), flush=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
