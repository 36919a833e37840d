"""Write `e2e_init.npz`: the initial params of the JAX trainer's own
`--e2e-full` runs of deepconn and deepconn++, so that the port can train
from JAX's starting point on a machine that has no JAX
(`chip_smoke.py --e2e-full --seeds N`).

The params are built as `reviews4rec_tpu.train.loop.train_complete`
builds them when it is given none: `model.init` keyed by
`fold_in(PRNGKey(hp.seed), 0)` on the first batch of the shuffled entity
train Batcher, its docs taken from the canonical per-entity store. The
flags are the reference's (`examples/e2e_realistic.py`: batch 256,
eval_num_negs 99, 60 epochs, early stop 5, use_pallas, scan_steps 10,
the entity cache) with seed 0, on the committed
`data/e2e/5_core/corpus.npz`. Stored under `<model>/params/<path>`,
every param but `word_vectors` (the corpus holds the table), f32.

It runs on the CPU in about a minute:

    python tests/torch_fixtures/make_e2e_init.py
"""

from __future__ import annotations

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

from reviews4rec_tpu.config import HyperParams  # noqa: E402
from reviews4rec_tpu.data.batcher import Batcher  # noqa: E402
from reviews4rec_tpu.data.corpus import ReviewDataset  # noqa: E402
from reviews4rec_tpu.models import build_model  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from make_e2e_ref import MODELS, _flat  # noqa: E402

# the reference's flags for both heads (chip_smoke.py `e2e_full`)
FLAGS = dict(dataset="e2e", batch_size=256, eval_num_negs=99, epochs=60,
             early_stop=5, use_pallas=True, scan_steps=10,
             cache_doc_embeds=True, cache_entity=True, seed=0)
OUT = HERE / "e2e_init.npz"


def init_params(ds: ReviewDataset, mt: str) -> dict:
    """The flattened initial params of `train_complete(hp, model, ds)`
    for `mt` under `FLAGS` (`reviews4rec_tpu/train/loop.py`, the
    `params is None` branch of the entity cache)."""
    hp = ds.apply_to(HyperParams(model_type=mt, **FLAGS))
    model = build_model(hp, ds.word_vectors)
    train_b = Batcher(ds.materialize_entity(hp, "train"), hp.batch_size,
                      shuffle=hp.shuffle_data_every_epoch, seed=hp.seed)
    sample = next(iter(train_b))
    (udocs, _), (idocs, _) = ds._entity_spans(hp.input_length)
    sample = dict(sample, user_doc=udocs[sample["user"]],
                  item_doc=idocs[sample["item"]])
    init_rng = jax.random.fold_in(jax.random.PRNGKey(hp.seed), 0)
    params = model.init({"params": init_rng, "dropout": init_rng},
                        jax.tree_util.tree_map(jnp.asarray, sample),
                        train=False)["params"]
    return _flat(params)


def main() -> None:
    os.chdir(ROOT)
    ds = ReviewDataset.load(HyperParams(**FLAGS).data_dir())
    arrays = {}
    for mt in MODELS:
        for path, v in init_params(ds, mt).items():
            arrays[f"{mt}/params/{path}"] = v
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
