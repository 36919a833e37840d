"""Write `entity_ref.npz`: the JAX package's first training steps for
deepconn and deepconn++ over the entity doc cache, at full width on the
committed e2e corpus, so that the port's entity trainer can be held
against JAX on a machine that has no JAX (`chip_smoke.py`).

The cache is `train.loop.build_entity_cache` over
`materialize_entity(hp, "train")` (ids, ratings and the (start, len)
leakage spans) and the canonical per-entity docs of `_entity_spans(1000)`,
embedded in f32. Both models start from the init params stored in
`e2e_ref.npz` and take `STEPS` Adam steps of
`train.loop.make_cached_train_step` at dropout 0 on the first `STEPS`
row batches (batch 256, no shuffle). The TextCNN runs the XLA branch
(use_pallas=False), f32. Stored under `<model>/...`:

- `loss`: the loss of each step;
- `grad1/<path>`: the gradient of step 1, every param but
  `word_vectors`;
- `params/<path>`: the params after the last step, every param but
  `word_vectors`.

It runs on the CPU in about 25 s:

    python tests/torch_fixtures/make_entity_ref.py
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

from reviews4rec_tpu.config import HyperParams  # noqa: E402
from reviews4rec_tpu.data.corpus import ReviewDataset  # noqa: E402
from reviews4rec_tpu.models import build_model  # noqa: E402
from reviews4rec_tpu.train.evaluate import make_apply_fn  # noqa: E402
from reviews4rec_tpu.train.loop import (TrainState, _batch_loss,  # noqa: E402
                                        build_entity_cache,
                                        gather_cached_batch,
                                        make_cached_train_step,
                                        make_optimizer)

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from make_e2e_ref import MODELS, _flat  # noqa: E402
from make_train_ref import _init_params  # noqa: E402

STEPS = 8
GEOM = dict(dataset="e2e", latent_size=10, batch_size=256, input_length=1000,
            dropout=0.0, seed=0, cache_doc_embeds=True, cache_entity=True)
OUT = HERE / "entity_ref.npz"


def main() -> None:
    os.chdir(ROOT)
    t0 = time.time()
    ds = ReviewDataset.load(HyperParams(**GEOM).data_dir())
    ref = dict(np.load(HERE / "e2e_ref.npz"))
    arrays = {"geometry": np.asarray(json.dumps(dict(GEOM, steps=STEPS)))}
    hp0 = ds.apply_to(HyperParams(model_type=MODELS[0], **GEOM))
    recs = ds.materialize_entity(hp0, "train")
    (udocs, _), (idocs, _) = ds._entity_spans(hp0.input_length)
    cache = build_entity_cache(recs, {"user_doc": udocs, "item_doc": idocs},
                               ds.word_vectors, jnp.float32,
                               keys=("user_doc", "item_doc"))
    bs = hp0.batch_size
    rows = [jnp.arange(s * bs, (s + 1) * bs, dtype=jnp.int32)
            for s in range(STEPS)]
    weight = jnp.ones(bs, jnp.float32)
    rng = jax.random.PRNGKey(0)
    for mt in MODELS:
        hp = ds.apply_to(HyperParams(model_type=mt, **GEOM))
        model = build_model(hp, ds.word_vectors)
        apply_fn = make_apply_fn(model)
        params = _init_params(ref, mt, ds.word_vectors)

        batch0 = gather_cached_batch(cache, rows[0], weight)
        grad1 = jax.grad(lambda p: _batch_loss(
            apply_fn(p, batch0, True, rng), batch0, mt)[0])(params)
        for path, v in _flat(grad1).items():
            arrays[f"{mt}/grad1/{path}"] = v

        opt = make_optimizer(hp)
        state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
        step = make_cached_train_step(apply_fn, opt, mt)
        losses = []
        for r in rows:
            state, m = step(state, cache, r, weight, rng)
            losses.append(float(m["loss"]))
        arrays[f"{mt}/loss"] = np.asarray(losses, np.float32)
        for path, v in _flat(state.params).items():
            arrays[f"{mt}/params/{path}"] = v
        print(mt, "losses", losses, flush=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes) in "
          f"{time.time() - t0:.0f} s")


if __name__ == "__main__":
    main()
