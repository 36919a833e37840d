"""Write `train_ref.npz`: the JAX package's first training steps for
deepconn and deepconn++ at full width on the committed e2e corpus, so
that the port's trainer can be held against JAX on a machine that has no
JAX (`chip_smoke.py`).

Both models start from the init params stored in `e2e_ref.npz` and take
`STEPS` Adam steps of `train.loop.make_train_step` at dropout 0 on the
first `STEPS` batches of the train split (the JAX `Batcher`, batch 256,
no shuffle). The TextCNN runs the XLA branch (use_pallas=False), f32.
Stored under `<model>/...`:

- `loss`: the loss of each step;
- `grad1/<path>`: the gradient of step 1, every param but
  `word_vectors`;
- `params/<path>`: the params after the last step, every param but
  `word_vectors`.

It runs on the CPU and takes a few minutes:

    python tests/torch_fixtures/make_train_ref.py
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

from reviews4rec_tpu.config import HyperParams  # noqa: E402
from reviews4rec_tpu.data.batcher import Batcher  # noqa: E402
from reviews4rec_tpu.data.corpus import ReviewDataset  # noqa: E402
from reviews4rec_tpu.models import build_model  # noqa: E402
from reviews4rec_tpu.train.evaluate import make_apply_fn  # noqa: E402
from reviews4rec_tpu.train.loop import (TrainState, _batch_loss,  # noqa: E402
                                        make_optimizer, make_train_step)

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from make_e2e_ref import MODELS, _flat  # noqa: E402

STEPS = 8
GEOM = dict(dataset="e2e", latent_size=10, batch_size=256, input_length=1000,
            dropout=0.0, seed=0)
OUT = HERE / "train_ref.npz"


def _init_params(ref, mt, word_vectors):
    prefix = f"{mt}/params/"
    tree = {"word_vectors": jnp.asarray(word_vectors)}
    for key, v in ref.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *parents, leaf = key[len(prefix):].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def main() -> None:
    os.chdir(ROOT)
    ds = ReviewDataset.load(HyperParams(**GEOM).data_dir())
    ref = dict(np.load(HERE / "e2e_ref.npz"))
    arrays = {"geometry": np.asarray(json.dumps(dict(GEOM, steps=STEPS)))}
    for mt in MODELS:
        hp = ds.apply_to(HyperParams(model_type=mt, **GEOM))
        model = build_model(hp, ds.word_vectors)
        apply_fn = make_apply_fn(model)
        params = _init_params(ref, mt, ds.word_vectors)
        batches = [jax.tree_util.tree_map(jnp.asarray, b) for b, _ in zip(
            Batcher(ds.materialize(hp, "train"), hp.batch_size), range(STEPS))]
        rng = jax.random.PRNGKey(0)

        grad1 = jax.grad(lambda p: _batch_loss(
            apply_fn(p, batches[0], True, rng), batches[0], mt)[0])(params)
        for path, v in _flat(grad1).items():
            arrays[f"{mt}/grad1/{path}"] = v

        opt = make_optimizer(hp)
        state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
        step = make_train_step(apply_fn, opt, mt)
        losses = []
        for batch in batches:
            state, m = step(state, batch, rng)
            losses.append(float(m["loss"]))
        arrays[f"{mt}/loss"] = np.asarray(losses, np.float32)
        for path, v in _flat(state.params).items():
            arrays[f"{mt}/params/{path}"] = v
        print(mt, "losses", losses, flush=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
