"""Write `prep_ref.npz`: what the JAX package's preprocessing gives, for
`chip_smoke.py`'s `cli` phase, which runs where there is no JAX.

- `corpus_names`, `corpus_sha256`, `corpus_shapes`, `corpus_dtypes`:
  for each array of the `corpus.npz` that JAX's preprocessing CLI
  (`python -m reviews4rec_tpu.data.preprocess e2e20k <dump> --w2v-epochs
  3`) writes for `examples/e2e_realistic.generate_dump(<dump>, 20000,
  seed=0)`, the sha256 of its bytes (C order), its shape and its dtype.
  The port's corpus of the same dump must match every array but
  `word_vectors` bitwise (the SGNS backends draw other random streams);
  `word_vectors` only in shape and dtype.
- `sgns/*`: one small `_train_sgns_jax` case (`SGNS`: 2000 pairs over a
  zipfian vocabulary of 200, dim 64, 16 negatives, 2 epochs, lr 0.5):
  its inputs (`centers`, `contexts`, `probs`, `vec_in0`), the draws JAX
  made (`perm` [epochs, n_pad] of `permutation(pk, n_pad)` and
  `uniform` [epochs, batches, bs, negatives] of `uniform(fold_in(nk,
  i), ...)`, from `key, pk, nk = split(key, 3)` each epoch) and its
  output table `out`.

It runs on the CPU in about a minute:

    python tests/torch_fixtures/make_prep_ref.py
"""

from __future__ import annotations

import hashlib
import os
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from examples.e2e_realistic import generate_dump  # noqa: E402
from reviews4rec_tpu.data import preprocess as jpp  # noqa: E402

OUT = HERE / "prep_ref.npz"
DUMP = dict(target_interactions=20000, seed=0)
NAME = "e2e20k"
W2V_EPOCHS = 3
SGNS = dict(n=2000, vocab=200, dim=64, negatives=16, epochs=2, lr=0.5,
            seed=0)


def array_digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def corpus_digests(corpus: dict) -> dict:
    names = sorted(corpus)
    return {
        "corpus_names": np.asarray(names),
        "corpus_sha256": np.asarray([array_digest(corpus[k])
                                     for k in names]),
        "corpus_shapes": np.asarray([",".join(map(str, corpus[k].shape))
                                     for k in names]),
        "corpus_dtypes": np.asarray([corpus[k].dtype.str for k in names]),
    }


def sgns_case(n, vocab, dim, seed, **_):
    """Pairs over a zipfian vocabulary, the unigram^0.75 table and the
    init table, as `train_word2vec` makes them."""
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, vocab + 1)
    centers = 1 + rng.choice(vocab, size=n, p=zipf / zipf.sum())
    contexts = 1 + rng.choice(vocab, size=n, p=zipf / zipf.sum())
    freq = np.bincount(contexts, minlength=vocab + 1).astype(np.float64)
    probs = freq ** 0.75
    probs[0] = 0.0
    probs /= probs.sum()
    vec_in0 = (rng.random((vocab + 1, dim), np.float32) - 0.5) / dim
    return centers, contexts, probs, vec_in0


def jax_draws(seed, epochs, n, negatives):
    bs = int(np.clip(n // 64, 256, 4096))
    n_batches = -(-n // bs)
    key = jax.random.PRNGKey(seed)
    perms, unis = [], []
    for _ in range(epochs):
        key, pk, nk = jax.random.split(key, 3)
        perms.append(np.asarray(jax.random.permutation(pk, n_batches * bs)))
        unis.append(np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(nk, i), (bs, negatives)))
            for i in range(n_batches)]))
    return np.stack(perms).astype(np.int32), np.stack(unis)


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "dump.json")
        generate_dump(dump, DUMP["target_interactions"], seed=DUMP["seed"])
        jpp.main([NAME, dump, "--out", tmp, "--w2v-epochs", str(W2V_EPOCHS)])
        with np.load(os.path.join(tmp, NAME, "5_core", "corpus.npz")) as f:
            corpus = {k: f[k] for k in f.files}
    out = corpus_digests(corpus)
    centers, contexts, probs, vec_in0 = sgns_case(**SGNS)
    table = jpp._train_sgns_jax(centers, contexts, probs, vec_in0,
                                SGNS["dim"], SGNS["epochs"],
                                SGNS["negatives"], SGNS["lr"], SGNS["seed"])
    perm, uniform = jax_draws(SGNS["seed"], SGNS["epochs"], SGNS["n"],
                              SGNS["negatives"])
    out.update({
        "sgns/centers": centers.astype(np.int64),
        "sgns/contexts": contexts.astype(np.int64),
        "sgns/probs": probs, "sgns/vec_in0": vec_in0,
        "sgns/params": np.asarray([SGNS["dim"], SGNS["epochs"],
                                   SGNS["negatives"], SGNS["lr"],
                                   SGNS["seed"]], np.float64),
        "sgns/perm": perm, "sgns/uniform": uniform, "sgns/out": table})
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size / 1e6:.2f} MB): "
          f"{len(corpus)} corpus arrays, SGNS case of {SGNS['n']} pairs")


if __name__ == "__main__":
    main()
