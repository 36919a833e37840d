"""The benchmark's corpus: a 5-core review corpus at the scale a
configuration names, made from the seed. It imports nothing of the
program: the program gets it through `ReviewDataset.build`
(`portbench.drivers.to_dataset`) and the plain reference reads the same
lists (`portbench.reference`).

The pattern is `examples/e2e_realistic.py`'s (a planted rating
structure, heavy-tailed review lengths, Zipf item popularity and word
frequencies), rewritten to be vectorized at a real category's size:

- exactly `users` users, `items` items and `reviews` reviews, every user
  and every item with at least `k_core` of them (a 5-core). Degrees:
  users lognormal, items Zipf by a shuffled rank; the pairs come from a
  configuration model whose repeated (user, item) pairs are swapped
  apart, so the degrees are kept exactly;
- ratings: mean + user and item biases + a rank-4 interaction + noise,
  rounded to 1..5 stars;
- the reference's random 80/10/10 split; only train reviews enter the
  user and item documents, and only they are generated;
- review lengths lognormal (median `review_words_median`, sigma
  `review_words_sigma`, at most `review_words_max`); word ids 1..vocab-1
  with P(id) falling as 1/id (id = floor(vocab ** u)); 0 pads;
- the word table [vocab + 1, word_dim] normal(0, 0.1), row 0 zero, made
  on `device` from the seed (it is frozen, so its values do not move
  speed).

Every draw comes from `numpy.random.default_rng((seed, stream))`, so the
same seed gives the same corpus, and every seed the same sizes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch


def stream(seed: int, name: str) -> np.random.Generator:
    """A numpy generator for one named stream of a run's seed."""
    tag = int.from_bytes(name.encode()[:8].ljust(8, b"\0"), "little")
    return np.random.default_rng([int(seed), tag])


def torch_seed(seed: int, name: str) -> int:
    """A 63-bit seed for a `torch.Generator`, one per named stream."""
    return int(stream(seed, name).integers(0, 2 ** 63 - 1))


@dataclass
class Corpus:
    num_users: int
    num_items: int
    vocab: int
    splits: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]
    # train reviews: per user and per item, in list order
    user_reviews: List[List[np.ndarray]]
    item_reviews: List[List[np.ndarray]]
    u_to_i: List[List[int]]
    i_to_u: List[List[int]]
    # (user, item) -> (index in the user's list, index in the item's)
    this_index: Dict[Tuple[int, int], Tuple[int, int]]
    word_vectors: np.ndarray


def _degrees(rng, n: int, total: int, k: int, weights: np.ndarray
             ) -> np.ndarray:
    extra = rng.multinomial(total - k * n, weights / weights.sum())
    return (k + extra).astype(np.int64)


def _pairs(rng, du: np.ndarray, di: np.ndarray, num_items: int):
    """A bipartite multigraph of the two degree sequences with no
    repeated pair: stubs matched at random, repeats swapped away."""
    users = np.repeat(np.arange(len(du)), du)
    items = np.repeat(np.arange(len(di)), di)
    rng.shuffle(items)
    for _ in range(200):
        key = users * num_items + items
        order = np.argsort(key, kind="stable")
        dup = order[1:][key[order][1:] == key[order][:-1]]
        if dup.size == 0:
            return users, items
        for a, b in zip(dup, rng.integers(0, len(items), dup.size)):
            items[a], items[b] = items[b], items[a]
    raise RuntimeError("could not separate repeated (user, item) pairs")


def generate(cfg: Dict, seed: int, device: torch.device) -> Corpus:
    """The corpus of configuration `cfg["corpus"]` for `seed`."""
    c = cfg["corpus"]
    U, I, N = c["users"], c["items"], c["reviews"]
    V, k = c["vocab"], c["k_core"]
    rng = stream(seed, "corpus")
    du = _degrees(rng, U, N, k, rng.lognormal(0.0, c["user_sigma"], U))
    rank = rng.permutation(I) + 1.0
    di = _degrees(rng, I, N, k, rank ** -c["item_zipf"])
    user, item = _pairs(rng, du, di, I)

    pu, qi = rng.normal(0, 1, (U, 4)), rng.normal(0, 1, (I, 4))
    bu, bi = rng.normal(0, 0.35, U), rng.normal(0, 0.35, I)
    raw = (c["rating_mean"] + bu[user] + bi[item]
           + 0.3 * np.einsum("nk,nk->n", pu[user], qi[item])
           + rng.normal(0, 0.5, N))
    rating = np.clip(np.rint(raw), 1, 5).astype(np.float32)

    perm = rng.permutation(N)
    n_train = int(c["split"][0] * N)
    n_val = (N - n_train) // 2
    parts = {"train": perm[:n_train], "val": perm[n_train:n_train + n_val],
             "test": perm[n_train + n_val:]}
    splits = {s: (user[ix].astype(np.int32), item[ix].astype(np.int32),
                  rating[ix]) for s, ix in parts.items()}

    tu, ti, _ = splits["train"]
    lens = np.minimum(np.rint(rng.lognormal(np.log(c["review_words_median"]),
                                            c["review_words_sigma"],
                                            n_train)),
                      c["review_words_max"]).astype(np.int64)
    lens = np.maximum(lens, 1)
    off = np.concatenate([[0], np.cumsum(lens)])
    words = np.floor(V ** rng.random(int(off[-1]))).astype(np.int32)
    words = np.clip(words, 1, V - 1)
    reviews = [words[off[j]:off[j + 1]] for j in range(n_train)]

    # each user's and each item's list order: random within the owner
    by_user = np.lexsort((rng.random(n_train), tu))
    by_item = np.lexsort((rng.random(n_train), ti))
    pos_u = np.empty(n_train, np.int64)
    pos_i = np.empty(n_train, np.int64)
    start_u = np.concatenate([[0], np.cumsum(np.bincount(tu, minlength=U))])
    start_i = np.concatenate([[0], np.cumsum(np.bincount(ti, minlength=I))])
    pos_u[by_user] = np.arange(n_train) - np.repeat(start_u[:-1],
                                                    np.diff(start_u))
    pos_i[by_item] = np.arange(n_train) - np.repeat(start_i[:-1],
                                                    np.diff(start_i))
    user_reviews = [[reviews[j] for j in by_user[start_u[u]:start_u[u + 1]]]
                    for u in range(U)]
    item_reviews = [[reviews[j] for j in by_item[start_i[i]:start_i[i + 1]]]
                    for i in range(I)]
    u_to_i = [ti[by_user[start_u[u]:start_u[u + 1]]].tolist()
              for u in range(U)]
    i_to_u = [tu[by_item[start_i[i]:start_i[i + 1]]].tolist()
              for i in range(I)]
    this_index = dict(zip(zip(tu.tolist(), ti.tolist()),
                          zip(pos_u.tolist(), pos_i.tolist())))

    gen = torch.Generator(device=device).manual_seed(
        torch_seed(seed, "words"))
    table = torch.randn((V + 1, c["word_dim"]), generator=gen,
                        device=device) * 0.1
    table[0] = 0.0
    return Corpus(U, I, V, splits, user_reviews, item_reviews, u_to_i,
                  i_to_u, this_index, table.cpu().numpy())
