"""Deterministic synthetic corpus for tests and benchmarks.

The port's own copy of `reviews4rec_tpu/data/synthetic.py`: the same
seed gives the same corpus, array for array.

Generates a rating matrix with a planted structure every model family
can exploit (global mean + user/item biases + a rank-4 latent
interaction, quantized to 1..5 stars) and sentiment-correlated review
text (positive/negative word pools sampled by rating, plus per-item
topic words for the HFT/word2vec signal).

The split is 80/10/10 like the reference's, with two guarantees the
tests rely on:
- every user keeps at least two train interactions;
- a handful of users are made "ranking-eligible" by construction: six
  of their interactions are placed in the test split with one 5.0
  rating and five low ratings, so `build_negatives` always finds
  candidate sets (users without them are skipped).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .corpus import ReviewDataset, Split
from .preprocess import build_negatives


def make_synthetic(num_users: int = 40, num_items: int = 30,
                   vocab: int = 120,
                   interactions_per_user: Tuple[int, int] = (10, 20),
                   word_embed: int = 64, seed: int = 0) -> ReviewDataset:
    rng = np.random.default_rng(seed)
    U, I, V = num_users, num_items, vocab
    lo, hi = interactions_per_user

    # planted structure
    pu = rng.normal(0.0, 1.0, (U, 4))
    qi = rng.normal(0.0, 1.0, (I, 4))
    bu = rng.normal(0.0, 0.3, U)
    bi = rng.normal(0.0, 0.3, I)
    mu = 3.4

    inter: List[Tuple[int, int, float]] = []
    per_user: List[List[int]] = []
    for u in range(U):
        n = min(int(rng.integers(lo, hi + 1)), I)
        items = rng.choice(I, size=n, replace=False)
        start = len(inter)
        for i in items:
            raw = (mu + bu[u] + bi[int(i)]
                   + 0.45 * float(pu[u] @ qi[int(i)])
                   + rng.normal(0.0, 0.25))
            r = float(np.clip(np.rint(raw), 1.0, 5.0))
            inter.append((u, int(i), r))
        per_user.append(list(range(start, len(inter))))

    n = len(inter)
    n_train = int(0.8 * n)
    n_test = (n - n_train + 1) // 2

    # ranking-eligible users: route 6 interactions whose PLANTED ratings
    # already qualify (one 5.0, five <= 3.0) into the test split — the
    # ratings themselves are untouched, so the test split keeps the same
    # latent structure as train/val.
    forced_test: List[int] = []
    eligible = 0
    want = max(2, min(8, U // 5))
    for u in range(U):
        if eligible >= want or len(per_user[u]) < 8:
            continue
        fives = [j for j in per_user[u] if inter[j][2] >= 4.9]
        lows = [j for j in per_user[u] if inter[j][2] <= 3.0]
        if not fives or len(lows) < 5:
            continue
        picks = [int(rng.choice(fives))] + \
            [int(j) for j in rng.choice(lows, size=5, replace=False)]
        forced_test.extend(picks)
        eligible += 1

    # every user keeps >= 2 train interactions
    forced_set = set(forced_test)
    forced_train: List[int] = []
    for u in range(U):
        free = [j for j in per_user[u] if j not in forced_set]
        keep = rng.choice(free, size=min(2, len(free)), replace=False)
        forced_train.extend(int(j) for j in keep)

    pool = np.asarray([j for j in range(n)
                       if j not in forced_set
                       and j not in set(forced_train)])
    rng.shuffle(pool)
    pool = list(pool)

    train_idx = forced_train + pool[:n_train - len(forced_train)]
    pool = pool[n_train - len(forced_train):]
    test_idx = forced_test + pool[:n_test - len(forced_test)]
    val_idx = pool[n_test - len(forced_test):]

    def mk_split(ix):
        return Split(
            np.asarray([inter[j][0] for j in ix], np.int32),
            np.asarray([inter[j][1] for j in ix], np.int32),
            np.asarray([inter[j][2] for j in ix], np.float32))

    splits = {"train": mk_split(train_idx), "test": mk_split(test_idx),
              "val": mk_split(val_idx)}

    # ---- sentiment/topic-structured review text ----
    third = max(V // 3, 1)
    pos_words = np.arange(1, third + 1)
    neg_words = np.arange(third + 1, 2 * third + 1)
    neutral = np.arange(2 * third + 1, V + 1)
    if len(neutral) == 0:
        neutral = pos_words
    item_topics = rng.choice(neutral, size=(I, 3))  # per-item topic words

    def make_review(i: int, rating: float) -> np.ndarray:
        length = int(rng.integers(6, 15))
        if rating >= 4.0:
            pools, probs = (pos_words, neg_words, neutral), (.55, .1, .35)
        elif rating <= 2.0:
            pools, probs = (pos_words, neg_words, neutral), (.1, .55, .35)
        else:
            pools, probs = (pos_words, neg_words, neutral), (.25, .25, .5)
        which = rng.choice(3, size=length, p=probs)
        toks = np.asarray([int(rng.choice(pools[w])) for w in which],
                          np.int32)
        toks[:2] = item_topics[i, rng.choice(3, size=2)]
        return toks

    user_reviews: List[List[np.ndarray]] = [[] for _ in range(U)]
    item_reviews: List[List[np.ndarray]] = [[] for _ in range(I)]
    u_to_i: List[List[int]] = [[] for _ in range(U)]
    i_to_u: List[List[int]] = [[] for _ in range(I)]
    this_index = {}
    for j in train_idx:
        u, i, r = inter[j]
        toks = make_review(i, r)
        this_index[(u, i)] = (len(user_reviews[u]), len(item_reviews[i]))
        user_reviews[u].append(toks)
        item_reviews[i].append(toks)
        u_to_i[u].append(i)
        i_to_u[i].append(u)

    test_reviews = {}
    for j in list(test_idx) + list(val_idx):
        u, i, r = inter[j]
        test_reviews[(u, i)] = make_review(i, r)

    # word vectors: random base + a planted sentiment axis
    word_vectors = rng.normal(0.0, 0.1, (V + 1, word_embed)) \
        .astype(np.float32)
    word_vectors[pos_words, 0] += 0.5
    word_vectors[neg_words, 0] -= 0.5
    word_vectors[0] = 0.0

    neg_users, neg_cands = build_negatives(splits["test"], seed=seed)

    return ReviewDataset.build(
        num_users=U, num_items=I, num_words=V, splits=splits,
        user_reviews=user_reviews, item_reviews=item_reviews,
        u_to_i=u_to_i, i_to_u=i_to_u, this_index=this_index,
        test_reviews=test_reviews, neg_users=neg_users,
        neg_cands=neg_cands, word_vectors=word_vectors)
