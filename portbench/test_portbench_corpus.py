"""The corpus generator: the same seed gives the same corpus, and the
generated counts are Amazon 2014 5-core Video Games'."""

import numpy as np
import torch

from portbench import corpus, run
from portbench.conftest import SEED, shrink

CPU = torch.device("cpu")


def _cfg(tiny=True):
    cfg = run.load_json(run.ROOT, "portbench", "configs",
                        "deepconn-videogames5.json")
    if tiny:
        shrink(cfg, {"entry": "train"})
    return cfg


def test_same_seed_same_corpus():
    a = corpus.generate(_cfg(), SEED, CPU)
    b = corpus.generate(_cfg(), SEED, CPU)
    for s in a.splits:
        for x, y in zip(a.splits[s], b.splits[s]):
            np.testing.assert_array_equal(x, y)
    for la, lb in zip(a.user_reviews + a.item_reviews,
                      b.user_reviews + b.item_reviews):
        assert len(la) == len(lb)
        assert all(np.array_equal(x, y) for x, y in zip(la, lb))
    assert a.this_index == b.this_index and a.u_to_i == b.u_to_i
    np.testing.assert_array_equal(a.word_vectors, b.word_vectors)
    c = corpus.generate(_cfg(), SEED + 1, CPU)
    assert not np.array_equal(a.splits["train"][0], c.splits["train"][0])


def test_video_games_5core_counts():
    cfg = _cfg(tiny=False)
    c = corpus.generate(cfg, SEED, CPU)
    users = np.concatenate([s[0] for s in c.splits.values()])
    items = np.concatenate([s[1] for s in c.splits.values()])
    assert (c.num_users, c.num_items, len(users)) == (24303, 10672, 231780)
    assert np.bincount(users, minlength=24303).min() >= 5
    assert np.bincount(items, minlength=10672).min() >= 5
    assert len(np.unique(users.astype(np.int64) * 10672 + items)) == 231780
    assert [len(c.splits[s][0]) for s in ("train", "val", "test")] == [
        185424, 23178, 23178]
    assert c.word_vectors.shape == (50001, 64)
    assert not c.word_vectors[0].any()
    # the train reviews, per user and per item, are the train split's
    tu, ti, _ = c.splits["train"]
    assert sum(map(len, c.user_reviews)) == len(tu)
    assert sum(map(len, c.item_reviews)) == len(ti)
    u, i = int(tu[0]), int(ti[0])
    a, b = c.this_index[(u, i)]
    assert c.user_reviews[u][a] is c.item_reviews[i][b]
    assert c.u_to_i[u][a] == i and c.i_to_u[i][b] == u


def test_every_seed_the_same_sizes():
    a = corpus.generate(_cfg(), SEED, CPU)
    b = corpus.generate(_cfg(), 7, CPU)
    assert {s: len(v[0]) for s, v in a.splits.items()} == {
        s: len(v[0]) for s, v in b.splits.items()}
