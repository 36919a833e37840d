"""The port's neighborhood models (`reviews4rec_torch.models.neighbors`)
against the JAX package's on the synthetic corpus, both on the CPU in
float32.

- The SGD fits (baseline, SVD, SVD++, 20 epochs of per-example updates
  through the plain version of the SGD kernel) from JAX's init: final
  state within 1e-5 (f32 dot products summed in another order, 10,140
  updates).
- NMF from JAX's init (50 epochs): factors within 1e-4 relative.
- kNN, dense and chunked: predictions within 1e-5 (the similarities are
  sums of small integers, exact in f32; the estimates divide the same
  numbers).
- baseline and kNN draw nothing, so their `run_neighbor` metrics equal
  JAX's with no init handed over; SVD, SVD++ and NMF from JAX's init.
- A tie at the k-th neighbour goes to the lower user index, as
  `jax.lax.top_k` gives it.
"""

import jax
import numpy as np
import pytest
import torch

from reviews4rec_torch import api as port_api
from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import ReviewDataset as PortDataset
from reviews4rec_torch.data.corpus import Split as PortSplit
from reviews4rec_torch.models import neighbors as port_nb
from reviews4rec_torch.ops import neighbors as sgd_ops
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data.corpus import ReviewDataset as JaxDataset
from reviews4rec_tpu.data.corpus import Split as JaxSplit
from reviews4rec_tpu.models import neighbors as jax_nb

torch.set_num_threads(1)
CPU = "cpu"
K = 6


@pytest.fixture(scope="module")
def port_dataset(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    dataset.save(str(d))
    return PortDataset.load(str(d))


def jax_init(mt, seed, U, I, k=K):
    """The init JAX's `_sgd_fit` / `_nmf_fit` draw from `seed`."""
    rng = jax.random.PRNGKey(seed)
    if mt == "NMF":
        k1, k2 = jax.random.split(rng)
        return {"p": np.asarray(jax.random.uniform(k1, (U, k))),
                "q": np.asarray(jax.random.uniform(k2, (I, k)))}
    k1, k2, k3 = jax.random.split(rng, 3)
    return {"bu": np.zeros(U, np.float32), "bi": np.zeros(I, np.float32),
            "p": np.asarray(0.1 * jax.random.normal(k1, (U, k))),
            "q": np.asarray(0.1 * jax.random.normal(k2, (I, k))),
            "y": np.asarray(0.1 * jax.random.normal(k3, (I, k)))}


def _hps(dataset, port_dataset, mt, **kw):
    geom = dict(model_type=mt, latent_size=K, **kw)
    return (dataset.apply_to(JaxHP(**geom)),
            port_dataset.apply_to(PortHP(**geom)))


@pytest.mark.parametrize("variant", ["baseline", "SVD", "SVD++"])
def test_sgd_fit_matches_jax(dataset, port_dataset, variant):
    tr = dataset.splits["train"]
    U, I = dataset.num_users, dataset.num_items
    mu = float(tr.rating.mean())
    lr = 0.007 if variant == "SVD++" else 0.005
    kw, pkw = {}, {}
    if variant == "SVD++":
        pad, cnt = port_nb.rated_lists(port_dataset)
        kw = {"rated_pad": jax.numpy.asarray(pad),
              "rated_count": jax.numpy.asarray(cnt)}
        pkw = {"rated_pad": torch.from_numpy(pad),
               "rated_count": torch.from_numpy(cnt)}
    want = jax_nb._sgd_fit(*jax_nb._train_arrays(dataset), U, I, mu,
                           epochs=20, variant=variant, factors=K, lr=lr,
                           reg=0.02, seed=0, **kw)
    users, items, ratings = port_nb._train_arrays(port_dataset,
                                                  torch.device(CPU))
    got = port_nb._sgd_fit(users, items, ratings, U, I, mu, epochs=20,
                           variant=variant, factors=K, lr=lr, reg=0.02,
                           seed=0, init=jax_init(variant, 0, U, I), **pkw)
    assert sorted(got) == sorted(want) == sorted(sgd_ops.KEYS[variant])
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)


def test_svdpp_duplicate_items_add_twice():
    """`.at[items_u].add` over the padded list: an item listed twice gets
    both updates, each from the value before the example; the pad slots
    add nothing."""
    users = torch.tensor([0], dtype=torch.int32)
    items = torch.tensor([1], dtype=torch.int32)
    ratings = torch.tensor([4.0])
    y0 = torch.tensor([[0.5, -0.5], [0.1, 0.2], [0.3, 0.3]])
    state = {"bu": torch.zeros(1), "bi": torch.zeros(3),
             "p": torch.tensor([[0.2, 0.1]]), "q": y0 * 0.5, "y": y0.clone()}
    pad = torch.tensor([[2, 2, 0]], dtype=torch.int32)  # item 2 twice
    cnt = torch.tensor([2.0])
    out = sgd_ops.sgd_fit(users, items, ratings, state, "SVD++", 1, 3.0,
                          0.1, 0.02, pad, cnt)
    sq = 1 / np.sqrt(2.0)
    imp = 2 * y0[2] * sq
    est = 3.0 + torch.dot(state["q"][1], state["p"][0] + imp)
    upd = 0.1 * ((4.0 - est) * sq * state["q"][1] - 0.02 * y0[2])
    np.testing.assert_allclose(out["y"][2].numpy(), (y0[2] + 2 * upd).numpy(),
                               rtol=1e-6)
    np.testing.assert_array_equal(out["y"][0].numpy(), y0[0].numpy())
    np.testing.assert_array_equal(state["y"].numpy(), y0.numpy())


def test_slot_table_marks_first_slots_with_their_count():
    """(item, mult): an item's count among the user's first `cnt` slots at
    its first slot, 0 at its later slots and at the pad slots (also where
    a pad slot repeats a counted item)."""
    pad = torch.tensor([[2, 2, 0, 5, 2, 0], [1, 3, 4, 0, 0, 0],
                        [7, 7, 7, 7, 0, 0], [0, 0, 0, 0, 0, 0]],
                       dtype=torch.int32)
    cnt = torch.tensor([5.0, 3.0, 3.0, 0.0])
    got = sgd_ops.slot_table(pad, cnt)
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, 6, 2)
    np.testing.assert_array_equal(got[..., 0].numpy(), pad.numpy())
    np.testing.assert_array_equal(got[..., 1].numpy(), [
        [3, 0, 1, 1, 0, 0], [1, 1, 1, 0, 0, 0], [3, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0]])


@pytest.mark.parametrize("k,step", [(1, 512), (6, 64), (10, 32), (32, 16),
                                    (64, 8), (128, 4)])
def test_pack_slots_for_the_kernel(k, step):
    """The kernel's packed slots: item | mult << 24 in a table whose width
    is the longest list rounded up to `slot_step(K)` slots (4 warps of
    slot groups x the slots a lane skips together), and each example's
    list count with bit 30 set where the list repeats an item."""
    pad = torch.tensor([[2, 2, 0, 5, 2, 0], [1, 3, 4, 0, 0, 0],
                        [7, 9, 8, 7, 0, 0]], dtype=torch.int32)
    cnt = torch.tensor([5.0, 3.0, 3.0])
    users = torch.tensor([2, 0, 1, 1, 0], dtype=torch.int32)
    table = sgd_ops.slot_table(pad, cnt)
    slots, meta = sgd_ops.pack_slots(table, cnt, users, k)
    assert slots.dtype == meta.dtype == torch.int32
    assert sgd_ops.slot_step(k) == step
    assert slots.shape == (3, -(-6 // step) * step)
    np.testing.assert_array_equal((slots[:, :6] & 0xffffff).numpy(),
                                  pad.numpy())
    np.testing.assert_array_equal((slots[:, :6] >> 24).numpy(),
                                  table[..., 1].numpy())
    assert int(slots[:, 6:].abs().sum()) == 0
    # user 0 repeats item 2 among its first 5; user 2 repeats 7 only past
    # its count of 3
    np.testing.assert_array_equal(meta.numpy(), [3, 5 | 1 << 30, 3, 3,
                                                 5 | 1 << 30])


def _duplicate_lists(k, seed):
    """A small SGD problem whose users list items more than once: user 0
    lists item 3 twice, user 1 item 2 three times, user 4 one item five
    times; JAX's init for `k` factors and a stream of 60 examples."""
    rng = np.random.default_rng(seed)
    U, I = 6, 9
    lists = [[3, 5, 3], [2, 7, 2, 8, 2], [1], [0, 4, 6, 8, 1, 2],
             [5, 5, 5, 5, 5, 0], [8, 3]]
    width = max(len(x) for x in lists) + 2
    pad = np.zeros((U, width), np.int32)
    for u, x in enumerate(lists):
        pad[u, :len(x)] = x
    cnt = np.array([len(x) for x in lists], np.float32)
    users = rng.integers(0, U, 60).astype(np.int32)
    items = rng.integers(0, I, 60).astype(np.int32)
    ratings = rng.integers(1, 6, 60).astype(np.float32)
    return U, I, pad, cnt, users, items, ratings, jax_init("SVD++", seed, U,
                                                           I, k)


@pytest.mark.parametrize("k", [1, 4, 10])
def test_svdpp_duplicate_lists_match_jax(k):
    """The plain version, which applies the y updates through
    `slot_table` (each item once, at its first slot, mult times), against
    JAX's `_sgd_fit` over padded lists with repeated items: 4 epochs,
    state within 1e-5."""
    U, I, pad, cnt, users, items, ratings, init = _duplicate_lists(k, k)
    mu = float(ratings.mean())
    want = jax_nb._sgd_fit(jax.numpy.asarray(users), jax.numpy.asarray(items),
                           jax.numpy.asarray(ratings), U, I, mu, epochs=4,
                           variant="SVD++", factors=k, lr=0.007, reg=0.02,
                           seed=k, rated_pad=jax.numpy.asarray(pad),
                           rated_count=jax.numpy.asarray(cnt))
    state = {key: torch.from_numpy(np.array(init[key]))
             for key in sgd_ops.KEYS["SVD++"]}
    got = sgd_ops.sgd_fit(torch.from_numpy(users), torch.from_numpy(items),
                          torch.from_numpy(ratings), state, "SVD++", 4, mu,
                          0.007, 0.02, torch.from_numpy(pad),
                          torch.from_numpy(cnt))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("variant,users,items,k,budget,expect", [
    # the e2e corpus: SVD++'s whole state (237 KB) is over the H100's
    # 225 KB left for state, so p stays global; SVD's (177 KB) and
    # baseline's fit
    ("SVD++", 2500, 1515, 10, None, ("y", "q", "bi", "bu")),
    ("SVD", 2500, 1515, 10, None, ("q", "bi", "bu", "p")),
    ("baseline", 2500, 1515, 0, None, ("bi", "bu")),
    # 10^5 users: the user arrays stay global, the item arrays fit
    ("SVD++", 100000, 1515, 10, None, ("y", "q", "bi")),
    ("SVD", 100000, 1515, 10, None, ("q", "bi")),
    ("baseline", 100000, 1515, 0, None, ("bi",)),
    # and as many items: nothing fits, the kernel runs on global memory
    ("SVD++", 100000, 100000, 10, None, ()),
    # a smaller card: y alone, then q skipped but bi and bu taken
    ("SVD++", 2500, 1515, 10, 70000, ("y", "bi")),
])
def test_placement_in_shared_memory(variant, users, items, k, budget,
                                    expect):
    kw = {} if budget is None else {"budget": budget}
    got = sgd_ops.placement(variant, users, items, k, **kw)
    assert got == expect
    used = sum(sgd_ops.state_bytes(n, users, items, k) for n in got)
    assert used <= (budget or sgd_ops.H100_SMEM_BUDGET)


def test_nmf_matches_jax(dataset, port_dataset):
    U, I = dataset.num_users, dataset.num_items
    p, q = jax_nb._nmf_fit(*jax_nb._train_arrays(dataset), U, I, epochs=50,
                           factors=K, seed=0)
    got = port_nb._nmf_fit(*port_nb._train_arrays(port_dataset,
                                                  torch.device(CPU)),
                           U, I, epochs=50, factors=K, seed=0,
                           init=jax_init("NMF", 0, U, I))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(p), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(q), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("k", [5, 10])
def test_knn_dense_and_chunked_match_jax(dataset, port_dataset, k):
    jh, ph = _hps(dataset, port_dataset, "kNN", knn_k=k)
    te = dataset.splits["test"]
    want = jax_nb._knn_predict(dataset, jh, te.user, te.item)
    dense = port_nb._knn_predict(port_dataset, ph, te.user, te.item,
                                 device=CPU)
    chunked = port_nb._knn_predict_chunked(port_dataset, ph, te.user,
                                           te.item, block=7, device=CPU)
    np.testing.assert_allclose(dense, want, atol=1e-5)
    np.testing.assert_allclose(chunked, want, atol=1e-5)


def _tie_corpus(split, build):
    """User 0 rated items 0 and 1; users 1, 2 and 3 rated item 0 as user 0
    did (MSD similarity 1.0 each, a tie) and item 2 with 5, 1 and 3."""
    triples = [[0, 0, 4.0], [0, 1, 2.0], [1, 0, 4.0], [2, 0, 4.0],
               [3, 0, 4.0], [1, 2, 5.0], [2, 2, 1.0], [3, 2, 3.0]]
    splits = {"train": split(*(np.asarray(c, dt) for c, dt in zip(
                  zip(*triples), (np.int32, np.int32, np.float32)))),
              "test": split(np.array([0], np.int32), np.array([2], np.int32),
                            np.array([3.0], np.float32))}
    splits["val"] = splits["test"]
    return build(
        num_users=4, num_items=3, num_words=1, splits=splits,
        user_reviews=[[]] * 4, item_reviews=[[]] * 3, u_to_i=[[]] * 4,
        i_to_u=[[]] * 3, this_index={}, test_reviews={},
        neg_users=np.array([0], np.int32),
        neg_cands=np.array([[2, 0, 0, 0, 0, 0]], np.int32),
        word_vectors=np.zeros((2, 4), np.float32))


@pytest.mark.parametrize("k,expect", [(1, 5.0), (2, 3.0), (3, 3.0)])
def test_knn_tie_at_k_goes_to_lower_index(k, expect):
    jds = _tie_corpus(JaxSplit, JaxDataset.build)
    pds = _tie_corpus(PortSplit, PortDataset.build)
    want = jax_nb._knn_predict(jds, JaxHP(model_type="kNN", knn_k=k),
                               np.array([0]), np.array([2]))
    hp = PortHP(model_type="kNN", knn_k=k)
    got = port_nb._knn_predict(pds, hp, np.array([0]), np.array([2]),
                               device=CPU)
    chunked = port_nb._knn_predict_chunked(pds, hp, np.array([0]),
                                           np.array([2]), device=CPU)
    assert float(want[0]) == expect
    assert float(got[0]) == expect and float(chunked[0]) == expect


@pytest.mark.parametrize("mt", ["baseline", "SVD", "SVD++", "NMF", "kNN"])
def test_run_neighbor_matches_jax(dataset, port_dataset, mt):
    jh, ph = _hps(dataset, port_dataset, mt, eval_num_negs=20)
    want = jax_nb.run_neighbor(jh, dataset)
    init = (None if mt in ("baseline", "kNN")
            else jax_init(mt, jh.seed, dataset.num_users, dataset.num_items))
    got = port_nb.run_neighbor(ph, port_dataset, device=CPU, init=init)
    assert set(got[0]) == set(want[0])
    for key in want[0]:
        assert abs(got[0][key] - want[0][key]) <= 1e-4, key
    for gmap, wmap in zip(got[1:], want[1:]):
        assert list(gmap) == list(wmap)
        for c in wmap:
            np.testing.assert_allclose(gmap[c], wmap[c], atol=1e-4)


@pytest.mark.parametrize("mt", ["baseline", "SVD", "SVD++", "NMF"])
def test_unknown_entities_fall_back(dataset, port_dataset, mt):
    """A user or item with no train rating predicts from the partial or
    global terms, as JAX's: an unknown id appended to both corpora."""
    jh, ph = _hps(dataset, port_dataset, mt)
    init = (None if mt == "baseline"
            else jax_init(mt, jh.seed, dataset.num_users, dataset.num_items))
    want = jax_nb.fit(jh, dataset)
    got = port_nb.fit(ph, port_dataset, device=CPU, init=init)
    u = np.array([0, 1, 2], np.int64)
    i = np.array([0, 1, 2], np.int64)
    np.testing.assert_allclose(got(u, i), want(u, i), atol=1e-5)
    # an entity id whose train count is 0 on both sides
    unknown_u = np.where(port_dataset.user_count == 0)[0]
    unknown_i = np.where(port_dataset.item_count == 0)[0]
    if len(unknown_u) or len(unknown_i):
        uu = unknown_u[:1] if len(unknown_u) else u[:1]
        ii = unknown_i[:1] if len(unknown_i) else i[:1]
        np.testing.assert_allclose(got(uu, ii), want(uu, ii), atol=1e-5)


def test_unknown_entity_partial_means():
    """Hand-made: an item nobody rated in train predicts mu + b_u (SGD)
    or mu (NMF), clipped to the rating scale."""
    triples = [[0, 0, 5.0], [1, 0, 3.0], [1, 1, 4.0]]
    split = PortSplit(*(np.asarray(c, dt) for c, dt in zip(
        zip(*triples), (np.int32, np.int32, np.float32))))
    ds = PortDataset.build(
        num_users=2, num_items=3, num_words=1,
        splits={"train": split, "test": split, "val": split},
        user_reviews=[[]] * 2, item_reviews=[[]] * 3, u_to_i=[[]] * 2,
        i_to_u=[[]] * 3, this_index={}, test_reviews={},
        neg_users=np.array([0], np.int32),
        neg_cands=np.array([[0, 1, 2, 1, 2, 1]], np.int32),
        word_vectors=np.zeros((2, 4), np.float32))
    mu = 4.0
    base = port_nb.fit(PortHP(model_type="baseline"), ds, device=CPU)
    bu = float(base.state["bu"][0])
    assert float(base(np.array([0]), np.array([2]))[0]) == \
        pytest.approx(mu + bu, abs=1e-6)
    nmf = port_nb.fit(PortHP(model_type="NMF", latent_size=2), ds,
                      device=CPU)
    assert float(nmf(np.array([1]), np.array([2]))[0]) == mu


def test_api_run_dispatches_neighbors(port_dataset, tmp_path):
    hp = port_dataset.apply_to(PortHP(model_type="baseline",
                                      log_dir=str(tmp_path)))
    metrics, ucm, icm = port_api.run(hp, port_dataset, device=CPU)
    assert metrics["dataset"] == hp.dataset and "MSE" in metrics
    assert sum(len(v) for v in ucm.values()) == len(
        port_dataset.splits["test"])


def test_build_model_refuses_non_sgd_with_jax_words(dataset, port_dataset):
    from reviews4rec_torch.models import build_model as port_build
    from reviews4rec_tpu.models import build_model as jax_build
    for mt in ("SVD", "HFT"):
        with pytest.raises(ValueError) as je:
            jax_build(dataset.apply_to(JaxHP(model_type=mt)))
        with pytest.raises(ValueError) as pe:
            port_build(port_dataset.apply_to(PortHP(model_type=mt)),
                       device=CPU)
        assert str(pe.value) == str(je.value)


def test_neighbor_state_carries_jax_fits(dataset, port_dataset):
    """`weights.neighbor_state` of JAX's fitted SVD state predicts as JAX's
    own predict does."""
    from reviews4rec_torch.weights import neighbor_state
    U, I = dataset.num_users, dataset.num_items
    mu = float(dataset.splits["train"].rating.mean())
    state = jax_nb._sgd_fit(*jax_nb._train_arrays(dataset), U, I, mu,
                            epochs=2, variant="SVD", factors=K, lr=0.005,
                            reg=0.02, seed=0)
    got = neighbor_state(state, device=CPU)
    assert sorted(got) == ["bi", "bu", "p", "q"]
    te = dataset.splits["test"]
    u, i = te.user.astype(np.int64), te.item.astype(np.int64)
    est = (mu + got["bu"][u] + got["bi"][i]
           + (got["p"][u] * got["q"][i]).sum(-1)).numpy()
    want = (mu + np.asarray(state["bu"])[u] + np.asarray(state["bi"])[i]
            + (np.asarray(state["p"])[u] * np.asarray(state["q"])[i]).sum(-1))
    np.testing.assert_allclose(est, want, rtol=1e-6)
