"""The entity doc cache of the port (`hp.cache_doc_embeds` +
`hp.cache_entity`) and its per-example doc cache, against the JAX
package's, on the synthetic corpus at a small geometry (input_length 64,
batch 32, latent 8), flax init params bridged into the port:

- the entity store (`_entity_spans`, `materialize_entity`) equal to
  JAX's arrays;
- entity-cached steps against `make_cached_train_step`, with and
  without `pallas_fuse_rows` (the row-gathered op), and `train_complete`
  against JAX's (val MSE per epoch within 1e-4);
- the mask semantics: an entity step equals the plain step on the same
  docs with the span masked;
- the per-example doc cache bitwise the uncached path, for every
  `cache_sides`; `fuse_rows` bitwise the gathered path; resume bitwise;
- entity `finalize`, `predict` and `Recommender(entity=True)` equal to
  the host paths and to JAX's `_finalize`.

Tolerances as in tests/test_torch_train.py: losses 1e-5 relative,
params 5e-4 absolute after 6 Adam steps (Adam amplifies f32 rounding of
gradients that nearly cancel the weight decay), val MSE 1e-4 (the
banner rounds to 4 decimals). The port's own variants are bitwise equal.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch.api import finalize
from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import ReviewDataset as PortDataset
from reviews4rec_torch.models import build_model as port_build
from reviews4rec_torch.serve import Recommender, predict
from reviews4rec_torch.train import loop
from reviews4rec_torch.utils.device import to_device
from reviews4rec_torch.weights import load_flax_params, params_from_flax
from reviews4rec_tpu.api import _finalize
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data.batcher import Batcher
from reviews4rec_tpu.models import build_model as jax_build
from reviews4rec_tpu.train import loop as jax_loop
from reviews4rec_tpu.train.evaluate import make_apply_fn

torch.backends.cuda.matmul.allow_tf32 = False
# small shapes: one torch thread, so the test workers running beside
# this one (JAX meshes on virtual CPU devices) keep their cores
torch.set_num_threads(1)
GEOM = dict(batch_size=32, input_length=64, latent_size=8)
ENTITY = dict(cache_doc_embeds=True, cache_entity=True)
CPU = torch.device("cpu")
HEADS = ["deepconn", "deepconn++"]
DOCS = ("user_doc", "item_doc")


@pytest.fixture(scope="module")
def port_dataset(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    dataset.save(str(d))
    return PortDataset.load(str(d))


def _pair(dataset, port_dataset, mt, tmp_path, **kw):
    """(JAX hp, port hp, flax model, flax init params, port model with
    those params), logs and checkpoints under tmp_path."""
    geom = dict(GEOM, log_dir=str(tmp_path / "logs"),
                model_dir=str(tmp_path / "models"), **kw)
    jh = dataset.apply_to(JaxHP(model_type=mt, **geom))
    ph = port_dataset.apply_to(PortHP(model_type=mt, **geom))
    jm = jax_build(jh, dataset.word_vectors)
    sample = next(iter(Batcher(dataset.materialize(jh, "train"), 4)))
    params = jm.init({"params": jax.random.PRNGKey(3),
                      "dropout": jax.random.PRNGKey(4)},
                     jax.tree_util.tree_map(jnp.asarray, sample),
                     train=False)["params"]
    tm = port_build(ph, port_dataset.word_vectors, device="cpu")
    load_flax_params(tm, params)
    return jh, ph, jm, params, tm


def _val_mse(log_file):
    text = open(log_file).read()
    return {int(e): float(m) for e, m in re.findall(
        r"end of epoch (\d+) \|[^\n]*?\| MSE = ([-\d.e]+)", text)}


def _assert_equal_dicts(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _port_entity_cache(port_dataset, ph, fuse_rows):
    recs = port_dataset.materialize_entity(ph, "train")
    (ud, _), (it, _) = port_dataset._entity_spans(ph.input_length)
    return loop.build_entity_cache(recs, {"user_doc": ud, "item_doc": it},
                                   port_dataset.word_vectors, torch.float32,
                                   CPU, keys=DOCS, fuse_rows=fuse_rows)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_entity_store_equals_jax(split, dataset, port_dataset):
    jh = dataset.apply_to(JaxHP(model_type="deepconn", **GEOM))
    ph = port_dataset.apply_to(PortHP(model_type="deepconn", **GEOM))
    want = dataset._entity_spans(jh.input_length)
    got = port_dataset._entity_spans(ph.input_length)
    for (gd, gs), (wd, ws) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gs, ws)
    want = dataset.materialize_entity(jh, split)
    got = port_dataset.materialize_entity(ph, split)
    assert set(got) == set(want)
    assert ("user_skip" in got) == (split == "train")
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("fuse_rows", [False, True], ids=["take", "rows"])
@pytest.mark.parametrize("mt", HEADS)
def test_entity_steps_match_jax(mt, fuse_rows, dataset, port_dataset,
                                tmp_path):
    """6 steps of `make_cached_train_step` (XLA branch) over JAX's entity
    cache against the port's `train_step` on `gather_cached_batch` over
    its own, dropout 0, the same row batches."""
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt, tmp_path,
                                   dropout=0.0, pallas_fuse_rows=fuse_rows,
                                   **ENTITY)
    recs = dataset.materialize_entity(jh, "train")
    (ud, _), (it, _) = dataset._entity_spans(jh.input_length)
    jcache = jax_loop.build_entity_cache(
        recs, {"user_doc": ud, "item_doc": it}, dataset.word_vectors,
        jnp.float32, keys=DOCS)
    pcache = _port_entity_cache(port_dataset, ph, fuse_rows)
    assert ("user_doc__table" in pcache.tables) == fuse_rows
    opt = jax_loop.make_optimizer(jh)
    state = jax_loop.TrainState(params, opt.init(params),
                                jnp.zeros((), jnp.int32))
    step = jax_loop.make_cached_train_step(make_apply_fn(jm), opt, mt)
    port_opt = loop.make_optimizer(ph, tm)
    tm.train()
    bs = ph.batch_size
    for s in range(6):
        rows = np.arange(s * bs, (s + 1) * bs)
        state, m = step(state, jcache, jnp.asarray(rows, jnp.int32),
                        jnp.ones(bs, jnp.float32), jax.random.PRNGKey(0))
        loss, sq_sum, n = loop.train_step(tm, port_opt, loop.gather_cached_batch(
            pcache, torch.from_numpy(rows), torch.ones(bs)))
        np.testing.assert_allclose(loss.item(), float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(sq_sum.item(), float(m["sq_sum"]),
                                   rtol=1e-5)
        assert n.item() == float(m["n"])
    want = params_from_flax(state.params)
    got = tm.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=5e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("fuse_rows", [False, True], ids=["take", "rows"])
def test_entity_step_is_the_step_on_masked_docs(fuse_rows, port_dataset):
    """One entity-cached step equals the plain `train_step` on the same
    canonical docs with the pair's own review masked: as int docs plus
    the skip spans, and as embedded docs with the spans zeroed (zeroing
    the ids would not do: word 0 has a real vector)."""
    ph = port_dataset.apply_to(PortHP(model_type="deepconn++", **GEOM,
                                      **ENTITY))
    recs = port_dataset.materialize_entity(ph, "train")
    (ud, _), (it, _) = port_dataset._entity_spans(ph.input_length)
    rows = np.arange(16)
    batch = {k: v[rows] for k, v in recs.items()}
    assert batch["user_skip"][:, 1].any() and batch["item_skip"][:, 1].any()
    ones = np.ones(16, np.float32)
    ids = dict(batch, user_doc=ud[batch["user"]], item_doc=it[batch["item"]],
               weight=ones)
    wv = port_dataset.word_vectors
    floats = dict(ids, weight=ones)
    for side in ("user", "item"):
        docs = wv[ids[f"{side}_doc"]].copy()
        for j, (st, ln) in enumerate(batch[f"{side}_skip"]):
            docs[j, st:st + ln] = 0.0
        floats[f"{side}_doc"] = docs
        del floats[f"{side}_skip"]

    def one_step(batch_fn):
        model = port_build(ph, wv, device="cpu")
        opt = loop.make_optimizer(ph, model)
        model.train()
        gen = loop.epoch_generator(0, 1, CPU)
        loss = loop.train_step(model, opt, batch_fn(), gen)[0]
        return loss, model.state_dict()

    cache = _port_entity_cache(port_dataset, ph, fuse_rows)
    cached = one_step(lambda: loop.gather_cached_batch(
        cache, torch.from_numpy(rows), torch.from_numpy(ones)))
    for plain in (ids, floats):
        loss, state = one_step(lambda: to_device(plain, CPU))
        assert torch.equal(loss, cached[0])
        _assert_equal_dicts(state, cached[1])


@pytest.mark.parametrize("mt", HEADS)
def test_entity_train_complete_matches_jax(mt, dataset, port_dataset,
                                           tmp_path):
    """3 epochs over the entity cache, reshuffled every epoch, dropout 0:
    val MSE per epoch within 1e-4 of JAX's, and the same best epoch."""
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt, tmp_path,
                                   dropout=0.0, epochs=3,
                                   shuffle_data_every_epoch=True, **ENTITY)
    _, jbest = jax_loop.train_complete(jh, jm, dataset, params=params)
    stats = {}
    _, pbest = loop.train_complete(ph, tm, port_dataset, stats=stats)
    jmse = _val_mse(jh.log_file())
    assert sorted(jmse) == [1, 2, 3]
    np.testing.assert_allclose(stats["epoch_val_mse"],
                               [jmse[e] for e in (1, 2, 3)], atol=1e-4)
    assert abs(pbest - jbest) <= 1e-4 + 1e-9
    assert int(np.argmin(stats["epoch_val_mse"])) == \
        min(jmse, key=lambda e: (jmse[e], e)) - 1


def _train(hp, port_dataset, path=None):
    model = port_build(hp, port_dataset.word_vectors, device="cpu")
    stats = {}
    best, _ = loop.train_complete(hp, model, port_dataset, stats=stats,
                                  checkpoint_path=path and str(path))
    return model.state_dict(), best, stats["epoch_val_mse"]


def test_fuse_rows_is_bitwise_the_gathered_path(port_dataset, tmp_path):
    """Dropout 0.6, reshuffled: training with the row-gathered op equals
    training on table[rows], bit for bit."""
    hp = port_dataset.apply_to(PortHP(
        model_type="deepconn++", epochs=2, shuffle_data_every_epoch=True,
        log_dir=str(tmp_path), **GEOM, **ENTITY))
    take = _train(hp, port_dataset)
    rows = _train(hp.replace(pallas_fuse_rows=True), port_dataset)
    _assert_equal_dicts(take[0], rows[0])
    _assert_equal_dicts(take[1], rows[1])
    assert take[2] == rows[2]


def test_entity_resume_is_bitwise_an_uninterrupted_run(port_dataset,
                                                       tmp_path):
    hp = port_dataset.apply_to(PortHP(
        model_type="deepconn", epochs=3, shuffle_data_every_epoch=True,
        pallas_fuse_rows=True, log_dir=str(tmp_path), **GEOM, **ENTITY))
    full = _train(hp, port_dataset, tmp_path / "a.pt")
    _train(hp.replace(epochs=1), port_dataset, tmp_path / "b.pt")
    resumed = _train(hp.replace(resume=True), port_dataset, tmp_path / "b.pt")
    _assert_equal_dicts(resumed[0], full[0])
    _assert_equal_dicts(resumed[1], full[1])


@pytest.mark.parametrize("sides", ["both", "item", "user", "ids"])
def test_doc_cache_is_bitwise_the_uncached_path(sides, port_dataset,
                                                tmp_path):
    """The per-example doc cache (no entity store): the same records,
    pre-embedded per `cache_sides` or kept as ids on the device, train
    bit for bit as the uncached path (dropout 0.6, reshuffled)."""
    hp = port_dataset.apply_to(PortHP(
        model_type="deepconn++", epochs=2, shuffle_data_every_epoch=True,
        log_dir=str(tmp_path), **GEOM))
    plain = _train(hp, port_dataset)
    cached = _train(hp.replace(cache_doc_embeds=True, cache_sides=sides),
                    port_dataset)
    _assert_equal_dicts(plain[0], cached[0])
    _assert_equal_dicts(plain[1], cached[1])
    assert plain[2] == cached[2]
    ck, idk = loop.doc_cache_keys(hp.model_type, sides)
    recs = loop._model_records(port_build(hp, port_dataset.word_vectors,
                                          device="cpu"),
                               port_dataset.materialize(hp, "val"))
    cache = loop.build_doc_cache(recs, port_dataset.word_vectors,
                                 torch.float32, CPU, keys=ck, id_keys=idk)
    for k in DOCS:
        assert cache[k].is_floating_point() == (k in ck)


@pytest.mark.parametrize("mt", HEADS)
def test_entity_finalize_equals_host_and_jax(mt, dataset, port_dataset,
                                             tmp_path):
    """For the same params, the entity finalize (test MSE through an
    entity example cache, id-only 1+5 and 1+12 grids) gives the port's
    host finalize's metrics and maps exactly, and JAX's `_finalize`'s
    within the serving tolerances."""
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt, tmp_path,
                                   eval_num_negs=12)
    host, host_u, host_i = finalize(ph, tm, port_dataset, device=CPU)
    ent, ent_u, ent_i = finalize(ph.replace(**ENTITY), tm, port_dataset,
                                 device=CPU)
    assert ent == host
    assert ent_u == host_u and ent_i == host_i
    want, want_u, _ = _finalize(jh.replace(**ENTITY), jm, params, dataset,
                                True)
    assert set(ent) == set(want) == {"MSE", "HR@1", "HR@10", "NDCG@10"}
    assert abs(ent["MSE"] - want["MSE"]) <= 1e-4 + 1e-9
    for k in ("HR@1", "HR@10", "NDCG@10"):
        assert ent[k] == want[k], k
    assert set(ent_u) == set(want_u)


@pytest.mark.parametrize("mt", HEADS)
def test_entity_serving_equals_host(mt, dataset, port_dataset, tmp_path):
    """Entity `predict` (val, test) and `Recommender(entity=True)` give
    the host paths' outputs exactly; train predictions differ only where
    the entity mode masks a review the host path removes."""
    _, ph, _, _, tm = _pair(dataset, port_dataset, mt, tmp_path)
    pe = ph.replace(**ENTITY)
    for split in ("val", "test"):
        np.testing.assert_array_equal(
            predict(pe, port_dataset, split, model=tm, device=CPU),
            predict(ph, port_dataset, split, model=tm, device=CPU))
    train = predict(pe, port_dataset, "train", model=tm, device=CPU)
    assert train.shape == (len(port_dataset.splits["train"]),)
    users = np.array([1, 4, 17])
    got = Recommender(ph, port_dataset, model=tm, item_chunk=16, device=CPU,
                      entity=True).topk(users, k=5)
    want = Recommender(ph, port_dataset, model=tm, item_chunk=16,
                       device=CPU).topk(users, k=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("option,match", [
    (dict(model_type="MF_dot"), "only applies to the review family"),
    (dict(model_type="MPCN"), "only the ids-only cache applies"),
])
def test_cache_refusals_are_jax_s(option, match, port_dataset, tmp_path):
    hp = port_dataset.apply_to(PortHP(model_type="deepconn",
                                      log_dir=str(tmp_path), **GEOM,
                                      **ENTITY))
    model = port_build(hp, port_dataset.word_vectors, device="cpu")
    with pytest.raises(ValueError, match=match):
        loop.train_complete(hp.replace(**option), model, port_dataset)
