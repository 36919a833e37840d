"""The entity doc cache of the port for NARRE, transnet and transnet++
against the JAX package's, on the synthetic corpus at a small geometry
(NARRE 4 reviews of 16 words; transnet input_length 64; latent 8), flax
init params bridged into the port:

- the per-review store (`_entity_rows_docs`) and `materialize_entity`
  (NARRE's review-row masks, transnet's per-example `this_doc` and
  span masks) bitwise equal to JAX's arrays;
- the row mask: a masked review row and its neighbor id do not reach
  NARRE's prediction;
- 4 entity-cached steps against `make_cached_train_step` (XLA branch),
  dropout 0: losses within 1e-5 relative, params within 5e-4 absolute
  (NARRE's attention output biases as in tests/test_torch_narre.py);
- entity `finalize` equal to the port's host finalize exactly and to
  JAX's `_finalize` within 1e-4 in MSE, MSE_right and MSE_transform,
  ranks equal;
- entity `predict` (val, test) and `Recommender(entity=True)` top-k
  equal to the host paths;
- the per-example doc cache (`cache_doc_embeds` alone) trains bit for
  bit as the uncached path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch.api import finalize
from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import ReviewDataset as PortDataset
from reviews4rec_torch.models import build_model as port_build
from reviews4rec_torch.serve import (FactorizedRecommender, Recommender,
                                     predict)
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
GEOM = dict(batch_size=16, input_length=64, latent_size=8,
            narre_num_reviews=4, narre_num_words=16)
ENTITY = dict(cache_doc_embeds=True, cache_entity=True)
CPU = torch.device("cpu")
MODELS = ["NARRE", "transnet", "transnet++"]
# NARRE's attention output biases: gradient 0 in exact arithmetic
SHIFT_FREE = ("att_user.fc1.bias", "att_item.fc1.bias")


@pytest.fixture(scope="module")
def port_dataset(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    dataset.save(str(d))
    return PortDataset.load(str(d))


def _pair(dataset, port_dataset, mt, tmp_path, **kw):
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


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("mt", MODELS)
def test_entity_store_equals_jax(mt, split, dataset, port_dataset):
    jh = dataset.apply_to(JaxHP(model_type=mt, **GEOM))
    ph = port_dataset.apply_to(PortHP(model_type=mt, **GEOM))
    if mt == "NARRE":
        args = (ph.narre_num_reviews, ph.narre_num_words, 10,
                ph.user_pad_id, ph.item_pad_id)
        for got, want in zip(port_dataset._entity_rows_docs(*args),
                             dataset._entity_rows_docs(*args)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    want = dataset.materialize_entity(jh, split)
    got = port_dataset.materialize_entity(ph, split)
    assert set(got) == set(want)
    assert ("user_skip" in got) == (split == "train")
    assert ("this_doc" in got) == mt.startswith("transnet")
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if split == "train" and mt == "NARRE":
        assert got["user_skip"].shape == (len(got["user"]),)
        assert (got["user_skip"] >= 0).any() and (got["user_skip"] < 0).any()


def test_narre_row_mask_blocks_the_masked_review(port_dataset):
    """With the row masks set, changing the masked review row's words
    and its neighbor id leaves every prediction as it was; without
    them, the same change moves them."""
    ph = port_dataset.apply_to(PortHP(model_type="NARRE", **GEOM))
    model = port_build(ph, port_dataset.word_vectors, device="cpu").eval()
    recs = port_dataset.materialize_entity(ph, "train")
    ud, it, wg, rv = port_dataset._entity_rows_docs(
        ph.narre_num_reviews, ph.narre_num_words, 10, ph.user_pad_id,
        ph.item_pad_id)
    sel = np.where((recs["user_skip"] >= 0) & (recs["item_skip"] >= 0))[0][:8]
    assert len(sel) == 8
    batch = {k: v[sel] for k, v in recs.items()}
    batch.update(user_doc=ud[batch["user"]], item_doc=it[batch["item"]],
                 users_who_gave=wg[batch["item"]],
                 items_reviewed=rv[batch["user"]])
    poisoned = {k: v.copy() for k, v in batch.items()}
    for j in range(8):
        a, b = batch["user_skip"][j], batch["item_skip"][j]
        poisoned["user_doc"][j, a] = 7
        poisoned["items_reviewed"][j, a] = 3
        poisoned["item_doc"][j, b] = 7
        poisoned["users_who_gave"][j, b] = 3

    def score(b, masked):
        b = {k: v for k, v in b.items()
             if masked or k not in ("user_skip", "item_skip")}
        with torch.no_grad():
            return model(to_device(b, CPU)).numpy()

    np.testing.assert_array_equal(score(batch, True), score(poisoned, True))
    assert not np.allclose(score(batch, False), score(poisoned, False),
                           atol=1e-6)


def _jax_entity_cache(dataset, jh):
    recs = dataset.materialize_entity(jh, "train")
    return jax_loop.EntityCache(
        example={k: jnp.asarray(v) for k, v in recs.items()},
        tables=jax_loop.build_entity_tables(jh, dataset))


@pytest.mark.parametrize("mt", MODELS)
def test_entity_steps_match_jax(mt, dataset, port_dataset, tmp_path):
    """4 steps of `make_cached_train_step` over JAX's entity cache
    against the port's `train_step` on `gather_cached_batch` over its
    own, dropout 0, the same row batches."""
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt, tmp_path,
                                   dropout=0.0, **ENTITY)
    init = params_from_flax(params)
    jcache = _jax_entity_cache(dataset, jh)
    pcache = loop.EntityCache(
        to_device(port_dataset.materialize_entity(ph, "train"), CPU),
        loop.build_entity_tables(ph, port_dataset, CPU))
    assert set(pcache.tables) == set(jcache.tables)
    for k, v in pcache.tables.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jcache.tables[k]))
    opt = jax_loop.make_optimizer(jh)
    state = jax_loop.TrainState(params, opt.init(params),
                                jnp.zeros((), jnp.int32))
    step = jax_loop.make_cached_train_step(make_apply_fn(jm), opt, mt)
    port_opt = loop.make_optimizer(ph, tm)
    tm.train()
    bs, steps = ph.batch_size, 4
    for s in range(steps):
        rows = np.arange(s * bs, (s + 1) * bs)
        state, m = step(state, jcache, jnp.asarray(rows, jnp.int32),
                        jnp.ones(bs, jnp.float32), jax.random.PRNGKey(0))
        loss, sq_sum, n = loop.train_step(
            tm, port_opt, loop.gather_cached_batch(
                pcache, torch.from_numpy(rows), torch.ones(bs)))
        np.testing.assert_allclose(loss.item(), float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(sq_sum.item(), float(m["sq_sum"]),
                                   rtol=1e-5)
        assert n.item() == float(m["n"])
    want = params_from_flax(state.params)
    got = tm.state_dict()
    assert set(got) == set(want)
    for k in want:
        if k in SHIFT_FREE:
            for side in (got[k], want[k]):
                assert (side - init[k]).abs().max().item() <= \
                    steps * ph.lr * 1.001, k
            continue
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=5e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("mt", MODELS)
def test_entity_finalize_equals_host_and_jax(mt, dataset, port_dataset,
                                             tmp_path):
    """For the same params, the entity finalize (test MSE through an
    entity example cache, id-only 1+5 and 1+12 grids) gives the port's
    host finalize's metrics and maps exactly, and JAX's entity
    `_finalize`'s within 1e-4 (MSE and transnet's MSE_right and
    MSE_transform) and equal ranks."""
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt, tmp_path,
                                   eval_num_negs=12)
    host, host_u, host_i = finalize(ph, tm, port_dataset, device=CPU)
    ent, ent_u, ent_i = finalize(ph.replace(**ENTITY), tm, port_dataset,
                                 device=CPU)
    assert ent == host
    assert ent_u == host_u and ent_i == host_i
    want, want_u, _ = _finalize(jh.replace(**ENTITY), jm, params, dataset,
                                True)
    assert set(ent) == set(want)
    assert ("MSE_right" in ent) == mt.startswith("transnet")
    for k in want:
        if k.startswith("MSE"):
            assert abs(ent[k] - want[k]) <= 1e-4 + 1e-9, k
        else:
            assert ent[k] == want[k], k
    assert set(ent_u) == set(want_u)


@pytest.mark.parametrize("mt", MODELS)
def test_entity_serving_equals_host(mt, dataset, port_dataset, tmp_path):
    """Entity `predict` (val, test) and `Recommender(entity=True)` give
    the host paths' outputs exactly."""
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


@pytest.mark.parametrize("mt", MODELS)
def test_entry_points_default_to_cuda_and_factorized_waits(mt,
                                                           port_dataset):
    """`build_model` runs on CUDA unless asked for the CPU, and the
    factorized index of these models equals the grid top-k."""
    hp = port_dataset.apply_to(PortHP(model_type=mt, **GEOM))
    if torch.cuda.is_available():
        assert next(port_build(hp, port_dataset.word_vectors)
                    .parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_build(hp, port_dataset.word_vectors)
    model = port_build(hp, port_dataset.word_vectors, device="cpu")
    users = np.array([1, 4, 17])
    fi, fs = FactorizedRecommender(hp, port_dataset, model=model,
                                   item_chunk=8, device=CPU).topk(users, k=5)
    gi, gs = Recommender(hp, port_dataset, model=model, item_chunk=16,
                         device=CPU).topk(users, k=5)
    np.testing.assert_allclose(fs, gs, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(fi, gi)


@pytest.mark.parametrize("mt", MODELS)
def test_doc_cache_is_bitwise_the_uncached_path(mt, port_dataset, tmp_path):
    """The per-example doc cache: the same records, pre-embedded on the
    device (NARRE's [N, R, W] docs as [N, R, W, E]), train bit for bit
    as the uncached path (dropout 0.6, reshuffled, one epoch)."""
    hp = port_dataset.apply_to(PortHP(
        model_type=mt, epochs=1, shuffle_data_every_epoch=True,
        log_dir=str(tmp_path), **GEOM))

    def train(h):
        model = port_build(h, port_dataset.word_vectors, device="cpu")
        stats = {}
        loop.train_complete(h, model, port_dataset, stats=stats)
        return model.state_dict(), stats["epoch_val_mse"]

    plain, cached = train(hp), train(hp.replace(cache_doc_embeds=True))
    assert set(plain[0]) == set(cached[0])
    for k in plain[0]:
        assert torch.equal(plain[0][k], cached[0][k]), k
    assert plain[1] == cached[1]
