"""The serving slice as a whole, both heads, flax params bridged into
the port: `predict` and `finalize` against the JAX package's
`serve.predict` and `api._finalize` (host branch), `Recommender.topk`
against JAX's, and the factorized index against the port's own grid
top-k, as the JAX tests hold them. Tolerances: predictions and scores
1e-4 absolute; MSE 1e-4 (both are rounded to 4 decimals); HR/NDCG and
top-k ids exactly equal."""

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
                                     predict, save_predictions)
from reviews4rec_torch.weights import load_flax_params
from reviews4rec_tpu import serve as jax_serve
from reviews4rec_tpu.api import _finalize
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data.batcher import Batcher
from reviews4rec_tpu.models import build_model as jax_build

torch.backends.cuda.matmul.allow_tf32 = False
# small shapes: one torch thread, so the test workers running beside
# this one (JAX meshes on virtual CPU devices) keep their cores
torch.set_num_threads(1)
GEOM = dict(batch_size=32, input_length=64, latent_size=8, eval_num_negs=12)
CPU = "cpu"


@pytest.fixture(scope="module")
def port_dataset(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    dataset.save(str(d))
    return PortDataset.load(str(d))


@pytest.fixture(scope="module", params=["deepconn", "deepconn++"])
def served(request, dataset, port_dataset):
    mt = request.param
    jh = dataset.apply_to(JaxHP(model_type=mt, **GEOM))
    ph = port_dataset.apply_to(PortHP(model_type=mt, **GEOM))
    jm = jax_build(jh, dataset.word_vectors)
    sample = next(iter(Batcher(dataset.materialize(jh, "test"), 4)))
    params = jm.init({"params": jax.random.PRNGKey(7),
                      "dropout": jax.random.PRNGKey(8)},
                     jax.tree_util.tree_map(jnp.asarray, sample),
                     train=False)["params"]
    tm = port_build(ph, port_dataset.word_vectors, device=CPU)
    load_flax_params(tm, params)
    return jh, ph, jm, params, tm


def test_predict_matches_jax(served, dataset, port_dataset):
    jh, ph, jm, params, tm = served
    want = jax_serve.predict(jh, dataset, "test", params=params, model=jm)
    got = predict(ph, port_dataset, "test", model=tm, device=CPU)
    assert got.shape == want.shape == (len(dataset.splits["test"]),)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_finalize_matches_jax(served, dataset, port_dataset):
    jh, ph, jm, params, tm = served
    want, want_u, want_i = _finalize(jh, jm, params, dataset, True)
    got, got_u, got_i = finalize(ph, tm, port_dataset, device=CPU)
    assert set(got) == set(want) == {"MSE", "HR@1", "HR@10", "NDCG@10"}
    assert abs(got["MSE"] - want["MSE"]) <= 1e-4 + 1e-9
    for k in ("HR@1", "HR@10", "NDCG@10"):
        assert got[k] == want[k], k
    assert set(got_u) == set(want_u) and set(got_i) == set(want_i)
    for c in want_u:
        np.testing.assert_allclose(got_u[c], want_u[c], atol=1e-3)


def test_recommender_topk_matches_jax(served, dataset, port_dataset):
    jh, ph, jm, params, tm = served
    users = np.array([1, 4, 17])
    want_i, want_s = jax_serve.Recommender(
        jh, dataset, params=params, model=jm, item_chunk=16).topk(users, k=5)
    got_i, got_s = Recommender(ph, port_dataset, model=tm, item_chunk=16,
                               device=CPU).topk(users, k=5)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, atol=1e-4, rtol=0)


def test_factorized_matches_grid(served, port_dataset):
    _, ph, _, _, tm = served
    users = np.array([0, 3, 9, 22])
    gi, gs = Recommender(ph, port_dataset, model=tm, item_chunk=7,
                         device=CPU).topk(users, k=6)
    fi, fs = FactorizedRecommender(ph, port_dataset, model=tm, item_chunk=8,
                                   device=CPU).topk(users, k=6)
    np.testing.assert_allclose(fs, gs, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(fi, gi)
    assert np.all(np.diff(gs, axis=1) <= 0)
    tr = port_dataset.splits["train"]
    for row, u in zip(gi, users):                 # exclude_seen
        assert not set(row) & set(tr.item[tr.user == u].tolist())


def test_save_predictions_files(served, port_dataset, tmp_path):
    _, ph, _, _, tm = served
    paths = save_predictions(ph, port_dataset, model=tm, splits=("test",),
                             out_dir=str(tmp_path), device=CPU)
    lines = open(paths["test"]).read().splitlines()
    assert len(lines) == len(port_dataset.splits["test"])
    assert paths["test"].endswith(f"{ph.run_tag()}_test_results")


def test_entry_points_need_a_model_and_default_to_cuda(served, port_dataset,
                                                      tmp_path):
    """Without `model=` an entry point restores the checkpoint `api.run`
    saved, and says so when there is none."""
    _, ph, _, _, tm = served
    untrained = ph.replace(model_dir=str(tmp_path))
    for call in (lambda: predict(untrained, port_dataset, "test", device=CPU),
                 lambda: save_predictions(untrained, port_dataset,
                                          out_dir=str(tmp_path), device=CPU),
                 lambda: Recommender(untrained, port_dataset, device=CPU),
                 lambda: FactorizedRecommender(untrained, port_dataset,
                                               device=CPU)):
        with pytest.raises(FileNotFoundError, match="train first"):
            call()
    with pytest.raises(ValueError):
        predict(ph.replace(model_type="HFT"), port_dataset, model=tm,
                device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            predict(ph, port_dataset, "test", model=tm)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            finalize(ph, tm, port_dataset)
