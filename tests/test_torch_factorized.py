"""The factorized serving index (`serve.FactorizedRecommender`) of the
seven models whose score splits into per-user and per-item terms
(bias_only, MF_dot, deepconn, deepconn++, NARRE, transnet, transnet++),
on the synthetic corpus at a small geometry (latent 8; 64 words, NARRE 4
reviews of 16), flax params bridged into the port:

- against the port's own grid `Recommender` (the joint forward over
  [users, item chunk] grids): scores within 1e-4 (float reassociation),
  the same top-k ids, over several item chunks and score chunks;
- against the JAX package's `FactorizedRecommender` on the same params:
  scores within 1e-5, the same ids; NARRE and transnet also against
  JAX's grid top-k with the Pallas forward in interpret mode;
- every other gradient model raises JAX's `ValueError`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import ReviewDataset as PortDataset
from reviews4rec_torch.models import build_model as port_build
from reviews4rec_torch.serve import FactorizedRecommender, Recommender
from reviews4rec_torch.weights import load_flax_params
from reviews4rec_tpu import serve as jax_serve
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data.batcher import Batcher
from reviews4rec_tpu.models import build_model as jax_build

torch.backends.cuda.matmul.allow_tf32 = False
# small shapes: one torch thread, so the test workers running beside
# this one (JAX meshes on virtual CPU devices) keep their cores
torch.set_num_threads(1)
GEOM = dict(batch_size=16, input_length=64, latent_size=8,
            narre_num_reviews=4, narre_num_words=16)
CPU = "cpu"
SUPPORTED = ["bias_only", "MF_dot", "deepconn", "deepconn++", "NARRE",
             "transnet", "transnet++"]
USERS = np.array([0, 3, 9, 22, 31])


@pytest.fixture(scope="module")
def port_dataset(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    dataset.save(str(d))
    return PortDataset.load(str(d))


def _pair(dataset, port_dataset, mt, use_pallas=False):
    """(JAX hp, port hp, flax model, flax init params, port model with
    those params). The bias tables start at 0.1 everywhere, so they are
    moved off it: a top-k of ties would not tell two orders apart."""
    jh = dataset.apply_to(JaxHP(model_type=mt, use_pallas=use_pallas,
                                **GEOM))
    ph = port_dataset.apply_to(PortHP(model_type=mt, **GEOM))
    jm = jax_build(jh, dataset.word_vectors)
    sample = next(iter(Batcher(dataset.materialize(jh, "train"), 4)))
    params = jm.init({"params": jax.random.PRNGKey(11),
                      "dropout": jax.random.PRNGKey(12)},
                     jax.tree_util.tree_map(jnp.asarray, sample),
                     train=False)["params"]
    rng = np.random.default_rng(13)
    params = dict(params)
    for key in ("user_bias", "item_bias"):
        if key in params:
            params[key] = params[key] + jnp.asarray(rng.normal(
                0, 0.3, params[key].shape), jnp.float32)
    tm = port_build(ph, port_dataset.word_vectors, device=CPU)
    load_flax_params(tm, params)
    return jh, ph, jm, params, tm


@pytest.fixture(scope="module", params=SUPPORTED)
def served(request, dataset, port_dataset):
    return _pair(dataset, port_dataset, request.param)


def test_factorized_equals_grid(served, port_dataset):
    _, ph, _, _, tm = served
    for items in (None, np.arange(3, 27, dtype=np.int32)):
        gi, gs = Recommender(ph, port_dataset, model=tm, item_chunk=7,
                             device=CPU).topk(USERS, k=6, items=items)
        fac = FactorizedRecommender(ph, port_dataset, model=tm, item_chunk=8,
                                    items=items, device=CPU)
        fi, fs = fac.topk(USERS, k=6, score_items=5)
        np.testing.assert_allclose(fs, gs, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(fi, gi)
        assert np.isfinite(fs).all() and np.all(np.diff(fs, axis=1) <= 0)
    tr = port_dataset.splits["train"]
    for row, u in zip(fi, USERS):                 # exclude_seen
        assert not set(row) & set(tr.item[tr.user == u].tolist())
    # without exclusion a seen item may come back
    ai, as_ = fac.topk(USERS, k=6, exclude_seen=False)
    gi, gs = Recommender(ph, port_dataset, model=tm, device=CPU).topk(
        USERS, k=6, items=np.arange(3, 27, dtype=np.int32),
        exclude_seen=False)
    np.testing.assert_allclose(as_, gs, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(ai, gi)


def test_factorized_matches_jax(served, dataset, port_dataset):
    jh, ph, jm, params, tm = served
    wi, ws = jax_serve.FactorizedRecommender(
        jh, dataset, params=params, model=jm, item_chunk=8).topk(USERS, k=6)
    fi, fs = FactorizedRecommender(ph, port_dataset, model=tm, item_chunk=8,
                                   device=CPU).topk(USERS, k=6)
    np.testing.assert_allclose(fs, np.asarray(ws), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(fi, np.asarray(wi))


@pytest.mark.parametrize("mt", ["NARRE", "transnet"])
def test_factorized_matches_jax_pallas_grid(mt, dataset, port_dataset):
    """The towers against JAX's joint forward with the Pallas TextCNN in
    interpret mode (the kernel the CUDA forward replaces)."""
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt,
                                   use_pallas=True)
    wi, ws = jax_serve.Recommender(jh, dataset, params=params, model=jm,
                                   item_chunk=16).topk(USERS[:3], k=5)
    fi, fs = FactorizedRecommender(ph, port_dataset, model=tm, item_chunk=8,
                                   device=CPU).topk(USERS[:3], k=5)
    np.testing.assert_allclose(fs, np.asarray(ws), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(fi, np.asarray(wi))


@pytest.mark.parametrize("mt", ["MF", "GMF", "MLP", "NeuMF", "MPCN"])
def test_pairwise_models_raise(mt, dataset, port_dataset):
    """JAX's refusal, word for word, before any checkpoint is read."""
    with pytest.raises(ValueError) as jax_err:
        jax_serve.FactorizedRecommender(
            dataset.apply_to(JaxHP(model_type=mt, **GEOM)), dataset)
    ph = port_dataset.apply_to(PortHP(model_type=mt, **GEOM))
    with pytest.raises(ValueError) as port_err:
        FactorizedRecommender(ph, port_dataset, device=CPU)
    assert str(port_err.value) == str(jax_err.value)
    assert "no exact two-tower factorization" in str(port_err.value)
    if mt != "MPCN":
        with pytest.raises(ValueError, match="use Recommender"):
            FactorizedRecommender(ph, port_dataset, model=port_build(
                ph, device=CPU), device=CPU)
