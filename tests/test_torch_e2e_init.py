"""The fixture `torch_fixtures/e2e_init.npz` holds the JAX trainer's own
initial params of the `--e2e-full` runs (`make_e2e_init.py`). The port
loads them through the weight bridge and predicts as JAX does from them,
and the fixture is what the script builds from the committed corpus
now, so a stale fixture fails."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import ReviewDataset as PortDataset
from reviews4rec_torch.models import build_model as port_build
from reviews4rec_torch.utils.io import load_npz
from reviews4rec_torch.weights import load_flax_params, tree_from_flat
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data.batcher import Batcher
from reviews4rec_tpu.data.corpus import ReviewDataset as JaxDataset
from reviews4rec_tpu.models import build_model as jax_build

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "torch_fixtures"
CORPUS = ROOT / "data" / "e2e" / "5_core"
MODELS = ("deepconn", "deepconn++")
N_EXAMPLES = 8

torch.set_num_threads(1)


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_e2e_init", FIXTURES / "make_e2e_init.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def maker():
    return _maker()


@pytest.fixture(scope="module")
def corpus():
    return JaxDataset.load(str(CORPUS)), PortDataset.load(str(CORPUS))


@pytest.fixture(scope="module")
def fixture():
    return load_npz(str(FIXTURES / "e2e_init.npz"))


def _params(fixture, mt):
    prefix = f"{mt}/params/"
    return {k[len(prefix):]: v for k, v in fixture.items()
            if k.startswith(prefix)}


def _merge(tree, flat_tree):
    """`tree` with every leaf that `flat_tree` holds replaced by it."""
    return {k: (_merge(v, flat_tree.get(k, {})) if hasattr(v, "items")
                else jnp.asarray(flat_tree[k]) if k in flat_tree else v)
            for k, v in tree.items()}


@pytest.mark.parametrize("mt", MODELS)
def test_fixture_is_what_the_script_builds(maker, corpus, fixture, mt):
    jds, _ = corpus
    built = maker.init_params(jds, mt)
    stored = _params(fixture, mt)
    assert sorted(built) == sorted(stored)
    for path, value in built.items():
        np.testing.assert_array_equal(stored[path], value, err_msg=path)


@pytest.mark.parametrize("mt", MODELS)
def test_port_predicts_as_jax_from_the_fixture(maker, corpus, fixture, mt):
    jds, pds = corpus
    flags = dict(maker.FLAGS, use_pallas=False)   # the XLA branch, f32
    jh = jds.apply_to(JaxHP(model_type=mt, **flags))
    ph = pds.apply_to(PortHP(model_type=mt, **flags))
    recs = jds.materialize(jh, "test")
    batch = next(iter(Batcher({k: v[:N_EXAMPLES] for k, v in recs.items()},
                              N_EXAMPLES)))
    jm = jax_build(jh, jds.word_vectors)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    key = jax.random.PRNGKey(1)
    params = _merge(jm.init({"params": key, "dropout": key}, jbatch,
                            train=False)["params"],
                    tree_from_flat(_params(fixture, mt)))
    want = np.asarray(jm.apply({"params": params}, jbatch, train=False))

    tm = port_build(ph, pds.word_vectors, device="cpu")
    load_flax_params(tm, tree_from_flat(_params(fixture, mt)))
    tm.eval()
    with torch.no_grad():
        got = tm({k: torch.from_numpy(np.asarray(v))
                  for k, v in batch.items()}).numpy()
    assert got.shape == want.shape == (N_EXAMPLES,)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
