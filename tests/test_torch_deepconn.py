"""DeepCoNN / DeepCoNN++ forward of the port against the flax model at
train=False, with the flax params bridged into the port, on the same
materialized batches and [B, C] candidate grids. The JAX side runs its
XLA TextCNN (use_pallas=False) and, once, its Pallas forward in
interpret mode (use_pallas=True). Tolerance 1e-4 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import Batcher
from reviews4rec_torch.data import ReviewDataset as PortDataset
from reviews4rec_torch.models import build_model as port_build
from reviews4rec_torch.utils.device import to_device
from reviews4rec_torch.weights import load_flax_params
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.models import build_model as jax_build

torch.backends.cuda.matmul.allow_tf32 = False
# small shapes: one torch thread, so the test workers running beside
# this one (JAX meshes on virtual CPU devices) keep their cores
torch.set_num_threads(1)
GEOM = dict(batch_size=16, input_length=64, latent_size=8)


@pytest.fixture(scope="module")
def port_dataset(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    dataset.save(str(d))
    return PortDataset.load(str(d))


def _models(dataset, port_dataset, model_type, use_pallas):
    jh = dataset.apply_to(JaxHP(model_type=model_type, use_pallas=use_pallas,
                                **GEOM))
    ph = port_dataset.apply_to(PortHP(model_type=model_type, **GEOM))
    jm = jax_build(jh, dataset.word_vectors)
    sample = next(iter(Batcher(dataset.materialize(jh, "test"), 4)))
    params = jm.init({"params": jax.random.PRNGKey(1),
                      "dropout": jax.random.PRNGKey(2)},
                     jax.tree_util.tree_map(jnp.asarray, sample),
                     train=False)["params"]
    tm = port_build(ph, port_dataset.word_vectors, device="cpu").eval()
    load_flax_params(tm, params)
    return jh, ph, jm, params, tm


def _compare(jm, params, tm, batch):
    want = jm.apply({"params": params},
                    jax.tree_util.tree_map(jnp.asarray, batch), train=False)
    with torch.no_grad():
        got = tm(to_device(batch, torch.device("cpu")))
    assert got.shape == tuple(np.asarray(want).shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("model_type", ["deepconn", "deepconn++"])
def test_forward_matches_flax(dataset, port_dataset, model_type, use_pallas):
    jh, ph, jm, params, tm = _models(dataset, port_dataset, model_type,
                                     use_pallas)
    recs = port_dataset.materialize(ph, "test")
    for batch in list(Batcher(recs, ph.batch_size))[:2]:
        _compare(jm, params, tm, batch)
    # [B, C] candidate grids: user side at lead [B, 1], broadcast
    grid = port_dataset.materialize_negs(ph)
    _compare(jm, params, tm, next(iter(Batcher(grid, 8))))


def test_forward_with_skip_spans(dataset, port_dataset):
    """user_skip / item_skip (start, len) spans zero a word span of each
    doc in both models."""
    jh, ph, jm, params, tm = _models(dataset, port_dataset, "deepconn++",
                                     False)
    batch = next(iter(Batcher(port_dataset.materialize(ph, "val"), 8)))
    rng = np.random.default_rng(0)
    st = rng.integers(0, 64, size=(8, 1))
    batch["user_skip"] = np.concatenate(
        [st, rng.integers(0, 20, size=(8, 1))], 1).astype(np.int32)
    batch["item_skip"] = np.concatenate(
        [st[::-1], rng.integers(0, 20, size=(8, 1))], 1).astype(np.int32)
    _compare(jm, params, tm, batch)


def test_build_model_raises_for_unported_models(port_dataset):
    """HFT and SVD fit by their own runners (`api.run`), so `build_model`
    raises the JAX package's `ValueError` for them; a conv dtype the port
    has no kernel for raises a `ValueError` naming the three it has."""
    for mt in ("HFT", "SVD"):
        hp = port_dataset.apply_to(PortHP(model_type=mt))
        with pytest.raises(ValueError, match="is not an SGD model"):
            port_build(hp, port_dataset.word_vectors, device="cpu")
    hp = port_dataset.apply_to(PortHP(model_type="deepconn",
                                      compute_dtype="float64"))
    with pytest.raises(ValueError, match="float32, bfloat16, float16"):
        port_build(hp, port_dataset.word_vectors, device="cpu")


def test_build_model_defaults_to_cuda(port_dataset):
    hp = port_dataset.apply_to(PortHP(model_type="deepconn"))
    if torch.cuda.is_available():
        assert next(port_build(hp, port_dataset.word_vectors)
                    .parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_build(hp, port_dataset.word_vectors)
