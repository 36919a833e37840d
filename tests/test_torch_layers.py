"""The port's FM, ScorerMLP and TextCNN against the flax modules of the
JAX package, with the flax params carried across by
`weights.load_flax_params`, at train=False on numpy-seeded inputs.
Tolerance 1e-5 absolute: the same f32 math summed in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch.models import layers as tl
from reviews4rec_torch.weights import (load_flax_params, params_from_flax,
                                       tree_from_flat)
from reviews4rec_tpu.models import layers as fl

torch.backends.cuda.matmul.allow_tf32 = False
# small shapes: one torch thread, so the test workers running beside
# this one (JAX meshes on virtual CPU devices) keep their cores
torch.set_num_threads(1)


def _init(module, *args):
    return module.init({"params": jax.random.PRNGKey(3)}, *args)["params"]


def _close(got: torch.Tensor, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def test_fm_matches_flax():
    x = np.random.default_rng(0).normal(size=(6, 20)).astype(np.float32)
    params = _init(fl.FM(8), jnp.asarray(x))
    port = tl.FM(20, 8)
    load_flax_params(port, params)
    _close(port(torch.from_numpy(x)),
           fl.FM(8).apply({"params": params}, jnp.asarray(x)))


def test_scorer_mlp_matches_flax():
    x = np.random.default_rng(1).normal(size=(5, 3, 16)).astype(np.float32)
    flax_mod = fl.ScorerMLP(8, 0.5)
    params = _init(flax_mod, jnp.asarray(x))
    port = tl.ScorerMLP(16, 8, 0.5).eval()
    load_flax_params(port, params)
    _close(port(torch.from_numpy(x)),
           flax_mod.apply({"params": params}, jnp.asarray(x), train=False))


@pytest.mark.parametrize("e,w", [(64, 3), (16, 5)])
def test_textcnn_matches_flax_embedded_input(e, w):
    rng = np.random.default_rng(e + w)
    x = rng.normal(size=(4, 33, e)).astype(np.float32)
    flax_mod = fl.TextCNN(latent_size=8, dropout=0.5, window=w)
    params = _init(flax_mod, jnp.asarray(x))
    port = tl.TextCNN(e, 8, 0.5, window=w).eval()
    load_flax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, flax_mod.apply({"params": params}, jnp.asarray(x)))


def test_textcnn_matches_flax_ids_table_and_skip():
    """int ids through a frozen table, with a (start, len) skip span:
    the JAX module masks at value level, the port in the op."""
    rng = np.random.default_rng(9)
    table = rng.normal(size=(50, 64)).astype(np.float32)
    table[0] = 0.0
    ids = rng.integers(0, 50, size=(3, 40)).astype(np.int32)
    skip = np.asarray([[5, 10], [0, 0], [30, 40]], np.int32)
    flax_mod = fl.TextCNN(latent_size=8, dropout=0.5)
    params = _init(flax_mod, jnp.asarray(ids), False, jnp.asarray(table))
    want = flax_mod.apply({"params": params}, jnp.asarray(ids), False,
                          jnp.asarray(table), jnp.asarray(skip))
    port = tl.TextCNN(64, 8, 0.5).eval()
    load_flax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), table=torch.from_numpy(table),
                   skip=torch.from_numpy(skip))
    _close(got, want)


def test_weight_bridge_layouts():
    """Dense kernels transpose to Linear.weight; conv params and other
    leaves keep their layout; a flat 'a/b' map rebuilds the tree."""
    k = np.arange(6, dtype=np.float32).reshape(2, 3)
    conv = np.ones((6, 4), np.float32)
    sd = params_from_flax({"fc": {"kernel": k, "bias": np.zeros(3)},
                           "conv_kernel": conv})
    assert torch.equal(sd["fc.weight"], torch.from_numpy(k.T.copy()))
    assert sd["fc.bias"].shape == (3,)
    assert torch.equal(sd["conv_kernel"], torch.from_numpy(conv))
    tree = tree_from_flat({"a/b/kernel": k, "a/c": conv})
    assert tree["a"]["b"]["kernel"] is k and tree["a"]["c"] is conv


def test_weight_bridge_rejects_a_different_word_table():
    from reviews4rec_torch.models.deepconn import DeepCoNN

    wv = np.random.default_rng(0).normal(size=(10, 8)).astype(np.float32)
    model = DeepCoNN(16, 16, 4, wv, use_fm=True)
    tree = {k: v.numpy() for k, v in model.state_dict().items()}
    params = {}
    for name, value in tree.items():   # state_dict -> flax-shaped tree
        *path, leaf = name.split(".")
        if leaf == "weight":
            leaf, value = "kernel", value.T
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    load_flax_params(model, params)      # round trip loads
    params["word_vectors"] = wv + 1.0
    with pytest.raises(ValueError):
        load_flax_params(model, params)
