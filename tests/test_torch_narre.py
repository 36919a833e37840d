"""NARRE of the port against the flax model, on the synthetic corpus at
a small geometry (4 reviews of 16 words, latent 8), flax params bridged
into the port:

- the forward at train=False on ids: pointwise batches, [B, C]
  candidate grids (the user side at lead [B, 1]) and the entity cache's
  row mask (`user_skip` / `item_skip` review rows), against the XLA
  TextCNN and, once, the Pallas forward in interpret mode; 1e-5
  absolute;
- gradients of the masked MSE against `jax.grad` within
  1e-4 * max(1, max|g|) per tensor, and no parameter left without one
  (Adam would skip its step and its weight decay);
- the bridge loads with `strict=True`;
- 4 Adam steps at dropout 0 against `make_train_step` on the same
  Batcher batches: losses within 1e-5 relative, params within 5e-4
  absolute (the bounds of tests/test_torch_train.py), except the two
  attention scorers' output biases. A softmax over the R reviews is
  blind to a shift of all R scores, so their gradient is 0 in exact
  arithmetic and f32 rounding noise in both frameworks (below 1e-6
  here), which Adam's normalised step turns into up to lr a step either
  way: each side is held within steps * lr of the init instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import ReviewDataset as PortDataset
from reviews4rec_torch.models import build_model as port_build
from reviews4rec_torch.models.layers import MLPTower
from reviews4rec_torch.train import loop
from reviews4rec_torch.utils.device import to_device
from reviews4rec_torch.weights import load_flax_params, params_from_flax
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data.batcher import Batcher
from reviews4rec_tpu.models import build_model as jax_build
from reviews4rec_tpu.models.layers import MLPTower as JaxMLPTower
from reviews4rec_tpu.train import loop as jax_loop
from reviews4rec_tpu.train.evaluate import make_apply_fn

torch.backends.cuda.matmul.allow_tf32 = False
# small shapes: one torch thread, so the test workers running beside
# this one (JAX meshes on virtual CPU devices) keep their cores
torch.set_num_threads(1)
GEOM = dict(batch_size=16, input_length=64, latent_size=8,
            narre_num_reviews=4, narre_num_words=16)
CPU = torch.device("cpu")
# the attention scorers' output biases, whose gradient is 0 in exact
# arithmetic (module docstring)
SHIFT_FREE = ("att_user.fc1.bias", "att_item.fc1.bias")


@pytest.fixture(scope="module")
def port_dataset(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    dataset.save(str(d))
    return PortDataset.load(str(d))


def _pair(dataset, port_dataset, use_pallas=False, **kw):
    """(JAX hp, port hp, flax model, flax init params, port model with
    those params)."""
    geom = dict(GEOM, **kw)
    jh = dataset.apply_to(JaxHP(model_type="NARRE", use_pallas=use_pallas,
                                **geom))
    ph = port_dataset.apply_to(PortHP(model_type="NARRE", **geom))
    jm = jax_build(jh, dataset.word_vectors)
    sample = next(iter(Batcher(dataset.materialize(jh, "train"), 4)))
    params = jm.init({"params": jax.random.PRNGKey(5),
                      "dropout": jax.random.PRNGKey(6)},
                     jax.tree_util.tree_map(jnp.asarray, sample),
                     train=False)["params"]
    tm = port_build(ph, port_dataset.word_vectors, device="cpu")
    load_flax_params(tm, params)
    return jh, ph, jm, params, tm


def _compare(jm, params, tm, batch):
    want = jm.apply({"params": params},
                    jax.tree_util.tree_map(jnp.asarray, batch), train=False)
    tm.eval()
    with torch.no_grad():
        got = tm(to_device(batch, CPU))
    assert got.shape == tuple(np.asarray(want).shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def _skip_rows(batch, r, seed):
    """The entity cache's row masks: a review row per example, or -1."""
    rng = np.random.default_rng(seed)
    n = len(batch["user"])
    return dict(batch,
                user_skip=rng.integers(-1, r, size=n).astype(np.int32),
                item_skip=rng.integers(-1, r, size=n).astype(np.int32))


@pytest.mark.parametrize("final", [None, "sigmoid"])
def test_mlp_tower_matches_flax(final):
    x = np.random.default_rng(0).standard_normal((6, 8)).astype(np.float32)
    tower = JaxMLPTower((8, 4, 1), dropout=0.5,
                        final_activation=final and jax.nn.sigmoid)
    params = tower.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    port = MLPTower(8, (8, 4, 1), dropout=0.5,
                    final_activation=final and torch.sigmoid)
    port.load_state_dict(params_from_flax(params), strict=True)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(tower.apply(
        {"params": params}, jnp.asarray(x))), atol=1e-6, rtol=0)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_matches_flax(dataset, port_dataset, use_pallas):
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, use_pallas)
    recs = port_dataset.materialize(ph, "test")
    for batch in list(Batcher(recs, ph.batch_size))[:2]:
        _compare(jm, params, tm, batch)
    # [B, C] candidate grids: user side at lead [B, 1], broadcast
    _compare(jm, params, tm,
             next(iter(Batcher(port_dataset.materialize_negs(ph), 8))))


@pytest.mark.parametrize("split", ["train", "val"])
def test_forward_with_skip_rows(dataset, port_dataset, split):
    """user_skip / item_skip review rows zero that row in the features
    and the neighbor context; the row keeps its softmax mass."""
    jh, ph, jm, params, tm = _pair(dataset, port_dataset)
    batch = next(iter(Batcher(port_dataset.materialize(ph, split), 16)))
    _compare(jm, params, tm, _skip_rows(batch, ph.narre_num_reviews, 1))


def test_bridge_is_strict(dataset, port_dataset):
    """Every port parameter has its flax twin and nothing is left over."""
    _, _, _, params, tm = _pair(dataset, port_dataset)
    want = set(params_from_flax(params))
    assert set(tm.state_dict()) == want
    del params["att_user"]["fc1"]
    with pytest.raises(RuntimeError, match="att_user.fc1"):
        load_flax_params(tm, params)


def _jax_grads(jm, params, batch):
    apply_fn = make_apply_fn(jm)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    return jax.grad(lambda p: jax_loop._batch_loss(
        apply_fn(p, jb, True, jax.random.PRNGKey(0)), jb, "NARRE")[0])(params)


@pytest.mark.parametrize("skip", [False, True])
def test_gradients_match_jax(dataset, port_dataset, skip):
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, dropout=0.0)
    batch = next(iter(Batcher(port_dataset.materialize(ph, "train"), 16)))
    if skip:
        batch = _skip_rows(batch, ph.narre_num_reviews, 2)
    want = params_from_flax(_jax_grads(jm, params, batch))
    tm.train()
    loss, _ = loop._batch_loss(tm(to_device(batch, CPU)),
                               to_device(batch, CPU))
    loss.backward()
    got = dict(tm.named_parameters())
    assert set(got) == set(want) - {"word_vectors"}
    for name, p in got.items():
        assert p.grad is not None, name
        g = want[name].numpy()
        if name in SHIFT_FREE:
            assert max(np.abs(g).max(), p.grad.abs().max().item()) < 1e-6
        tol = 1e-4 * max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(p.grad.numpy(), g, atol=tol, rtol=0,
                                   err_msg=name)


def test_adam_steps_match_jax(dataset, port_dataset):
    """4 steps of `make_train_step` against the port's `train_step` on
    the same Batcher batches, dropout 0."""
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, dropout=0.0)
    init = params_from_flax(params)
    batches = list(Batcher(dataset.materialize(jh, "train"), 16))[:4]
    opt = jax_loop.make_optimizer(jh)
    state = jax_loop.TrainState(params, opt.init(params),
                                jnp.zeros((), jnp.int32))
    step = jax_loop.make_train_step(make_apply_fn(jm), opt, "NARRE")
    port_opt = loop.make_optimizer(ph, tm)
    tm.train()
    for b in batches:
        state, m = step(state, jax.tree_util.tree_map(jnp.asarray, b),
                        jax.random.PRNGKey(0))
        loss, sq_sum, n = loop.train_step(tm, port_opt, to_device(b, CPU))
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
                    len(batches) * ph.lr * 1.001, k
            continue
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=5e-4, rtol=0, err_msg=k)
