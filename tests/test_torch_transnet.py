"""TransNet and TransNet++ of the port against the flax model, on the
synthetic corpus at a small geometry (input_length 64, latent 8), flax
params bridged into the port:

- the forward (source, target, trans_loss) at train=False, pointwise
  and on [B, C] candidate grids, against the XLA TextCNN and, once,
  the Pallas forward in interpret mode; 1e-5 absolute;
- the gradient of each of the three losses (source MSE, target MSE,
  transform loss) against `jax.grad` of JAX's own, per parameter,
  within 1e-4 * max(1, max|g|), and its routing: each loss reaches only
  its own partition, exactly 0 elsewhere, as
  tests/test_review_models.py holds JAX's;
- the bridge loads with `strict=True`;
- no parameter without a gradient after a backward of the routed loss
  (Adam would skip its step and its weight decay);
- 4 Adam steps at dropout 0 against `make_train_step`: losses within
  1e-5 relative, params within 5e-4 absolute (the bounds of
  tests/test_torch_train.py);
- `api.run` on the CPU reports the JAX `api.run`'s keys, `MSE_right`
  and `MSE_transform` among them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch import api as port_api
from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import ReviewDataset as PortDataset
from reviews4rec_torch.models import build_model as port_build
from reviews4rec_torch.train import loop
from reviews4rec_torch.utils.device import to_device
from reviews4rec_torch.weights import load_flax_params, params_from_flax
from reviews4rec_tpu import api as jax_api
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data.batcher import Batcher
from reviews4rec_tpu.models import build_model as jax_build
from reviews4rec_tpu.train import loop as jax_loop
from reviews4rec_tpu.train.evaluate import make_apply_fn

torch.backends.cuda.matmul.allow_tf32 = False
# small shapes: one torch thread, so the test workers running beside
# this one (JAX meshes on virtual CPU devices) keep their cores
torch.set_num_threads(1)
GEOM = dict(batch_size=16, input_length=64, latent_size=8)
CPU = torch.device("cpu")
HEADS = ["transnet", "transnet++"]
# the parameter partitions, by top-level module, and the loss each one
# learns from
PARTS = {"source": ("source_fm", "user_embedding", "item_embedding"),
         "target": ("target_conv", "target_fm"),
         "trans": ("source_user_conv", "source_item_conv", "project_fc0",
                   "project_fc1")}


@pytest.fixture(scope="module")
def port_dataset(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    dataset.save(str(d))
    return PortDataset.load(str(d))


def _pair(dataset, port_dataset, mt, use_pallas=False, **kw):
    geom = dict(GEOM, **kw)
    jh = dataset.apply_to(JaxHP(model_type=mt, use_pallas=use_pallas,
                                **geom))
    ph = port_dataset.apply_to(PortHP(model_type=mt, **geom))
    jm = jax_build(jh, dataset.word_vectors)
    sample = next(iter(Batcher(dataset.materialize(jh, "train"), 4)))
    params = jm.init({"params": jax.random.PRNGKey(9),
                      "dropout": jax.random.PRNGKey(10)},
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
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.asarray(w).shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mt", HEADS)
def test_forward_matches_flax(mt, use_pallas, dataset, port_dataset):
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt, use_pallas)
    recs = port_dataset.materialize(ph, "train")
    batches = list(Batcher(recs, ph.batch_size))
    # the last batch is padded: its rows of weight 0 leave trans_loss
    for batch in (batches[0], batches[-1]):
        _compare(jm, params, tm, batch)
    _compare(jm, params, tm,
             next(iter(Batcher(port_dataset.materialize_negs(ph), 8))))


@pytest.mark.parametrize("mt", HEADS)
def test_bridge_is_strict(mt, dataset, port_dataset):
    """Every port parameter has its flax twin and nothing is left over."""
    _, _, _, params, tm = _pair(dataset, port_dataset, mt)
    assert set(tm.state_dict()) == set(params_from_flax(params))
    del params["project_fc1"]
    with pytest.raises(RuntimeError, match="project_fc1"):
        load_flax_params(tm, params)


def _split_losses_jax(jm, params, batch):
    apply_fn = make_apply_fn(jm)
    y, w = batch["rating"], batch["weight"]

    def losses(p):
        src, tgt, tl = apply_fn(p, batch, True, jax.random.PRNGKey(0))
        return (jnp.sum((src - y) ** 2 * w) / jnp.sum(w),
                jnp.sum((tgt - y) ** 2 * w) / jnp.sum(w), tl)
    return losses


@pytest.mark.parametrize("mt", HEADS)
def test_gradient_routing_matches_jax(mt, dataset, port_dataset):
    """Each loss's gradient per parameter equals JAX's, and reaches its
    own partition only."""
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt, dropout=0.0)
    batch = next(iter(Batcher(port_dataset.materialize(ph, "train"), 16)))
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    losses = _split_losses_jax(jm, params, jb)
    tb = to_device(batch, CPU)
    tm.train()
    for j, part in enumerate(("source", "target", "trans")):
        want = params_from_flax(jax.grad(lambda p: losses(p)[j])(params))
        tm.zero_grad(set_to_none=True)
        src, tgt, tl = tm(tb)
        y, w = tb["rating"], tb["weight"]
        port_loss = (torch.sum((src - y) ** 2 * w) / torch.sum(w),
                     torch.sum((tgt - y) ** 2 * w) / torch.sum(w), tl)[j]
        port_loss.backward()
        for name, p in tm.named_parameters():
            mine = name.split(".")[0] in PARTS[part]
            g = (p.grad if p.grad is not None
                 else torch.zeros_like(p)).numpy()
            if not mine:
                assert not np.any(g), (part, name)
                assert not np.any(want[name].numpy()), (part, name)
                continue
            assert np.any(g), (part, name)
            tol = 1e-4 * max(1.0, float(np.abs(want[name].numpy()).max()))
            np.testing.assert_allclose(g, want[name].numpy(), atol=tol,
                                       rtol=0, err_msg=f"{part} {name}")


@pytest.mark.parametrize("mt", HEADS)
def test_routed_loss_reaches_every_parameter(mt, port_dataset):
    ph = port_dataset.apply_to(PortHP(model_type=mt, **GEOM))
    model = port_build(ph, port_dataset.word_vectors, device="cpu")
    batch = next(iter(Batcher(port_dataset.materialize(ph, "train"), 16)))
    model.train()
    gen = loop.epoch_generator(0, 1, CPU)
    loss, _ = loop._batch_loss(model(to_device(batch, CPU), gen),
                               to_device(batch, CPU))
    loss.backward()
    names = [n for n, p in model.named_parameters() if p.grad is None]
    assert names == []
    assert (mt == "transnet++") == hasattr(model, "user_embedding")


@pytest.mark.parametrize("mt", HEADS)
def test_adam_steps_match_jax(mt, dataset, port_dataset):
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt, dropout=0.0)
    batches = list(Batcher(dataset.materialize(jh, "train"), 16))[:4]
    opt = jax_loop.make_optimizer(jh)
    state = jax_loop.TrainState(params, opt.init(params),
                                jnp.zeros((), jnp.int32))
    step = jax_loop.make_train_step(make_apply_fn(jm), opt, mt)
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
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=5e-4, rtol=0, err_msg=k)


def test_run_reports_the_transform_metrics(dataset, port_dataset,
                                           tmp_path):
    """`api.run` (1 epoch) of transnet++ reports the keys the JAX
    `api.run` reports, `MSE_right` and `MSE_transform` among them."""
    geom = dict(GEOM, epochs=1, log_dir=str(tmp_path / "logs"),
                model_dir=str(tmp_path / "models"))
    jh = dataset.apply_to(JaxHP(model_type="transnet++", **geom))
    ph = port_dataset.apply_to(PortHP(model_type="transnet++", **geom))
    want, _, _ = jax_api.run(jh, dataset)
    got, ucm, icm = port_api.run(ph, port_dataset, device="cpu")
    assert set(got) == set(want)
    assert {"MSE_right", "MSE_transform"} <= set(got) and ucm and icm
    assert all(np.isfinite(got[k]) for k in got if k != "dataset")
