"""The port's ranking losses against the JAX package's, on the synthetic
corpus at a small geometry:

- `train/losses.py`'s five losses, with and without a padding mask,
  within 1e-6 relative;
- `materialize_train_negs` (train and val splits, id and review
  layouts): every array equal to JAX's for the same seed;
- 4 steps of CE / BPR / HINGE on [B, 6] grids against `make_train_step`
  (dropout 0; MPCN at fixed Gumbel uniforms): losses within 1e-5
  relative, params within 5e-4. A parameter that adds the same amount to
  every candidate of a grid row (an output bias, the global bias) has a
  gradient of 0 in exact arithmetic under a ranking loss, and Adam turns
  its f32 rounding into up to lr a step: such elements (step-1 gradient
  below 1e-6 on both sides) are held within steps * lr of their init
  instead;
- `train_complete` under BPR (MF_dot) and CE (deepconn++): the val HR@1
  of each epoch, the same best epoch, and -HR@1 returned, as JAX's;
- the refusals JAX makes: transnet with a ranking loss, and the entity
  cache with one.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import ReviewDataset as PortDataset
from reviews4rec_torch.models import build_model as port_build
from reviews4rec_torch.train import loop, losses
from reviews4rec_torch.utils.device import to_device
from reviews4rec_torch.weights import load_flax_params, params_from_flax
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data.batcher import Batcher
from reviews4rec_tpu.models import att as jax_att
from reviews4rec_tpu.models import build_model as jax_build
from reviews4rec_tpu.train import loop as jax_loop
from reviews4rec_tpu.train import losses as jax_losses
from reviews4rec_tpu.train.evaluate import make_apply_fn

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)
GEOM = dict(batch_size=16, input_length=64, mpcn_dmax=4, mpcn_smax=8,
            latent_size=8, narre_num_reviews=4, narre_num_words=16)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def port_dataset(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    dataset.save(str(d))
    return PortDataset.load(str(d))


def _loss_inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(12, 6)).astype(np.float32)
    labels = np.zeros_like(logits)
    labels[np.arange(12), rng.integers(0, 6, 12)] = 1.0
    weight = (rng.uniform(size=12) > 0.25).astype(np.float32)
    return logits, labels, weight


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("name", ["raw_mse", "softmax_ce",
                                  "sigmoid_ce_point", "bpr", "hinge"])
def test_losses_match_jax(name, masked):
    logits, labels, weight = _loss_inputs()
    pos, neg = logits[:, :1], logits[:, 1:]
    wn = np.broadcast_to(weight[:, None], neg.shape)
    args = {"raw_mse": (logits[:, 0], labels[:, 0] * 4.0, weight),
            "softmax_ce": (logits, labels, weight),
            "sigmoid_ce_point": (logits, labels, weight[:, None]),
            "bpr": (pos, neg, wn), "hinge": (pos, neg, 0.3, wn)}[name]
    if not masked:
        args = args[:-1]
    want = float(getattr(jax_losses, name)(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    got = getattr(losses, name)(
        *[torch.from_numpy(np.ascontiguousarray(a))
          if isinstance(a, np.ndarray) else a for a in args]).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("mt", ["MF_dot", "deepconn", "NARRE", "MPCN"])
def test_materialize_train_negs_equals_jax(mt, split, dataset,
                                           port_dataset):
    jh = dataset.apply_to(JaxHP(model_type=mt, **GEOM))
    ph = port_dataset.apply_to(PortHP(model_type=mt, **GEOM))
    want = dataset.materialize_train_negs(jh, split, seed=7)
    got = port_dataset.materialize_train_negs(ph, split, seed=7)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["item"].shape == (len(dataset.splits[split]), 6)


def _fixed_gumbel(monkeypatch, model, us):
    """JAX's `gumbel_softmax` reads the fixed uniforms `us` in call
    order (this process only); the port's MPCN is handed the same."""
    calls = []

    def fixed(logits, _rng, temperature, hard=True):
        u = jnp.asarray(us[len(calls) % len(us)])
        calls.append(1)
        g = -jnp.log(-jnp.log(u))
        y = jax.nn.softmax((logits + g) / temperature, axis=-1)
        y_hard = (y == jnp.max(y, axis=-1, keepdims=True)).astype(y.dtype)
        return jax.lax.stop_gradient(y_hard - y) + y

    monkeypatch.setattr(jax_att, "gumbel_softmax", fixed)
    model.gumbel_u = [(torch.from_numpy(us[0]), torch.from_numpy(us[1]))]


def _pair(dataset, port_dataset, mt, **kw):
    geom = dict(GEOM, model_type=mt, dropout=0.0, mpcn_dropout_keep=1.0,
                **kw)
    jh = dataset.apply_to(JaxHP(**geom))
    ph = port_dataset.apply_to(PortHP(**geom))
    jm = jax_build(jh, dataset.word_vectors)
    sample = next(iter(Batcher(dataset.materialize(jh, "train"), 4)))
    params = jm.init({"params": jax.random.PRNGKey(3),
                      "dropout": jax.random.PRNGKey(4)},
                     jax.tree_util.tree_map(jnp.asarray, sample),
                     train=False)["params"]
    wv = port_dataset.word_vectors if ph.family == "review" else None
    tm = port_build(ph, wv, device="cpu")
    load_flax_params(tm, params)
    return jh, ph, jm, params, tm


@pytest.mark.parametrize("mt,loss", [
    ("MF_dot", "BPR"), ("MF_dot", "CE"), ("deepconn", "CE"),
    ("deepconn++", "BPR"), ("deepconn", "HINGE"), ("MPCN", "HINGE"),
    ("MPCN", "CE")])
def test_ranking_steps_match_jax(mt, loss, dataset, port_dataset,
                                 monkeypatch):
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt, loss=loss)
    recs = dataset.materialize_train_negs(jh, "train", seed=0)
    batches = list(Batcher(recs, 16))[:4]
    if mt == "MPCN":
        rng = np.random.default_rng(5)
        _fixed_gumbel(monkeypatch, tm, [
            rng.uniform(1e-6, 1, (16 * 6, jh.mpcn_dmax)).astype(np.float32)
            for _ in range(2)])
    opt = jax_loop.make_optimizer(jh)
    state = jax_loop.TrainState(params, opt.init(params),
                                jnp.zeros((), jnp.int32))
    step = jax_loop.make_train_step(make_apply_fn(jm), opt, mt, loss,
                                    jh.hinge_margin)
    apply_fn = make_apply_fn(jm)
    b0 = jax.tree_util.tree_map(jnp.asarray, batches[0])
    want_g = params_from_flax(jax.grad(lambda p: jax_loop._batch_loss(
        apply_fn(p, b0, True, jax.random.PRNGKey(0)), b0, mt, loss,
        jh.hinge_margin)[0])(params))
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    port_opt = loop.make_optimizer(ph, tm)
    grads = {}

    def grab(*_):
        if not grads:
            grads.update({n: p.grad.clone()
                          for n, p in tm.named_parameters()})

    port_opt.register_step_pre_hook(grab)
    tm.train()
    for b in batches:
        state, m = step(state, jax.tree_util.tree_map(jnp.asarray, b),
                        jax.random.PRNGKey(0))
        got, acc, n = loop.train_step(tm, port_opt, to_device(b, CPU),
                                      None, loss, ph.hinge_margin)
        np.testing.assert_allclose(got.item(), float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(acc.item(), float(m["sq_sum"]),
                                   rtol=1e-5)
    lr = port_opt.param_groups[0]["lr"]
    want = params_from_flax(state.params)
    for k, v in tm.named_parameters():
        v = v.detach()
        g, wg = grads[k].abs(), want_g[k].abs()
        free = torch.maximum(g, wg) < 1e-6
        err = (v - want[k]).abs()
        moved = torch.maximum((v - init[k]).abs(), (want[k] - init[k]).abs())
        assert float(err.masked_fill(free, 0).max()) <= 5e-4, k
        assert float(moved.masked_fill(~free, 0).max()) <= 4 * lr * 1.001, k


def _epoch_hr1(log_file):
    text = open(log_file).read()
    return [float(h) for h in re.findall(
        r"end of epoch \d+ \|[^\n]*?\| HR@1 = ([\d.]+)", text)]


@pytest.mark.parametrize("mt,loss,epochs", [("MF_dot", "BPR", 3),
                                            ("deepconn++", "CE", 2)])
def test_ranking_train_complete_matches_jax(mt, loss, epochs, dataset,
                                            port_dataset, tmp_path):
    """val HR@1 per epoch as JAX's, HR@1 selection and -best HR@1
    returned; no "MSE" in the banners. A shift-free bias (module
    docstring) moves no rank, but deepconn++'s hidden-bias elements are
    shift-free only while their unit is active on every candidate; after
    that their Adam noise steers the run, so deepconn++ is held for 2
    epochs."""
    jh, ph, jm, params, tm = _pair(
        dataset, port_dataset, mt, loss=loss, epochs=epochs,
        log_dir=str(tmp_path), shuffle_data_every_epoch=True)
    _, jbest = jax_loop.train_complete(jh, jm, dataset, params=params)
    want = _epoch_hr1(jh.log_file())
    open(ph.log_file(), "w").close()
    stats = {}
    best, pbest = loop.train_complete(ph, tm, port_dataset, stats=stats)
    got = _epoch_hr1(ph.log_file())
    assert len(got) == len(want) == epochs
    np.testing.assert_allclose(got, want, atol=1e-9)
    assert pbest == jbest == -max(want)
    assert stats["epoch_val_mse"] == [-h for h in got]
    assert "MSE =" not in open(ph.log_file()).read()


@pytest.mark.parametrize("mt", ["transnet", "transnet++"])
def test_transnet_refuses_ranking_losses(mt, dataset, port_dataset,
                                         tmp_path):
    """JAX's `ValueError`, word for word."""
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt, loss="BPR",
                                   log_dir=str(tmp_path))
    with pytest.raises(ValueError) as jax_err:
        jax_loop.train_complete(jh, jm, dataset, params=params)
    with pytest.raises(ValueError) as port_err:
        loop.train_complete(ph, tm, port_dataset)
    assert str(port_err.value) == str(jax_err.value)
    assert "routed 3-loss objective" in str(port_err.value)


def test_entity_cache_refuses_ranking_losses(dataset, port_dataset,
                                             tmp_path):
    jh, ph, jm, params, tm = _pair(
        dataset, port_dataset, "deepconn", loss="CE", log_dir=str(tmp_path),
        cache_doc_embeds=True, cache_entity=True)
    with pytest.raises(ValueError) as jax_err:
        jax_loop.train_complete(jh, jm, dataset, params=params)
    with pytest.raises(ValueError) as port_err:
        loop.train_complete(ph, tm, port_dataset)
    assert str(port_err.value) == str(jax_err.value)


def test_unknown_loss_raises(dataset, port_dataset, tmp_path):
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, "MF_dot",
                                   loss="LOG", log_dir=str(tmp_path))
    with pytest.raises(ValueError, match="unknown loss 'LOG'"):
        loop.train_complete(ph, tm, port_dataset)
