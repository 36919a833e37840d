"""The port's id models (bias_only, MF_dot, MF, GMF, MLP, NeuMF) against
the flax models, on the synthetic corpus at latent 8 and batch 16, flax
params bridged into the port:

- the forward at train=False on pointwise batches and [B, 6] candidate
  grids: 1e-5 absolute;
- gradients of the masked MSE at dropout 0 against `jax.grad`, within
  1e-5 * max(1, max|g|) per tensor, no parameter left without one;
- 4 Adam steps at dropout 0 against `make_train_step` on the same
  Batcher batches: losses within 1e-5 relative, params within 5e-4
  absolute (the bounds of tests/test_torch_train.py);
- `neumf_warm_start` equal to JAX's on the same three param sets, and
  NeuMF's three phases through `api.run` (three checkpoints, the last
  one served by `restore_model`);
- `api.run` trains and finalizes each model on the CPU with JAX's
  metric keys, and the refusals JAX makes (a sharded `embedding_lookup`
  without a model axis, the doc cache, `seq_parallel`) or the port makes
  (a mesh without the process group of its ranks; meshes run in
  tests/test_torch_parallel.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch import api as port_api
from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import ReviewDataset as PortDataset
from reviews4rec_torch.models import build_model as port_build
from reviews4rec_torch.models.mf import neumf_warm_start
from reviews4rec_torch.serve import predict, restore_model
from reviews4rec_torch.train import loop
from reviews4rec_torch.train.checkpoint import (checkpoint_path,
                                                load_checkpoint)
from reviews4rec_torch.utils.device import to_device
from reviews4rec_torch.weights import load_flax_params, params_from_flax
from reviews4rec_tpu import api as jax_api
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data.batcher import Batcher
from reviews4rec_tpu.models import build_model as jax_build
from reviews4rec_tpu.models.mf import \
    neumf_warm_start as jax_neumf_warm_start
from reviews4rec_tpu.train import loop as jax_loop
from reviews4rec_tpu.train.evaluate import make_apply_fn

torch.backends.cuda.matmul.allow_tf32 = False
# small shapes: one torch thread, so the test workers running beside
# this one (JAX meshes on virtual CPU devices) keep their cores
torch.set_num_threads(1)
GEOM = dict(batch_size=16, latent_size=8)
CPU = torch.device("cpu")
MODELS = ["bias_only", "MF_dot", "MF", "GMF", "MLP", "NeuMF"]


@pytest.fixture(scope="module")
def port_dataset(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    dataset.save(str(d))
    return PortDataset.load(str(d))


def _init(jm, seed):
    z = jnp.zeros(2, jnp.int32)
    key = jax.random.PRNGKey(seed)
    return jm.init({"params": key, "dropout": key}, {"user": z, "item": z},
                   train=False)["params"]


def _pair(dataset, port_dataset, mt, seed=5, **kw):
    """(JAX hp, port hp, flax model, flax init params, port model with
    those params)."""
    geom = dict(GEOM, **kw)
    jh = dataset.apply_to(JaxHP(model_type=mt, **geom))
    ph = port_dataset.apply_to(PortHP(model_type=mt, **geom))
    jm = jax_build(jh)
    params = _init(jm, seed)
    tm = port_build(ph, device="cpu")
    load_flax_params(tm, params)
    return jh, ph, jm, params, tm


@pytest.mark.parametrize("mt", MODELS)
def test_forward_matches_flax(mt, dataset, port_dataset):
    _, ph, jm, params, tm = _pair(dataset, port_dataset, mt)
    assert set(tm.state_dict()) == set(params_from_flax(params))
    tm.eval()
    batches = list(Batcher(port_dataset.materialize(ph, "test"), 16))[:2]
    # [B, 6] candidate grids (1 positive + num_negs)
    batches.append(next(iter(Batcher(port_dataset.materialize_negs(ph), 8))))
    assert batches[-1]["item"].shape == (8, 6)
    for batch in batches:
        want = np.asarray(jm.apply({"params": params}, jax.tree_util.tree_map(
            jnp.asarray, batch), train=False))
        with torch.no_grad():
            got = tm(to_device(batch, CPU)).numpy()
        assert got.shape == want.shape == batch["item"].shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _jax_grads(jm, params, batch, mt):
    apply_fn = make_apply_fn(jm)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    return jax.grad(lambda p: jax_loop._batch_loss(
        apply_fn(p, jb, True, jax.random.PRNGKey(0)), jb, mt)[0])(params)


@pytest.mark.parametrize("mt", MODELS)
def test_gradients_match_jax(mt, dataset, port_dataset):
    _, ph, jm, params, tm = _pair(dataset, port_dataset, mt, dropout=0.0)
    batch = next(iter(Batcher(port_dataset.materialize(ph, "train"), 16)))
    want = params_from_flax(_jax_grads(jm, params, batch, mt))
    tm.train()
    placed = to_device(batch, CPU)
    loss, _ = loop._batch_loss(tm(placed), placed)
    loss.backward()
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        assert p.grad is not None, name
        g = want[name].numpy()
        tol = 1e-5 * max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(p.grad.numpy(), g, atol=tol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("mt", MODELS)
def test_adam_steps_match_jax(mt, dataset, port_dataset):
    """4 steps of `make_train_step` against the port's `train_step` on
    the same Batcher batches, dropout 0."""
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


def test_neumf_warm_start_matches_jax(dataset, port_dataset):
    """The same three flax param sets through both warm starts; the
    result loads into NeuMF with `strict=True` and scores as JAX's."""
    _, ph, jm, neumf, tm = _pair(dataset, port_dataset, "NeuMF", seed=1)
    gmf = _pair(dataset, port_dataset, "GMF", seed=2)[3]
    mlp = _pair(dataset, port_dataset, "MLP", seed=3)[3]
    want = jax_neumf_warm_start(neumf, gmf, mlp)
    got = neumf_warm_start(*(params_from_flax(p) for p in (neumf, gmf, mlp)))
    ref = params_from_flax(want)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(),
                                      err_msg=k)
    # global_bias is NeuMF's own; the final layer GMF first
    np.testing.assert_array_equal(got["global_bias"].numpy(),
                                  np.asarray(neumf["global_bias"]))
    assert got["final.weight"].shape == (1, 2 * ph.latent_size)
    tm.load_state_dict(got, strict=True)
    batch = next(iter(Batcher(port_dataset.materialize(ph, "test"), 16)))
    tm.eval()
    with torch.no_grad():
        out = tm(to_device(batch, CPU)).numpy()
    np.testing.assert_allclose(out, np.asarray(jm.apply(
        {"params": want}, jax.tree_util.tree_map(jnp.asarray, batch),
        train=False)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mt", MODELS)
def test_api_run_trains_and_finalizes(mt, dataset, port_dataset, tmp_path):
    """`api.run` on the CPU: JAX's metric keys, finite values, and the
    checkpoint it leaves serves as the run's model."""
    kw = dict(GEOM, model_type=mt, epochs=2, eval_num_negs=10,
              eval_ks=(1, 10), log_dir=str(tmp_path / "log"),
              model_dir=str(tmp_path / "models"))
    ph = port_dataset.apply_to(PortHP(**kw))
    got, ucm, icm = port_api.run(ph, port_dataset, device="cpu")
    want, _, _ = jax_api.run(dataset.apply_to(JaxHP(**dict(
        kw, model_dir=str(tmp_path / "jax")))), dataset)
    assert set(got) == set(want)
    assert np.isfinite([v for k, v in got.items() if k != "dataset"]).all()
    assert ucm and icm
    restored = restore_model(ph, port_dataset, device=CPU)
    again, _, _ = port_api.finalize(ph, restored, port_dataset, device=CPU)
    assert all(again[k] == got[k] for k in again)


def test_neumf_runs_three_phases(port_dataset, tmp_path):
    """GMF, MLP and NeuMF each leave their own checkpoint; NeuMF's is
    the one `serve` restores, and its first params are the warm start
    of the other two phases' best params. A resumed run of the finished
    run trains nothing and gives the same metrics, as JAX's does."""
    ph = port_dataset.apply_to(PortHP(
        model_type="NeuMF", epochs=2, log_dir=str(tmp_path),
        model_dir=str(tmp_path), **GEOM))
    metrics, _, _ = port_api.run(ph, port_dataset, device="cpu")
    paths = [checkpoint_path(ph.replace(model_type=mt))
             for mt in ("GMF", "MLP", "NeuMF")]
    assert len(set(paths)) == 3 and all(map(os.path.exists, paths))
    gmf, mlp, neumf = (load_checkpoint(p) for p in paths)
    assert neumf["epoch"] == 2 and "final.weight" in neumf["params"]
    assert set(gmf["params"]) == set(port_build(
        ph.replace(model_type="GMF"), device="cpu").state_dict())
    # the warm start: NeuMF's untrained init with the two phases' bests
    start = neumf_warm_start(port_build(ph, device="cpu").state_dict(),
                             gmf["best_params"], mlp["best_params"])
    tm = port_build(ph, device="cpu")
    tm.load_state_dict(start)
    assert torch.equal(tm.gmf_user_embedding, gmf["best_params"][
        "user_embedding"])
    restored = restore_model(ph, port_dataset, device=CPU)
    best = neumf["best_params"]
    assert all(torch.equal(restored.state_dict()[k], best[k]) for k in best)
    np.testing.assert_array_equal(
        predict(ph, port_dataset, "test", device=CPU),
        predict(ph, port_dataset, "test", model=restored, device=CPU))
    again, _, _ = port_api.run(ph.replace(resume=True), port_dataset,
                               device="cpu")
    assert again == metrics
    assert load_checkpoint(paths[2])["epoch"] == 2


@pytest.mark.parametrize("mt", MODELS)
def test_build_model_defaults_to_cuda(mt, port_dataset):
    hp = port_dataset.apply_to(PortHP(model_type=mt, **GEOM))
    if torch.cuda.is_available():
        assert next(port_build(hp).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_build(hp)
    assert next(port_build(hp, device="cpu").parameters()).device == CPU


@pytest.mark.parametrize("lookup", ["psum", "a2a"])
@pytest.mark.parametrize("mt", ["MF_dot", "NeuMF"])
def test_sharded_lookup_without_model_axis_raises(mt, lookup, dataset,
                                                  port_dataset):
    """As JAX: a sharded embedding lookup needs a model axis of 2 or
    more, and bias_only has no table to shard."""
    jh = dataset.apply_to(JaxHP(model_type=mt, embedding_lookup=lookup))
    with pytest.raises(ValueError) as jax_err:
        jax_build(jh)
    ph = port_dataset.apply_to(PortHP(model_type=mt,
                                      embedding_lookup=lookup))
    with pytest.raises(ValueError) as port_err:
        port_build(ph, device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    port_build(ph.replace(model_type="bias_only"), device="cpu")


@pytest.mark.parametrize("option,err,match", [
    (dict(cache_doc_embeds=True), ValueError, "only applies to the review "
     "family"),
    (dict(cache_doc_embeds=True, cache_entity=True), ValueError,
     "only applies to the review family"),
    (dict(seq_parallel=True), ValueError, "seq_parallel=True shards the "
     "TextCNN time axis"),
    (dict(mesh_shape=(1, 2), embedding_lookup="psum"), ValueError,
     "parallel.distributed.initialize"),
])
def test_refusals(option, err, match, port_dataset, tmp_path):
    hp = port_dataset.apply_to(PortHP(
        model_type="MF_dot", log_dir=str(tmp_path), model_dir=str(tmp_path),
        **GEOM)).replace(**option)
    with pytest.raises(err, match=match):
        port_api.run(hp, port_dataset, device="cpu")
