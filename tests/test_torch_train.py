"""The port's trainer against the JAX package's, both heads, on the
synthetic corpus at a small geometry (input_length 64, batch 32,
latent 8), flax init params bridged into the port.

Tolerances, dropout 0 on both sides:
- per-step losses within 1e-5 relative (f32 sums in another order);
- params after K Adam steps within 5e-4 absolute. Adam divides each
  gradient element by its own running magnitude, so an element whose
  gradient nearly cancels against the weight decay (~1e-8, Adam's eps)
  turns f32 rounding of ~1e-9 into an update difference of a few
  percent of lr (0.002) per step: 1.05e-4 after 8 steps measured on
  deepconn++'s item conv kernel, with its step-1 gradient off by 8e-10.
- val MSE per epoch within 1e-4 (the banner rounds to 4 decimals), and
  the same best and early-stop epochs.
The port's own runs (resume, scan_steps, restore) are bitwise equal.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch import api as port_api
from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import ReviewDataset as PortDataset
from reviews4rec_torch.models import build_model as port_build
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
from reviews4rec_tpu.train import loop as jax_loop
from reviews4rec_tpu.train.evaluate import make_apply_fn

torch.backends.cuda.matmul.allow_tf32 = False
# small shapes: one torch thread, so the test workers running beside
# this one (JAX meshes on virtual CPU devices) keep their cores
torch.set_num_threads(1)
GEOM = dict(batch_size=32, input_length=64, latent_size=8)
CPU = torch.device("cpu")
HEADS = ["deepconn", "deepconn++"]


@pytest.fixture(scope="module")
def port_dataset(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    dataset.save(str(d))
    return PortDataset.load(str(d))


def _pair(dataset, port_dataset, mt, tmp_path, **kw):
    """(JAX hp, port hp, flax model, flax init params, port model with
    those params), logs and checkpoints under tmp_path."""
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


def _val_mse(log_file):
    """{epoch: val MSE} from a run's epoch banners, and the early-stop
    epoch (or None)."""
    text = open(log_file).read()
    mse = {int(e): float(m) for e, m in re.findall(
        r"end of epoch (\d+) \|[^\n]*?\| MSE = ([-\d.e]+)", text)}
    stop = re.search(r"early stop at epoch (\d+)", text)
    return mse, (int(stop.group(1)) if stop else None)


def _assert_params_close(model, flax_params, atol):
    want = params_from_flax(flax_params)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("mt", HEADS)
def test_train_steps_match_jax(mt, dataset, port_dataset, tmp_path):
    """K=6 steps of `make_train_step` against the port's `train_step`
    on the same Batcher batches, dropout 0."""
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt, tmp_path,
                                   dropout=0.0)
    batches = list(Batcher(dataset.materialize(jh, "train"), 32))[:6]
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
    _assert_params_close(tm, state.params, atol=5e-4)


@pytest.mark.parametrize("mt", HEADS)
def test_train_complete_matches_jax(mt, dataset, port_dataset, tmp_path):
    """3 epochs at dropout 0: val MSE per epoch within 1e-4, the same
    best epoch, and best params that score alike."""
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt, tmp_path,
                                   dropout=0.0, epochs=3)
    _, jbest = jax_loop.train_complete(jh, jm, dataset, params=params)
    stats = {}
    best, pbest = loop.train_complete(ph, tm, port_dataset, stats=stats)
    jmse, _ = _val_mse(jh.log_file())
    assert sorted(jmse) == [1, 2, 3]
    np.testing.assert_allclose(stats["epoch_val_mse"],
                               [jmse[e] for e in (1, 2, 3)], atol=1e-4)
    assert abs(pbest - jbest) <= 1e-4 + 1e-9
    assert int(np.argmin(stats["epoch_val_mse"])) == \
        min(jmse, key=lambda e: (jmse[e], e)) - 1
    assert stats["train_examples_per_s"] > 0


def test_early_stop_at_the_same_epoch(dataset, port_dataset, tmp_path):
    """A learning rate that overshoots, patience 1: both stop after the
    first epoch that does not improve on the best val MSE."""
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, "deepconn",
                                   tmp_path, dropout=0.0, epochs=8,
                                   lr=0.05, early_stop=1)
    jax_loop.train_complete(jh, jm, dataset, params=params)
    loop.train_complete(ph, tm, port_dataset)
    jmse, jstop = _val_mse(jh.log_file())
    pmse, pstop = _val_mse(ph.log_file())
    assert jstop is not None and jstop < 8
    assert pstop == jstop
    np.testing.assert_allclose([pmse[e] for e in sorted(pmse)],
                               [jmse[e] for e in sorted(jmse)], atol=1e-4)


def _final_state(hp, port_dataset, path):
    model = port_build(hp, port_dataset.word_vectors, device="cpu")
    best, _ = loop.train_complete(hp, model, port_dataset,
                                  checkpoint_path=str(path))
    return model.state_dict(), best


def _assert_equal_dicts(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resume_is_bitwise_an_uninterrupted_run(port_dataset, tmp_path):
    """Dropout 0.6 and a reshuffle every epoch: 1 epoch, then a resumed
    run to 3, ends bitwise where 3 epochs in one run end."""
    hp = port_dataset.apply_to(PortHP(
        model_type="deepconn++", epochs=3, shuffle_data_every_epoch=True,
        log_dir=str(tmp_path), **GEOM))
    full, full_best = _final_state(hp, port_dataset, tmp_path / "a.pt")
    _final_state(hp.replace(epochs=1), port_dataset, tmp_path / "b.pt")
    assert load_checkpoint(str(tmp_path / "b.pt"))["epoch"] == 1
    resumed, resumed_best = _final_state(hp.replace(resume=True),
                                         port_dataset, tmp_path / "b.pt")
    _assert_equal_dicts(resumed, full)
    _assert_equal_dicts(resumed_best, full_best)
    a = load_checkpoint(str(tmp_path / "a.pt"))
    b = load_checkpoint(str(tmp_path / "b.pt"))
    assert (a["epoch"], a["step"]) == (b["epoch"], b["step"]) == (3, 3 * 16)
    assert a["opt_state"]["state"][0]["step"] == 3 * 16


def test_scan_steps_runs_the_same_updates(port_dataset, tmp_path):
    hp = port_dataset.apply_to(PortHP(model_type="deepconn", epochs=1,
                                      log_dir=str(tmp_path), **GEOM))
    one, _ = _final_state(hp, port_dataset, tmp_path / "a.pt")
    three, _ = _final_state(hp.replace(scan_steps=3), port_dataset,
                            tmp_path / "b.pt")
    _assert_equal_dicts(one, three)


def test_word_table_is_frozen_and_outside_the_optimizer(port_dataset):
    hp = port_dataset.apply_to(PortHP(model_type="deepconn", **GEOM))
    model = port_build(hp, port_dataset.word_vectors, device="cpu")
    opt = loop.make_optimizer(hp, model)
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    assert id(model.word_vectors) not in in_opt
    assert in_opt == {id(p) for p in model.parameters()}
    before = model.word_vectors.clone()
    batch = next(iter(Batcher(port_dataset.materialize(hp, "train"), 32)))
    model.train()
    loop.train_step(model, opt, to_device(batch, CPU))
    assert torch.equal(model.word_vectors, before)
    assert not model.word_vectors.requires_grad


def test_keyboard_interrupt_returns_the_best_params(port_dataset, tmp_path,
                                                    monkeypatch):
    hp = port_dataset.apply_to(PortHP(model_type="deepconn", epochs=3,
                                      log_dir=str(tmp_path), **GEOM))
    model = port_build(hp, port_dataset.word_vectors, device="cpu")
    real = loop.evaluate
    calls = []

    def evaluate(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return real(*a, **k)

    monkeypatch.setattr(loop, "evaluate", evaluate)
    best, mse = loop.train_complete(hp, model, port_dataset)
    assert len(calls) == 2 and np.isfinite(mse)
    assert "KeyboardInterrupt" in open(hp.log_file()).read()
    assert not torch.equal(best["fm.V"], model.state_dict()["fm.V"])


def test_run_returns_the_jax_metric_keys_and_restores(dataset, port_dataset,
                                                      tmp_path):
    """`api.run` (1 epoch) reports the keys the JAX `api.run` reports,
    saves its checkpoint as `<model_path>.pt`, and `restore_model` then
    `predict` equal the trained model's predictions."""
    jh, ph, _, _, _ = _pair(dataset, port_dataset, "deepconn", tmp_path,
                            epochs=1)
    want, _, _ = jax_api.run(jh, dataset)
    got, ucm, icm = port_api.run(ph, port_dataset, device="cpu")
    assert set(got) == set(want)
    assert got["dataset"] == want["dataset"] and ucm and icm
    path = checkpoint_path(ph)
    assert path == ph.model_path() + ".pt"

    trained = port_build(ph, port_dataset.word_vectors, device="cpu")
    trained.load_state_dict(load_checkpoint(path)["best_params"])
    expect = predict(ph, port_dataset, "test", model=trained, device=CPU)
    restored = restore_model(ph, port_dataset, device=CPU)
    assert not restored.training
    np.testing.assert_array_equal(
        predict(ph, port_dataset, "test", model=restored, device=CPU), expect)
    np.testing.assert_array_equal(
        predict(ph, port_dataset, "test", device=CPU), expect)
    # finalize of the restored model gives the run's own test metrics
    again, _, _ = port_api.finalize(ph, restored, port_dataset, device=CPU)
    assert all(again[k] == got[k] for k in again)


@pytest.mark.parametrize("option,item", [
    (dict(cache_doc_embeds=True), "Queue 1 item 7"),
    (dict(cache_doc_embeds=True, cache_entity=True), "Queue 1 item 7"),
    (dict(mesh_shape=(2, 1)), "Queue 1 item 13"),
    (dict(loss="BPR"), "Queue 1 item 11"),
    (dict(model_type="transnet"), "Queue 1 item 8"),
    (dict(model_type="MF_dot"), "Queue 1 item 9"),
])
def test_unported_options_raise(option, item, port_dataset, tmp_path):
    hp = port_dataset.apply_to(PortHP(
        model_type="deepconn", log_dir=str(tmp_path),
        model_dir=str(tmp_path), **GEOM)).replace(**option)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        port_api.run(hp, port_dataset, device="cpu")
