"""`hp.scan_steps` in the port (`train.loop.ScanSteps`): S training steps
per dispatch, the JAX package's `lax.scan` over S batches. On the card a
group is one CUDA-graph replay; on the CPU, where these tests run, it
runs its S steps eagerly from the same staged [S, B, ...] buffers, so
what is checked here is the grouping, the staging, the trailing group
and the dropout stream. The graph replays are checked on the card by
`chip_smoke.py --only scan`.

- `scan_steps` 3 and 4, each with a trailing group shorter than S
  (asserted), end an epoch of `train_complete` at dropout 0.5 with
  params bitwise equal to `scan_steps` 1: MF_dot, NeuMF's three phases,
  deepconn uncached (with and without the fused word gather) and on the
  entity cache (with and without `pallas_fuse_rows`), NARRE on the
  entity cache, transnet++ uncached and on the entity cache;
- the epoch MSE and the throughput count (examples and steps) of
  `train_epoch` are unchanged;
- a checkpoint taken at S=3 and resumed at S=1 ends where the run
  without a break ends;
- one epoch against the JAX package's scan trainer (`train_epoch` with
  `make_scan_train_step`, the model of tests/test_scan.py) at
  scan_steps 3, dropout 0: params within 5e-4, the bound of
  tests/test_torch_train.py, and the epoch MSE within 1e-4.
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
from reviews4rec_torch.data.batcher import Batcher as PortBatcher
from reviews4rec_torch.models import build_model as port_build
from reviews4rec_torch.train import loop
from reviews4rec_torch.train.checkpoint import (checkpoint_path,
                                                load_checkpoint)
from reviews4rec_torch.weights import load_flax_params, params_from_flax
from reviews4rec_tpu.data.batcher import Batcher
from reviews4rec_tpu.models import build_model as jax_build
from reviews4rec_tpu.train import loop as jax_loop
from reviews4rec_tpu.train.evaluate import make_apply_fn

torch.backends.cuda.matmul.allow_tf32 = False
# small shapes: one torch thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)
GEOM = dict(batch_size=40, input_length=64, latent_size=8,
            narre_num_reviews=4, narre_num_words=16, dropout=0.5)
ENTITY = dict(cache_doc_embeds=True, cache_entity=True)
CPU = torch.device("cpu")
CASES = {
    "MF_dot": ("MF_dot", {}),
    "deepconn": ("deepconn", {}),
    "deepconn-fuse_gather": ("deepconn", dict(use_pallas=True,
                                              pallas_fuse_gather=True)),
    "deepconn-entity": ("deepconn", ENTITY),
    "deepconn-entity-fuse_rows": ("deepconn", dict(ENTITY,
                                                   pallas_fuse_rows=True)),
    "NARRE-entity": ("NARRE", ENTITY),
    "transnet++": ("transnet++", {}),
    "transnet++-entity": ("transnet++", ENTITY),
}


@pytest.fixture(scope="module")
def port_dataset(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    dataset.save(str(d))
    return PortDataset.load(str(d))


def _hp(port_dataset, mt, tmp_path, **kw):
    return port_dataset.apply_to(PortHP(
        model_type=mt, shuffle_data_every_epoch=True, log_dir=str(tmp_path),
        model_dir=str(tmp_path), **{**GEOM, "epochs": 1, **kw}))


def _train(hp, port_dataset, path):
    model = port_build(hp, port_dataset.word_vectors, device="cpu")
    loop.train_complete(hp, model, port_dataset, checkpoint_path=str(path))
    return model.state_dict()


def _assert_equal_dicts(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _batches(hp, port_dataset):
    n = len(port_dataset.splits["train"])
    return -(-n // hp.batch_size)


@pytest.mark.parametrize("steps", [3, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_scan_groups_give_the_single_step_params(case, steps, port_dataset,
                                                 tmp_path):
    mt, flags = CASES[case]
    hp = _hp(port_dataset, mt, tmp_path, **flags)
    n = _batches(hp, port_dataset)
    assert n > steps and n % steps, "a full group and a trailing one"
    one = _train(hp, port_dataset, tmp_path / "one.pt")
    grouped = _train(hp.replace(scan_steps=steps), port_dataset,
                     tmp_path / "grouped.pt")
    _assert_equal_dicts(one, grouped)


@pytest.mark.parametrize("steps", [3, 4])
def test_neumf_phases_under_scan(steps, port_dataset, tmp_path):
    """GMF, MLP and NeuMF (warm-started from the two) each end their
    phase with the params of scan_steps 1."""
    runs = {}
    for s in (1, steps):
        d = tmp_path / f"s{s}"
        hp = _hp(port_dataset, "NeuMF", d, scan_steps=s)
        port_api.run(hp, port_dataset, device="cpu")
        runs[s] = [load_checkpoint(checkpoint_path(hp.replace(model_type=mt)))
                   for mt in ("GMF", "MLP", "NeuMF")]
    for a, b in zip(runs[1], runs[steps]):
        _assert_equal_dicts(a["params"], b["params"])
        _assert_equal_dicts(a["best_params"], b["best_params"])


@pytest.mark.parametrize("case", ["MF_dot", "deepconn-entity-fuse_rows",
                                  "transnet++"])
def test_epoch_mse_and_throughput_count_unchanged(case, port_dataset,
                                                  tmp_path, monkeypatch):
    mt, flags = CASES[case]
    hp = _hp(port_dataset, mt, tmp_path, **flags)
    counters = []

    class Counted(loop.Throughput):
        def __init__(self):
            super().__init__()
            counters.append(self)

    monkeypatch.setattr(loop, "Throughput", Counted)
    metrics = []
    for steps in (1, 3):
        model = port_build(hp, port_dataset.word_vectors, device="cpu")
        opt = loop.make_optimizer(hp, model)
        cache = None
        if flags:
            cache = loop.EntityCache(
                {k: torch.from_numpy(v) for k, v in
                 port_dataset.materialize_entity(hp, "train").items()},
                loop.build_entity_tables(hp, port_dataset, CPU))
            if loop.fuse_rows_for(hp):
                cache = loop.EntityCache(cache.example,
                                         loop._fuse_tables(cache.tables))
            recs = {"row": np.arange(len(cache.example["rating"]))}
        else:
            recs = port_dataset.materialize(hp, "train")
        batcher = PortBatcher(recs, hp.batch_size, shuffle=True, seed=hp.seed)
        scan = (loop.ScanSteps(model, opt, steps, CPU, cache)
                if steps > 1 else None)
        gen = loop.epoch_generator(hp.seed, 1, CPU)
        metrics.append(loop.train_epoch(model, opt, batcher, gen, CPU, cache,
                                        scan))
    assert metrics[0]["MSE"] == metrics[1]["MSE"]
    a, b = counters
    assert (a.examples, a.steps) == (b.examples, b.steps)
    assert a.steps == _batches(hp, port_dataset)
    assert a.examples == len(port_dataset.splits["train"])


def test_checkpoint_at_scan_resumes_at_single_steps(port_dataset, tmp_path):
    """Epoch 1 at scan_steps 3, then a resumed run at 1 to epoch 3, ends
    bitwise where 3 epochs at 1 in one run end (dropout 0.5, a reshuffle
    every epoch)."""
    hp = _hp(port_dataset, "deepconn", tmp_path, epochs=3)
    full = _train(hp, port_dataset, tmp_path / "a.pt")
    _train(hp.replace(epochs=1, scan_steps=3), port_dataset,
           tmp_path / "b.pt")
    assert load_checkpoint(str(tmp_path / "b.pt"))["epoch"] == 1
    resumed = _train(hp.replace(resume=True), port_dataset, tmp_path / "b.pt")
    _assert_equal_dicts(resumed, full)
    a, b = (load_checkpoint(str(tmp_path / p)) for p in ("a.pt", "b.pt"))
    _assert_equal_dicts(a["best_params"], b["best_params"])
    assert os.path.exists(tmp_path / "b.pt") and b["epoch"] == 3


def test_scan_epoch_matches_jax(dataset, hp_base, port_dataset):
    """tests/test_scan.py's MF_dot epoch at batch 16, scan_steps 3 with a
    trailing group, dropout 0: JAX's `train_epoch` with
    `make_scan_train_step` against the port's with `ScanSteps`, from the
    same flax init."""
    hp = hp_base.replace(model_type="MF_dot", batch_size=16, dropout=0.0)
    ph = port_dataset.apply_to(PortHP(model_type="MF_dot", batch_size=16,
                                      latent_size=hp.latent_size,
                                      dropout=0.0))
    recs = dataset.materialize(hp, "train")
    b = Batcher(recs, hp.batch_size)
    assert len(b) > 3 and len(b) % 3
    jm = jax_build(hp, dataset.word_vectors)
    rng = jax.random.PRNGKey(3)
    params = jm.init({"params": rng, "dropout": rng}, next(iter(b)),
                     train=False)["params"]
    opt = jax_loop.make_optimizer(hp)
    state = jax_loop.TrainState(params, opt.init(params),
                                np.zeros((), np.int32))
    apply_fn = make_apply_fn(jm)
    state, want = jax_loop.train_epoch(
        jax_loop.make_train_step(apply_fn, opt, "MF_dot"), state, b, rng,
        scan_step=jax_loop.make_scan_train_step(apply_fn, opt, "MF_dot"),
        scan_steps=3)
    tm = port_build(ph, device="cpu")
    load_flax_params(tm, params)
    port_opt = loop.make_optimizer(ph, tm)
    got = loop.train_epoch(
        tm, port_opt, PortBatcher(port_dataset.materialize(ph, "train"), 16),
        None, CPU, None, loop.ScanSteps(tm, port_opt, 3, CPU))
    np.testing.assert_allclose(got["MSE"], want["MSE"], atol=1e-4)
    want_params = params_from_flax(state.params)
    got_params = tm.state_dict()
    assert set(got_params) == set(want_params)
    for k in want_params:
        np.testing.assert_allclose(got_params[k].numpy(),
                                   want_params[k].numpy(), atol=5e-4, rtol=0,
                                   err_msg=k)


def test_scan_steps_refuses_a_group_of_one(port_dataset):
    hp = port_dataset.apply_to(PortHP(model_type="MF_dot", **GEOM))
    model = port_build(hp, device="cpu")
    with pytest.raises(ValueError, match="2 or more"):
        loop.ScanSteps(model, loop.make_optimizer(hp, model), 1, CPU)
