"""The fused word gather of the port (`ops.textcnn.textcnn_pool_embed`,
the towers' `fuse_gather` under `hp.use_pallas and
hp.pallas_fuse_gather`) against the JAX package's `textcnn_pool_embed`
and its models, on the CPU. The JAX op runs as `tests/test_pallas.py`
runs it: the Pallas kernels in interpret mode, f32 dots.

- the op on tie-free random data: out within 1e-5, idx equal; dK and db
  within 1e-4 of each one's max against `jax.vjp`; the word table gets
  no gradient (a zero cotangent in JAX, none here). Shapes: B=5, T=37,
  E=64, F=16, W=3 (JAX's paired branch), and E=32 and W=5 (its generic
  branch);
- DeepCoNN, NARRE and transnet++ built with both flags against JAX's
  `build_model` with the same flags (interpret mode), params bridged by
  `weights.params_from_flax`: the forward at train=False within 1e-5,
  gradients within 1e-4 * max(1, max|g|), and 3 Adam steps at dropout 0
  (losses within 1e-5 relative, params within 5e-4, the bounds of
  tests/test_torch_train.py; NARRE's shift-free attention biases as in
  tests/test_torch_narre.py);
- the port's fused path bitwise equal to its unfused path (forward,
  gradients, 3 steps at dropout 0.5), taken exactly where JAX takes it:
  int ids with a table and no skip span;
- `build_model` and the serving entry points follow the flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import ReviewDataset as PortDataset
from reviews4rec_torch.models import build_model as port_build
from reviews4rec_torch.models import layers
from reviews4rec_torch.ops import textcnn
from reviews4rec_torch.serve import predict, restore_model
from reviews4rec_torch.train import loop
from reviews4rec_torch.utils.device import to_device
from reviews4rec_torch.weights import load_flax_params, params_from_flax
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data.batcher import Batcher
from reviews4rec_tpu.models import build_model as jax_build
from reviews4rec_tpu.ops import textcnn_pallas
from reviews4rec_tpu.train import loop as jax_loop
from reviews4rec_tpu.train.evaluate import make_apply_fn

torch.backends.cuda.matmul.allow_tf32 = False
# small shapes: one torch thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)
GEOM = dict(batch_size=8, input_length=64, latent_size=8,
            narre_num_reviews=4, narre_num_words=16)
FUSED = dict(use_pallas=True, pallas_fuse_gather=True)
CPU = torch.device("cpu")
MODELS = ["deepconn", "NARRE", "transnet++"]
TEXT_MODELS = ["deepconn", "deepconn++", "NARRE", "transnet", "transnet++"]
# NARRE's attention output biases, gradient 0 in exact arithmetic
SHIFT_FREE = ("att_user.fc1.bias", "att_item.fc1.bias")
# (B, T, E, F, W): JAX's paired branch (2E = 128, W <= 3), then its
# generic one (2E != 128; W > 3)
SHAPES = [(5, 37, 64, 16, 3), (5, 37, 32, 16, 3), (5, 37, 64, 16, 5)]


def _op_case(b, t, e, f, w, seed=0):
    rng = np.random.default_rng(seed)
    v = 50
    table = rng.normal(size=(v, e)).astype(np.float32)
    ids = rng.integers(0, v, (b, t)).astype(np.int32)
    kernel = (rng.normal(size=(w * e, f)) / np.sqrt(w * e)).astype(np.float32)
    bias = rng.normal(size=(f,)).astype(np.float32)
    return ids, table, kernel, bias


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}T{}E{}F{}W{}"
                         .format(*s))
def test_op_forward_matches_jax(shape):
    b, t, e, f, w = shape
    ids, table, kernel, bias = _op_case(*shape)
    want_out, want_idx = textcnn_pallas._forward_embed(
        jnp.asarray(ids), jnp.asarray(table), jnp.asarray(kernel),
        jnp.asarray(bias), w, True, jnp.float32)
    got_out, got_idx = textcnn.textcnn_pool_embed(
        torch.from_numpy(ids), torch.from_numpy(table),
        torch.from_numpy(kernel), torch.from_numpy(bias), w)
    assert got_out.shape == (b, f) and got_idx.dtype == torch.int32
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    # and JAX's public op gives the same out
    np.testing.assert_allclose(
        np.asarray(textcnn_pallas.textcnn_pool_embed(
            jnp.asarray(ids), jnp.asarray(table), jnp.asarray(kernel),
            jnp.asarray(bias), w, True, jnp.float32)),
        got_out.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}T{}E{}F{}W{}"
                         .format(*s))
def test_op_gradient_matches_jax_vjp(shape):
    b, t, e, f, w = shape
    ids, table, kernel, bias = _op_case(*shape, seed=1)
    g = np.random.default_rng(2).normal(size=(b, f)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda tab, k, bb: textcnn_pallas.textcnn_pool_embed(
            jnp.asarray(ids), tab, k, bb, w, True, jnp.float32),
        jnp.asarray(table), jnp.asarray(kernel), jnp.asarray(bias))
    d_table, d_kernel, d_bias = vjp(jnp.asarray(g))
    assert not np.asarray(d_table).any()
    tab = torch.from_numpy(table).requires_grad_(True)
    k = torch.from_numpy(kernel).requires_grad_(True)
    bb = torch.from_numpy(bias).requires_grad_(True)
    got, _ = textcnn.textcnn_pool_embed(torch.from_numpy(ids), tab, k, bb, w)
    got.backward(torch.from_numpy(g))
    assert tab.grad is None
    for name, mine, want in (("dK", k.grad, d_kernel), ("db", bb.grad,
                                                        d_bias)):
        want = np.asarray(want)
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(mine.numpy(), want, atol=tol, rtol=0,
                                   err_msg=name)


def test_op_is_the_plain_op_on_the_gathered_doc():
    """On the CPU the fused op computes the plain op on table[ids] bit
    for bit, forward and (dK, db), and its plain versions are those."""
    ids, table, kernel, bias = (torch.from_numpy(a)
                                for a in _op_case(6, 40, 64, 16, 3, seed=3))
    x = table[ids.long()]
    k1, b1 = kernel.clone().requires_grad_(True), bias.clone().requires_grad_(
        True)
    k2, b2 = kernel.clone().requires_grad_(True), bias.clone().requires_grad_(
        True)
    out1, idx1 = textcnn.textcnn_pool_embed(ids, table, k1, b1, 3)
    out2, idx2 = textcnn.textcnn_pool(x, k2, b2, 3)
    assert torch.equal(out1, out2) and torch.equal(idx1, idx2)
    out1.sum().backward()
    out2.sum().backward()
    assert torch.equal(k1.grad, k2.grad) and torch.equal(b1.grad, b2.grad)
    ref_out, ref_idx = textcnn.textcnn_pool_embed_reference(ids, table,
                                                            kernel, bias, 3)
    assert torch.equal(ref_out, out1) and torch.equal(ref_idx, idx1)
    g = torch.where(out1 > 0, torch.ones_like(out1), torch.zeros_like(out1))
    dk, db = textcnn.textcnn_pool_embed_backward_reference(ids, table, g,
                                                           idx1, 3)
    assert torch.equal(dk, k1.grad) and torch.equal(db, b1.grad)


def test_op_refuses_an_id_outside_the_table():
    ids, table, kernel, bias = (torch.from_numpy(a)
                                for a in _op_case(2, 10, 8, 4, 3))
    for bad in (-1, table.shape[0]):
        ids[1, 4] = bad
        with pytest.raises(IndexError, match="must lie in"):
            textcnn.textcnn_pool_embed(ids, table, kernel, bias, 3)


@pytest.fixture(scope="module")
def port_dataset(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    dataset.save(str(d))
    return PortDataset.load(str(d))


def _pair(dataset, port_dataset, mt, **kw):
    """(JAX hp, port hp, flax model, flax init params, port model with
    those params), both built with the fused gather."""
    geom = dict(GEOM, **FUSED, **kw)
    jh = dataset.apply_to(JaxHP(model_type=mt, **geom))
    ph = port_dataset.apply_to(PortHP(model_type=mt, **geom))
    jm = jax_build(jh, dataset.word_vectors)
    sample = next(iter(Batcher(dataset.materialize(jh, "train"), 4)))
    params = jm.init({"params": jax.random.PRNGKey(5),
                      "dropout": jax.random.PRNGKey(6)},
                     jax.tree_util.tree_map(jnp.asarray, sample),
                     train=False)["params"]
    tm = port_build(ph, port_dataset.word_vectors, device="cpu")
    load_flax_params(tm, params)
    return jh, ph, jm, params, tm


def _fused_calls(monkeypatch):
    """Counts the towers' calls of the fused op."""
    calls = []
    real = layers.textcnn_pool_embed

    def counted(*a, **k):
        calls.append(tuple(a[0].shape))
        return real(*a, **k)

    monkeypatch.setattr(layers, "textcnn_pool_embed", counted)
    return calls


def _towers(mt):
    return {"NARRE": 2, "transnet++": 3}.get(mt, 2)


@pytest.mark.parametrize("mt", MODELS)
def test_model_forward_matches_jax(mt, dataset, port_dataset, monkeypatch):
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt)
    batch = next(iter(Batcher(port_dataset.materialize(ph, "train"), 8)))
    calls = _fused_calls(monkeypatch)
    want = jm.apply({"params": params},
                    jax.tree_util.tree_map(jnp.asarray, batch), train=False)
    tm.eval()
    with torch.no_grad():
        got = tm(to_device(batch, CPU))
    assert len(calls) == _towers(mt)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)


def _jax_grads(jm, params, batch, mt):
    apply_fn = make_apply_fn(jm)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    return jax.grad(lambda p: jax_loop._batch_loss(
        apply_fn(p, jb, True, jax.random.PRNGKey(0)), jb, mt)[0])(params)


@pytest.mark.parametrize("mt", MODELS)
def test_model_gradients_match_jax(mt, dataset, port_dataset):
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt, dropout=0.0)
    batch = next(iter(Batcher(port_dataset.materialize(ph, "train"), 8)))
    want = params_from_flax(_jax_grads(jm, params, batch, mt))
    tm.train()
    loss, _ = loop._batch_loss(tm(to_device(batch, CPU)),
                               to_device(batch, CPU))
    loss.backward()
    got = dict(tm.named_parameters())
    assert set(got) == set(want) - {"word_vectors"}
    for name, p in got.items():
        assert p.grad is not None, name
        g = want[name].numpy()
        tol = 1e-4 * max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(p.grad.numpy(), g, atol=tol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("mt", MODELS)
def test_model_adam_steps_match_jax(mt, dataset, port_dataset):
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt, dropout=0.0)
    init = params_from_flax(params)
    batches = list(Batcher(dataset.materialize(jh, "train"), 8))[:3]
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


@pytest.mark.parametrize("mt", MODELS)
def test_fused_path_is_bitwise_the_unfused_one(mt, port_dataset,
                                               monkeypatch):
    """The same model with and without the flags: predictions, then 3
    steps at dropout 0.5 from one generator seed, params bitwise equal;
    only the flagged model calls the fused op."""
    ph = port_dataset.apply_to(PortHP(model_type=mt, dropout=0.5, **GEOM))
    plain = port_build(ph, port_dataset.word_vectors, device="cpu")
    fused = port_build(ph.replace(**FUSED), port_dataset.word_vectors,
                       device="cpu")
    assert torch.equal(torch.cat([p.flatten() for p in plain.parameters()]),
                       torch.cat([p.flatten() for p in fused.parameters()]))
    recs = port_dataset.materialize(ph, "train")
    batches = [to_device(b, CPU) for b in list(Batcher(recs, 8))[:3]]
    calls = _fused_calls(monkeypatch)
    with torch.no_grad():
        plain.eval(), fused.eval()
        a, b = plain(batches[0]), fused(batches[0])
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        assert torch.equal(x, y)
    assert len(calls) == _towers(mt)
    for model in (plain, fused):
        model.train()
        opt = loop.make_optimizer(ph, model)
        gen = torch.Generator().manual_seed(11)
        for batch in batches:
            loop.train_step(model, opt, batch, gen)
    assert len(calls) == 4 * _towers(mt)
    for (name, x), y in zip(plain.state_dict().items(),
                            fused.state_dict().values()):
        assert torch.equal(x, y), name


def test_fused_gather_waits_for_ids_table_and_no_skip(monkeypatch):
    """Float docs, a skip span or no table take the unfused path, as the
    JAX TextCNN does; int ids with a table and no span take the fused
    one."""
    gen = torch.Generator().manual_seed(0)
    tower = layers.TextCNN(8, 4, 0.0, generator=gen, fuse_gather=True).eval()
    table = torch.randn(20, 8, generator=gen)
    ids = torch.randint(0, 20, (3, 12), generator=gen, dtype=torch.int32)
    skip = torch.tensor([[1, 2], [0, 0], [5, 3]], dtype=torch.int32)
    calls = _fused_calls(monkeypatch)
    with torch.no_grad():
        fused = tower(ids, table=table)
        assert len(calls) == 1
        assert torch.equal(fused, tower(table[ids.long()], table=table))
        tower(ids, table=table, skip=skip)
        tower(table[ids.long()])
        # an [N, T] id table read by rows is gathered, then fused
        tower(ids, table=table, rows=torch.tensor([2, 0], dtype=torch.int32))
    assert calls == [(3, 12), (2, 12)]


def test_transnet_target_tower_fuses_on_the_entity_path(port_dataset,
                                                        monkeypatch):
    """On the entity cache the source towers read float entity docs and
    the target tower the pair's own review as word ids: with the flags
    the target tower alone takes the fused op, and the model's outputs
    are the unfused model's bits."""
    ph = port_dataset.apply_to(PortHP(
        model_type="transnet++", cache_doc_embeds=True, cache_entity=True,
        **GEOM))
    plain = port_build(ph, port_dataset.word_vectors, device="cpu").eval()
    fused = port_build(ph.replace(**FUSED), port_dataset.word_vectors,
                       device="cpu").eval()
    cache = loop.EntityCache(
        to_device(port_dataset.materialize_entity(ph, "train"), CPU),
        loop.build_entity_tables(ph, port_dataset, CPU))
    batch = loop.gather_cached_batch(cache, torch.arange(8), torch.ones(8))
    assert batch["user_doc"].is_floating_point()
    calls = _fused_calls(monkeypatch)
    with torch.no_grad():
        want, got = plain(batch), fused(batch)
    assert calls == [tuple(batch["this_doc"].shape)]
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mt", TEXT_MODELS)
def test_build_model_and_serving_follow_the_flags(mt, port_dataset,
                                                  tmp_path, monkeypatch):
    """`build_model` sets every tower's `fuse_gather` from `use_pallas
    and pallas_fuse_gather`, and the serving entry points, which build
    through it, then take the fused op."""
    ph = port_dataset.apply_to(PortHP(model_type=mt, model_dir=str(tmp_path),
                                      log_dir=str(tmp_path), **GEOM))

    def flags(hp):
        model = port_build(hp, port_dataset.word_vectors, device="cpu")
        return {m.fuse_gather for m in model.modules()
                if isinstance(m, layers.TextCNN)}

    assert flags(ph) == {False}
    assert flags(ph.replace(pallas_fuse_gather=True)) == {False}
    assert flags(ph.replace(use_pallas=True)) == {False}
    assert flags(ph.replace(**FUSED)) == {True}
    # a checkpoint of the unfused model, restored and served fused
    from reviews4rec_torch.train.checkpoint import (checkpoint_path,
                                                    save_checkpoint)
    model = port_build(ph, port_dataset.word_vectors, device="cpu")
    save_checkpoint(checkpoint_path(ph.replace(**FUSED)), model.state_dict(),
                    step=0, epoch=0)
    calls = _fused_calls(monkeypatch)
    restored = restore_model(ph.replace(**FUSED), port_dataset, device=CPU)
    assert {m.fuse_gather for m in restored.modules()
            if isinstance(m, layers.TextCNN)} == {True}
    got = predict(ph.replace(**FUSED), port_dataset, "val", device=CPU)
    assert calls
    want = predict(ph, port_dataset, "val", model=model, device=CPU)
    np.testing.assert_array_equal(got, want)
