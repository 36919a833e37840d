"""The port's MPCN (`reviews4rec_torch/models/mpcn.py`) and its
optimizer recipe against the JAX package's, on the synthetic corpus at
dmax 4, smax 8, latent 8, flax params bridged into the port
(`strict=True`, the trained `word_embedding` included):

- the forward over the variant space (affinity x head, the CNN encoder,
  D_ATT, HIGH, two heads) on pointwise batches and [B, 6] grids whose
  user side sits at [B, 1]: at eval (the hard pointer, the rating clip)
  and in training at dropout 0 with fixed Gumbel uniforms (JAX's
  `gumbel_softmax` replaced in this process only), within 1e-5;
- gradients of the masked MSE within 1e-4 * max(1, max|g|) per tensor,
  the word table's [V, E] gradient included;
- 4 steps against `make_train_step` at dropout 0 and fixed uniforms:
  losses within 1e-5 relative, params within 5e-4;
- `ClippedAdam` against optax's chain (L2, then the global-norm clip,
  then Adam) where the clip triggers, and torch's own Adam(weight_decay)
  + `clip_grad_norm_` shown to be another update;
- the hard pointer on padded reviews (exact ties: multi-hot);
- the ids-only cache and `scan_steps` bitwise the plain run; `api.run`,
  restore, `Recommender` on host records and `entity=True`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from reviews4rec_torch import api as port_api
from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import ReviewDataset as PortDataset
from reviews4rec_torch.models import build_model as port_build
from reviews4rec_torch.serve import Recommender, predict, restore_model
from reviews4rec_torch.train import loop
from reviews4rec_torch.train.checkpoint import checkpoint_path
from reviews4rec_torch.utils.device import to_device
from reviews4rec_torch.weights import load_flax_params, params_from_flax
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data.batcher import Batcher
from reviews4rec_tpu.models import att as jax_att
from reviews4rec_tpu.models import build_model as jax_build
from reviews4rec_tpu.train import loop as jax_loop
from reviews4rec_tpu.train.evaluate import make_apply_fn

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)
GEOM = dict(batch_size=16, mpcn_dmax=4, mpcn_smax=8, latent_size=8)
CPU = torch.device("cpu")
VARIANTS = (
    [dict(mpcn_affinity=a, mpcn_head=h)
     for a in ("SOFT", "BILINEAR", "TENSOR", "MLP", "MD")
     for h in ("FM", "DOT", "MLP", "MF")]
    + [dict(mpcn_encoder="CNN"), dict(mpcn_joint="D_ATT"),
       dict(mpcn_joint="D_ATT", mpcn_head="MLP"),
       dict(mpcn_projection="HIGH"), dict(mpcn_heads=2),
       dict(mpcn_pretrained=True)])


def _id(v):
    return "-".join(f"{k[5:]}={x}" for k, x in v.items())


@pytest.fixture(scope="module")
def port_dataset(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    dataset.save(str(d))
    return PortDataset.load(str(d))


def _uniforms(hp, b, seed=11):
    """Fixed Gumbel uniforms, (u_a, u_b) [b, dmax] per head."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(1e-6, 1.0, size=(b, hp.mpcn_dmax)).astype(np.float32)
            for _ in range(2 * hp.mpcn_heads)]


def _fix_gumbel(monkeypatch, model, us):
    """Both sides draw the same Gumbel uniforms: JAX's `gumbel_softmax`
    reads `us` in call order (cycling, so one trace or many give the
    same), the port's model is handed them per head."""
    calls = []

    def fixed(logits, _rng, temperature, hard=True):
        u = jnp.asarray(us[len(calls) % len(us)])
        calls.append(1)
        g = -jnp.log(-jnp.log(u))
        y = jax.nn.softmax((logits + g) / temperature, axis=-1)
        y_hard = (y == jnp.max(y, axis=-1, keepdims=True)).astype(y.dtype)
        return jax.lax.stop_gradient(y_hard - y) + y

    monkeypatch.setattr(jax_att, "gumbel_softmax", fixed)
    model.gumbel_u = [(torch.from_numpy(us[2 * h]),
                       torch.from_numpy(us[2 * h + 1]))
                      for h in range(len(us) // 2)]


def _pair(dataset, port_dataset, variant=None, **kw):
    """(JAX hp, port hp, flax model, flax params, port model with
    them)."""
    geom = dict(GEOM, model_type="MPCN", **(variant or {}), **kw)
    jh = dataset.apply_to(JaxHP(**geom))
    ph = port_dataset.apply_to(PortHP(**geom))
    jm = jax_build(jh, dataset.word_vectors)
    sample = next(iter(Batcher(dataset.materialize(jh, "train"), 4)))
    params = jm.init({"params": jax.random.PRNGKey(3),
                      "dropout": jax.random.PRNGKey(4)},
                     jax.tree_util.tree_map(jnp.asarray, sample),
                     train=False)["params"]
    tm = port_build(ph, port_dataset.word_vectors, device="cpu")
    load_flax_params(tm, params)
    return jh, ph, jm, params, tm


def _batch(dataset, jh, grid: bool, n: int = 8):
    recs = (dataset.materialize_negs(jh) if grid
            else dataset.materialize(jh, "train"))
    return next(iter(Batcher(recs, n)))


def _jax_apply(jm, params, batch, train):
    rngs = ({"dropout": jax.random.PRNGKey(0),
             "gumbel": jax.random.PRNGKey(1)} if train else {})
    return jm.apply({"params": params},
                    jax.tree_util.tree_map(jnp.asarray, batch), train=train,
                    rngs=rngs)


@pytest.mark.parametrize("grid", [False, True], ids=["pointwise", "grid"])
@pytest.mark.parametrize("variant", VARIANTS, ids=_id)
def test_forward_matches_jax(variant, grid, dataset, port_dataset,
                             monkeypatch):
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, variant,
                                   mpcn_dropout_keep=1.0)
    batch = _batch(dataset, jh, grid)
    tb = to_device(batch, CPU)
    want = np.asarray(_jax_apply(jm, params, batch, False))
    got = tm.eval()(tb).detach().numpy()
    assert got.shape == want.shape == batch["item"].shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got.min() >= jh.rating_min and got.max() <= jh.rating_max
    # training: no clip; the pointer at fixed uniforms
    lead = int(np.prod(batch["item"].shape))
    _fix_gumbel(monkeypatch, tm, _uniforms(jh, lead))
    want = np.asarray(_jax_apply(jm, params, batch, True))
    got = tm.train()(tb).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _jax_grads(jm, params, batch):
    b = jax.tree_util.tree_map(jnp.asarray, batch)
    return jax.grad(lambda p: jax_loop._batch_loss(
        jm.apply({"params": p}, b, train=True,
                 rngs={"dropout": jax.random.PRNGKey(0),
                       "gumbel": jax.random.PRNGKey(1)}),
        b, "MPCN")[0])(params)


@pytest.mark.parametrize("variant", [
    {}, dict(mpcn_affinity="TENSOR", mpcn_head="MLP"),
    dict(mpcn_affinity="MD", mpcn_head="MF"), dict(mpcn_encoder="CNN"),
    dict(mpcn_joint="D_ATT"), dict(mpcn_projection="HIGH"),
    dict(mpcn_heads=2, mpcn_affinity="BILINEAR")], ids=_id)
def test_gradients_match_jax(variant, dataset, port_dataset, monkeypatch):
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, variant,
                                   mpcn_dropout_keep=1.0)
    batch = _batch(dataset, jh, False, 16)
    _fix_gumbel(monkeypatch, tm, _uniforms(jh, 16))
    want = params_from_flax(_jax_grads(jm, params, batch))
    loss, _ = loop._batch_loss(tm.train()(to_device(batch, CPU)),
                               to_device(batch, CPU))
    loss.backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(grads) == set(want)
    assert grads["word_embedding"].shape == tm.word_embedding.shape
    assert grads["word_embedding"].abs().sum() > 0
    for name, g in grads.items():
        scale = max(1.0, float(want[name].abs().max()))
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=1e-4 * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("variant", [
    {}, dict(mpcn_affinity="BILINEAR", mpcn_head="MLP"),
    dict(mpcn_joint="D_ATT")], ids=_id)
def test_train_steps_match_jax(variant, dataset, port_dataset, monkeypatch):
    """4 steps of `make_train_step` (L2 1e-3 and clip 0.5, so both act)
    against the port's `train_step` on the same batches."""
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, variant,
                                   mpcn_dropout_keep=1.0, mpcn_l2=1e-3,
                                   mpcn_clip_norm=0.5)
    batches = list(Batcher(dataset.materialize(jh, "train"), 16))[:4]
    _fix_gumbel(monkeypatch, tm, _uniforms(jh, 16))
    opt = jax_loop.make_optimizer(jh)
    state = jax_loop.TrainState(params, opt.init(params),
                                jnp.zeros((), jnp.int32))
    step = jax_loop.make_train_step(make_apply_fn(jm), opt, "MPCN")
    port_opt = loop.make_optimizer(ph, tm)
    assert isinstance(port_opt, loop.ClippedAdam)
    tm.train()
    for b in batches:
        state, m = step(state, jax.tree_util.tree_map(jnp.asarray, b),
                        jax.random.PRNGKey(0))
        loss, sq_sum, n = loop.train_step(tm, port_opt, to_device(b, CPU))
        np.testing.assert_allclose(loss.item(), float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(sq_sum.item(), float(m["sq_sum"]),
                                   rtol=1e-5)
    want = params_from_flax(state.params)
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=5e-4,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("l2,max_norm", [(0.5, 0.05), (0.0, 1e3)],
                         ids=["clip", "no-clip"])
def test_optimizer_chain_order(l2, max_norm):
    """`ClippedAdam` is optax's chain: decay added before the clip, the
    clip g / ||g|| * max_norm. torch's Adam(weight_decay) adds the decay
    after `clip_grad_norm_`, which divides by ||g|| + 1e-6: another
    update wherever the clip triggers."""
    rng = np.random.default_rng(0)
    p0 = [rng.normal(size=(5, 3)).astype(np.float32),
          rng.normal(size=(4,)).astype(np.float32)]
    gs = [[rng.normal(size=p.shape).astype(np.float32) for p in p0]
          for _ in range(3)]
    chain = optax.chain(optax.add_decayed_weights(l2),
                        optax.clip_by_global_norm(max_norm),
                        optax.adam(1e-2))
    jp = [jnp.asarray(p) for p in p0]
    state = chain.init(jp)
    for g in gs:
        up, state = chain.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, up)

    def run(make, clip):
        ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
        opt = make(ps)
        for g in gs:
            for p, x in zip(ps, g):
                p.grad = torch.from_numpy(x.copy())
            if clip:
                torch.nn.utils.clip_grad_norm_(ps, max_norm)
            opt.step()
        return ps

    port = run(lambda ps: loop.ClippedAdam(ps, 1e-2, l2, max_norm), False)
    for p, w in zip(port, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   atol=1e-6, rtol=0)
    naive = run(lambda ps: torch.optim.Adam(ps, lr=1e-2, weight_decay=l2),
                True)
    gap = max(float(np.abs(p.detach().numpy() - np.asarray(w)).max())
              for p, w in zip(naive, jp))
    if l2:
        assert gap > 1e-4
    else:
        assert gap <= 1e-6


def test_pointer_sums_tied_padded_reviews(dataset, port_dataset):
    """Users and items with fewer than dmax reviews pad with all-zero
    reviews, whose NBOW reps tie exactly. Where a padded review wins the
    hard pointer every padded one is picked (JAX's multi-hot); the
    predictions agree with JAX's."""
    jh, ph, jm, params, tm = _pair(dataset, port_dataset,
                                   mpcn_dropout_keep=1.0, mpcn_dmax=16)
    batch = next(iter(Batcher(dataset.materialize(jh, "test"), 64)))
    pads = (batch["user_doc"].sum(-1) == 0).sum(-1)
    assert (pads >= 2).any()
    tb = to_device(batch, CPU)
    picks = []
    tm.mpcn_0.register_forward_hook(
        lambda _m, _i, out: picks.append(out[2].detach()))
    got = tm.eval()(tb).detach().numpy()
    want = np.asarray(_jax_apply(jm, params, batch, False))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (picks[0].sum(-1) > 1).any()


def _run_hp(port_dataset, tmp_path, **kw):
    return port_dataset.apply_to(PortHP(
        model_type="MPCN", epochs=2, log_dir=str(tmp_path / "l"),
        model_dir=str(tmp_path / "m"), shuffle_data_every_epoch=True,
        **dict(GEOM, **kw)))


def test_ids_cache_and_scan_steps_are_bitwise(port_dataset, tmp_path):
    """The ids-only per-example cache and scan_steps 3 train the same
    bits as the plain run (dropout 0.2 and Gumbel noise from the one
    generator)."""
    runs = {}
    for name, kw in (("plain", {}),
                     ("ids", dict(cache_doc_embeds=True, cache_sides="ids")),
                     ("ids scan3", dict(cache_doc_embeds=True,
                                        cache_sides="ids", scan_steps=3))):
        hp = _run_hp(port_dataset, tmp_path / name, **kw)
        model = port_build(hp, port_dataset.word_vectors, device="cpu")
        stats = {}
        best, mse = loop.train_complete(hp, model, port_dataset, stats=stats)
        runs[name] = (best, mse, stats["epoch_val_mse"])
    for name in ("ids", "ids scan3"):
        assert runs[name][1:] == runs["plain"][1:]
        for k, v in runs["plain"][0].items():
            assert torch.equal(v, runs[name][0][k]), (name, k)


def test_run_restore_and_serve(port_dataset, tmp_path):
    """`api.run` trains MPCN with JAX's metric keys; the checkpoint
    serves the same predictions; the grid top-k on host records equals
    the entity=True one (id grids, docs gathered from the id tables)."""
    hp = _run_hp(port_dataset, tmp_path, mpcn_l2=1e-4)
    metrics, ucm, icm = port_api.run(hp, port_dataset, device="cpu")
    assert {"MSE", "HR@1", "HR@10", "NDCG@10", "train_examples_per_s",
            "dataset"} <= set(metrics)
    assert os.path.exists(checkpoint_path(hp)) and ucm and icm
    model = restore_model(hp, port_dataset, device="cpu")
    pred = predict(hp, port_dataset, "test", model=model, device="cpu")
    y = port_dataset.splits["test"].rating
    assert abs(float(np.mean((pred - y) ** 2)) - metrics["MSE"]) <= 5e-5
    users = np.array([1, 5, 8])
    host = Recommender(hp, port_dataset, model=model, item_chunk=16,
                       device="cpu").topk(users, k=5)
    ent = Recommender(hp, port_dataset, model=model, item_chunk=16,
                      device="cpu", entity=True).topk(users, k=5)
    np.testing.assert_array_equal(host[0], ent[0])
    np.testing.assert_allclose(host[1], ent[1], atol=1e-5, rtol=0)
