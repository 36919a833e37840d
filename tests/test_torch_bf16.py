"""`compute_dtype="bfloat16"`: the port's bf16 TextCNN op against the JAX
package's XLA TextCNN branch at bf16 (`reviews4rec_tpu/models/layers.py`
without `use_pallas`), both on the CPU.

- The op: JAX's `TextCNN` module with an identity `fc` (so its output is
  the pooled conv) under `jax.vjp`, against the port's
  `textcnn_pool(..., dtype=torch.bfloat16)` with the plain versions of
  the bf16 kernels. out within 1e-5 absolute; db within 1e-5; dK, which
  both give as f32 holding bf16 values (JAX's cotangent of
  `kernel.astype(bfloat16)`), equal or one bf16 ulp apart where the f32
  sum, taken in another order, sits on a rounding boundary: at most 1%
  of the elements (the share is printed; 0.03-0.07% on the card's
  kernel against the plain version at the serving shape).
- deepconn, deepconn++, NARRE and transnet++ at bf16 from the same flax
  params: serving outputs within 1e-5, and 4 Adam steps at dropout 0
  within the bounds of tests/test_torch_train.py (losses 1e-5 relative,
  params 5e-4 absolute; NARRE's attention output biases, whose gradient
  is 0 in exact arithmetic, held within steps * lr of the init, as in
  tests/test_torch_narre.py).
- The bf16 op on `table[rows]` and on `table[ids]` gives the bits of the
  op on the gathered x, so the entity cache and the fused gather keep
  their outputs at bf16.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.data import ReviewDataset as PortDataset
from reviews4rec_torch.models import build_model as port_build
from reviews4rec_torch.models.layers import TextCNN as PortTextCNN
from reviews4rec_torch.ops import textcnn
from reviews4rec_torch.train import loop
from reviews4rec_torch.utils.device import to_device
from reviews4rec_torch.weights import load_flax_params, params_from_flax
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.data.batcher import Batcher
from reviews4rec_tpu.models import build_model as jax_build
from reviews4rec_tpu.models.layers import TextCNN as JaxTextCNN
from reviews4rec_tpu.train import loop as jax_loop
from reviews4rec_tpu.train.evaluate import make_apply_fn

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)
CPU = torch.device("cpu")
GEOM = dict(batch_size=16, input_length=64, latent_size=8,
            narre_num_reviews=4, narre_num_words=16, dropout=0.0,
            compute_dtype="bfloat16")
SHIFT_FREE = {"NARRE": ("att_user.fc1.bias", "att_item.fc1.bias")}


def _bf16_values(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _ulp_bf16(a: np.ndarray) -> np.ndarray:
    """The bf16 spacing at each value (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("b,t,e,f,w,seed", [
    (8, 40, 16, 24, 3, 0), (5, 13, 20, 100, 3, 1), (4, 30, 8, 12, 5, 2)])
def test_op_matches_jax_xla_branch(b, t, e, f, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, e)).astype(np.float32)
    k = (0.2 * rng.normal(size=(w * e, f))).astype(np.float32)
    bias = (0.1 * rng.normal(size=f)).astype(np.float32)
    g = rng.normal(size=(b, f)).astype(np.float32)
    mod = JaxTextCNN(latent_size=f, dropout=0.0, window=w, num_filters=f,
                     compute_dtype=jnp.bfloat16)
    params = {"conv_kernel": jnp.asarray(k), "conv_bias": jnp.asarray(bias),
              "fc": {"kernel": jnp.eye(f, dtype=jnp.float32),
                     "bias": jnp.zeros(f, jnp.float32)}}

    def fwd(xx, pp):
        return mod.apply({"params": pp}, xx, train=False)

    want, vjp = jax.vjp(fwd, jnp.asarray(x), params)
    jdx, jgrads = vjp(jnp.asarray(g))
    jdk = np.asarray(jgrads["conv_kernel"])
    np.testing.assert_array_equal(_bf16_values(jdk), jdk)

    xt = torch.from_numpy(x).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    out, _ = textcnn.textcnn_pool(xt, kt, bt, w, None, torch.bfloat16)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(bt.grad.numpy(),
                               np.asarray(jgrads["conv_bias"]), atol=1e-5)
    pdk = kt.grad.numpy()
    np.testing.assert_array_equal(_bf16_values(pdk), pdk)
    diff = np.abs(pdk - jdk)
    assert (diff <= _ulp_bf16(jdk) * 1.0001).all()
    share = float((diff > 0).mean())
    print(f"dK one bf16 ulp apart: {share:.4%} of {pdk.size}")
    assert share <= 0.01
    # dx: bf16 values, where the same windows won
    assert np.array_equal(_bf16_values(xt.grad.numpy()), xt.grad.numpy())


def test_plain_versions_are_the_f32_op_on_bf16_values():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(3, 11, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(24, 5)).astype(np.float32))
    bias = torch.zeros(5)
    xb, kb = x.to(torch.bfloat16), k.to(torch.bfloat16)
    out, idx = textcnn.textcnn_pool_forward_bf16(xb, kb, bias, 3)
    want = textcnn.textcnn_pool_reference(xb.float(), kb.float(), bias, 3)
    assert torch.equal(out, want[0]) and torch.equal(idx, want[1])
    g = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
    dk = textcnn.textcnn_pool_bwd_dg_bf16(xb, g, idx, 3)
    f32 = textcnn.textcnn_pool_backward_reference(xb.float(), kb.float(), g,
                                                  idx, 3)[1]
    assert torch.equal(dk, f32.to(torch.bfloat16).float())


def test_dtype_must_be_float32_or_bfloat16():
    x = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        textcnn.textcnn_pool(x, torch.zeros(6, 3), torch.zeros(3), 3, None,
                             torch.float16)


def test_rows_and_ids_gather_first_at_bf16():
    rng = np.random.default_rng(3)
    conv = PortTextCNN(8, 4, dropout=0.0, num_filters=6,
                       generator=torch.Generator().manual_seed(0),
                       compute_dtype="bfloat16").eval()
    table = torch.from_numpy(rng.normal(size=(20, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 20, size=(5, 9)))
    docs = table[ids]
    rows = torch.tensor([4, 0, 2], dtype=torch.int32)
    skip = torch.tensor([[1, 2], [0, 0], [3, 9]], dtype=torch.int32)
    with torch.no_grad():
        want = conv(docs)
        assert torch.equal(conv(ids, table=table), want)
        assert torch.equal(conv(docs, rows=rows, skip=skip),
                           conv(docs[rows.long()], skip=skip))
        assert torch.equal(conv(ids, table=table, rows=rows),
                           want[rows.long()])


@pytest.fixture(scope="module")
def port_dataset(dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    dataset.save(str(d))
    return PortDataset.load(str(d))


def _pair(dataset, port_dataset, mt):
    jh = dataset.apply_to(JaxHP(model_type=mt, **GEOM))
    ph = port_dataset.apply_to(PortHP(model_type=mt, **GEOM))
    jm = jax_build(jh, dataset.word_vectors)
    sample = next(iter(Batcher(dataset.materialize(jh, "train"), 4)))
    params = jm.init({"params": jax.random.PRNGKey(3),
                      "dropout": jax.random.PRNGKey(4)},
                     jax.tree_util.tree_map(jnp.asarray, sample),
                     train=False)["params"]
    tm = port_build(ph, port_dataset.word_vectors, device="cpu")
    load_flax_params(tm, params)
    return jh, ph, jm, params, tm


def _first(y):
    return y[0] if isinstance(y, tuple) else y


MODELS = ["deepconn", "deepconn++", "NARRE", "transnet++"]


@pytest.mark.parametrize("mt", MODELS)
def test_serving_matches_jax(mt, dataset, port_dataset):
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt)
    batch = next(iter(Batcher(dataset.materialize(jh, "test"), 16)))
    want = _first(jm.apply({"params": params},
                           jax.tree_util.tree_map(jnp.asarray, batch),
                           train=False))
    # the bf16 outputs are not the f32 ones
    f32 = jax_build(jh.replace(compute_dtype="float32"), dataset.word_vectors)
    other = _first(f32.apply({"params": params},
                             jax.tree_util.tree_map(jnp.asarray, batch),
                             train=False))
    assert np.abs(np.asarray(other) - np.asarray(want)).max() > 1e-6
    tm.eval()
    with torch.no_grad():
        got = _first(tm(to_device(batch, CPU)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("mt", MODELS)
def test_adam_steps_match_jax(mt, dataset, port_dataset):
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt)
    init = params_from_flax(params)
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
        if k in SHIFT_FREE.get(mt, ()):
            for side in (got[k], want[k]):
                assert (side - init[k]).abs().max().item() <= \
                    len(batches) * ph.lr * 1.001, k
            continue
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=5e-4, rtol=0, err_msg=k)


# ---------------------------------------------------------------------
# the doc caches at bf16: without `use_pallas` both packages cache the
# embedded docs at `compute_dtype` (`cache_dtype_for`)
# ---------------------------------------------------------------------
CACHE_STEPS = 8
# the share of a tensor's elements that may take a flipped Adam step
FLIP_SHARE = 5e-3
DOCS = ("user_doc", "item_doc")


def _caches(dataset, port_dataset, jh, ph, kind, id_keys=()):
    """JAX's and the port's train cache of `kind` ("per_example" or
    "entity") at each package's `cache_dtype_for`; the port's keeps the
    docs of `id_keys` as ids, embedded in the step."""
    jdt, pdt = jax_loop.cache_dtype_for(jh), loop.cache_dtype_for(ph)
    keys = tuple(k for k in DOCS if k not in id_keys)
    if kind == "entity":
        (ud, _), (it, _) = dataset._entity_spans(jh.input_length)
        jc = jax_loop.build_entity_cache(
            dataset.materialize_entity(jh, "train"),
            {"user_doc": ud, "item_doc": it}, dataset.word_vectors, jdt,
            keys=DOCS)
        (ud, _), (it, _) = port_dataset._entity_spans(ph.input_length)
        pc = loop.build_entity_cache(
            port_dataset.materialize_entity(ph, "train"),
            {"user_doc": ud, "item_doc": it}, port_dataset.word_vectors, pdt,
            CPU, keys=keys, id_keys=id_keys)
        return jc, pc
    jc = jax_loop.build_doc_cache(dataset.materialize(jh, "train"),
                                  dataset.word_vectors, jdt, keys=DOCS)
    pc = loop.build_doc_cache(port_dataset.materialize(ph, "train"),
                              port_dataset.word_vectors, pdt, CPU, keys=keys,
                              id_keys=id_keys)
    return jc, pc


def _cached_steps(tm, ph, cache, steps=CACHE_STEPS):
    """`steps` port steps over row batches 0.. of a device cache: the
    losses and the final params."""
    opt = loop.make_optimizer(ph, tm)
    tm.train()
    bs, losses = ph.batch_size, []
    for s in range(steps):
        rows = torch.arange(s * bs, (s + 1) * bs)
        losses.append(loop.train_step(tm, opt, loop.gather_cached_batch(
            cache, rows, torch.ones(bs)))[0].item())
    return losses, {k: v.clone() for k, v in tm.state_dict().items()}


@pytest.mark.parametrize("kind", ["per_example", "entity"])
def test_cached_steps_match_jax(kind, dataset, port_dataset):
    """8 steps of deepconn++ at bf16 over JAX's cache
    (`make_cached_train_step`) and over the port's, both at bf16, from the
    same params at dropout 0: the uncached bf16 test's bounds (losses
    1e-5 relative over the first 4 steps, params 5e-4)."""
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, "deepconn++")
    if kind == "entity":
        jh = jh.replace(cache_doc_embeds=True, cache_entity=True)
        ph = ph.replace(cache_doc_embeds=True, cache_entity=True)
    assert loop.cache_dtype_for(ph) == torch.bfloat16
    assert jax_loop.cache_dtype_for(jh) == jnp.bfloat16
    jc, pc = _caches(dataset, port_dataset, jh, ph, kind)
    docs = pc.tables if kind == "entity" else pc
    assert all(docs[k].dtype == torch.bfloat16 for k in DOCS)
    opt = jax_loop.make_optimizer(jh)
    state = jax_loop.TrainState(params, opt.init(params),
                                jnp.zeros((), jnp.int32))
    step = jax_loop.make_cached_train_step(make_apply_fn(jm), opt,
                                           "deepconn++")
    bs, want_losses = ph.batch_size, []
    for s in range(CACHE_STEPS):
        rows = np.arange(s * bs, (s + 1) * bs)
        state, m = step(state, jc, jnp.asarray(rows, jnp.int32),
                        jnp.ones(bs, jnp.float32), jax.random.PRNGKey(0))
        want_losses.append(float(m["loss"]))
    losses, got = _cached_steps(tm, ph, pc)
    # the uncached test's bound over its 4 steps; from step 5 on the
    # uncached bf16 steps themselves drift further (1.9e-5 relative at
    # step 7, where a bf16 rounding of K falls the other way), and the
    # cached steps are those steps bit for bit (the test below)
    np.testing.assert_allclose(losses[:4], want_losses[:4], rtol=1e-5)
    np.testing.assert_allclose(losses, want_losses, rtol=5e-5)
    want = params_from_flax(state.params)
    assert set(got) == set(want)
    flips = 0
    for k in want:
        diff = np.abs(got[k].numpy() - want[k].numpy())
        # an element whose gradient sums to about 0 can take its Adam
        # step the other way when the bf16 dK rounds an f32 sum taken in
        # another order (the entity docs zero the pair's own review, so
        # many item windows are 0): at most 2 * steps * lr apart
        far = diff > 5e-4
        flips += int(far.sum())
        assert far.mean() <= FLIP_SHARE, (k, far.mean())
        assert diff.max() <= 2 * CACHE_STEPS * ph.lr * 1.001, k
    print(f"{kind}: {flips} param elements beyond 5e-4")


@pytest.mark.parametrize("kind", ["per_example", "entity"])
def test_cached_steps_are_bitwise_uncached(kind, dataset, port_dataset):
    """The port's bf16 cache against its own uncached bf16 steps on the
    same records, docs embedded in the step: the same losses and params,
    bit for bit (the bf16 cast of a word row commutes with the gather)."""
    _, ph, _, _, tm = _pair(dataset, port_dataset, "deepconn++")
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    jh = dataset.apply_to(JaxHP(model_type="deepconn++", **GEOM))
    _, cached = _caches(dataset, port_dataset, jh, ph, kind)
    _, ids = _caches(dataset, port_dataset, jh, ph, kind, id_keys=DOCS)
    docs = ids.tables if kind == "entity" else ids
    assert all(not docs[k].is_floating_point() for k in DOCS)
    got = _cached_steps(tm, ph, cached)
    tm.load_state_dict(init)
    want = _cached_steps(tm, ph, ids)
    assert got[0] == want[0]
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
