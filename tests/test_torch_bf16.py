"""`compute_dtype="bfloat16"` and `"float16"`: the port's 16-bit TextCNN
op against the JAX package's XLA TextCNN branch at that type
(`reviews4rec_tpu/models/layers.py` without `use_pallas`), both on the
CPU. Every case runs at both types unless it says otherwise.

- The op: JAX's `TextCNN` module with an identity `fc` (so its output is
  the pooled conv) under `jax.vjp`, against the port's
  `textcnn_pool(..., dtype=...)` with the plain versions of the 16-bit
  kernels. out within 1e-5 absolute; db within 1e-5; dK, which both give
  as f32 holding 16-bit values (JAX's cotangent of
  `kernel.astype(dtype)`), equal or one ulp of the type apart where the
  f32 sum, taken in another order, sits on a rounding boundary: at most
  1% of the elements (the share is printed; 0.03-0.07% on the card's bf16
  kernel against the plain version at the serving shape). At float16
  also with g scaled by 1e-6, so that dK spans f16's normal and
  subnormal values and 0.
- deepconn, deepconn++, NARRE and transnet++ from the same flax params:
  serving outputs within 1e-5, and Adam steps at dropout 0 (4 at bf16,
  8 at f16) within the bounds of tests/test_torch_train.py (losses 1e-5
  relative over the first 4 steps, 5e-5 by step 8, params 5e-4
  absolute; NARRE's attention output biases, whose gradient is 0 in
  exact arithmetic, held within steps * lr of the init, as in
  tests/test_torch_narre.py).
- The 16-bit op on `table[rows]` and on `table[ids]` gives the bits of
  the op on the gathered x, so the entity cache and the fused gather
  keep their outputs at 16 bits.
- The doc caches: JAX's and the port's cached steps at the type, and
  the port's cached steps bitwise its uncached ones.
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
            narre_num_reviews=4, narre_num_words=16, dropout=0.0)
SHIFT_FREE = {"NARRE": ("att_user.fc1.bias", "att_item.fc1.bias")}
# (JAX type, torch type, significant bits, least normal exponent)
TYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16, 8, -126),
         "float16": (jnp.float16, torch.float16, 11, -14)}
DTYPES = list(TYPES)
# Adam steps of the uncached comparison at each type
STEPS = {"bfloat16": 4, "float16": 8}


def _values(a: np.ndarray, dtype: str) -> np.ndarray:
    """The f32 values of a rounded to `dtype` by JAX's convert."""
    return np.asarray(jnp.asarray(a).astype(TYPES[dtype][0])
                      .astype(jnp.float32))


def _ulp(a: np.ndarray, dtype: str) -> np.ndarray:
    """The spacing of `dtype` at each value (its subnormals' below its
    least normal)."""
    _, _, bits, emin = TYPES[dtype]
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** emin)))
    return np.exp2(e - (bits - 1))


@pytest.mark.parametrize("b,t,e,f,w,seed", [
    (8, 40, 16, 24, 3, 0), (5, 13, 20, 100, 3, 1), (4, 30, 8, 12, 5, 2)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_op_matches_jax_xla_branch(dtype, b, t, e, f, w, seed):
    _op_vs_jax(dtype, b, t, e, f, w, seed, 1.0)


@pytest.mark.parametrize("b,t,e,f,w,seed", [
    (8, 40, 16, 24, 3, 3), (16, 50, 64, 100, 3, 4)])
def test_f16_subnormal_dk_matches_jax(b, t, e, f, w, seed):
    """g scaled by 1e-6: most dK values are f16 subnormals, some round to
    0, and both frameworks keep the subnormals."""
    jdk = _op_vs_jax("float16", b, t, e, f, w, seed, 1e-6)
    tiny = 2.0 ** TYPES["float16"][3]
    sub = (jdk != 0) & (np.abs(jdk) < tiny)
    print(f"dK subnormal {sub.mean():.2%}, zero {(jdk == 0).mean():.2%}")
    assert sub.mean() > 0.5 and (jdk == 0).any()


def _op_vs_jax(dtype, b, t, e, f, w, seed, g_scale) -> np.ndarray:
    """The 16-bit op against JAX's branch on a random case (g times
    g_scale); returns JAX's dK."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, e)).astype(np.float32)
    k = (0.2 * rng.normal(size=(w * e, f))).astype(np.float32)
    bias = (0.1 * rng.normal(size=f)).astype(np.float32)
    g = (g_scale * rng.normal(size=(b, f))).astype(np.float32)
    mod = JaxTextCNN(latent_size=f, dropout=0.0, window=w, num_filters=f,
                     compute_dtype=TYPES[dtype][0])
    params = {"conv_kernel": jnp.asarray(k), "conv_bias": jnp.asarray(bias),
              "fc": {"kernel": jnp.eye(f, dtype=jnp.float32),
                     "bias": jnp.zeros(f, jnp.float32)}}

    def fwd(xx, pp):
        return mod.apply({"params": pp}, xx, train=False)

    want, vjp = jax.vjp(fwd, jnp.asarray(x), params)
    jdx, jgrads = vjp(jnp.asarray(g))
    jdk = np.asarray(jgrads["conv_kernel"])
    np.testing.assert_array_equal(_values(jdk, dtype), jdk)

    xt = torch.from_numpy(x).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    out, _ = textcnn.textcnn_pool(xt, kt, bt, w, None, TYPES[dtype][1])
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(bt.grad.numpy(),
                               np.asarray(jgrads["conv_bias"]), atol=1e-5)
    pdk = kt.grad.numpy()
    np.testing.assert_array_equal(_values(pdk, dtype), pdk)
    diff = np.abs(pdk - jdk)
    assert (diff <= _ulp(jdk, dtype) * 1.0001).all()
    share = float((diff > 0).mean())
    print(f"dK one {dtype} ulp apart: {share:.4%} of {pdk.size}")
    assert share <= 0.01
    # dx: 16-bit values, where the same windows won
    assert np.array_equal(_values(xt.grad.numpy(), dtype), xt.grad.numpy())
    return jdk


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_are_the_f32_op_on_bf16_values(dtype):
    """At either 16-bit type, the plain versions of the forward and dG
    kernels are the f32 plain op on the 16-bit values, the dK rounded to
    the type once."""
    tdt = TYPES[dtype][1]
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(3, 11, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(24, 5)).astype(np.float32))
    bias = torch.zeros(5)
    xb, kb = x.to(tdt), k.to(tdt)
    out, idx = textcnn.textcnn_pool_forward(xb, kb, bias, 3, dtype=tdt)
    want = textcnn.textcnn_pool_reference(xb.float(), kb.float(), bias, 3)
    assert torch.equal(out, want[0]) and torch.equal(idx, want[1])
    g = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
    dk = textcnn.textcnn_pool_bwd_dg(xb, g, idx, 3, dtype=tdt)
    f32 = textcnn.textcnn_pool_backward_reference(xb.float(), kb.float(), g,
                                                  idx, 3)[1]
    assert torch.equal(dk, f32.to(tdt).float())


def test_dtype_must_be_float32_or_bfloat16():
    """The op takes float32, bfloat16 and float16 operands (float16 used
    to be refused here) and refuses any other type, naming the three."""
    x = torch.zeros(1, 4, 2)
    out, _ = textcnn.textcnn_pool(x, torch.zeros(6, 3), torch.zeros(3), 3,
                                  None, torch.float16)
    assert out.shape == (1, 3) and out.dtype == torch.float32
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        textcnn.textcnn_pool(x, torch.zeros(6, 3), torch.zeros(3), 3, None,
                             torch.float64)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rows_and_ids_gather_first_at_bf16(dtype):
    rng = np.random.default_rng(3)
    conv = PortTextCNN(8, 4, dropout=0.0, num_filters=6,
                       generator=torch.Generator().manual_seed(0),
                       compute_dtype=dtype).eval()
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


def _pair(dataset, port_dataset, mt, dtype):
    jh = dataset.apply_to(JaxHP(model_type=mt, **GEOM, compute_dtype=dtype))
    ph = port_dataset.apply_to(PortHP(model_type=mt, **GEOM,
                                      compute_dtype=dtype))
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
@pytest.mark.parametrize("dtype", DTYPES)
def test_serving_matches_jax(dtype, mt, dataset, port_dataset):
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt, dtype)
    batch = next(iter(Batcher(dataset.materialize(jh, "test"), 16)))
    want = _first(jm.apply({"params": params},
                           jax.tree_util.tree_map(jnp.asarray, batch),
                           train=False))
    # the 16-bit outputs are not the f32 ones
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
@pytest.mark.parametrize("dtype", DTYPES)
def test_adam_steps_match_jax(dtype, mt, dataset, port_dataset):
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, mt, dtype)
    init = params_from_flax(params)
    batches = list(Batcher(dataset.materialize(jh, "train"),
                           16))[:STEPS[dtype]]
    opt = jax_loop.make_optimizer(jh)
    state = jax_loop.TrainState(params, opt.init(params),
                                jnp.zeros((), jnp.int32))
    step = jax_loop.make_train_step(make_apply_fn(jm), opt, mt)
    port_opt = loop.make_optimizer(ph, tm)
    tm.train()
    for s, b in enumerate(batches):
        state, m = step(state, jax.tree_util.tree_map(jnp.asarray, b),
                        jax.random.PRNGKey(0))
        loss, sq_sum, n = loop.train_step(tm, port_opt, to_device(b, CPU))
        rtol = 1e-5 if s < 4 else 5e-5
        np.testing.assert_allclose(loss.item(), float(m["loss"]), rtol=rtol)
        np.testing.assert_allclose(sq_sum.item(), float(m["sq_sum"]),
                                   rtol=rtol)
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
# the doc caches at 16 bits: without `use_pallas` both packages cache the
# embedded docs at `compute_dtype` (`cache_dtype_for`)
# ---------------------------------------------------------------------
CACHE_STEPS = 8
# the share of a tensor's elements that may take a flipped Adam step
FLIP_SHARE = 5e-3
# (steps whose losses are held to 1e-5, the bound of all 8, filter
# columns of a conv kernel that may lie 2 * steps * lr from JAX's) of the
# cached comparison at each type; why f16's differ: the test below
CACHE_BOUNDS = {"bfloat16": (4, 5e-5, 0), "float16": (2, 2e-4, 1)}
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
@pytest.mark.parametrize("dtype", DTYPES)
def test_cached_steps_match_jax(dtype, kind, dataset, port_dataset):
    """8 steps of deepconn++ at the 16-bit type over JAX's cache
    (`make_cached_train_step`) and over the port's, both at that type,
    from the same params at dropout 0: the uncached test's bounds (losses
    1e-5 relative over the first 4 steps, params 5e-4)."""
    jh, ph, jm, params, tm = _pair(dataset, port_dataset, "deepconn++",
                                   dtype)
    if kind == "entity":
        jh = jh.replace(cache_doc_embeds=True, cache_entity=True)
        ph = ph.replace(cache_doc_embeds=True, cache_entity=True)
    assert loop.cache_dtype_for(ph) == TYPES[dtype][1]
    assert jax_loop.cache_dtype_for(jh) == TYPES[dtype][0]
    jc, pc = _caches(dataset, port_dataset, jh, ph, kind)
    docs = pc.tables if kind == "entity" else pc
    assert all(docs[k].dtype == TYPES[dtype][1] for k in DOCS)
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
    # cached steps are those steps bit for bit (the test below). At f16
    # the entity run meets a near-tie at step 3: two windows of one
    # (b, f) 1.7e-7 apart in float64, which the two frameworks' f32 sums
    # (in other orders, on params 1.5e-6 apart) rank the other way, so
    # the step routes that gradient to the other window and Adam moves
    # that filter's column of K (104 of its 192 elements) by up to 3.3 lr
    # by step 8; the losses of steps 4-8 are then up to 1.2e-4 off. So
    # f16 holds 1e-5 over the 2 steps before it and 2e-4 to the end, and
    # lets one filter column of a conv kernel move that far.
    early, late, tie_cols = CACHE_BOUNDS[dtype]
    np.testing.assert_allclose(losses[:early], want_losses[:early],
                               rtol=1e-5)
    np.testing.assert_allclose(losses, want_losses, rtol=late)
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
        cols = (np.unique(np.nonzero(far)[1]) if k.endswith("conv_kernel")
                else ())
        assert far.mean() <= FLIP_SHARE or (
            k.endswith("conv_kernel") and 0 < len(cols) <= tie_cols), \
            (k, far.mean(), len(cols))
        assert diff.max() <= 2 * CACHE_STEPS * ph.lr * 1.001, k
    print(f"{kind}: {flips} param elements beyond 5e-4")


@pytest.mark.parametrize("kind", ["per_example", "entity"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cached_steps_are_bitwise_uncached(dtype, kind, dataset,
                                           port_dataset):
    """The port's 16-bit cache against its own uncached steps at the type
    on the same records, docs embedded in the step: the same losses and
    params, bit for bit (the cast of a word row commutes with the
    gather)."""
    jh, ph, _, _, tm = _pair(dataset, port_dataset, "deepconn++", dtype)
    init = {k: v.clone() for k, v in tm.state_dict().items()}
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


# ---------------------------------------------------------------------
# every TextCNN model at float16 through `api.run` and `serve.predict`
# ---------------------------------------------------------------------
CACHES = {"uncached": {}, "per_example": dict(cache_doc_embeds=True),
          "entity": dict(cache_doc_embeds=True, cache_entity=True)}


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("mt", ["deepconn", "deepconn++", "NARRE",
                                "transnet", "transnet++"])
def test_f16_models_train_and_serve(mt, cache, port_dataset, tmp_path,
                                    monkeypatch):
    """`build_model` at `compute_dtype="float16"` (no `use_pallas`)
    trains each TextCNN model an epoch through `api.run`, uncached and
    on the per-example and entity doc caches (held at f16), every conv
    of training, validation and the test pass at f16; the restored
    checkpoint serves finite predictions."""
    from reviews4rec_torch import api as port_api
    from reviews4rec_torch.models import layers as port_layers
    from reviews4rec_torch.serve import predict

    dtypes = []
    pool = port_layers.textcnn_pool

    def counted(*args):
        dtypes.append(args[-1])
        return pool(*args)

    monkeypatch.setattr(port_layers, "textcnn_pool", counted)
    ph = port_dataset.apply_to(PortHP(
        model_type=mt, **dict(GEOM, dropout=0.5), compute_dtype="float16",
        epochs=1, log_dir=str(tmp_path), model_dir=str(tmp_path),
        **CACHES[cache]))
    if cache != "uncached":
        assert loop.cache_dtype_for(ph) == torch.float16
    metrics, _, _ = port_api.run(ph, port_dataset, device="cpu")
    assert np.isfinite(metrics["MSE"]) and metrics["MSE"] > 0
    assert dtypes and set(dtypes) == {torch.float16}
    pred = predict(ph, port_dataset, "test", device=CPU)
    assert pred.shape == (len(port_dataset.splits["test"].rating),)
    assert np.isfinite(pred).all()
