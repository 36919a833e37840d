"""The port's library pieces that no model reaches, against the JAX
package's, both on the CPU: `LayerNorm`, `positional_encoding` and
`PosFFN` (`models/layers.py`, params moved across by
`weights.load_flax_params` with `strict=True`, outputs within 1e-6),
`restore_params` / `restore_like` (`train/checkpoint.py`), `save_json` /
`load_json` (`utils/io.py`), `HyperParams.num_candidates` / `vocab_rows`
and `train/losses.py::optax_sigmoid_ce`.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch.config import HyperParams as PortHP
from reviews4rec_torch.models import layers as port_layers
from reviews4rec_torch.train import checkpoint as port_ckpt
from reviews4rec_torch.train.losses import optax_sigmoid_ce
from reviews4rec_torch.utils import io as port_io
from reviews4rec_torch.weights import load_flax_params
from reviews4rec_tpu.config import HyperParams as JaxHP
from reviews4rec_tpu.models import layers as jax_layers
from reviews4rec_tpu.train.losses import optax_sigmoid_ce as jax_sigmoid_ce
from reviews4rec_tpu.utils import io as jax_io

torch.backends.cuda.matmul.allow_tf32 = False


def _moved(params, seed):
    """flax params moved off their init, so that gamma, beta and every
    bias matter."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: v + jnp.asarray(0.3 * rng.normal(size=v.shape),
                                  jnp.float32), params)


@pytest.mark.parametrize("shape,scale", [((5, 16), 3.0), ((2, 7, 12), 1e-3)])
def test_layer_norm_matches_jax(shape, scale):
    rng = np.random.default_rng(0)
    x = (scale * rng.normal(size=shape) + 2.0 * scale).astype(np.float32)
    mod = jax_layers.LayerNorm()
    params = _moved(mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
                    ["params"], 1)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    ln = port_layers.LayerNorm(shape[-1])
    load_flax_params(ln, params)
    with torch.no_grad():
        got = ln(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("length,dim,zero_pad,scale", [
    (7, 6, False, False), (7, 6, True, False), (50, 64, False, True),
    (20, 15, True, True)])
def test_positional_encoding_matches_jax(length, dim, zero_pad, scale):
    want = np.asarray(jax_layers.positional_encoding(length, dim, zero_pad,
                                                     scale))
    got = port_layers.positional_encoding(length, dim, zero_pad, scale)
    assert got.dtype == torch.float32 and got.shape == (length, dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape,hidden", [((2, 5, 8), 16), ((3, 12), 20)])
def test_pos_ffn_matches_jax(shape, hidden):
    rng = np.random.default_rng(2)
    x = rng.normal(size=shape).astype(np.float32)
    mod = jax_layers.PosFFN(hidden=hidden)
    params = _moved(mod.init(jax.random.PRNGKey(3), jnp.asarray(x))
                    ["params"], 3)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    ffn = port_layers.PosFFN(shape[-1], hidden)
    load_flax_params(ffn, params)
    with torch.no_grad():
        got = ffn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_restore_params_round_trip(tmp_path):
    gen = torch.Generator().manual_seed(0)
    model = port_layers.PosFFN(8, 16, generator=gen)
    path = str(tmp_path / "ck" / "run.ckpt.pt")
    port_ckpt.save_checkpoint(path, model.state_dict(), step=3, epoch=1)
    other = port_layers.PosFFN(8, 16, generator=torch.Generator()
                               .manual_seed(1))
    restored = port_ckpt.restore_params(path, other)
    assert set(restored) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(restored[k], v), k
    other.load_state_dict(restored)
    x = torch.randn(4, 8, generator=gen)
    assert torch.equal(other(x), model(x))
    # a state_dict template: its dtypes (and devices) are kept
    template = {k: v.double() for k, v in model.state_dict().items()}
    as64 = port_ckpt.restore_params(path, template)
    assert all(v.dtype == torch.float64 for v in as64.values())
    assert torch.equal(as64["inner.weight"],
                       model.state_dict()["inner.weight"].double())


def test_restore_like_refuses_another_layout():
    model = port_layers.PosFFN(8, 16)
    state = model.state_dict()
    with pytest.raises(ValueError, match="missing \\['ln.beta'\\]"):
        port_ckpt.restore_like(model, {k: v for k, v in state.items()
                                       if k != "ln.beta"})
    with pytest.raises(ValueError, match="unexpected \\['extra'\\]"):
        port_ckpt.restore_like(state, dict(state, extra=torch.zeros(1)))
    with pytest.raises(ValueError, match="inner.weight: shape"):
        port_ckpt.restore_like(model, dict(state, **{
            "inner.weight": torch.zeros(16, 9)}))


def test_restore_like_keeps_a_mesh_rank_s_rows():
    """On a mesh rank a row-sharded table holds the rank's rows: a whole
    table is cut to them, and the shard's shape is the one checked."""
    model = torch.nn.Module()
    model.table = torch.nn.Parameter(torch.zeros(3, 4))   # rows 3..5 of 5
    model.bias = torch.nn.Parameter(torch.zeros(4))
    model._mesh_rows = {"table"}
    model.mesh = SimpleNamespace(shape={"data": 1, "model": 2},
                                 index={"data": 0, "model": 1},
                                 model_axis="model")
    full = torch.arange(20.0).reshape(5, 4)
    got = port_ckpt.restore_like(model, {"table": full,
                                         "bias": torch.ones(4)})
    assert torch.equal(got["table"], torch.cat([full[3:],
                                                torch.zeros(1, 4)]))
    assert torch.equal(got["bias"], torch.ones(4))
    with pytest.raises(ValueError, match="table: shape"):
        port_ckpt.restore_like(model, {"table": full[:4],
                                       "bias": torch.ones(4)})


def test_json_round_trip_with_jax_s(tmp_path):
    obj = {"metrics": {"MSE": 0.5, "HR@10": 31.2}, "ks": [1, 10],
           "name": "deepconn"}
    port_path = str(tmp_path / "a" / "b" / "port.json")
    port_io.save_json(port_path, obj)
    assert jax_io.load_json(port_path) == obj
    jax_path = str(tmp_path / "c" / "jax.json")
    jax_io.save_json(jax_path, obj)
    assert port_io.load_json(jax_path) == obj


@pytest.mark.parametrize("fields", [
    dict(), dict(num_negs=99, total_words=8921),
    dict(num_negs=0, total_words=0, total_users=7, total_items=3)])
def test_derived_sizes_match_jax(fields):
    jh, ph = JaxHP(**fields), PortHP(**fields)
    assert ph.num_candidates == jh.num_candidates
    assert ph.vocab_rows == jh.vocab_rows
    assert (ph.num_user_rows, ph.num_item_rows) == (jh.num_user_rows,
                                                    jh.num_item_rows)


def test_optax_sigmoid_ce_matches_jax():
    rng = np.random.default_rng(5)
    logits = np.concatenate([rng.normal(scale=4.0, size=200),
                             [0.0, -80.0, 80.0]]).astype(np.float32)
    labels = rng.integers(0, 2, size=logits.shape).astype(np.float32)
    want = np.asarray(jax_sigmoid_ce(jnp.asarray(logits),
                                     jnp.asarray(labels)))
    got = optax_sigmoid_ce(torch.from_numpy(logits),
                           torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
