"""The port's attention library (`reviews4rec_torch/models/att.py`)
against the flax modules of `reviews4rec_tpu/models/att.py`, on the same
seeded inputs with the flax params bridged into the port
(`weights.params_from_flax`, `strict=True`):

- `CoAttention` over the 5 affinities x 5 poolings at eval, and the
  Gumbel pointer in training at fixed uniforms (outputs, and gradients
  of params and inputs within 1e-5 * max(1, max|g|));
- `hard_argmax` and the Gumbel pointer on exact ties: multi-hot, as
  JAX's `== max` pointer (not `argmax` + one-hot);
- `IntraAttention`, `ConvAttention` and `DualAttention` (its convs under
  the flax auto-names, even windows padded as JAX pads them).

Outputs within 1e-5 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch.models import att
from reviews4rec_torch.weights import params_from_flax
from reviews4rec_tpu.models import att as jax_att

torch.set_num_threads(1)
TOL = 1e-5


def _inputs(b=2, la=5, lb=7, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, la, d)).astype(np.float32),
            rng.normal(size=(b, lb, d)).astype(np.float32))


def _load(module, params):
    module.load_state_dict(params_from_flax(params), strict=True)
    return module


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


def _fixed_gumbel(logits, u, temperature):
    """JAX's straight-through Gumbel pointer at fixed uniforms `u`."""
    g = -jnp.log(-jnp.log(jnp.asarray(u)))
    y = jax.nn.softmax((logits + g) / temperature, axis=-1)
    y_hard = (y == jnp.max(y, axis=-1, keepdims=True)).astype(y.dtype)
    return jax.lax.stop_gradient(y_hard - y) + y


@pytest.mark.parametrize("pooling", jax_att.POOLINGS)
@pytest.mark.parametrize("affinity", jax_att.AFFINITIES)
def test_coattention_matches_flax(affinity, pooling):
    a, b = _inputs()
    flax_mod = jax_att.CoAttention(att_type=affinity, pooling=pooling)
    params = flax_mod.init(jax.random.PRNGKey(1), a, b)["params"]
    want = flax_mod.apply({"params": params}, a, b)
    port = _load(att.CoAttention(8, affinity, pooling), params).eval()
    got = port(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


@pytest.mark.parametrize("affinity", ["SOFT", "TENSOR", "MD"])
def test_gumbel_pointer_at_fixed_uniforms(affinity, monkeypatch):
    """In training the pointer draws its uniforms; both sides get the
    same fixed ones (JAX's `gumbel_softmax` replaced in this process).
    The hard pointer's forward and the soft sample's gradient agree."""
    a, b = _inputs(seed=3)
    rng = np.random.default_rng(4)
    us = [rng.uniform(1e-6, 1, size=(2, 5)).astype(np.float32),
          rng.uniform(1e-6, 1, size=(2, 7)).astype(np.float32)]
    calls = []

    def fixed(logits, _rng, temperature, hard=True):
        calls.append(1)
        return _fixed_gumbel(logits, us[len(calls) - 1], temperature)

    monkeypatch.setattr(jax_att, "gumbel_softmax", fixed)
    flax_mod = jax_att.CoAttention(att_type=affinity, pooling="MAX",
                                   gumbel=True)
    params = flax_mod.init(jax.random.PRNGKey(1), a, b)["params"]

    def f(p, a, b):
        fa, fb, wa, wb, _ = flax_mod.apply(
            {"params": p}, a, b, train=True,
            rngs={"gumbel": jax.random.PRNGKey(0),
                  "dropout": jax.random.PRNGKey(0)})
        return jnp.sum(fa * fa) + jnp.sum(fb) + jnp.sum(wa * wa), (wa, wb)

    (_, (wa, wb)), (gp, ga, gb) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(params, a, b)
    port = _load(att.CoAttention(8, affinity, "MAX", gumbel=True),
                 params).train()
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    fa, fb, pwa, pwb, _ = port(ta, tb, u=tuple(torch.from_numpy(u)
                                               for u in us))
    (torch.sum(fa * fa) + torch.sum(fb) + torch.sum(pwa * pwa)).backward()
    _close(pwa, wa)
    _close(pwb, wb)
    assert set(np.unique(pwa.detach().numpy())) <= {0.0, 1.0}
    want = params_from_flax(gp)
    for name, p in port.named_parameters():
        scale = max(1.0, float(want[name].abs().max()))
        _close(p.grad, want[name].numpy(), TOL * scale)
    _close(ta.grad, ga, TOL * max(1.0, float(np.abs(ga).max())))
    _close(tb.grad, gb, TOL * max(1.0, float(np.abs(gb).max())))


def test_pointers_on_exact_ties():
    """Padded reviews encode alike, so their logits tie exactly: both
    pointers give every tied position a 1, as JAX's do; argmax + one-hot
    would keep only the first."""
    logits = np.array([[0.5, 2.0, 2.0, -1.0, 2.0],
                       [0.0, 0.0, 0.0, 0.0, 0.0],
                       [3.0, 1.0, 0.0, 0.0, 0.0]], np.float32)
    want = np.asarray(jax_att.hard_argmax(jnp.asarray(logits)))
    got = att.hard_argmax(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.sum(-1), [3, 5, 1])
    one_hot = torch.nn.functional.one_hot(
        torch.from_numpy(logits).argmax(-1), 5).numpy()
    assert not np.array_equal(one_hot, got)
    # equal uniforms keep the tie through the noise
    u = np.full(logits.shape, 0.3, np.float32)
    g = att.gumbel_softmax(torch.from_numpy(logits), 0.5,
                           u=torch.from_numpy(u))
    np.testing.assert_array_equal(
        g.detach().numpy(), np.asarray(_fixed_gumbel(jnp.asarray(logits), u,
                                                     0.5)))
    np.testing.assert_array_equal(g.detach().numpy(), want)


def test_gumbel_uniforms_lie_in_jax_s_range():
    gen = torch.Generator().manual_seed(0)
    u = att.gumbel_uniform((4096,), gen, torch.device("cpu"), torch.float32)
    assert float(u.min()) >= 1e-20 and float(u.max()) < 1.0
    y = att.gumbel_softmax(torch.zeros(64, 6), 0.5, gen)
    assert torch.all(y.sum(-1) == 1.0)


def test_intra_attention_matches_flax():
    x, _ = _inputs(b=3, la=9, d=6, seed=5)
    flax_mod = jax_att.IntraAttention(dim=7, dist_bias=4)
    params = flax_mod.init(jax.random.PRNGKey(2), x)["params"]
    # a non-zero distance table, so the clipped-distance bias counts
    params = dict(params, dist_bias=jnp.arange(4, dtype=jnp.float32) * 0.3)
    want = flax_mod.apply({"params": params}, x)
    port = _load(att.IntraAttention(6, 7, 4), params)
    _close(port(torch.from_numpy(x)), want)


@pytest.mark.parametrize("window", [5, 4])
def test_conv_attention_matches_flax(window):
    x, _ = _inputs(b=3, la=11, d=6, seed=6)
    flax_mod = jax_att.ConvAttention(window=window)
    params = flax_mod.init(jax.random.PRNGKey(2), x)["params"]
    assert "_Conv1D_0" in params
    want = flax_mod.apply({"params": params}, x)
    port = _load(att.ConvAttention(6, window), params)
    _close(port(torch.from_numpy(x)), want)


def test_dual_attention_matches_flax():
    """D-ATT: local gate + window-3 CNN, global CNN over windows 2, 3, 4
    (even windows pad (w-1)//2 before), two ReLU Dense layers; forward
    and parameter gradients."""
    x, _ = _inputs(b=3, la=12, d=8, seed=7)
    flax_mod = jax_att.DualAttention(features=9)
    params = flax_mod.init(jax.random.PRNGKey(1), x)["params"]
    assert set(params["global"]) == {"_Conv1D_0", "_Conv1D_1", "_Conv1D_2"}
    want, vjp = jax.vjp(lambda p: flax_mod.apply({"params": p}, x), params)
    port = _load(att.DualAttention(8, 9), params)
    got = port(torch.from_numpy(x))
    _close(got, want)
    seed = np.random.default_rng(8).normal(size=want.shape).astype(
        np.float32)
    (gp,) = vjp(jnp.asarray(seed))
    (got * torch.from_numpy(seed)).sum().backward()
    want_g = params_from_flax(gp)
    for name, p in port.named_parameters():
        _close(p.grad, want_g[name].numpy(),
               TOL * max(1.0, float(want_g[name].abs().max())))
