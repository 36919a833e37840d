"""The gradient of the port's TextCNN pooling op against the JAX
package's: `jax.vjp` of `reviews4rec_tpu.ops.textcnn_pallas.textcnn_pool`
(Pallas kernels in interpret mode, f32) and of the flax TextCNN's XLA
branch, on the same numpy-seeded inputs and cotangents.

Tolerances: dK and dx within 1e-4 absolute, db within 1e-5 (f32 sums in
another order; every input is O(1)); exactly equal on integer-valued
inputs, where every sum is exact in any order.

The port routes each (b, f) cotangent to idx, the lowest winning start.
So do the JAX generic path and, where windows tie only when their
content is equal (real docs: padding, repeated n-grams), the XLA
branch, whose `jnp.max` splits a tie evenly over equal taps. The paired
path's idx keeps the even start of an odd/even tie, which moves dx (and
dK, where tied windows differ in content): one case pins that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch.models.layers import TextCNN as PortTextCNN
from reviews4rec_torch.ops import textcnn
from reviews4rec_torch.ops.textcnn import (textcnn_pool,
                                           textcnn_pool_backward_reference,
                                           textcnn_pool_reference)
from reviews4rec_torch.train import profiler
from reviews4rec_torch.weights import load_flax_params
from reviews4rec_tpu.models.layers import TextCNN as JaxTextCNN
from reviews4rec_tpu.ops.textcnn_pallas import textcnn_pool as jax_pool

torch.backends.cuda.matmul.allow_tf32 = False
# small shapes: one torch thread, so the test workers running beside
# this one (JAX meshes on virtual CPU devices) keep their cores
torch.set_num_threads(1)


def _inputs(b, t, e, f, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, e)).astype(np.float32)
    k = (rng.normal(size=(w * e, f)) / np.sqrt(w * e)).astype(np.float32)
    bias = rng.normal(size=(f,)).astype(np.float32)
    g = rng.normal(size=(b, f)).astype(np.float32)
    return x, k, bias, g


def _tie_inputs(b, t, e, f, w, seed):
    """Integer-valued: repeated words make exact ties, row 0 is all
    zeros, and a third of the cotangents are 0."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-2, 3, size=(4, e)).astype(np.float32)
    x = words[rng.integers(0, 4, size=(b, t))]
    x[0] = 0.0
    k = rng.integers(-1, 2, size=(w * e, f)).astype(np.float32)
    bias = rng.integers(-3, 4, size=f).astype(np.float32)
    g = rng.integers(-3, 4, size=(b, f)).astype(np.float32)
    g[rng.random((b, f)) < 1 / 3] = 0.0
    return x, k, bias, g


def _port_grads(x, k, bias, g, w, skip=None, need_dx=True):
    """(dx, dK, db) of the plain backward, gating g by out > 0."""
    tx, tk, tb = (torch.from_numpy(a) for a in (x, k, bias))
    sk = None if skip is None else torch.from_numpy(skip)
    out, idx = textcnn_pool_reference(tx, tk, tb, w, sk)
    gated = torch.where(out > 0, torch.from_numpy(g), 0.0)
    dx, dk, db = textcnn_pool_backward_reference(tx, tk, gated, idx, w, sk,
                                                 need_dx)
    return (None if dx is None else dx.numpy()), dk.numpy(), db.numpy()


def _jax_grads(x, k, bias, g, w, need_dx=True):
    _, vjp = jax.vjp(lambda xx, kk, bb: jax_pool(xx, kk, bb, w, True,
                                                 jnp.float32, need_dx),
                     jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    return tuple(np.asarray(a) for a in vjp(jnp.asarray(g)))


def _close(got, want, exact=False, atol=1e-4, what=""):
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                   err_msg=what)


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("shape", [(4, 130, 3), (37, 40, 3), (3, 100, 2),
                                   (40, 100, 3)])
def test_paired_backward_matches_jax(shape, need_dx):
    """E=64, W<=3: JAX runs `_backward_paired` (need_dx) or
    `_dg_only_from_xp` (not), both Pallas kernels in interpret mode. The
    last shape is the NARRE tower's docs ([B*10, 100] words) scaled
    down."""
    b, t, w = shape
    x, k, bias, g = _inputs(b, t, 64, 100, w, seed=b + t)
    dx, dk, db = _port_grads(x, k, bias, g, w, need_dx=need_dx)
    jdx, jdk, jdb = _jax_grads(x, k, bias, g, w, need_dx)
    _close(dk, jdk, what="dK")
    _close(db, jdb, atol=1e-5, what="db")
    if need_dx:
        _close(dx, jdx, what="dx")
    else:
        assert dx is None
        np.testing.assert_array_equal(jdx, 0.0)   # JAX's symbolic zeros


@pytest.mark.parametrize("shape", [(3, 90, 32, 5), (5, 57, 16, 3),
                                   (2, 33, 5, 8), (3, 40, 256, 3)])
def test_generic_backward_matches_jax(shape):
    """E != 64 or W > 3: JAX runs `_kernel` and the XLA gather/scatter
    backward (`textcnn_pallas.py:702-718`). E=256 spans several passes of
    the dG kernel's warp."""
    b, t, e, w = shape
    x, k, bias, g = _inputs(b, t, e, 24, w, seed=t)
    dx, dk, db = _port_grads(x, k, bias, g, w)
    jdx, jdk, jdb = _jax_grads(x, k, bias, g, w)
    _close(dk, jdk, what="dK")
    _close(db, jdb, atol=1e-5, what="db")
    _close(dx, jdx, what="dx")


def test_forced_ties_are_exact():
    """E=32 (generic, first argmax on both sides), integer inputs with
    exact ties and gated-off cotangents: every gradient bit-equal."""
    x, k, bias, g = _tie_inputs(6, 70, 32, 20, 3, seed=4)
    dx, dk, db = _port_grads(x, k, bias, g, 3)
    jdx, jdk, jdb = _jax_grads(x, k, bias, g, 3)
    _close(dk, jdk, exact=True, what="dK")
    _close(db, jdb, exact=True, what="db")
    _close(dx, jdx, exact=True, what="dx")


def test_paired_tie_moves_dx_not_equal_taps():
    """The tie of `test_torch_textcnn.py::test_paired_kernel_tie_prefers_
    even_start`: the same word at positions 1 and 4, only tap 0 of K
    non-zero, winning starts 3 (port) and 6 (paired kernel). The tied
    windows hold the same words, so dK and db agree; dx goes to word 1
    in the port and to word 4 in the paired backward."""
    b, t, e, f, w = 1, 20, 64, 4, 3
    x = np.zeros((b, t, e), np.float32)
    x[0, 1] = x[0, 4] = 1.0
    k = np.zeros((w * e, f), np.float32)
    k[:e] = 1.0
    bias = np.zeros(f, np.float32)
    g = np.ones((b, f), np.float32)
    dx, dk, db = _port_grads(x, k, bias, g, w)
    jdx, jdk, jdb = _jax_grads(x, k, bias, g, w)
    _close(dk, jdk, exact=True)
    _close(db, jdb, exact=True)
    rows = lambda d: np.nonzero(np.abs(d[0]).sum(1))[0].tolist()  # noqa
    assert rows(dx) == [1] and rows(jdx) == [4]


def test_skip_spans_match_value_level_mask():
    """skip (start, len) spans against JAX's value-level mask
    (`models/layers.py:126-131`) in front of the op: dK and db as on the
    masked doc, dx zero inside the span (the mask's own gradient)."""
    b, t, e, f, w = 5, 70, 64, 30, 3
    x, k, bias, g = _inputs(b, t, e, f, w, seed=7)
    skip = np.asarray([[0, 0], [3, 7], [0, 70], [65, 20], [10, 1]],
                      np.int32)
    dx, dk, db = _port_grads(x, k, bias, g, w, skip=skip)

    ts = jnp.arange(t)[None, :]
    m = (ts >= skip[:, :1]) & (ts < skip[:, :1] + skip[:, 1:2])

    def masked(xx, kk, bb):
        return jax_pool(jnp.where(m[..., None], 0.0, xx), kk, bb, w, True,
                        jnp.float32, True)

    _, vjp = jax.vjp(masked, jnp.asarray(x), jnp.asarray(k),
                     jnp.asarray(bias))
    jdx, jdk, jdb = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    _close(dk, jdk, what="dK")
    _close(db, jdb, atol=1e-5, what="db")
    _close(dx, jdx, what="dx")
    np.testing.assert_array_equal(dx[2], 0.0)        # whole doc skipped


def test_need_dx_false_gives_the_same_dk():
    for e, t in [(64, 70), (16, 40)]:
        x, k, bias, g = _inputs(4, t, e, 100, 3, seed=9)
        dx1, dk1, db1 = _port_grads(x, k, bias, g, 3, need_dx=True)
        dx0, dk0, db0 = _port_grads(x, k, bias, g, 3, need_dx=False)
        assert dx1 is not None and dx0 is None
        np.testing.assert_array_equal(dk0, dk1)
        np.testing.assert_array_equal(db0, db1)


@pytest.mark.parametrize("with_skip", [False, True])
def test_autograd_function_equals_plain_backward(with_skip):
    """`textcnn_pool` (the TextCNNPool autograd function) under
    `backward()` gives the plain backward's gradients, bit for bit, and
    launches no kernel on the CPU."""
    b, t, e, f, w = 6, 50, 16, 12, 3
    x, k, bias, g = _inputs(b, t, e, f, w, seed=3)
    skip = np.asarray([[4, 9]] * b, np.int32) if with_skip else None
    before = dict(profiler.counters)
    tx, tk, tb = (torch.from_numpy(a).requires_grad_() for a in (x, k, bias))
    sk = None if skip is None else torch.from_numpy(skip)
    out, idx = textcnn_pool(tx, tk, tb, w, sk)
    assert not idx.requires_grad
    out.backward(torch.from_numpy(g))
    dx, dk, db = _port_grads(x, k, bias, g, w, skip=skip)
    np.testing.assert_array_equal(tx.grad.numpy(), dx)
    np.testing.assert_array_equal(tk.grad.numpy(), dk)
    np.testing.assert_array_equal(tb.grad.numpy(), db)
    assert profiler.counters == before


def test_no_dx_when_x_needs_no_grad(monkeypatch):
    """x without requires_grad (an embedding of the frozen table): the
    backward never computes dx, as JAX's need_dx=False."""
    def fail(*_a, **_k):
        raise AssertionError("dx computed for an x that needs no grad")

    monkeypatch.setattr(textcnn, "textcnn_pool_bwd_dx", fail)
    x, k, bias, g = _inputs(3, 40, 16, 8, 3, seed=5)
    tx = torch.from_numpy(x)
    tk, tb = (torch.from_numpy(a).requires_grad_() for a in (k, bias))
    out, _ = textcnn_pool(tx, tk, tb, 3)
    out.backward(torch.from_numpy(g))
    assert tx.grad is None
    _, dk, db = _port_grads(x, k, bias, g, 3, need_dx=False)
    np.testing.assert_array_equal(tk.grad.numpy(), dk)
    np.testing.assert_array_equal(tb.grad.numpy(), db)


@pytest.mark.parametrize("e", [64, 32])
def test_textcnn_layer_grads_match_xla_branch(e):
    """The port's TextCNN layer (op + fc, dropout 0) under autograd
    against `jax.vjp` of the flax TextCNN's XLA branch
    (use_pallas=False, `models/layers.py:174-190`), params bridged:
    the gradients of the conv, the fc and x."""
    b, t, f, w, latent = 5, 60, 100, 3, 8
    rng = np.random.default_rng(e)
    x = rng.normal(size=(b, t, e)).astype(np.float32)
    cot = rng.normal(size=(b, latent)).astype(np.float32)
    jm = JaxTextCNN(latent, dropout=0.0, num_filters=f, window=w)
    params = jm.init(jax.random.PRNGKey(e), jnp.asarray(x))["params"]

    def f_jax(p, xx):
        return jm.apply({"params": p}, xx)

    _, vjp = jax.vjp(f_jax, params, jnp.asarray(x))
    jp, jx = vjp(jnp.asarray(cot))

    pm = PortTextCNN(e, latent, dropout=0.0, num_filters=f, window=w)
    load_flax_params(pm, params)
    tx = torch.from_numpy(x).requires_grad_()
    pm(tx).backward(torch.from_numpy(cot))
    _close(tx.grad.numpy(), np.asarray(jx), what="dx")
    _close(pm.conv_kernel.grad.numpy(), np.asarray(jp["conv_kernel"]),
           what="dK")
    _close(pm.conv_bias.grad.numpy(), np.asarray(jp["conv_bias"]),
           atol=1e-5, what="db")
    _close(pm.fc.weight.grad.numpy(), np.asarray(jp["fc"]["kernel"]).T,
           what="fc")
