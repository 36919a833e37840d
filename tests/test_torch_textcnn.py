"""The port's TextCNN pooling op against the JAX package's Pallas
forwards (interpret mode on the CPU), on the same numpy-seeded inputs.

Tolerances: `out` within 1e-4 absolute (f32 sums in another order);
`idx` exactly equal to `_forward_generic` (`_kernel`), which like the
port returns the lowest winning start. `_forward` at E=64, W<=3 runs
`_paired_kernel`, which keeps the EVEN start of an exact odd/even tie
inside one 256-start chunk; its `idx` is compared only on inputs
without exact ties, and one case pins that behaviour.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch.ops import textcnn
from reviews4rec_torch.ops.textcnn import (textcnn_pool,
                                           textcnn_pool_reference)
from reviews4rec_torch.train import profiler
from reviews4rec_tpu.ops.textcnn_pallas import _forward, _forward_generic

torch.backends.cuda.matmul.allow_tf32 = False
# small shapes: one torch thread, so the test workers running beside
# this one (JAX meshes on virtual CPU devices) keep their cores
torch.set_num_threads(1)


def _inputs(b, t, e, f, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, e)).astype(np.float32)
    k = (rng.normal(size=(w * e, f)) / np.sqrt(w * e)).astype(np.float32)
    bias = rng.normal(size=(f,)).astype(np.float32)
    return x, k, bias


def _port(x, k, bias, w, skip=None):
    out, idx = textcnn_pool_reference(
        torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias), w,
        None if skip is None else torch.from_numpy(skip))
    return out.numpy(), idx.numpy()


def _jax(fn, x, k, bias, w):
    out, idx = fn(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), w, True)
    return np.asarray(out), np.asarray(idx)


# (B, T, E, W): the shapes of tests/test_pallas.py's forward parity, a B
# that is not a multiple of the 32-row batch tile, E=32 with W=5
# (generic kernel only), and T=100
SHAPES = [(4, 37, 8, 3), (2, 130, 16, 3), (3, 260, 8, 3), (2, 100, 64, 3),
          (3, 257, 64, 3), (5, 1000, 64, 3), (37, 40, 64, 3),
          (3, 90, 32, 5), (4, 100, 64, 2)]


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_pallas_forwards(shape):
    b, t, e, w = shape
    f = 16 if e < 64 else 100
    x, k, bias = _inputs(b, t, e, f, w, seed=sum(shape))
    out, idx = _port(x, k, bias, w)
    assert out.shape == (b, f) and idx.dtype == np.int32

    g_out, g_idx = _jax(_forward_generic, x, k, bias, w)
    np.testing.assert_allclose(out, g_out, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(idx, g_idx)

    # random normal inputs hold no exact ties, so the paired kernel's
    # tie rule cannot show: its idx must agree too
    p_out, p_idx = _jax(_forward, x, k, bias, w)
    np.testing.assert_allclose(out, p_out, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(idx, p_idx)
    assert np.all(idx >= 0) and np.all(idx < t + w - 1)


def test_paired_kernel_tie_prefers_even_start():
    """The same word at positions 1 and 4 with only tap 0 non-zero: the
    winning starts are 3 and 6 (padded coordinates). `_kernel` and the
    port return 3, the first; `_paired_kernel` returns 6, the even one
    of the tie inside its chunk. Values agree."""
    b, t, e, f, w = 1, 20, 64, 4, 3
    x = np.zeros((b, t, e), np.float32)
    x[0, 1] = x[0, 4] = 1.0
    k = np.zeros((w * e, f), np.float32)
    k[:e] = 1.0
    bias = np.zeros(f, np.float32)
    out, idx = _port(x, k, bias, w)
    g_out, g_idx = _jax(_forward_generic, x, k, bias, w)
    p_out, p_idx = _jax(_forward, x, k, bias, w)
    np.testing.assert_array_equal(out, np.full((1, f), 64.0, np.float32))
    np.testing.assert_array_equal(g_out, out)
    np.testing.assert_array_equal(p_out, out)
    np.testing.assert_array_equal(idx, np.full((1, f), 3))
    np.testing.assert_array_equal(g_idx, idx)
    np.testing.assert_array_equal(p_idx, np.full((1, f), 6))


@pytest.mark.parametrize("e", [64, 16])
def test_forced_ties_take_the_first_start(e):
    """Integer-valued inputs (exact in f32 in any summation order) with
    repeated words and an all-zero doc: every exact tie goes to the
    lowest start, as `_kernel` does."""
    rng = np.random.default_rng(5)
    b, t, f, w = 3, 70, 8, 3
    words = rng.integers(-2, 3, size=(4, e)).astype(np.float32)
    x = words[rng.integers(0, 4, size=(b, t))]
    x[2] = 0.0                                     # all-zero doc
    k = rng.integers(-1, 2, size=(w * e, f)).astype(np.float32)
    bias = rng.integers(-3, 4, size=f).astype(np.float32)
    out, idx = _port(x, k, bias, w)
    g_out, g_idx = _jax(_forward_generic, x, k, bias, w)
    np.testing.assert_array_equal(out, g_out)
    np.testing.assert_array_equal(idx, g_idx)
    # the zero doc: every start gives relu(bias), the first is 0
    np.testing.assert_array_equal(out[2], np.maximum(bias, 0))
    np.testing.assert_array_equal(idx[2], np.zeros(f))


def test_skip_spans_match_value_level_mask():
    """skip (start, len) zeroes that word span first, as the JAX
    TextCNN's value-level mask (models/layers.py) does before the conv;
    len 0 masks nothing, a span past the end is cut."""
    b, t, e, f, w = 5, 120, 64, 100, 3
    x, k, bias = _inputs(b, t, e, f, w, seed=11)
    skip = np.asarray([[10, 30], [0, 0], [100, 50], [0, 120], [60, 1]],
                      np.int32)
    out, idx = _port(x, k, bias, w, skip)

    ts = jnp.arange(t)[None, :]
    st, ln = jnp.asarray(skip[:, :1]), jnp.asarray(skip[:, 1:2])
    xm = jnp.where(((ts >= st) & (ts < st + ln))[..., None], 0.0,
                   jnp.asarray(x))
    g_out, g_idx = _forward_generic(xm, jnp.asarray(k), jnp.asarray(bias),
                                    w, True)
    np.testing.assert_allclose(out, np.asarray(g_out), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(idx, np.asarray(g_idx))


def test_wrapper_on_cpu_runs_the_plain_version():
    x, k, bias = _inputs(3, 50, 16, 8, 3, seed=2)
    before = dict(profiler.counters)
    out, idx = textcnn_pool(torch.from_numpy(x), torch.from_numpy(k),
                            torch.from_numpy(bias), 3)
    ref_out, ref_idx = _port(x, k, bias, 3)
    np.testing.assert_array_equal(out.numpy(), ref_out)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    assert profiler.counters == before       # no kernel ran
    with pytest.raises(ValueError):
        textcnn_pool(torch.empty((1, 4, 2), device="meta"),
                     torch.empty((6, 3), device="meta"),
                     torch.empty((3,), device="meta"), 3)

