"""The order of the dx kernel's sums (`csrc/textcnn_pool_bwd_dx.cu`),
emulated on the CPU: per item of (b, up to 256 output rows, a doc's items
of equal size), a bit mask over
the filters for each window start (the lanes of a 32-filter word grouped
by start, as `__match_any_sync` groups them), each row's mask the OR of
the W start masks whose windows cover it (none inside the skip span), and
each row summed from 0 with one fma a set bit, in ascending f. The rows'
tap lists must come out in (f, w) order, and the result must agree with
`jax.vjp` of the JAX package's `textcnn_pool` with `need_dx=True` (within
1e-5: f32 sums in another order; exact on integer inputs, which reach
JAX's generic path) and with the port's plain `_dx_reference` (within
1e-6; exact on integer inputs).

The fma is emulated as a float64 product and sum rounded to f32; on the
card it rounds once, so the two can differ in the last bit of a real
value, never on integers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch.ops.textcnn import _dx_reference, textcnn_pool_reference
from reviews4rec_tpu.ops.textcnn_pallas import textcnn_pool as jax_pool

torch.set_num_threads(1)

ROWS = 256   # the kernel's most output rows an item


def _emulate_dx(g, idx, k, t, w, skip=None):
    """dx [B, T, E] summed in the kernel's order, and the tap lists
    [(b, t, [(f, w), ...])] of the rows that have taps."""
    b_, f_ = g.shape
    e = k.shape[0] // w
    k64 = k.reshape(w, e, f_).astype(np.float64)
    words = -(-f_ // 32)
    dx = np.empty((b_, t, e), np.float32)
    lists = []
    for b in range(b_):
        lo, hi = (0, 0) if skip is None else (skip[b, 0],
                                              skip[b, 0] + skip[b, 1])
        rows = -(-t // -(-t // ROWS))     # equal items of at most ROWS
        for t0 in range(0, t, rows):
            n = min(rows, t - t0)
            # start masks: p = idx - t0 is the window's last item row
            start = np.zeros((n + w - 1, words), np.uint64)
            for c in range(words):
                groups = {}
                for lane in range(32):
                    f = 32 * c + lane
                    p = int(idx[b, f]) - t0 if f < f_ and g[b, f] != 0 else -1
                    if 0 <= p < n + w - 1:
                        groups.setdefault(p, []).append(lane)
                for p, lanes in groups.items():   # one writer a start
                    start[p, c] = sum(1 << lane for lane in lanes)
            for r in range(n):
                mask = np.zeros(words, np.uint64)
                if not lo <= t0 + r < hi:
                    for tap in range(w):
                        mask |= start[r + tap]
                acc = np.zeros(e, np.float32)
                taps = []
                for c in range(words):
                    for lane in range(32):
                        if int(mask[c]) >> lane & 1:
                            f = 32 * c + lane
                            tap = t0 + r + (w - 1) - int(idx[b, f])
                            taps.append((f, tap))
                            acc = (np.float64(g[b, f]) * k64[tap, :, f]
                                   + acc).astype(np.float32)
                dx[b, t0 + r] = acc
                if taps:
                    lists.append((b, t0 + r, taps))
    return dx, lists


def _inputs(b, t, e, f, w, seed, integer, zero):
    rng = np.random.default_rng(seed)
    if integer:
        words = rng.integers(-2, 3, size=(4, e)).astype(np.float32)
        x = words[rng.integers(0, 4, size=(b, t))]
        k = rng.integers(-1, 2, size=(w * e, f)).astype(np.float32)
        bias = rng.integers(-3, 4, size=f).astype(np.float32)
        g = rng.integers(-3, 4, size=(b, f)).astype(np.float32)
    else:
        x = rng.normal(size=(b, t, e)).astype(np.float32)
        k = (rng.normal(size=(w * e, f)) / np.sqrt(w * e)).astype(np.float32)
        bias = rng.normal(size=(f,)).astype(np.float32)
        g = rng.normal(size=(b, f)).astype(np.float32)
    g[rng.random((b, f)) < zero] = 0.0
    return x, k, bias, g


def _forward(x, k, bias, w, skip):
    out, idx = textcnn_pool_reference(
        torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(bias), w,
        None if skip is None else torch.from_numpy(skip))
    return out.numpy(), idx.numpy()


def _skip_over_winners(x, k, bias, w):
    """A one-word span in the middle of each row's winning window of
    filter b % F, found without a span."""
    _, idx = _forward(x, k, bias, w, None)
    b_, t = x.shape[:2]
    f_ = k.shape[1]
    first = idx[np.arange(b_), np.arange(b_) % f_] - (w - 1)
    start = np.clip(first + w // 2, 0, t - 1)
    return np.stack([start, np.ones(b_, np.int64)], 1).astype(np.int32)


# (B, T, E, F, W, integer, share of g set to 0, skip spans, what the
# case must show)
CASES = {
    # 600 rows: three items of 200 rows
    "chunk edges": (8, 600, 64, 100, 3, False, 0.0, None, "crosses"),
    # 6 words, 8 starts: most windows reach into the padding
    "padding": (6, 6, 64, 100, 3, False, 0.0, None, "padding"),
    "skip over winners": (8, 300, 64, 100, 3, False, 0.0, "winners", "skip"),
    "g zero on a third": (6, 300, 64, 100, 3, False, 1 / 3, None, "zeros"),
    "T=1 W=8 B=37": (37, 1, 16, 24, 8, False, 0.0, None, "padding"),
    "integer E=16 ties": (8, 300, 16, 40, 3, True, 1 / 3,
                          [[0, 0], [3, 40], [0, 300], [290, 20], [1, 1],
                           [100, 0], [255, 2], [0, 1]], "zeros"),
    "E=5 F=129 W=8 T=300": (7, 300, 5, 129, 8, False, 0.0, None, "crosses"),
    "NARRE docs B=40 T=100": (40, 100, 64, 100, 3, False, 0.0, None,
                              "padding"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bucketed_order_matches_jax_and_plain(case):
    b, t, e, f, w, integer, zero, spans, shows = CASES[case]
    x, k, bias, g = _inputs(b, t, e, f, w, seed=b * 1000 + t, integer=integer,
                            zero=zero)
    skip = (_skip_over_winners(x, k, bias, w) if spans == "winners"
            else None if spans is None else np.asarray(spans, np.int32))
    out, idx = _forward(x, k, bias, w, skip)
    gated = np.where(out > 0, g, 0.0).astype(np.float32)

    dx, lists = _emulate_dx(gated, idx, k, t, w, skip)
    assert lists and all(taps == sorted(taps) and 0 <= min(x for _, x in taps)
                         and max(x for _, x in taps) < w
                         for _, _, taps in lists), "taps out of order"
    lead = idx.astype(np.int64) - (w - 1)      # first word of each window
    live = gated != 0
    if shows == "crosses":        # a live window crosses an item's edge
        rows = -(-t // -(-t // ROWS))
        edge = (lead // rows) != ((lead + w - 1) // rows)
        assert np.any(edge & live & (lead >= 0) & (lead + w - 1 < t))
    elif shows == "padding":      # live taps in the left and right padding
        assert np.any(live & (lead < 0)) and np.any(live & (lead + w > t))
    elif shows == "skip":         # a live winning window has a tap in a span
        taps = lead[:, :, None] + np.arange(w)
        inside = ((taps >= skip[:, :1, None])
                  & (taps < (skip[:, :1] + skip[:, 1:2])[:, :, None]))
        assert np.any(inside.any(-1) & live)
    else:                         # winners whose g is 0
        assert np.any((out > 0) & (g == 0))

    ref = _dx_reference(torch.from_numpy(gated), torch.from_numpy(idx),
                        torch.from_numpy(k), t, w,
                        None if skip is None else torch.from_numpy(skip))
    if integer:
        np.testing.assert_array_equal(dx, ref.numpy())
    else:
        np.testing.assert_allclose(dx, ref.numpy(), atol=1e-6, rtol=0)

    if skip is None:
        mask = None
    else:
        ts = np.arange(t)[None, :]
        mask = jnp.asarray((ts >= skip[:, :1])
                           & (ts < skip[:, :1] + skip[:, 1:2]))

    def op(xx, kk, bb):   # a span is the JAX towers' value-level mask
        if mask is not None:
            xx = jnp.where(mask[..., None], 0.0, xx)
        return jax_pool(xx, kk, bb, w, True, jnp.float32, True)

    _, vjp = jax.vjp(op, jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    jdx = np.asarray(vjp(jnp.asarray(g))[0])
    if integer:
        np.testing.assert_array_equal(dx, jdx)
    else:
        np.testing.assert_allclose(dx, jdx, atol=1e-5, rtol=0)
