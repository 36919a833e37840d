"""The precision design of the TextCNN forward kernel
(`reviews4rec_torch/csrc/textcnn_pool_fwd.cu`): 3xTF32 products on the
tensor cores, each operand split as hi = rna_tf32(a), lo = rna_tf32(a -
hi), and each product taken as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with
f32 sums.

A plain numpy emulation of that product (the rounding done bit-exact on
the f32 bits, as `cvt.rna.tf32.f32` does) runs the op `windows @ K` at
the serving widths, B=8, T=1000, E=64, F=100, W=3, and is held against
the same op in float64:
- out within TOL = 1e-5 absolute (values are O(1); f32 rounding of the
  192-term sums is about 1e-6);
- idx equal, except on random data where float64's two best starts lie
  within TOL of each other (counted; there a rounding may pick either);
- on integer inputs (the forced-tie case) the split is exact: every lo
  part is 0, out equals float64 bit for bit and idx is equal;
- on exact ties of real-valued windows (4 random word vectors) idx is
  equal: windows of equal content give bit-equal sums;
- one TF32 rounding (1xTF32) misses float64 by more than 1e-4 on the
  random data, which is why the kernel splits.

Windows of equal content are summed once (`np.unique`), as the kernel
sums every start in the same order.
"""

import numpy as np
import pytest
import torch

from reviews4rec_torch.ops.textcnn import textcnn_pool_reference

B, T, E, F, W = 8, 1000, 64, 100, 3
TOL = 1e-5


def rna_tf32(a: np.ndarray) -> np.ndarray:
    """`cvt.rna.tf32.f32`: f32 rounded to 10 mantissa bits, to nearest
    with ties away from zero, on the bits."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(a: np.ndarray):
    hi = rna_tf32(a)
    return hi, rna_tf32(a.astype(np.float32) - hi)


def _case(kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "forced ties":
        words = rng.integers(-2, 3, size=(4, E)).astype(np.float32)
        x = words[rng.integers(0, 4, size=(B, T))]
        x[0] = 0.0
        k = rng.integers(-1, 2, size=(W * E, F)).astype(np.float32)
        bias = rng.integers(-3, 4, size=(F,)).astype(np.float32)
        return x, k, bias
    if kind == "real-valued ties":
        words = rng.normal(size=(4, E)).astype(np.float32)
        x = words[rng.integers(0, 4, size=(B, T))]
    else:
        x = rng.normal(size=(B, T, E)).astype(np.float32)
    k = (rng.normal(size=(W * E, F)) / np.sqrt(W * E)).astype(np.float32)
    bias = rng.normal(size=(F,)).astype(np.float32)
    return x, k, bias


def _windows(x: np.ndarray) -> np.ndarray:
    """[B * (T + W - 1), W * E] tap-major windows of the padded docs."""
    xp = np.pad(x, ((0, 0), (W - 1, W - 1), (0, 0)))
    t_out = T + W - 1
    taps = [xp[:, w:w + t_out] for w in range(W)]
    return np.concatenate(taps, axis=2).reshape(B * t_out, W * E)


def _op(x, k, bias, product):
    """(out [B, F], idx [B, F], y [B, T+W-1, F]) of relu(windows @ K + b)
    with `product(unique_windows, k)` for the matmul."""
    uniq, inv = np.unique(_windows(x), axis=0, return_inverse=True)
    y = product(uniq, k)[inv.reshape(-1)]
    y = np.maximum(y + bias.astype(y.dtype), 0).reshape(B, T + W - 1, F)
    return y.max(axis=1), y.argmax(axis=1), y


def _f64(a, k):
    return a.astype(np.float64) @ k.astype(np.float64)


def _tf32x3(a, k):
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(k)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi     # f32 sums


def _tf32x1(a, k):
    return rna_tf32(a) @ rna_tf32(k)


def _near_ties(y64: np.ndarray, tol: float) -> np.ndarray:
    """[B, F] True where float64's two best starts lie within tol."""
    top2 = -np.partition(-y64, 1, axis=1)[:, :2]
    return top2[:, 0] - top2[:, 1] <= tol


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                  # TF32 step at 1
    vals = np.array([1 + 2.0 ** -11,              # tie: away from zero
                     -(1 + 2.0 ** -11),
                     1 + 2.0 ** -11 - 2.0 ** -20,  # below the tie: down
                     1 + 3 * 2.0 ** -12,           # above: up
                     3.0, -0.0], dtype=np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + ulp, 3.0, -0.0],
                    dtype=np.float32)
    np.testing.assert_array_equal(rna_tf32(vals), want)
    hi, lo = split(vals)
    # hi + lo reproduces each value to within lo's own rounding
    assert np.all(np.abs(hi.astype(np.float64) + lo - vals)
                  <= 2.0 ** -22 * np.abs(vals))


@pytest.mark.parametrize("kind", ["random", "forced ties",
                                  "real-valued ties"])
def test_tf32x3_matches_float64(kind):
    x, k, bias = _case(kind)
    out64, idx64, y64 = _op(x, k, bias, _f64)
    out3, idx3, _ = _op(x, k, bias, _tf32x3)
    err = np.abs(out3 - out64).max()
    assert err <= TOL, err
    if kind == "forced ties":
        # integers are exact in TF32: nothing is left for the lo parts
        assert not split(x)[1].any() and not split(k)[1].any()
        np.testing.assert_array_equal(out3, out64)
        np.testing.assert_array_equal(idx3, idx64)
        return
    if kind == "real-valued ties":
        np.testing.assert_array_equal(idx3, idx64)
        return
    near = _near_ties(y64, TOL)
    assert near.sum() <= 2, int(near.sum())
    np.testing.assert_array_equal(idx3[~near], idx64[~near])


def test_tf32x1_misses_float64_by_more_than_1e_4():
    x, k, bias = _case("random")
    out64, _, _ = _op(x, k, bias, _f64)
    out1, _, _ = _op(x, k, bias, _tf32x1)
    assert np.abs(out1 - out64).max() > 1e-4


def test_float64_op_matches_the_plain_version():
    """The float64 op of this file is the port's plain version (f32)."""
    x, k, bias = _case("random", seed=1)
    out64, idx64, y64 = _op(x, k, bias, _f64)
    out, idx = textcnn_pool_reference(torch.from_numpy(x),
                                      torch.from_numpy(k),
                                      torch.from_numpy(bias), W)
    np.testing.assert_allclose(out.numpy(), out64, atol=1e-4, rtol=0)
    near = _near_ties(y64, TOL)
    np.testing.assert_array_equal(idx.numpy()[~near], idx64[~near])
