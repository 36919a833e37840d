"""The port's row-gathered TextCNN op, `textcnn_pool_rows` (the op on
`table[rows]` of a whole [N, T, E] entity doc table, differentiable in K
and b), against the JAX package's `textcnn_pool_rows` (Pallas kernels in
interpret mode, f32, on `paired_operand(docs)`), at the shapes of
`tests/test_pallas.py::test_rows_kernel_matches_take_path`.

Tolerances: out within 1e-5 absolute, idx equal (continuous random
inputs: no exact ties, so the paired kernel's even-start tie rule does
not show), dK and db within 1e-5 of each one's max |value| (f32 sums in
another order). On the CPU the rows op IS the plain op on table[rows],
so the two are held bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reviews4rec_torch.models.layers import TextCNN
from reviews4rec_torch.ops.textcnn import (textcnn_pool, textcnn_pool_rows,
                                           textcnn_pool_rows_reference)
from reviews4rec_tpu.ops.textcnn_pallas import (_forward_rows,
                                                paired_operand)
from reviews4rec_tpu.ops.textcnn_pallas import \
    textcnn_pool_rows as jax_pool_rows

torch.backends.cuda.matmul.allow_tf32 = False
# small shapes: one torch thread, so the test workers running beside
# this one (JAX meshes on virtual CPU devices) keep their cores
torch.set_num_threads(1)

N, B, T, E, F, W = 11, 5, 70, 64, 9, 3
ROWS = np.asarray([3, 0, 10, 7, 3], np.int32)
# spans: none, interior, whole doc, tail overhang, single word
SPANS = np.asarray([[0, 0], [3, 7], [0, 70], [65, 20], [10, 1]], np.int32)


# (N, rows, T, E, F, skip) of test_rows_op_matches_jax: the module's
# geometry, and the NARRE tower's docs scaled down (40 rows of 100 words,
# as [B*10, 100]). JAX's rows op takes E=64 only (`paired_operand`); wide
# E is held against JAX by test_torch_textcnn_grad.py
ROWS_CASES = {
    "no-skip": (N, ROWS, T, E, F, None),
    "skip": (N, ROWS, T, E, F, SPANS),
    "narre": (48, (np.arange(40, dtype=np.int32) * 7) % 48, 100, 64, 9,
              None),
}


def _inputs(seed=3, n=N, b=B, t=T, e=E, f=F):
    rng = np.random.default_rng(seed)
    docs = rng.normal(size=(n, t, e)).astype(np.float32)
    kern = rng.normal(size=(W * e, f)).astype(np.float32)
    bias = rng.normal(size=(f,)).astype(np.float32)
    g = rng.normal(size=(b, f)).astype(np.float32)
    return docs, kern, bias, g


def _port(docs, kern, bias, g, skip, op="rows", rows=ROWS):
    """(out, idx, dK, db) of the port's op on the CPU, cotangent g."""
    table = torch.from_numpy(docs)
    rows = torch.from_numpy(rows)
    k = torch.from_numpy(kern).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    sk = None if skip is None else torch.from_numpy(skip)
    if op == "rows":
        out, idx = textcnn_pool_rows(table, rows, k, b, W, sk)
    else:
        out, idx = textcnn_pool(table[rows.long()], k, b, W, sk)
    out.backward(torch.from_numpy(g))
    return out.detach(), idx, k.grad, b.grad


@pytest.mark.parametrize("case", list(ROWS_CASES))
def test_rows_op_matches_jax(case):
    n, rows_np, t, e, f, skip = ROWS_CASES[case]
    docs, kern, bias, g = _inputs(n=n, b=len(rows_np), t=t, e=e, f=f)
    table = paired_operand(jnp.asarray(docs), W, jnp.float32)
    rows = jnp.asarray(rows_np)
    sk = None if skip is None else jnp.asarray(skip)
    want_out, want_idx = _forward_rows(table, rows, jnp.asarray(kern),
                                       jnp.asarray(bias), t, W, True,
                                       jnp.float32, sk)
    _, vjp = jax.vjp(lambda k, b: jax_pool_rows(table, rows, k, b, t, W, True,
                                                jnp.float32, sk),
                     jnp.asarray(kern), jnp.asarray(bias))
    want_dk, want_db = (np.asarray(a) for a in vjp(jnp.asarray(g)))

    out, idx, dk, db = _port(docs, kern, bias, g, skip, rows=rows_np)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    for got, want in ((dk, want_dk), (db, want_db)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("skip", [None, SPANS], ids=["no-skip", "skip"])
def test_rows_op_is_the_op_on_gathered_rows(skip):
    docs, kern, bias, g = _inputs(seed=5)
    got = _port(docs, kern, bias, g, skip, op="rows")
    want = _port(docs, kern, bias, g, skip, op="take")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ref_out, ref_idx = textcnn_pool_rows_reference(
        torch.from_numpy(docs), torch.from_numpy(ROWS),
        torch.from_numpy(kern), torch.from_numpy(bias), W,
        None if skip is None else torch.from_numpy(skip))
    assert torch.equal(got[0], ref_out) and torch.equal(got[1], ref_idx)


def test_rows_op_refuses_a_table_that_needs_grad():
    docs, kern, bias, _ = _inputs()
    table = torch.from_numpy(docs).requires_grad_()
    with pytest.raises(ValueError, match="no gradient for its table"):
        textcnn_pool_rows(table, torch.from_numpy(ROWS),
                          torch.from_numpy(kern), torch.from_numpy(bias), W)


@pytest.mark.parametrize("bad", [-1, N])
def test_rows_outside_the_table_raise(bad):
    docs, kern, bias, _ = _inputs()
    rows = torch.from_numpy(ROWS.copy())
    rows[2] = bad
    with pytest.raises(IndexError, match=f"rows must lie in \\[0, {N}\\)"):
        textcnn_pool_rows(torch.from_numpy(docs), rows,
                          torch.from_numpy(kern), torch.from_numpy(bias), W)


@pytest.mark.parametrize("form", ["float-table", "id-table"])
def test_textcnn_layer_rows_equals_the_gathered_docs(form):
    """TextCNN.forward(table, rows=...) equals the forward on the rows
    gathered first: a float [N, T, E] table through the rows op, int
    [N, T] ids gathered, then embedded; the skip span keeps its meaning."""
    rng = np.random.default_rng(9)
    words = torch.from_numpy(rng.normal(size=(40, 16)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 40, size=(N, 30)).astype(np.int32))
    layer = TextCNN(16, 4, dropout=0.0,
                    generator=torch.Generator().manual_seed(0)).eval()
    rows = torch.from_numpy(ROWS)
    skip = torch.from_numpy(np.asarray([[0, 0], [3, 7], [0, 30], [25, 20],
                                        [10, 1]], np.int32))
    docs = words[ids] if form == "float-table" else ids
    got = layer(docs, table=words, skip=skip, rows=rows)
    want = layer(words[ids][rows.long()], skip=skip)
    assert torch.equal(got, want)
