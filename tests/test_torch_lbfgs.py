"""The port's copy of `optax.lbfgs()` (`reviews4rec_torch.train.lbfgs`)
against optax itself on the CPU: the value at the start of each
iteration (the JAX package's M-step loop, `make_m_step`) and the final
params.

- Rosenbrock in float64 (JAX under `enable_x64`): the algorithm itself,
  within 1e-9 relative. In float32 the same runs part after a few
  iterations (3.3e-4 relative by the 7th of 12 at dim 2): the valley is
  ill-conditioned, so f32 rounding of the sums in another order moves
  the line search's trial points, and the difference grows from there.
- A well-conditioned f32 problem (a ridge least squares), within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from reviews4rec_torch.train import lbfgs

torch.set_num_threads(1)


def _optax_values(fn, params, iters):
    opt = optax.lbfgs()
    state = opt.init(params)
    value_and_grad = optax.value_and_grad_from_state(fn)
    values = []
    for _ in range(iters):
        value, grad = value_and_grad(params, state=state)
        updates, state = opt.update(grad, state, params, value=value,
                                    grad=grad, value_fn=fn)
        params = optax.apply_updates(params, updates)
        values.append(float(value))
    return params, np.asarray(values)


def _rosen_jax(p):
    x = p["x"]
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2) \
        + 0.5 * p["s"] ** 2


def _rosen_torch(p):
    x = p["x"]
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                     + (1.0 - x[:-1]) ** 2) + 0.5 * p["s"] ** 2


@pytest.mark.parametrize("dim,iters", [(2, 12), (6, 20)])
def test_rosenbrock_matches_optax(dim, iters):
    x0 = np.random.default_rng(dim).uniform(-1.5, 1.5, dim)
    tp = {"x": torch.from_numpy(x0.copy()),
          "s": torch.tensor(0.7, dtype=torch.float64)}
    with jax.enable_x64(True):
        jp = {"x": jnp.asarray(x0), "s": jnp.asarray(np.float64(0.7))}
        jout, jvals = _optax_values(_rosen_jax, jp, iters)
        jx = np.asarray(jout["x"])
    tout, tvals = lbfgs.minimize(_rosen_torch, tp, iters)
    tvals = np.asarray([float(v) for v in tvals])
    assert tout["x"].dtype == torch.float64
    np.testing.assert_allclose(tvals, jvals, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tout["x"].numpy(), jx, rtol=1e-9, atol=1e-12)


def test_ridge_f32_matches_optax():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(40, 8)).astype(np.float32)
    y = rng.normal(size=40).astype(np.float32)
    w0 = rng.normal(size=8).astype(np.float32)

    def jfn(p):
        r = jnp.asarray(A) @ p["w"] + p["b"] - jnp.asarray(y)
        return jnp.sum(r * r) + 0.1 * jnp.sum(p["w"] ** 2)

    def tfn(p):
        r = torch.from_numpy(A) @ p["w"] + p["b"] - torch.from_numpy(y)
        return torch.sum(r * r) + 0.1 * torch.sum(p["w"] ** 2)

    jout, jvals = _optax_values(
        jfn, {"w": jnp.asarray(w0), "b": jnp.asarray(np.float32(0.0))}, 8)
    tout, tvals = lbfgs.minimize(
        tfn, {"w": torch.from_numpy(w0.copy()), "b": torch.tensor(0.0)}, 8)
    np.testing.assert_allclose([float(v) for v in tvals], jvals, rtol=1e-5)
    np.testing.assert_allclose(tout["w"].numpy(), np.asarray(jout["w"]),
                               rtol=1e-4, atol=1e-5)


def test_quadratic_first_step_is_capped():
    """A first step is the gradient scaled by min(1, 1/|g|), then searched:
    on a quadratic with |g| < 1 and unit curvature the first trial step
    1 lands on the minimum exactly."""
    a = np.array([0.3, -0.2], np.float32)
    fn = lambda p: 0.5 * torch.sum((p["w"] - torch.from_numpy(a)) ** 2)
    out, values = lbfgs.minimize(fn, {"w": torch.zeros(2)}, 2)
    np.testing.assert_allclose(out["w"].numpy(), a, atol=1e-7)
    assert float(values[1]) == 0.0


def test_value_and_grad_is_autograd():
    p = {"a": torch.tensor([1.0, 2.0]), "b": torch.tensor(3.0)}
    v, g = lbfgs.value_and_grad(
        lambda q: torch.sum(q["a"] ** 2) * q["b"], p)
    assert float(v) == 15.0
    np.testing.assert_array_equal(g["a"].numpy(), [6.0, 12.0])
    assert float(g["b"]) == 5.0
    assert not p["a"].requires_grad
