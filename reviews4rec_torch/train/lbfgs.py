"""L-BFGS with a zoom line search: the port's own copy of
`optax.lbfgs()` as the JAX package's HFT M-step uses it
(`reviews4rec_tpu/models/hft.py::make_m_step`), on dicts of tensors.

What is kept of optax (0.2.6, `_src/alias.py::lbfgs`,
`_src/transform.py::scale_by_lbfgs`, `_src/linesearch.py`):
- `scale_by_lbfgs(memory_size=10, scale_init_precond=True)`: the memory
  of the last 10 (parameter, gradient) differences, written at
  `(count - 1) % 10`, the two-loop product over it, and the initial scale
  (dw . du) / |du|^2, or min(1, 1 / |g|) at the first iteration;
- then `scale(-1)`, then `scale_by_zoom_linesearch(max_linesearch_steps=
  20, initial_guess_strategy='one')` with its defaults: slope_rtol 1e-4,
  curv_rtol 0.9, approx_dec_rtol 1e-6, increase_factor 2, tol 0 and
  stepsize_precision 1e-5, the interval search, the cubic / quadratic /
  bisection zoom and the safe-step fallback;
- `value_and_grad_from_state`: an iteration reuses the value and gradient
  the line search last accepted, and evaluates only when there is none.

Every scalar of the search (step sizes, values, slopes, errors) is a
0-d tensor of the params' type (float32 in HFT), as in JAX, so each
threshold compares numbers of the same precision; a tree's inner product
is the sum of its leaves' dot products in sorted key order (JAX's dict
order). Gradients come from
`torch.autograd`. `torch.optim.LBFGS` is not used: its strong-Wolfe
search and its counting of iterations differ from optax's.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

Tree = Dict[str, torch.Tensor]


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of v in the type and on the device of `like`."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def tree_vdot(a: Tree, b: Tree) -> torch.Tensor:
    total = None
    for k in sorted(a):
        d = torch.dot(a[k].reshape(-1), b[k].reshape(-1))
        total = d if total is None else total + d
    return total


def tree_sqnorm(a: Tree) -> torch.Tensor:
    total = None
    for k in sorted(a):
        s = torch.sum(a[k] * a[k])
        total = s if total is None else total + s
    return total


def tree_add_scale(x: Tree, scalar: torch.Tensor, y: Tree) -> Tree:
    return {k: x[k] + scalar * y[k] for k in x}


def tree_scale(scalar: torch.Tensor, x: Tree) -> Tree:
    return {k: scalar * x[k] for k in x}


def value_and_grad(fn: Callable[[Tree], torch.Tensor], params: Tree
                   ) -> Tuple[torch.Tensor, Tree]:
    """(fn(params), its gradient) by autograd, both detached."""
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        value = fn(leaves)
        keys = sorted(leaves)
        grads = torch.autograd.grad(value, [leaves[k] for k in keys])
    return value.detach(), {k: g.detach() for k, g in zip(keys, grads)}


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN if none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc ** 2 * v0 + (-(db ** 2)) * v1) / denom
    B = ((-(dc ** 3)) * v0 + db ** 3 * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db ** 2)
    return a - C / (2.0 * B)


class ZoomLinesearch:
    """optax's `zoom_linesearch` with `scale_by_zoom_linesearch`'s
    defaults and `initial_guess_strategy='one'`."""

    def __init__(self, max_linesearch_steps: int = 20, tol: float = 0.0,
                 increase_factor: float = 2.0, slope_rtol: float = 1e-4,
                 curv_rtol: float = 0.9, approx_dec_rtol: float = 1e-6,
                 interval_threshold: float = 1e-5):
        self.max_steps = max_linesearch_steps
        self.tol = tol
        self.increase_factor = increase_factor
        self.slope_rtol = slope_rtol
        self.curv_rtol = curv_rtol
        self.approx_dec_rtol = approx_dec_rtol
        self.interval_threshold = interval_threshold

    def _on_line(self, fn, params, stepsize, updates):
        step = tree_add_scale(params, stepsize, updates)
        value, grad = value_and_grad(fn, step)
        return value, grad, tree_vdot(grad, updates)

    def _decrease_error(self, stepsize, value, slope, value_init,
                        slope_init):
        err = value - value_init - self.slope_rtol * stepsize * slope_init
        approx = slope - (2 * self.slope_rtol - 1.0) * slope_init
        delta = value - value_init - self.approx_dec_rtol * torch.abs(
            value_init)
        err = torch.minimum(torch.maximum(approx, delta), err)
        err = torch.clamp(err, min=0.0)
        return torch.where(torch.isnan(err), torch.full_like(err, torch.inf),
                           err)

    def _curvature_error(self, slope, slope_init):
        err = torch.abs(slope) - self.curv_rtol * torch.abs(slope_init)
        err = torch.clamp(err, min=0.0)
        return torch.where(torch.isnan(err), torch.full_like(err, torch.inf),
                           err)

    def _search_interval(self, s: dict, fn) -> None:
        it = s["count"]
        new_stepsize = (s["stepsize_guess"] if it == 0
                        else self.increase_factor * s["stepsize"])
        value, grad, slope = self._on_line(fn, s["params"], new_stepsize,
                                           s["updates"])
        dec = self._decrease_error(new_stepsize, value, slope,
                                   s["value_init"], s["slope_init"])
        curv = self._curvature_error(slope, s["slope_init"])
        err = torch.maximum(dec, curv)
        if bool(dec <= self.tol):
            s["safe_stepsize"], s["safe_value"], s["safe_grad"] = \
                new_stepsize, value, grad
        set_high = bool((dec > 0.0) | ((value >= s["value"]) & (it > 0)))
        set_low = bool(slope >= 0.0) and not set_high
        prev = (s["stepsize"], s["value"], s["slope"])
        new = (new_stepsize, value, slope)
        low, high = (new, prev) if set_low else (prev, new)
        s["low"], s["value_low"], s["slope_low"] = low
        s["high"], s["value_high"], s["slope_high"] = high
        found = set_high or set_low or bool(err <= self.tol)
        done = bool(err <= self.tol)  # no max step size
        s.update(count=it + 1, stepsize=new_stepsize, value=value, grad=grad,
                 slope=slope, decrease_error=dec, curvature_error=curv,
                 error=err, interval_found=found, done=done,
                 failed=(it + 1 >= self.max_steps) and not done,
                 cubic_ref=s["low"], value_cubic_ref=s["value_low"])

    def _zoom_into_interval(self, s: dict, fn) -> None:
        it = s["count"]
        low, value_low, slope_low = s["low"], s["value_low"], s["slope_low"]
        high, value_high, slope_high = (s["high"], s["value_high"],
                                        s["slope_high"])
        cubic_ref, value_cubic_ref = s["cubic_ref"], s["value_cubic_ref"]
        delta = torch.abs(high - low)
        left = torch.minimum(high, low)
        right = torch.maximum(high, low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta
        too_small = bool(delta <= self.interval_threshold)
        middle_cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                                 cubic_ref, value_cubic_ref)
        use_cubic = bool((middle_cubic > left + cubic_chk)
                         & (middle_cubic < right - cubic_chk))
        middle_quad = _quadmin(low, value_low, slope_low, high, value_high)
        use_quad = not use_cubic and bool(
            (middle_quad > left + quad_chk) & (middle_quad < right - quad_chk))
        if use_cubic:
            middle = middle_cubic
        elif use_quad:
            middle = middle_quad
        else:
            middle = (low + high) / 2.0
        value, grad, slope = self._on_line(fn, s["params"], middle,
                                           s["updates"])
        dec = self._decrease_error(middle, value, slope, s["value_init"],
                                   s["slope_init"])
        curv = self._curvature_error(slope, s["slope_init"])
        err = torch.maximum(dec, curv)
        if bool((dec <= self.tol) & (value < s["safe_value"])):
            s["safe_stepsize"], s["safe_value"], s["safe_grad"] = \
                middle, value, grad
        done = bool(err <= self.tol)
        set_high_to_middle = bool((dec > 0.0) | (value >= value_low))
        set_high_to_low = bool(slope * (high - low) >= 0.0) \
            and not set_high_to_middle
        if set_high_to_middle:
            s["high"], s["value_high"], s["slope_high"] = middle, value, slope
        if set_high_to_low:
            s["high"], s["value_high"], s["slope_high"] = (low, value_low,
                                                           slope_low)
        if not set_high_to_middle:
            s["low"], s["value_low"], s["slope_low"] = middle, value, slope
        if set_high_to_middle or set_high_to_low:
            s["cubic_ref"], s["value_cubic_ref"] = high, value_high
        else:
            s["cubic_ref"], s["value_cubic_ref"] = low, value_low
        presumably_failed = (it + 1 >= self.max_steps) or (
            too_small and bool(s["safe_stepsize"] > 0.0))
        s.update(count=it + 1, stepsize=middle, value=value, grad=grad,
                 slope=slope, decrease_error=dec, curvature_error=curv,
                 error=err, done=done, failed=presumably_failed and not done)

    @staticmethod
    def _try_safe_step(s: dict) -> None:
        outside_domain = bool(torch.isinf(s["decrease_error"]))
        if bool(s["safe_stepsize"] > 0.0) or outside_domain:
            s["stepsize"], s["value"], s["grad"] = (
                s["safe_stepsize"], s["safe_value"], s["safe_grad"])

    def search(self, fn, params: Tree, updates: Tree, value: torch.Tensor,
               grad: Tree) -> dict:
        """The final line-search state along `updates` from `params`:
        `stepsize`, and the `value` and `grad` at that step."""
        slope = tree_vdot(updates, grad)
        zero = _scalar(0.0, value)
        s = dict(count=0, params=params, updates=updates,
                 stepsize_guess=_scalar(1.0, value), stepsize=zero, value=value,
                 grad=grad, slope=slope, value_init=value, slope_init=slope,
                 decrease_error=_scalar(torch.inf, value),
                 curvature_error=_scalar(torch.inf, value),
                 error=_scalar(torch.inf, value), interval_found=False,
                 done=False, failed=False, low=zero, value_low=value,
                 slope_low=slope, high=zero, value_high=value,
                 slope_high=slope, cubic_ref=zero, value_cubic_ref=value,
                 safe_stepsize=zero, safe_value=value, safe_grad=grad)
        while not (s["done"] or s["failed"]):
            if s["interval_found"]:
                self._zoom_into_interval(s, fn)
            else:
                self._search_interval(s, fn)
            if s["failed"]:
                self._try_safe_step(s)
        return s


class LBFGS:
    """`optax.lbfgs()`: init(params) -> state; step(fn, params, state) ->
    (new params, the value at params, state)."""

    def __init__(self, memory_size: int = 10,
                 scale_init_precond: bool = True,
                 linesearch: ZoomLinesearch = None):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.memory_size = memory_size
        self.scale_init_precond = scale_init_precond
        self.linesearch = linesearch or ZoomLinesearch()

    def init(self, params: Tree) -> dict:
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        m = self.memory_size
        ref = next(iter(params.values()))
        return dict(count=0, params=zeros, updates=zeros,
                    diff_params=[zeros] * m, diff_updates=[zeros] * m,
                    weights=[_scalar(0.0, ref)] * m,
                    value=_scalar(torch.inf, ref), grad=zeros)

    def _precondition(self, updates: Tree, state: dict,
                      identity_scale: torch.Tensor, memory_idx: int) -> Tree:
        m = self.memory_size
        indices = [(memory_idx + j) % m for j in range(m)]
        rhos, dws, dus = (state["weights"], state["diff_params"],
                          state["diff_updates"])
        vec = updates
        alphas: List[torch.Tensor] = [None] * m
        for j in reversed(range(m)):
            idx = indices[j]
            alpha = rhos[idx] * tree_vdot(dws[idx], vec)
            vec = tree_add_scale(vec, -alpha, dus[idx])
            alphas[j] = alpha
        vec = tree_scale(identity_scale, vec)
        for j in range(m):
            idx = indices[j]
            beta = rhos[idx] * tree_vdot(dus[idx], vec)
            vec = tree_add_scale(vec, alphas[j] - beta, dws[idx])
        return vec

    def _scale_by_lbfgs(self, grad: Tree, state: dict, params: Tree) -> Tree:
        m = self.memory_size
        count = state["count"]
        memory_idx = count % m
        prev_idx = (count - 1) % m
        ref = next(iter(grad.values()))
        if count > 0:
            diff_params = {k: params[k] - state["params"][k] for k in params}
            diff_updates = {k: grad[k] - state["updates"][k] for k in grad}
            vdp = tree_vdot(diff_updates, diff_params)
            weight = torch.where(vdp == 0.0, _scalar(0.0, ref), 1.0 / vdp)
        else:
            diff_params = {k: torch.zeros_like(v) for k, v in params.items()}
            diff_updates = diff_params
            weight = _scalar(0.0, ref)
        for key, val in (("diff_params", diff_params),
                         ("diff_updates", diff_updates), ("weights", weight)):
            state[key] = list(state[key])
            state[key][prev_idx] = val
        if self.scale_init_precond:
            if count > 0:
                num = tree_vdot(diff_updates, diff_params)
                den = tree_sqnorm(diff_updates)
                identity_scale = torch.where(den > 0.0, num / den,
                                             _scalar(1.0, ref))
            else:
                update_norm = torch.sqrt(tree_sqnorm(grad))
                identity_scale = torch.minimum(_scalar(1.0, ref),
                                               1.0 / update_norm)
        else:
            identity_scale = _scalar(1.0, ref)
        precond = self._precondition(grad, state, identity_scale, memory_idx)
        state.update(count=count + 1, params=params, updates=grad)
        return precond

    def step(self, fn: Callable[[Tree], torch.Tensor], params: Tree,
             state: dict) -> Tuple[Tree, torch.Tensor, dict]:
        """One iteration of the JAX package's M-step loop body: the value
        and gradient at `params` (the line search's last, when it has
        them), the L-BFGS direction, the zoom line search along it, and
        the updated params. Returns (params, value at the old params,
        state)."""
        value, grad = state["value"], state["grad"]
        if bool(torch.isinf(value) | torch.isnan(value)):
            value, grad = value_and_grad(fn, params)
        direction = self._scale_by_lbfgs(grad, state, params)
        direction = tree_scale(_scalar(-1.0, value), direction)
        ls = self.linesearch.search(fn, params, direction, value, grad)
        scaled = tree_scale(ls["stepsize"], direction)
        state.update(value=ls["value"], grad=ls["grad"],
                     stepsize=ls["stepsize"], linesearch_steps=ls["count"])
        return {k: params[k] + scaled[k] for k in params}, value, state


def minimize(fn: Callable[[Tree], torch.Tensor], params: Tree, iters: int,
             optimizer: LBFGS = None) -> Tuple[Tree, List[torch.Tensor]]:
    """`iters` L-BFGS iterations from `params`: (final params, the value
    at the start of each iteration)."""
    opt = optimizer or LBFGS()
    state = opt.init(params)
    values = []
    for _ in range(iters):
        params, value, state = opt.step(fn, params, state)
        values.append(value)
    return params, values
