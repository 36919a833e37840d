"""The per-example SGD of the surprise-equivalent baseline, SVD and SVD++
models (the JAX package's `models/neighbors.py::_sgd_fit`, a `lax.scan`
over the train stream there).

- `sgd_fit_reference`: the plain PyTorch version, a Python loop over
  epochs and examples in train insertion order (any device). The CPU
  tests hold it against the JAX package; the GPU checks hold the kernel
  against it on a cut of the corpus.
- `sgd_fit`: the plain version for CPU tensors, else one launch of
  `csrc/neighbors_sgd.cu` for the whole fit (adds one to
  `launches[SGD]`). The state dict is updated in place on the card and
  returned; the plain version works on clones.
- `rmw_chain`: a yardstick, n dependent read-modify-writes of one float
  on the card (the latency that bounds the recurrence).

The state dict holds f32 `bu` [U], `bi` [I] and, for SVD and SVD++, `p`
[U, K] and `q` [I, K]; for SVD++ also `y` [I, K], with the user's train
items `rated_pad` [U, max_items] int32 and their count `rated_count` [U]
f32 (the pad slots past the count are skipped).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import _build

SGD = "neighbors_sgd"
VARIANTS = {"baseline": 0, "SVD": 1, "SVD++": 2}
KEYS = {"baseline": ("bu", "bi"), "SVD": ("bu", "bi", "p", "q"),
        "SVD++": ("bu", "bi", "p", "q", "y")}
MAX_FACTORS = 128

# kernel launches since the count was last set to 0
launches: Dict[str, int] = {SGD: 0}


def sgd_fit_reference(users: torch.Tensor, items: torch.Tensor,
                      ratings: torch.Tensor, state: Dict[str, torch.Tensor],
                      variant: str, epochs: int, mu: float, lr: float,
                      reg: float, rated_pad: Optional[torch.Tensor] = None,
                      rated_count: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
    """The fitted state after `epochs` passes over the examples, each
    example's updates computed from the state before it."""
    st = {k: v.clone() for k, v in state.items()}
    dev = ratings.device
    f32 = torch.float32
    mu_t = torch.tensor(mu, dtype=f32, device=dev)
    lr_t = torch.tensor(lr, dtype=f32, device=dev)
    reg_t = torch.tensor(reg, dtype=f32, device=dev)
    uu, ii = users.tolist(), items.tolist()
    lists = counts = None
    if variant == "SVD++":
        counts = [int(c) for c in rated_count.tolist()]
        lists = [rated_pad[u, :c].long() for u, c in enumerate(counts)]
    for _ in range(epochs):
        for n, (u, i) in enumerate(zip(uu, ii)):
            r = ratings[n]
            bu_u, bi_i = st["bu"][u].clone(), st["bi"][i].clone()
            est = mu_t + bu_u + bi_i
            if variant == "SVD":
                pu, qi = st["p"][u].clone(), st["q"][i].clone()
                est = est + torch.dot(pu, qi)
            elif variant == "SVD++":
                pu, qi = st["p"][u].clone(), st["q"][i].clone()
                its = lists[u]
                yj = st["y"][its]
                sq = torch.rsqrt(torch.clamp(rated_count[u], min=1.0))
                imp = yj.sum(0) * sq
                est = est + torch.dot(qi, pu + imp)
            err = r - est
            st["bu"][u] = bu_u + lr_t * (err - reg_t * bu_u)
            st["bi"][i] = bi_i + lr_t * (err - reg_t * bi_i)
            if variant == "SVD":
                st["p"][u] = pu + lr_t * (err * qi - reg_t * pu)
                st["q"][i] = qi + lr_t * (err * pu - reg_t * qi)
            elif variant == "SVD++":
                st["p"][u] = pu + lr_t * (err * qi - reg_t * pu)
                st["q"][i] = qi + lr_t * (err * (pu + imp) - reg_t * qi)
                upd = lr_t * (err * sq * qi - reg_t * yj)
                st["y"].index_add_(0, its, upd)
    return st


def _library() -> ctypes.CDLL:
    lib = _build.load(SGD)
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.neighbors_sgd_fit.argtypes = ([p, p, p, i] + [p] * 7 + [i, p]
                                          + [i, i, i, f, f, f, p])
        lib.neighbors_sgd_fit.restype = i
        lib.neighbors_sgd_rmw_chain.argtypes = [p, i, p]
        lib.neighbors_sgd_rmw_chain.restype = i
        lib.neighbors_sgd_error_string.argtypes = [i]
        lib.neighbors_sgd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(name: str, ten: Optional[torch.Tensor], dtype, dev) -> None:
    if ten is None:
        return
    if ten.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {ten.dtype}")
    if ten.device != dev:
        raise ValueError(f"{name} lies on {ten.device}, ratings on {dev}")
    if not ten.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sgd_fit(users: torch.Tensor, items: torch.Tensor, ratings: torch.Tensor,
            state: Dict[str, torch.Tensor], variant: str, epochs: int,
            mu: float, lr: float, reg: float,
            rated_pad: Optional[torch.Tensor] = None,
            rated_count: Optional[torch.Tensor] = None
            ) -> Dict[str, torch.Tensor]:
    """The fitted state: the plain version for CPU tensors, else the
    kernel, which updates `state` in place and returns it."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}, got "
                         f"{variant!r}")
    missing = set(KEYS[variant]) - set(state)
    if missing:
        raise ValueError(f"{variant} state lacks {sorted(missing)}")
    if variant == "SVD++" and (rated_pad is None or rated_count is None):
        raise ValueError("SVD++ needs rated_pad and rated_count")
    if ratings.device.type == "cpu":
        return sgd_fit_reference(users, items, ratings, state, variant,
                                 epochs, mu, lr, reg, rated_pad, rated_count)
    dev = ratings.device
    if dev.type != "cuda":
        raise ValueError(f"sgd_fit runs on cpu or cuda, not {dev}")
    n = ratings.shape[0]
    if users.shape != (n,) or items.shape != (n,):
        raise ValueError(f"users, items and ratings must be [n], got "
                         f"{tuple(users.shape)}, {tuple(items.shape)}, "
                         f"{tuple(ratings.shape)}")
    for name, ten, dtype in (("users", users, torch.int32),
                             ("items", items, torch.int32),
                             ("ratings", ratings, torch.float32),
                             ("rated_pad", rated_pad, torch.int32),
                             ("rated_count", rated_count, torch.float32)):
        _check(name, ten, dtype, dev)
    for key in KEYS[variant]:
        _check(key, state[key], torch.float32, dev)
    k = state["p"].shape[1] if "p" in state else 0
    if k > MAX_FACTORS:
        raise ValueError(f"the kernel takes at most {MAX_FACTORS} factors, "
                         f"got {k}")
    max_items = rated_pad.shape[1] if variant == "SVD++" else 0
    scratch = (torch.empty(max_items * k, dtype=torch.float32, device=dev)
               if variant == "SVD++" else None)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.neighbors_sgd_fit(
            ptr(users), ptr(items), ptr(ratings), n, ptr(state["bu"]),
            ptr(state["bi"]), ptr(state.get("p")), ptr(state.get("q")),
            ptr(state.get("y")), ptr(rated_pad), ptr(rated_count), max_items,
            ptr(scratch), k, epochs, VARIANTS[variant], mu, lr, reg, stream)
    if err != 0:
        raise RuntimeError(f"{SGD} launch failed ({variant}, n={n}, K={k}): "
                           f"{lib.neighbors_sgd_error_string(err).decode()}")
    launches[SGD] += 1
    return state


def rmw_chain(a: torch.Tensor, n: int) -> None:
    """n dependent read-modify-writes of a[0] by one thread on the card
    (a CUDA f32 tensor); a yardstick, not an op."""
    if a.device.type != "cuda" or a.dtype != torch.float32:
        raise ValueError("rmw_chain takes a CUDA float32 tensor")
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.neighbors_sgd_rmw_chain(a.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(lib.neighbors_sgd_error_string(err).decode())
