"""The per-example SGD of the surprise-equivalent baseline, SVD and SVD++
models (the JAX package's `models/neighbors.py::_sgd_fit`, a `lax.scan`
over the train stream there).

- `sgd_fit_reference`: the plain PyTorch version, a Python loop over
  epochs and examples in train insertion order (any device). The CPU
  tests hold it against the JAX package; the GPU checks hold the kernel
  against it on a cut of the corpus.
- `sgd_fit`: the plain version for CPU tensors, else one launch of
  `csrc/neighbors_sgd.cu` for the whole fit (adds one to `SGD` in
  `train.profiler.counters`). The state dict is updated in place on the
  card and returned; the plain version works on clones.
- `slot_table`: SVD++'s lists as (item, mult) slots, built once a fit;
  both versions apply the y updates through it (`pack_slots`: the
  kernel's packed form, with each example's list count).
- `placement`: the state arrays the kernel keeps in shared memory.
- `rmw_chain`: a yardstick, n dependent read-modify-writes of one float
  on the card (the latency that bounds the recurrence).

The state dict holds f32 `bu` [U], `bi` [I] and, for SVD and SVD++, `p`
[U, K] and `q` [I, K]; for SVD++ also `y` [I, K], with the user's train
items `rated_pad` [U, max_items] int32 and their count `rated_count` [U]
f32 (the pad slots past the count are skipped).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..train.profiler import count
from . import _build

SGD = "neighbors_sgd"
VARIANTS = {"baseline": 0, "SVD": 1, "SVD++": 2}
KEYS = {"baseline": ("bu", "bi"), "SVD": ("bu", "bi", "p", "q"),
        "SVD++": ("bu", "bi", "p", "q", "y")}
MAX_FACTORS = 128
# the arrays the kernel may keep in shared memory, in the order the host
# places them (the most read first), and their bits in its `smem_mask`
PLACE_ORDER = ("y", "q", "bi", "bu", "p")
PLACE_BITS = {"bu": 1, "bi": 2, "p": 4, "q": 8, "y": 16}
# the bytes of shared memory the state may take on an H100: its opt-in
# 232,448 a block less the kernel's 2,048 for SVD++'s partial sums (what
# `neighbors_sgd_smem_limit` gives there); the default budget
H100_SMEM_BUDGET = 232448 - 2048
# the kernel packs a slot as item | mult << 24 in an int32
ITEM_LIMIT = 1 << 24
MULT_LIMIT = 1 << 7


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
    lists = firsts = None
    if variant == "SVD++":
        table = slot_table(rated_pad, rated_count)
        counts = rated_count.tolist()
        lists, firsts = {}, {}
        # per user of the stream: the list, and the first slot of each
        # item with its item and multiplicity
        for u in set(uu):
            c = int(counts[u])
            lists[u] = rated_pad[u, :c].long()
            mult = table[u, :c, 1].long()
            first = (mult > 0).nonzero().flatten()
            firsts[u] = (first, table[u, first, 0].long(), mult[first])
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
                first, fitems, mult = firsts[u]
                # an item listed m times: m equal updates, one after
                # another (the items of one pass are distinct)
                for rep in range(int(mult.max()) if len(mult) else 0):
                    sel = mult > rep
                    st["y"].index_add_(0, fitems[sel], upd[first[sel]])
    return st


def slot_table(rated_pad: torch.Tensor, rated_count: torch.Tensor
               ) -> torch.Tensor:
    """[U, max_items, 2] int32 (item, mult) on the device of `rated_pad`:
    the item of each slot, and at the first slot of an item among a
    user's first `rated_count` slots its count there (0 at its later
    slots and at the pad slots). JAX's `.at[items_u].add` gives an item
    listed m times m updates; the kernel adds them at the first slot."""
    U, width = rated_pad.shape
    dev = rated_pad.device
    pad = rated_pad.long()
    valid = (torch.arange(width, device=dev)[None, :]
             < rated_count.to(dev)[:, None])
    # a stable sort puts each item's slots together, its first slot first;
    # the pad slots sort last as one run of their own
    key = torch.where(valid, pad, torch.full_like(pad, torch.iinfo(
        torch.int64).max))
    srt, order = torch.sort(key, dim=1, stable=True)
    start = torch.ones_like(srt, dtype=torch.bool)
    start[:, 1:] = srt[:, 1:] != srt[:, :-1]
    run = torch.cumsum(start.long(), dim=1) - 1
    length = torch.zeros_like(srt).scatter_add_(1, run, torch.ones_like(srt))
    mult_sorted = torch.where(start, length.gather(1, run),
                              torch.zeros_like(srt))
    mult = torch.zeros_like(srt).scatter_(1, order, mult_sorted)
    mult = torch.where(valid, mult, torch.zeros_like(mult))
    return torch.stack((pad, mult), dim=-1).to(torch.int32).contiguous()


def state_bytes(name: str, num_users: int, num_items: int, k: int) -> int:
    """Bytes of one state array in the kernel's shared memory (16-byte
    aligned), as the kernel's `placed_bytes` counts them."""
    rows = num_users if name in ("bu", "p") else num_items
    cols = k if name in ("p", "q", "y") else 1
    return (4 * rows * cols + 15) // 16 * 16


def placement(variant: str, num_users: int, num_items: int, k: int,
              budget: int = H100_SMEM_BUDGET) -> Tuple[str, ...]:
    """The state arrays of `variant` the kernel keeps in shared memory:
    in `PLACE_ORDER`, each that still fits in `budget` bytes (the card's
    shared memory the state may take); the rest stay in global memory."""
    placed, left = [], budget
    for name in PLACE_ORDER:
        if name not in KEYS[variant]:
            continue
        need = state_bytes(name, num_users, num_items, k)
        if need <= left:
            placed.append(name)
            left -= need
    return tuple(placed)


def slot_step(k: int) -> int:
    """The multiple the kernel's SVD++ slot table's width must be at K
    factors: its slot groups (4 warps x 32 lanes over K rounded up to a
    power of two, at most 32 lanes a row) x the slots a lane skips
    together (4, 2 or 1 as a lane owns 1, 2 or 4 factors)."""
    lanes = 1
    while lanes < min(k, 32):
        lanes *= 2
    return 4 * 32 // lanes * (4 if k <= 32 else 2 if k <= 64 else 1)


def pack_slots(table: torch.Tensor, rated_count: torch.Tensor,
               users: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's form of `slot_table`: (slots [U, width] int32 of item
    | mult << 24, width the longest list rounded up to a multiple of
    `slot_step(k)`; meta [n] int32 of each example's list count, bit 30
    set where the list repeats an item)."""
    U, longest = table.shape[:2]
    if table.shape[0] and int(table[..., 0].max()) >= ITEM_LIMIT:
        raise ValueError(f"the kernel takes item ids below {ITEM_LIMIT}")
    mult = table[..., 1]
    if table.numel() and int(mult.max()) >= MULT_LIMIT:
        raise ValueError(f"the kernel takes an item at most "
                         f"{MULT_LIMIT - 1} times in a list")
    step = slot_step(k)
    width = -(-max(longest, 1) // step) * step
    packed = torch.zeros(U, width, dtype=torch.int32, device=table.device)
    packed[:, :longest] = table[..., 0] | (mult << 24)
    rep = (mult > 1).any(dim=1).to(torch.int32)
    cnt = rated_count.to(table.device).to(torch.int32)
    meta = (cnt | (rep << 30))[users.long()]
    return packed.contiguous(), meta.contiguous()


def _library() -> ctypes.CDLL:
    lib = _build.load(SGD)
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.neighbors_sgd_fit.argtypes = ([p] * 5 + [i] + [p] * 6
                                          + [i] * 6 + [f, f, f, i, p])
        lib.neighbors_sgd_fit.restype = i
        lib.neighbors_sgd_smem_limit.argtypes = [ctypes.POINTER(i)]
        lib.neighbors_sgd_smem_limit.restype = i
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
    U, I = state["bu"].shape[0], state["bi"].shape[0]
    k = state["p"].shape[1] if "p" in state else 0
    want = {"bu": (U,), "bi": (I,), "p": (U, k), "q": (I, k), "y": (I, k)}
    for key in KEYS[variant]:
        if tuple(state[key].shape) != want[key]:
            raise ValueError(f"{key} must be {want[key]}, got "
                             f"{tuple(state[key].shape)}")
    if variant == "SVD++" and (rated_pad.dim() != 2
                               or rated_pad.shape[0] != U
                               or tuple(rated_count.shape) != (U,)):
        raise ValueError(f"rated_pad must be [{U}, max_items] and "
                         f"rated_count [{U}], got {tuple(rated_pad.shape)}, "
                         f"{tuple(rated_count.shape)}")
    if k > MAX_FACTORS:
        raise ValueError(f"the kernel takes at most {MAX_FACTORS} factors, "
                         f"got {k}")
    lim = 2 ** 31 - 64  # the kernel's indices are 32-bit
    if max(n * epochs, U * k, I * k) >= lim:
        raise ValueError(f"the kernel takes epochs * n, U * K and I * K "
                         f"below {lim}, got {epochs} x {n}, {U} x {k}, "
                         f"{I} x {k}")
    slots = meta = sqs = None
    width = 0
    if variant == "SVD++":
        slots, meta = pack_slots(slot_table(rated_pad, rated_count),
                                 rated_count, users, k)
        # each example's |I_u|^-1/2, as the plain version computes it
        sqs = torch.rsqrt(torch.clamp(rated_count, min=1.0))[users.long()]
        width = slots.shape[1]
        if U * width >= lim:
            raise ValueError(f"the kernel takes U * width below {lim}, got "
                             f"{U} x {width}")

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib = _library()
    with torch.cuda.device(dev):
        limit = ctypes.c_int(0)
        err = lib.neighbors_sgd_smem_limit(ctypes.byref(limit))
        if err == 0:
            mask = sum(PLACE_BITS[name] for name in
                       placement(variant, U, I, k, limit.value))
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.neighbors_sgd_fit(
                ptr(users), ptr(items), ptr(ratings), ptr(meta), ptr(sqs), n,
                ptr(state["bu"]), ptr(state["bi"]), ptr(state.get("p")),
                ptr(state.get("q")), ptr(state.get("y")), ptr(slots), U, I,
                width, k, epochs, VARIANTS[variant], mu, lr, reg, mask,
                stream)
    if err != 0:
        raise RuntimeError(f"{SGD} launch failed ({variant}, n={n}, K={k}): "
                           f"{lib.neighbors_sgd_error_string(err).decode()}")
    count(SGD)
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
