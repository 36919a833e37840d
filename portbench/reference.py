"""The plain reference: each model written out in plain PyTorch from
the published description and the configuration, in float64 (f32
rounding alone moves some seeds' 10-step trajectories by 1e-5: a bias
whose gradient is near zero takes Adam's full step either way). It
imports nothing of the program and takes nothing the program made: it
builds every document from the corpus's own review lists, computes from
the benchmark's weights, draws the dropout masks from the generator
seed the benchmark derives from the run's seed, and takes its gradients
from autograd and its updates from Adam written out here.

What differs between models (their documents, forward, ranking scores,
and where one trains otherwise its objective and update) lies in the
model's file, `portbench/models/<model>.py`; this class holds what
every model shares. Semantics it shares with the configuration (not
with the program's code):

- the TextCNN: W-1 zero words pad each end, relu(conv + b), max over
  every window start (the gradient through the first start that
  reaches it), FC to the latent size, dropout;
- dropout keeps a value where `torch.rand(shape, generator)` (float32)
  < 1 - p
  and scales it by 1 / (1 - p), drawn in the order the forward reads
  the layers, step after step from one generator;
- unless the model's file says otherwise, the loss is the mean squared
  error over the batch's rows, and the update Adam with additive L2
  weight decay (betas 0.9, 0.999, eps 1e-8). The loss each step
  reports is the rating's mean squared error either way.

`tf32=True` is the control: float32, every product computed on operands
rounded to TF32 (10 mantissa bits, to nearest), the precision the
program would be tempted to drop to.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import models

BETAS, EPS = (0.9, 0.999), 1e-8


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits, ties to even."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b on TF32 operands, forward and backward, as a TF32 tensor
    core computes a product and its two gradients."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.transpose(-1, -2), (
            a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1]))


def concat_doc(revs: Sequence[np.ndarray], t: int, skip: int = -1
               ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """The first t words of `revs` concatenated, and the (start, len)
    word span of review `skip` in it ((0, 0) for none)."""
    doc = np.zeros(t, np.int64)
    at, span = 0, (0, 0)
    for j, r in enumerate(revs):
        m = max(min(len(r), t - at), 0)
        if j == skip:
            span = (min(at, t), m)
        doc[at:at + m] = r[:m]
        at += len(r)
    return doc, span


def rows_doc(revs: Sequence[np.ndarray], others: Sequence[int], rows: int,
             words: int, pad: int) -> Tuple[np.ndarray, np.ndarray]:
    """NARRE's [rows, words] document and its [rows] context ids."""
    doc = np.zeros((rows, words), np.int64)
    ctx = np.full(rows, pad, np.int64)
    for j, (r, o) in enumerate(zip(revs[:rows], others[:rows])):
        doc[j, :min(len(r), words)] = r[:words]
        ctx[j] = o
    return doc, ctx


class Reference:
    def __init__(self, cfg: Dict, corpus, weights: Dict[str, torch.Tensor],
                 device: torch.device, tf32: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.corpus, self.device, self.tf32 = cfg, corpus, device, tf32
        self.arch = models.load(cfg["model"])
        shape = self.arch.towers(cfg)
        self.T, self.R = shape["t"], shape["docs"]
        self.p = cfg["hp"]["dropout"]
        self.window = cfg["window"]
        dtype = torch.float32 if tf32 else torch.float64
        self.wv = torch.as_tensor(corpus.word_vectors, device=device,
                                  dtype=dtype)
        self.w = {k: v.detach().to(dtype=dtype, copy=True)
                  for k, v in weights.items()}

    # --- arithmetic -----------------------------------------------------
    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return _TF32MatMul.apply(a, b)
        return a @ b

    def dense(self, w: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.mm(x, w[name + ".weight"].T) + w[name + ".bias"]

    def drop(self, x: torch.Tensor, gen: Optional[torch.Generator]):
        if gen is None:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=gen, device=x.device,
                          dtype=torch.float32) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def textcnn(self, x: torch.Tensor, k: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
        n, t, e = x.shape
        h = self.window - 1
        xp = F.pad(x, (0, 0, h, h))
        win = xp.unfold(1, self.window, 1).transpose(2, 3).reshape(
            n, t + h, self.window * e)
        y = torch.relu(self.mm(win, k) + b)
        with torch.no_grad():
            first = (y == y.amax(dim=1, keepdim=True)).float().argmax(dim=1)
        return y.gather(1, first[:, None, :])[:, 0, :]

    def tower(self, w: Dict, side: str, ids: torch.Tensor,
              spans: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The TextCNN and FC of `side` on word-id docs [N, T]; `spans`
        [N, 2] zero each doc's own review."""
        x = self.wv[ids]
        if spans is not None:
            ts = torch.arange(ids.shape[1], device=ids.device)[None, :]
            inside = (ts >= spans[:, :1]) & (ts < spans[:, :1] + spans[:, 1:])
            x = torch.where(inside[..., None], torch.zeros((), device=x.device),
                            x)
        y = self.textcnn(x, w[f"{side}.conv_kernel"], w[f"{side}.conv_bias"])
        return self.dense(w, f"{side}.fc", y)

    def fm(self, w: Dict, x: torch.Tensor) -> torch.Tensor:
        v = w["fm.V"]
        xv = self.mm(x, v)
        inter = 0.5 * torch.sum(xv * xv - self.mm(x * x, v * v), dim=-1)
        return inter + self.dense(w, "fm.lin", x)[..., 0]

    # --- documents --------------------------------------------------------
    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def concat_docs(self, lists, owners, skips=None):
        out = [concat_doc(lists[o], self.T, -1 if skips is None else s)
               for o, s in zip(owners, skips if skips is not None
                               else [-1] * len(owners))]
        return (self._t(np.stack([d for d, _ in out])),
                self._t(np.asarray([s for _, s in out], np.int64)))

    # --- the model's file -------------------------------------------------
    def batch_inputs(self, users, items) -> Dict:
        """The training inputs of (user, item) pairs, each masking its
        own review."""
        return self.arch.batch_inputs(self, users, items)

    def forward(self, w: Dict, users, items, inp: Dict,
                gen: Optional[torch.Generator]) -> torch.Tensor:
        """The rating prediction of each pair."""
        return self.arch.forward(self, w, users, items, inp, gen)

    def encode(self, *a, **kw) -> torch.Tensor:
        """Eval tower outputs, where the model's file has them."""
        return models.need(self.arch, "encode")(self, *a, **kw)

    def score(self, *a, **kw) -> torch.Tensor:
        """Eval scores of tower outputs, where the model's file has them."""
        return models.need(self.arch, "score")(self, *a, **kw)

    def rank_scores(self, users: np.ndarray, grid: np.ndarray) -> np.ndarray:
        """[M, C] eval scores of each grid row's user and candidates."""
        return models.need(self.arch, "rank_scores")(self, users, grid)

    # --- training ---------------------------------------------------------
    def train(self, batches: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
              gen_seed: int) -> Dict:
        """Steps from the weights on `batches` (user, item, rating), every
        step's dropout drawn in turn from one generator seeded
        `gen_seed`, by the model's objective and update (the defaults:
        the mean squared error, `adam_l2`). Returns each step's rating
        mean squared error, the update's first moment after the last
        step (weight decay in its gradients, as Adam takes them) and the
        parameters after it."""
        objective = getattr(self.arch, "objective", None)
        update = getattr(self.arch, "update", adam_l2)
        w = {k: v.clone().requires_grad_(True) for k, v in self.w.items()}
        state = {"exp_avg": {k: torch.zeros_like(v) for k, v in w.items()},
                 "exp_avg_sq": {k: torch.zeros_like(v) for k, v in w.items()}}
        gen = torch.Generator(device=self.device).manual_seed(gen_seed)
        losses = []
        for step, (users, items, y) in enumerate(batches, start=1):
            inp = self.batch_inputs(users, items)
            pred = self.forward(w, users, items, inp, gen)
            y = self._t(y)
            mse = torch.mean((pred - y) ** 2)
            loss = mse if objective is None else objective(self, pred, y)
            grads = torch.autograd.grad(loss, list(w.values()))
            losses.append(float(mse.detach()))
            with torch.no_grad():
                update(self, w, dict(zip(w, grads)), state, step)
            del inp, pred, mse, loss, grads
        return {"losses": losses, "exp_avg": state["exp_avg"],
                "params": {k: t.detach() for k, t in w.items()}}


def adam_l2(ref: Reference, w: Dict[str, torch.Tensor],
            grads: Dict[str, torch.Tensor], state: Dict, step: int) -> None:
    """Adam with additive L2 weight decay, in place on `w` and `state`
    ("exp_avg", "exp_avg_sq"); `step` counts from 1."""
    hp = ref.cfg["hp"]
    lr, wd = hp["lr"], hp["weight_decay"]
    m, v2 = state["exp_avg"], state["exp_avg_sq"]
    c1, c2 = 1 - BETAS[0] ** step, 1 - BETAS[1] ** step
    for k, gk in grads.items():
        g = gk + wd * w[k]
        m[k] = BETAS[0] * m[k] + (1 - BETAS[0]) * g
        v2[k] = BETAS[1] * v2[k] + (1 - BETAS[1]) * g * g
        w[k] -= lr * (m[k] / c1) / (torch.sqrt(v2[k] / c2) + EPS)
