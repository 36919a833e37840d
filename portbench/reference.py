"""The plain reference: DeepCoNN and NARRE written out in plain PyTorch
from the published description and the configuration, in float64 (f32
rounding alone moves some seeds' 10-step trajectories by 1e-5: a bias
whose gradient is near zero takes Adam's full step either way). It imports nothing of the program and takes nothing the
program made: it builds every document from the corpus's own review
lists, computes from the benchmark's weights, draws the dropout masks
from the generator seed the benchmark derives from the run's seed, and
takes its gradients from autograd and its updates from Adam written
out here.

Semantics it shares with the configuration (not with the program's
code):

- a user's (item's) document is its train reviews concatenated in list
  order, the first T words, zero-padded; in training the pair's own
  review is masked in place (its word span zeroed), as the entity cache
  states. NARRE's: the first R reviews a row, W words each, with the
  ids on the other side of those reviews as attention context (pad id
  count + 1), the pair's own review row zeroed in the features and the
  context;
- the TextCNN: W-1 zero words pad each end, relu(conv + b), max over
  every window start (the gradient through the first start that
  reaches it), FC to the latent size, dropout;
- dropout keeps a value where `torch.rand(shape, generator)` (float32)
  < 1 - p
  and scales it by 1 / (1 - p), drawn in the order the forward reads
  the layers, step after step from one generator;
- the loss is the mean squared error over the batch's rows; Adam with
  additive L2 weight decay (betas 0.9, 0.999, eps 1e-8).

`tf32=True` is the control: float32, every product computed on operands
rounded to TF32 (10 mantissa bits, to nearest), the precision the
program would be tempted to drop to.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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
        hp = cfg["hp"]
        self.narre = cfg["model"] == "NARRE"
        self.T = hp["narre_num_words"] if self.narre else hp["input_length"]
        self.R = hp.get("narre_num_reviews", 1)
        self.p = hp["dropout"]
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

    # --- documents --------------------------------------------------------
    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def concat_docs(self, lists, owners, skips=None):
        out = [concat_doc(lists[o], self.T, -1 if skips is None else s)
               for o, s in zip(owners, skips if skips is not None
                               else [-1] * len(owners))]
        return (self._t(np.stack([d for d, _ in out])),
                self._t(np.asarray([s for _, s in out], np.int64)))

    def batch_inputs(self, users, items):
        """The train docs of (user, item) pairs, each masking its own
        review."""
        c = self.corpus
        a = [c.this_index[(int(u), int(i))] for u, i in zip(users, items)]
        if not self.narre:
            ud, us = self.concat_docs(c.user_reviews, users, [x[0] for x in a])
            idd, isp = self.concat_docs(c.item_reviews, items,
                                        [x[1] for x in a])
            return {"udoc": ud, "uspan": us, "idoc": idd, "ispan": isp}
        R, W = self.R, self.T
        u = [rows_doc(c.user_reviews[x], c.u_to_i[x], R, W, c.num_items + 1)
             for x in users]
        it = [rows_doc(c.item_reviews[x], c.i_to_u[x], R, W, c.num_users + 1)
              for x in items]
        return {"udoc": self._t(np.stack([d for d, _ in u])),
                "uctx": self._t(np.stack([x for _, x in u])),
                "idoc": self._t(np.stack([d for d, _ in it])),
                "ictx": self._t(np.stack([x for _, x in it])),
                "uskip": self._t([x[0] if x[0] < R else -1 for x in a]),
                "iskip": self._t([x[1] if x[1] < R else -1 for x in a])}

    # --- models -----------------------------------------------------------
    def fm(self, w: Dict, x: torch.Tensor) -> torch.Tensor:
        v = w["fm.V"]
        xv = self.mm(x, v)
        inter = 0.5 * torch.sum(xv * xv - self.mm(x * x, v * v), dim=-1)
        return inter + self.dense(w, "fm.lin", x)[..., 0]

    def _attend(self, w, scorer, feats, ctx, skip, gen):
        if skip is not None:
            hit = (torch.arange(feats.shape[1], device=feats.device)[None, :]
                   == skip[:, None])[..., None]
            feats = torch.where(hit, torch.zeros((), device=feats.device),
                                feats)
            ctx = torch.where(hit, torch.zeros((), device=ctx.device), ctx)
        h = torch.relu(self.dense(w, scorer + ".fc0",
                                  torch.cat([feats, ctx], dim=-1)))
        s = self.dense(w, scorer + ".fc1", self.drop(h, gen))[..., 0]
        return torch.sum(torch.softmax(s, dim=-1)[..., None] * feats, dim=1)

    def forward(self, w: Dict, users, items, inp: Dict,
                gen: Optional[torch.Generator]) -> torch.Tensor:
        if not self.narre:
            u = self.drop(self.tower(w, "user_conv", inp["udoc"],
                                     inp["uspan"]), gen)
            i = self.drop(self.tower(w, "item_conv", inp["idoc"],
                                     inp["ispan"]), gen)
            return w["global_bias"][0] + self.fm(w, torch.cat([u, i], -1))
        b, R, L = len(users), self.R, self.cfg["hp"]["latent_size"]
        uid, iid = self._t(users).long(), self._t(items).long()
        uf = self.drop(self.tower(w, "user_conv",
                                  inp["udoc"].reshape(b * R, -1)), gen)
        itf = self.drop(self.tower(w, "item_conv",
                                   inp["idoc"].reshape(b * R, -1)), gen)
        ua = self._attend(w, "att_user", uf.reshape(b, R, L),
                          w["item_embedding"][inp["uctx"]], inp["uskip"], gen)
        ia = self._attend(w, "att_item", itf.reshape(b, R, L),
                          w["user_embedding"][inp["ictx"]], inp["iskip"], gen)
        u = ua + self.drop(w["user_embedding"][uid], gen)
        i = ia + self.drop(w["item_embedding"][iid], gen)
        h = torch.relu(self.dense(w, "final.fc0", self.drop(u * i, gen)))
        return (self.dense(w, "final.fc1", h)[..., 0] + w["user_bias"][uid]
                + w["item_bias"][iid] + w["global_bias"][0])

    # --- training ---------------------------------------------------------
    def train(self, batches: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
              gen_seed: int) -> Dict:
        """Steps of Adam from the weights on `batches` (user, item,
        rating), every step's dropout drawn in turn from one generator
        seeded `gen_seed`. Returns each step's loss, Adam's first moment
        after the last step (weight decay in its gradients, as Adam
        takes them) and the parameters after it."""
        hp = self.cfg["hp"]
        lr, wd = hp["lr"], hp["weight_decay"]
        w = {k: v.clone().requires_grad_(True) for k, v in self.w.items()}
        m = {k: torch.zeros_like(v) for k, v in w.items()}
        v2 = {k: torch.zeros_like(v) for k, v in w.items()}
        gen = torch.Generator(device=self.device).manual_seed(gen_seed)
        losses = []
        for step, (users, items, y) in enumerate(batches, start=1):
            inp = self.batch_inputs(users, items)
            pred = self.forward(w, users, items, inp, gen)
            loss = torch.mean((pred - self._t(y)) ** 2)
            grads = torch.autograd.grad(loss, list(w.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                c1, c2 = 1 - BETAS[0] ** step, 1 - BETAS[1] ** step
                for k, gk in zip(w, grads):
                    g = gk + wd * w[k]
                    m[k] = BETAS[0] * m[k] + (1 - BETAS[0]) * g
                    v2[k] = BETAS[1] * v2[k] + (1 - BETAS[1]) * g * g
                    w[k] -= lr * (m[k] / c1) / (torch.sqrt(v2[k] / c2) + EPS)
            del inp, pred, loss, grads
        return {"losses": losses, "exp_avg": m,
                "params": {k: t.detach() for k, t in w.items()}}

    # --- scoring (DeepCoNN) -----------------------------------------------
    @torch.no_grad()
    def encode(self, side: str, ids: Sequence[int], chunk: int = 128
               ) -> torch.Tensor:
        """Eval tower outputs [len(ids), L] of whole documents."""
        lists = (self.corpus.user_reviews if side == "user_conv"
                 else self.corpus.item_reviews)
        out = []
        for s in range(0, len(ids), chunk):
            docs, _ = self.concat_docs(lists, ids[s:s + chunk])
            out.append(self.tower(self.w, side, docs))
        return torch.cat(out)

    @torch.no_grad()
    def score(self, u: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        """Eval scores of paired tower outputs [..., L]."""
        return self.w["global_bias"][0] + self.fm(self.w, torch.cat([u, i], -1))
