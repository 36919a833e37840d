"""MPCN: Multi-Pointer Co-Attention Networks. Counterpart of
`reviews4rec_tpu/models/mpcn.py`, with its parameter names and layouts.

Per side, each review is encoded from a TRAINED word table
(`word_embedding`: xavier, or the corpus word2vec under
`pretrained_words`; gathered with `F.embedding`, whose backward on CUDA
sorts the indices, so two runs of a step give the same bits): the sum of
its word embeddings (NBOW) or a window-3 conv, ReLU and max over words
(CNN). A projection shared by both sides (`trans_proj`, ReLU Dense, or
the `trans_proj_hw` highway) maps them to `hidden`. Then per head:

1. review-level co-attention (`mpcn_<h>`), MAX-pooled, whose Gumbel
   pointer picks one review per side in training (fresh noise from the
   forward's generator, or the fixed uniforms of `gumbel_u`) and the
   hard pointer at eval; an exact tie (padded reviews all encode alike)
   sums the tied reviews, as JAX's `== max` pointer does;
2. the picked review's words: the pointer-weighted sum over reviews;
3. word-level co-attention (`inner_<h>`), MEAN-pooled over all `smax`
   words (pads included), softmax weights, summed over words.

The heads' outputs and the summed review reps go through one shared
ReLU Dense (`final_proj`) per side, dropout, and a head: FM (MPCN's own
inline one: `fm_V` [2E, factors] and `fm_lin`; dropout first), DOT, MF
(`mf_hidden`) or MLP (`mlp0`, `mlp1`, `mlp_out`). joint "D_ATT" instead
runs `DualAttention` over each side's flat document. Dropout is at rate
1 - `dropout_keep`, each application its own mask. At eval the rating
is clipped to [rating_min, rating_max]; in training it is not.

Candidate grids carry the user side at lead [B, 1]: the user docs are
broadcast to [B, C] before the reshape, because co-attention couples
each candidate pair.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .att import CoAttention, DualAttention
from .layers import Dropout, Highway, _linear, take_rows

HEADS = ("FM", "DOT", "MLP", "MF")
ENCODERS = ("NBOW", "CNN")
JOINTS = ("MPCN", "D_ATT")
PROJECTIONS = ("FC", "HIGH")


def _xavier(shape, generator) -> nn.Parameter:
    return nn.Parameter(nn.init.xavier_uniform_(torch.empty(shape),
                                                generator=generator))


class MPCN(nn.Module):
    # the record keys a forward reads (besides the label and weight)
    INPUTS = ("user", "item", "user_doc", "item_doc")

    def __init__(self, num_user_rows: int, num_item_rows: int, hidden: int,
                 word_vectors: np.ndarray, num_heads: int = 1,
                 temperature: float = 0.5, factors: int = 10,
                 dropout_keep: float = 0.8, rating_min: float = 1.0,
                 rating_max: float = 5.0, affinity: str = "SOFT",
                 encoder: str = "NBOW", head: str = "FM",
                 joint: str = "MPCN", pretrained_words: bool = False,
                 projection: str = "FC",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"head {head!r} not in {HEADS}")
        if encoder not in ENCODERS:
            raise ValueError(f"encoder {encoder!r} not in {ENCODERS}")
        if joint not in JOINTS:
            raise ValueError(f"joint {joint!r} not in {JOINTS}")
        if projection not in PROJECTIONS:
            raise ValueError(
                f"projection {projection!r} not in {PROJECTIONS}")
        wv = np.asarray(word_vectors, np.float32)
        vocab, e = wv.shape
        self.hidden, self.num_heads = hidden, num_heads
        self.rating_min, self.rating_max = rating_min, rating_max
        self.head, self.encoder, self.joint = head, encoder, joint
        self.projection = projection
        rate = 1.0 - dropout_keep
        # fixed Gumbel uniforms for training, one (u_a, u_b) per head;
        # None draws them from the forward's generator
        self.gumbel_u: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
        self.word_embedding = (nn.Parameter(torch.from_numpy(wv.copy()))
                               if pretrained_words
                               else _xavier((vocab, e), generator))
        if joint == "D_ATT":
            self.dual_att = DualAttention(e, hidden, rate, generator)
            width = hidden
        else:
            rep = e
            if encoder == "CNN":
                self.cnn_kernel = _xavier((3 * e, hidden), generator)
                self.cnn_bias = nn.Parameter(torch.full((hidden,), 0.1))
                rep = hidden
            if projection == "HIGH":
                self.trans_proj_hw = Highway(rep, hidden, generator)
            else:
                self.trans_proj = _linear(rep, hidden, generator)
            for h in range(num_heads):
                self.add_module(f"mpcn_{h}", CoAttention(
                    hidden, affinity, "MAX", gumbel=True,
                    temperature=temperature, dropout_rate=rate,
                    generator=generator))
                self.add_module(f"inner_{h}", CoAttention(
                    e, affinity, "MEAN", dropout_rate=rate,
                    generator=generator))
            self.final_proj = _linear(num_heads * e + hidden, e, generator)
            width = e
        self.dropout = Dropout(rate)
        if head == "MF":
            self.mf_hidden = _xavier((width, 1), generator)
        elif head == "MLP":
            self.mlp0 = _linear(3 * width, hidden, generator)
            self.mlp1 = _linear(hidden, hidden, generator)
            self.mlp_out = _linear(hidden, 1, generator)
        elif head == "FM":
            self.fm_V = _xavier((2 * width, factors), generator)
            self.fm_lin = _linear(2 * width, 1, generator)

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        if getattr(self, "row_lookup", None) is not None:
            return take_rows(self, self.word_embedding, ids)
        return F.embedding(ids, self.word_embedding)

    def _reviews(self, doc: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """(review reps [b, dmax, H|E], word embeddings [b, dmax, smax*E])
        of int docs [b, dmax, smax]."""
        b, dmax, smax = doc.shape
        emb = self._embed(doc.reshape(b * dmax, smax))
        if self.encoder == "CNN":
            win = F.pad(emb, (0, 0, 1, 1)).unfold(1, 3, 1).transpose(-1, -2)
            win = win.reshape(b * dmax, smax, -1)
            reps = torch.relu(win @ self.cnn_kernel + self.cnn_bias
                              ).amax(dim=1)
        else:
            reps = emb.sum(dim=1)
        return reps.reshape(b, dmax, -1), emb.reshape(b, dmax, -1)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        lead = tuple(batch["item"].shape)
        udoc = batch["user_doc"]
        dmax, smax = udoc.shape[-2:]
        if tuple(udoc.shape[:-2]) != lead:
            udoc = udoc.expand(lead + (dmax, smax))
        udoc = udoc.reshape(-1, dmax, smax)
        idoc = batch["item_doc"].reshape(-1, dmax, smax)
        b = udoc.shape[0]

        if self.joint == "D_ATT":
            u = self.dual_att(self._embed(udoc.reshape(b, dmax * smax)),
                              generator)
            i = self.dual_att(self._embed(idoc.reshape(b, dmax * smax)),
                              generator)
            return self._clip(self._rec_output(u, i, generator)).reshape(lead)

        q1, o1 = self._reviews(udoc)
        q2, o2 = self._reviews(idoc)
        if self.projection == "HIGH":
            q1, q2 = self.trans_proj_hw(q1), self.trans_proj_hw(q2)
        else:
            q1 = torch.relu(self.trans_proj(q1))
            q2 = torch.relu(self.trans_proj(q2))
        e = self.word_embedding.shape[1]
        f1, f2 = [], []
        for h in range(self.num_heads):
            u = self.gumbel_u[h] if self.gumbel_u is not None else None
            _, _, a1, a2, _ = getattr(self, f"mpcn_{h}")(
                q1, q2, generator, u=u, finals=False)
            sel1 = (o1 * a1[..., None]).sum(dim=1).reshape(b, smax, e)
            sel2 = (o2 * a2[..., None]).sum(dim=1).reshape(b, smax, e)
            z1, z2, _, _, _ = getattr(self, f"inner_{h}")(sel1, sel2,
                                                          generator)
            f1.append(z1.sum(dim=1))
            f2.append(z2.sum(dim=1))
        f1.append(q1.sum(dim=1))
        f2.append(q2.sum(dim=1))
        u = torch.relu(self.final_proj(torch.cat(f1, dim=-1)))
        i = torch.relu(self.final_proj(torch.cat(f2, dim=-1)))
        u, i = self.dropout(u, generator), self.dropout(i, generator)
        return self._clip(self._rec_output(u, i, generator)).reshape(lead)

    def _clip(self, out: torch.Tensor) -> torch.Tensor:
        """The rating scale's clip, at eval only."""
        if self.training:
            return out
        return out.clamp(self.rating_min, self.rating_max)

    def _rec_output(self, u: torch.Tensor, i: torch.Tensor,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.head == "DOT":
            return (u * i).sum(dim=-1)
        if self.head == "MF":
            return ((u * i) @ self.mf_hidden)[..., 0]
        if self.head == "MLP":
            x = torch.cat([u, i, u * i], dim=-1)
            for layer in (self.mlp0, self.mlp1):
                x = torch.relu(layer(self.dropout(x, generator)))
            return self.mlp_out(x)[..., 0]
        x = self.dropout(torch.cat([u, i], dim=-1), generator)
        v = self.fm_V
        xv = x @ v
        inter = 0.5 * torch.sum(xv * xv - (x * x) @ (v * v), dim=-1)
        return inter + self.fm_lin(x)[..., 0]
