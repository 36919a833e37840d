"""NARRE: per-review TextCNN features attended with neighbor-id
embeddings as context, added to id embeddings, then a hadamard-product
MLP head plus biases. Counterpart of `reviews4rec_tpu/models/narre.py`.

The per-review layout is [R=10 reviews, W=100 words]; review slot j of
an entity aligns with neighbor-id slot j (the data pipeline emits both
lists in the same order).

Spans (`train.profiler.annotate`, ranges only while a profiler
records): `narre.towers` (the two per-review TextCNN towers),
`narre.attend` (both sides' review attention) and `narre.head` (id
embeddings, the MLP head and the biases). A step replayed from a CUDA
graph runs none of them; the review counters are the trainer's
(`train.loop.review_counts`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..train.profiler import annotate
from .layers import (Dropout, MLPTower, ScorerMLP, TextCNN, doc_shape,
                     take_rows)


class NARRE(nn.Module):
    # the record keys a forward reads (besides the label and weight)
    INPUTS = ("user", "item", "user_doc", "item_doc", "users_who_gave",
              "items_reviewed", "user_skip", "item_skip")

    def __init__(self, num_user_rows: int, num_item_rows: int,
                 latent_size: int, word_vectors: np.ndarray,
                 dropout: float = 0.6,
                 generator: Optional[torch.Generator] = None,
                 fuse_gather: bool = False,
                 compute_dtype: str = "float32"):
        super().__init__()
        # frozen word table: a buffer, so no optimizer ever sees it
        self.register_buffer("word_vectors", torch.as_tensor(
            np.asarray(word_vectors, np.float32)))
        e = self.word_vectors.shape[1]
        L = latent_size
        self.user_embedding = nn.Parameter(nn.init.xavier_uniform_(
            torch.empty(num_user_rows, L), generator=generator))
        self.item_embedding = nn.Parameter(nn.init.xavier_uniform_(
            torch.empty(num_item_rows, L), generator=generator))
        self.user_conv = TextCNN(e, L, dropout, generator=generator,
                                 fuse_gather=fuse_gather,
                                 compute_dtype=compute_dtype)
        self.item_conv = TextCNN(e, L, dropout, generator=generator,
                                 fuse_gather=fuse_gather,
                                 compute_dtype=compute_dtype)
        self.att_user = ScorerMLP(2 * L, L, dropout, generator=generator)
        self.att_item = ScorerMLP(2 * L, L, dropout, generator=generator)
        self.dropout = Dropout(dropout)
        self.final = MLPTower(L, (L, 1), dropout, generator=generator)
        self.user_bias = nn.Parameter(torch.full((num_user_rows,), 0.1))
        self.item_bias = nn.Parameter(torch.full((num_item_rows,), 0.1))
        self.global_bias = nn.Parameter(torch.full((1,), 4.0))

    @staticmethod
    def _attend(feats: torch.Tensor, ctx: torch.Tensor, scorer: ScorerMLP,
                generator: Optional[torch.Generator],
                skip_row: Optional[torch.Tensor] = None) -> torch.Tensor:
        # feats, ctx: [B, R, L]. skip_row ([B], -1 = none), the entity
        # cache's leakage mask in its rows > 1 form: the pair's own
        # review row is zeroed in feats and ctx, and keeps its share of
        # the softmax
        if skip_row is not None:
            rows = torch.arange(feats.shape[1], device=feats.device)
            hit = (rows[None, :] == skip_row.reshape(-1, 1))[..., None]
            zero = torch.zeros((), dtype=feats.dtype, device=feats.device)
            feats = torch.where(hit, zero, feats)
            ctx = torch.where(hit, zero, ctx)
        scores = scorer(torch.cat([feats, ctx], dim=-1), generator)
        att = torch.softmax(scores, dim=-1)                  # [B, R]
        return torch.sum(att[..., None] * feats, dim=1)      # [B, L]

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # `generator` draws the dropout masks in training. Candidate
        # grids carry the user side at lead [B, 1] and the item side at
        # [B, C]: the user's encoding and attention run once per grid
        # row and broadcast. Docs are int ids [..., R, W] or embedded
        # floats [..., R, W, E] (hp.cache_doc_embeds).
        lead = tuple(batch["item"].shape)
        u_lead, u_tail = doc_shape(batch["user_doc"], 2)
        _, i_tail = doc_shape(batch["item_doc"], 2)
        r = u_tail[0]
        udoc = batch["user_doc"].reshape((-1,) + u_tail)
        idoc = batch["item_doc"].reshape((-1,) + i_tail)
        ub_rows, b = udoc.shape[0], idoc.shape[0]
        user_id = batch["user"].reshape(-1)
        item_id = batch["item"].reshape(-1)
        who_gave = batch["users_who_gave"].reshape(b, -1)[:, :r]
        reviewed = batch["items_reviewed"].reshape(ub_rows, -1)[:, :r]

        # per-review encoding: reviews folded into the batch axis
        wv = self.word_vectors
        with annotate("narre.towers"):
            uf = self.user_conv(udoc.reshape((ub_rows * r,) + u_tail[1:]),
                                table=wv, generator=generator
                                ).reshape(ub_rows, r, -1)
            itf = self.item_conv(idoc.reshape((b * r,) + i_tail[1:]),
                                 table=wv, generator=generator
                                 ).reshape(b, r, -1)

        # the user's reviews attend over the items they were written
        # about, the item's over the users who wrote them
        with annotate("narre.attend"):
            u_att = self._attend(uf, take_rows(self, self.item_embedding,
                                               reviewed),
                                 self.att_user, generator,
                                 batch.get("user_skip"))
            i_att = self._attend(itf, take_rows(self, self.user_embedding,
                                                who_gave),
                                 self.att_item, generator,
                                 batch.get("item_skip"))
            if u_lead != lead:
                u_att = u_att.reshape(u_lead + u_att.shape[-1:]).expand(
                    lead + u_att.shape[-1:]).reshape(-1, u_att.shape[-1])

        with annotate("narre.head"):
            u = u_att + self.dropout(
                take_rows(self, self.user_embedding, user_id), generator)
            i = i_att + self.dropout(
                take_rows(self, self.item_embedding, item_id), generator)
            rating = self.final(u * i, generator)[..., 0]
            out = (rating + take_rows(self, self.user_bias, user_id)
                   + take_rows(self, self.item_bias, item_id)
                   + self.global_bias[0])
        return out.reshape(lead)
