"""DeepCoNN / DeepCoNN++: two TextCNN towers over the user's and the
item's concatenated review documents (frozen word vectors), joined by an
FM head plus global bias ('deepconn') or an MLP head plus per-entity
biases ('deepconn++'). Counterpart of `reviews4rec_tpu/models/deepconn.py`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .layers import FM, ScorerMLP, TextCNN, doc_shape


class DeepCoNN(nn.Module):
    # the record keys a forward reads (besides the label and weight)
    INPUTS = ("user", "item", "user_doc", "item_doc", "user_skip",
              "item_skip")

    def __init__(self, num_user_rows: int, num_item_rows: int,
                 latent_size: int, word_vectors: np.ndarray,
                 dropout: float = 0.6, use_fm: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # frozen word table: a buffer, so no optimizer ever sees it
        self.register_buffer("word_vectors", torch.as_tensor(
            np.asarray(word_vectors, np.float32)))
        e = self.word_vectors.shape[1]
        L = latent_size
        self.use_fm = use_fm
        self.user_conv = TextCNN(e, L, dropout, generator=generator)
        self.item_conv = TextCNN(e, L, dropout, generator=generator)
        self.global_bias = nn.Parameter(torch.full((1,), 4.0))
        if use_fm:
            self.fm = FM(2 * L, 8, generator=generator)
        else:
            self.user_bias = nn.Parameter(torch.full((num_user_rows,), 0.1))
            self.item_bias = nn.Parameter(torch.full((num_item_rows,), 0.1))
            self.final = ScorerMLP(2 * L, L, dropout, generator=generator)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # `generator` draws the dropout masks in training
        # Candidate grids carry the user side at lead [B, 1] (identical
        # across the C candidates) and the item side at [B, C]: the user
        # tower runs once per grid row and its features broadcast.
        lead = tuple(batch["item"].shape)
        u_lead, u_tail = doc_shape(batch["user_doc"], 1)
        _, i_tail = doc_shape(batch["item_doc"], 1)
        udoc = batch["user_doc"].reshape((-1,) + u_tail)
        idoc = batch["item_doc"].reshape((-1,) + i_tail)
        u_skip = batch.get("user_skip")
        i_skip = batch.get("item_skip")
        if u_skip is not None:
            u_skip = u_skip.reshape(-1, 2).to(torch.int32).contiguous()
        if i_skip is not None:
            i_skip = i_skip.reshape(-1, 2).to(torch.int32).contiguous()
        wv = self.word_vectors
        u = self.user_conv(udoc, table=wv, skip=u_skip, generator=generator)
        i = self.item_conv(idoc, table=wv, skip=i_skip, generator=generator)
        if u_lead != lead:
            u = u.reshape(u_lead + u.shape[-1:]).expand(
                lead + u.shape[-1:]).reshape(-1, u.shape[-1])
        cat = torch.cat([u, i], dim=-1)

        if self.use_fm:
            return (self.global_bias[0] + self.fm(cat)).reshape(lead)
        rating = (self.final(cat, generator)
                  + self.user_bias[batch["user"].reshape(-1)]
                  + self.item_bias[batch["item"].reshape(-1)]
                  + self.global_bias[0])
        return rating.reshape(lead)
