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

from .layers import FM, ScorerMLP, TextCNN, doc_shape, take_rows


class DeepCoNN(nn.Module):
    # the record keys a forward reads (besides the label and weight)
    INPUTS = ("user", "item", "user_doc", "item_doc", "user_skip",
              "item_skip", "user_doc__table", "item_doc__table")

    def __init__(self, num_user_rows: int, num_item_rows: int,
                 latent_size: int, word_vectors: np.ndarray,
                 dropout: float = 0.6, use_fm: bool = True,
                 generator: Optional[torch.Generator] = None,
                 fuse_gather: bool = False,
                 compute_dtype: str = "float32"):
        super().__init__()
        # frozen word table: a buffer, so no optimizer ever sees it
        self.register_buffer("word_vectors", torch.as_tensor(
            np.asarray(word_vectors, np.float32)))
        e = self.word_vectors.shape[1]
        L = latent_size
        self.use_fm = use_fm
        self.user_conv = TextCNN(e, L, dropout, generator=generator,
                                 fuse_gather=fuse_gather,
                                 compute_dtype=compute_dtype)
        self.item_conv = TextCNN(e, L, dropout, generator=generator,
                                 fuse_gather=fuse_gather,
                                 compute_dtype=compute_dtype)
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
        # Under hp.pallas_fuse_rows a `<side>_doc__table` key carries the
        # WHOLE per-entity doc table, read by entity id in the kernels.
        lead = tuple(batch["item"].shape)
        u_rows = i_rows = None
        if "user_doc__table" in batch:
            udoc = batch["user_doc__table"]
            u_rows = batch["user"].reshape(-1)
            u_lead = lead
        else:
            u_lead, u_tail = doc_shape(batch["user_doc"], 1)
            udoc = batch["user_doc"].reshape((-1,) + u_tail)
        if "item_doc__table" in batch:
            idoc = batch["item_doc__table"]
            i_rows = batch["item"].reshape(-1)
        else:
            _, i_tail = doc_shape(batch["item_doc"], 1)
            idoc = batch["item_doc"].reshape((-1,) + i_tail)
        u_skip = batch.get("user_skip")
        i_skip = batch.get("item_skip")
        if u_skip is not None:
            u_skip = u_skip.reshape(-1, 2).to(torch.int32).contiguous()
        if i_skip is not None:
            i_skip = i_skip.reshape(-1, 2).to(torch.int32).contiguous()
        wv = self.word_vectors
        u = self.user_conv(udoc, table=wv, skip=u_skip, generator=generator,
                           rows=u_rows)
        i = self.item_conv(idoc, table=wv, skip=i_skip, generator=generator,
                           rows=i_rows)
        if u_lead != lead:
            u = u.reshape(u_lead + u.shape[-1:]).expand(
                lead + u.shape[-1:]).reshape(-1, u.shape[-1])
        return self.pair_head(u, i, batch["user"], batch["item"],
                              generator).reshape(lead)

    # The split a ranking call factorizes its grid by
    # (`train.evaluate.score_grid`): each distinct entity's tower once,
    # then the head on each pair's two tower vectors.
    def entity_towers(self, side: str, table: torch.Tensor,
                      ids: torch.Tensor) -> torch.Tensor:
        """[n, L] tower outputs of `side`'s ("user" or "item") entities
        `ids` ([n] int), read by id from the side's entity doc table
        (`train.loop.build_entity_tables`: f32 [N, T, E] to the
        row-gathered kernels, or int [N, T] word ids)."""
        conv = self.user_conv if side == "user" else self.item_conv
        return conv(table, table=self.word_vectors, rows=ids)

    def pair_head(self, u: torch.Tensor, i: torch.Tensor,
                  users: torch.Tensor, items: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """[P] ratings of P pairs from their [P, L] user and item tower
        vectors and their user and item ids (P of each, in any shape;
        only deepconn++'s biases read them)."""
        cat = torch.cat([u, i], dim=-1)
        if self.use_fm:
            return self.global_bias[0] + self.fm(cat)
        return (self.final(cat, generator)
                + take_rows(self, self.user_bias, users.reshape(-1))
                + take_rows(self, self.item_bias, items.reshape(-1))
                + self.global_bias[0])
