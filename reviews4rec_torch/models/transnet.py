"""TransNet / TransNet++: a source net (TextCNNs over the user's and the
item's review docs, a 2-layer transform to `source_ir`, an FM) and a
target net (a TextCNN over the pair's own review `this_doc`, an FM),
tied by the transform loss ||source_ir - target_ir||^2. '++' adds 5-d
id embeddings to the source FM's input. Counterpart of
`reviews4rec_tpu/models/transnet.py`.

The forward returns (source prediction, target prediction, transform
loss). `.detach()` routes each loss to the parameters whose optimizer it
steps in the reference's three-optimizer schedule
(`train/loop.py` has the derivation):
  - target conv + FM       <- MSE(target)
  - source convs + project <- ||source_ir - target_ir.detach()||^2
  - source FM (+ id embeddings in '++') <- MSE(source), with
    source_ir.detach() as the FM input.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .layers import (FM, Dropout, TextCNN, _linear, data_sum, doc_shape,
                     take_rows)


class TransNet(nn.Module):
    # the record keys a forward reads (besides the label and weight)
    INPUTS = ("user", "item", "user_doc", "item_doc", "this_doc",
              "user_skip", "item_skip")
    ID_EMBED_SIZE = 5

    def __init__(self, num_user_rows: int, num_item_rows: int,
                 latent_size: int, word_vectors: np.ndarray,
                 dropout: float = 0.6, plus: bool = False,
                 generator: Optional[torch.Generator] = None,
                 fuse_gather: bool = False,
                 compute_dtype: str = "float32"):
        super().__init__()
        # frozen word table: a buffer, so no optimizer ever sees it
        self.register_buffer("word_vectors", torch.as_tensor(
            np.asarray(word_vectors, np.float32)))
        e = self.word_vectors.shape[1]
        L = latent_size
        self.plus = plus
        fuse = dict(generator=generator, fuse_gather=fuse_gather,
                    compute_dtype=compute_dtype)
        self.source_user_conv = TextCNN(e, L, dropout, **fuse)
        self.source_item_conv = TextCNN(e, L, dropout, **fuse)
        self.project_fc0 = _linear(2 * L, L, generator)
        self.project_fc1 = _linear(L, L, generator)
        # reads the pair's own review as ids even on the entity path,
        # so it takes the fused gather there too
        self.target_conv = TextCNN(e, L, dropout, **fuse)
        self.target_fm = FM(L, 8, generator=generator)
        self.dropout = Dropout(dropout)
        n_fm = L
        if plus:
            k = self.ID_EMBED_SIZE
            self.user_embedding = nn.Parameter(nn.init.xavier_uniform_(
                torch.empty(num_user_rows, k), generator=generator))
            self.item_embedding = nn.Parameter(nn.init.xavier_uniform_(
                torch.empty(num_item_rows, k), generator=generator))
            n_fm += 2 * k
        self.source_fm = FM(n_fm, 8, generator=generator)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        # `generator` draws the dropout masks in training. Candidate
        # grids carry the user doc at lead [B, 1]: the source user tower
        # runs once per grid row and broadcasts. Docs are int ids
        # [..., T] or embedded floats [..., T, E] (hp.cache_doc_embeds).
        lead = tuple(batch["item"].shape)
        u_lead, u_tail = doc_shape(batch["user_doc"], 1)
        _, i_tail = doc_shape(batch["item_doc"], 1)
        _, t_tail = doc_shape(batch["this_doc"], 1)
        udoc = batch["user_doc"].reshape((-1,) + u_tail)
        idoc = batch["item_doc"].reshape((-1,) + i_tail)
        tdoc = batch["this_doc"].reshape((-1,) + t_tail)
        user_id = batch["user"].reshape(-1)
        item_id = batch["item"].reshape(-1)
        # the weight masks padded batch rows out of the transform loss
        w = batch.get("weight")
        if w is None:
            w = torch.ones(idoc.shape[0], device=idoc.device)
        else:
            w = w.reshape(tuple(w.shape) + (1,) * (len(lead) - 1)).expand(
                lead).reshape(-1)

        # source net; the entity cache's leakage spans ([B, 2] (start,
        # len)) mask the source towers, the target tower reads the
        # held-out review unmasked
        u_skip = batch.get("user_skip")
        i_skip = batch.get("item_skip")
        if u_skip is not None:
            u_skip = u_skip.reshape(-1, 2).to(torch.int32).contiguous()
        if i_skip is not None:
            i_skip = i_skip.reshape(-1, 2).to(torch.int32).contiguous()
        wv = self.word_vectors
        u = self.source_user_conv(udoc, table=wv, skip=u_skip,
                                  generator=generator)
        i = self.source_item_conv(idoc, table=wv, skip=i_skip,
                                  generator=generator)
        if u_lead != lead:
            u = u.reshape(u_lead + u.shape[-1:]).expand(
                lead + u.shape[-1:]).reshape(-1, u.shape[-1])
        ir = self.project_fc1(torch.relu(self.project_fc0(
            torch.cat([u, i], dim=-1))))
        source_ir = self.dropout(ir, generator)

        # target net
        t = self.target_conv(tdoc, table=wv, generator=generator)
        target_ir = self.dropout(t, generator)
        target_out = self.target_fm(target_ir)

        # transform loss: the weight-masked mean of the per-example L2
        diff = source_ir - target_ir.detach()
        trans_loss = (torch.sum(torch.sum(diff * diff, dim=-1) * w)
                      / torch.clamp(data_sum(self, torch.sum(w)), min=1.0))

        # source prediction off the detached source_ir
        fm_in = source_ir.detach()
        if self.plus:
            fm_in = torch.cat(
                [self.dropout(take_rows(self, self.user_embedding, user_id),
                              generator),
                 self.dropout(take_rows(self, self.item_embedding, item_id),
                              generator),
                 fm_in], dim=-1)
        source_out = self.source_fm(fm_in)
        return (source_out.reshape(lead), target_out.reshape(lead),
                trans_loss)
