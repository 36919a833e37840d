"""NARRE (Chen, Zhang, Liu and Ma, WWW 2018), as the configuration
states it: a user's (item's) document is its first R reviews a row, W
words each, with the ids on the other side of those reviews as the
attention's context (pad id count + 1); in training the pair's own
review row is zeroed in the features and the context. Each review
row's TextCNN tower and FC to latent, dropout; a scorer over [feature,
context embedding] weights the rows' softmax; the id embedding joins
the attended feature, and an MLP over their product plus the per-entity
and global biases gives the rating. Ranking draws no dropout and masks
no row, so each entity's attended feature plus its id embedding is the
same for every pair it is in: each distinct user and item is encoded
once, and the head scores every grid pair.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from portbench.counts import dense_flop
from portbench.reference import rows_doc
from portbench.weights import dense_leaves, entity_rows, tower_leaves

LEFT_OUT = {"word_vectors"}
# the CPU tests' cut (`portbench.conftest.shrink`): words a review row
SHRUNK_HP = {"narre_num_words": 16}


def params(cfg: Dict, num_users: int, num_items: int):
    hp = cfg["hp"]
    e, L = hp["word_embed_size"], hp["latent_size"]
    f, w = cfg["num_filters"], cfg["window"]
    ur, ir = entity_rows(num_users), entity_rows(num_items)
    return ([("user_embedding", (ur, L), "xavier"),
             ("item_embedding", (ir, L), "xavier")]
            + tower_leaves("user_conv", e, f, w, L)
            + tower_leaves("item_conv", e, f, w, L)
            + dense_leaves("att_user.fc0", 2 * L, L)
            + dense_leaves("att_user.fc1", L, 1)
            + dense_leaves("att_item.fc0", 2 * L, L)
            + dense_leaves("att_item.fc1", L, 1)
            + dense_leaves("final.fc0", L, L)
            + dense_leaves("final.fc1", L, 1)
            + [("user_bias", (ur,), 0.1), ("item_bias", (ir,), 0.1),
               ("global_bias", (1,), 4.0)])


def towers(cfg: Dict) -> Dict[str, int]:
    hp = cfg["hp"]
    return {"docs": hp["narre_num_reviews"], "t": hp["narre_num_words"],
            "e": hp["word_embed_size"], "f": cfg["num_filters"],
            "w": cfg["window"], "l": hp["latent_size"]}


def head_flop(cfg: Dict) -> float:
    r, L = cfg["hp"]["narre_num_reviews"], cfg["hp"]["latent_size"]
    # two attention scorers over r reviews, weighted sums, hadamard and
    # the final MLP
    att = r * (dense_flop(2 * L, L) + dense_flop(L, 1)) + 2 * r * L
    return 2 * att + L + dense_flop(L, L) + dense_flop(L, 1)


def batch_inputs(ref, users, items):
    """Each pair's [R, W] review rows a side, their context ids, and the
    row of the pair's own review (-1 where it lies beyond R)."""
    c = ref.corpus
    a = [c.this_index[(int(u), int(i))] for u, i in zip(users, items)]
    R, W = ref.R, ref.T
    u = [rows_doc(c.user_reviews[x], c.u_to_i[x], R, W, c.num_items + 1)
         for x in users]
    it = [rows_doc(c.item_reviews[x], c.i_to_u[x], R, W, c.num_users + 1)
          for x in items]
    return {"udoc": ref._t(np.stack([d for d, _ in u])),
            "uctx": ref._t(np.stack([x for _, x in u])),
            "idoc": ref._t(np.stack([d for d, _ in it])),
            "ictx": ref._t(np.stack([x for _, x in it])),
            "uskip": ref._t([x[0] if x[0] < R else -1 for x in a]),
            "iskip": ref._t([x[1] if x[1] < R else -1 for x in a])}


def _attend(ref, w, scorer, feats, ctx, skip, gen):
    if skip is not None:
        hit = (torch.arange(feats.shape[1], device=feats.device)[None, :]
               == skip[:, None])[..., None]
        feats = torch.where(hit, torch.zeros((), device=feats.device), feats)
        ctx = torch.where(hit, torch.zeros((), device=ctx.device), ctx)
    h = torch.relu(ref.dense(w, scorer + ".fc0",
                             torch.cat([feats, ctx], dim=-1)))
    s = ref.dense(w, scorer + ".fc1", ref.drop(h, gen))[..., 0]
    return torch.sum(torch.softmax(s, dim=-1)[..., None] * feats, dim=1)


def forward(ref, w: Dict, users, items, inp: Dict, gen) -> torch.Tensor:
    b, R, L = len(users), ref.R, ref.cfg["hp"]["latent_size"]
    uid, iid = ref._t(users).long(), ref._t(items).long()
    uf = ref.drop(ref.tower(w, "user_conv",
                            inp["udoc"].reshape(b * R, -1)), gen)
    itf = ref.drop(ref.tower(w, "item_conv",
                             inp["idoc"].reshape(b * R, -1)), gen)
    ua = _attend(ref, w, "att_user", uf.reshape(b, R, L),
                 w["item_embedding"][inp["uctx"]], inp["uskip"], gen)
    ia = _attend(ref, w, "att_item", itf.reshape(b, R, L),
                 w["user_embedding"][inp["ictx"]], inp["iskip"], gen)
    u = ua + ref.drop(w["user_embedding"][uid], gen)
    i = ia + ref.drop(w["item_embedding"][iid], gen)
    h = torch.relu(ref.dense(w, "final.fc0", ref.drop(u * i, gen)))
    return (ref.dense(w, "final.fc1", h)[..., 0] + w["user_bias"][uid]
            + w["item_bias"][iid] + w["global_bias"][0])


@torch.no_grad()
def encode(ref, side: str, ids: Sequence[int], chunk: int = 128
           ) -> torch.Tensor:
    """Eval [len(ids), L] of users ("user") or items ("item"): the
    attended review rows plus the id embedding, no dropout, no row
    masked."""
    c, w, R, W = ref.corpus, ref.w, ref.R, ref.T
    if side == "user":
        lists, others, pad = c.user_reviews, c.u_to_i, c.num_items + 1
        ctx_table, own = w["item_embedding"], w["user_embedding"]
    else:
        lists, others, pad = c.item_reviews, c.i_to_u, c.num_users + 1
        ctx_table, own = w["user_embedding"], w["item_embedding"]
    out = []
    for s in range(0, len(ids), chunk):
        part = ids[s:s + chunk]
        rows = [rows_doc(lists[x], others[x], R, W, pad) for x in part]
        doc = ref._t(np.stack([d for d, _ in rows]))
        ctx = ref._t(np.stack([x for _, x in rows]))
        f = ref.tower(w, side + "_conv", doc.reshape(len(part) * R, W))
        att = _attend(ref, w, "att_" + side, f.reshape(len(part), R, -1),
                      ctx_table[ctx], None, None)
        out.append(att + own[ref._t(part).long()])
    return torch.cat(out)


@torch.no_grad()
def score(ref, u: torch.Tensor, i: torch.Tensor, users, items
          ) -> torch.Tensor:
    """Eval scores of paired encodings [..., L] and their ids [...]."""
    w = ref.w
    h = torch.relu(ref.dense(w, "final.fc0", u * i))
    return (ref.dense(w, "final.fc1", h)[..., 0] + w["user_bias"][users]
            + w["item_bias"][items] + w["global_bias"][0])


def rank_scores(ref, users: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """[M, C] scores: each distinct user and item encoded once, then the
    head over every grid pair."""
    items, pos = np.unique(grid, return_inverse=True)
    pos = torch.as_tensor(pos.reshape(grid.shape), device=ref.device)
    u = encode(ref, "user", users.tolist())
    i = encode(ref, "item", items.tolist())[pos]
    uid = ref._t(users).long()[:, None].expand(grid.shape)
    return score(ref, u[:, None, :].expand_as(i), i, uid,
                 ref._t(grid).long()).cpu().numpy()
