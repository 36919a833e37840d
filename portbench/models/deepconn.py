"""DeepCoNN (Zheng, Noroozi and Yu, WSDM 2017) with an FM head, as the
configuration states it: a user's (item's) document is its train
reviews concatenated in list order, the first T words, zero-padded; in
training the pair's own review is masked in place (its word span
zeroed), as the entity cache states. Each side's TextCNN tower and FC
to latent, dropout on both, then global bias + FM over the two latents
concatenated. Ranking encodes each distinct user and item once, whole
documents and no dropout, and scores every grid pair by the FM.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from portbench.counts import dense_flop
from portbench.weights import dense_leaves, tower_leaves

LEFT_OUT = {"word_vectors"}


def params(cfg: Dict, num_users: int, num_items: int):
    hp = cfg["hp"]
    e, L = hp["word_embed_size"], hp["latent_size"]
    f, w = cfg["num_filters"], cfg["window"]
    return (tower_leaves("user_conv", e, f, w, L)
            + tower_leaves("item_conv", e, f, w, L)
            + [("global_bias", (1,), 4.0),
               ("fm.V", (2 * L, cfg["fm_factors"]), "xavier"),
               *dense_leaves("fm.lin", 2 * L, 1)])


def towers(cfg: Dict) -> Dict[str, int]:
    hp = cfg["hp"]
    return {"docs": 1, "t": hp["input_length"], "e": hp["word_embed_size"],
            "f": cfg["num_filters"], "w": cfg["window"],
            "l": hp["latent_size"]}


def head_flop(cfg: Dict) -> float:
    k = cfg["fm_factors"]
    n = 2 * cfg["hp"]["latent_size"]
    # FM: x V, (x*x)(V*V), the squared difference summed, the linear term
    return 2 * dense_flop(n, k) + 3 * k + 2 * n + dense_flop(n, 1)


def batch_inputs(ref, users, items):
    """The train docs of (user, item) pairs, each masking its own
    review."""
    c = ref.corpus
    a = [c.this_index[(int(u), int(i))] for u, i in zip(users, items)]
    ud, us = ref.concat_docs(c.user_reviews, users, [x[0] for x in a])
    idd, isp = ref.concat_docs(c.item_reviews, items, [x[1] for x in a])
    return {"udoc": ud, "uspan": us, "idoc": idd, "ispan": isp}


def forward(ref, w: Dict, users, items, inp: Dict, gen) -> torch.Tensor:
    u = ref.drop(ref.tower(w, "user_conv", inp["udoc"], inp["uspan"]), gen)
    i = ref.drop(ref.tower(w, "item_conv", inp["idoc"], inp["ispan"]), gen)
    return w["global_bias"][0] + ref.fm(w, torch.cat([u, i], -1))


@torch.no_grad()
def encode(ref, side: str, ids: Sequence[int], chunk: int = 128
           ) -> torch.Tensor:
    """Eval tower outputs [len(ids), L] of whole documents."""
    lists = (ref.corpus.user_reviews if side == "user_conv"
             else ref.corpus.item_reviews)
    out = []
    for s in range(0, len(ids), chunk):
        docs, _ = ref.concat_docs(lists, ids[s:s + chunk])
        out.append(ref.tower(ref.w, side, docs))
    return torch.cat(out)


@torch.no_grad()
def score(ref, u: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Eval scores of paired tower outputs [..., L]."""
    return ref.w["global_bias"][0] + ref.fm(ref.w, torch.cat([u, i], -1))


def rank_scores(ref, users: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """[M, C] scores: each distinct user's and item's tower once, then
    the FM over every grid pair."""
    items, pos = np.unique(grid, return_inverse=True)
    u = encode(ref, "user_conv", users.tolist())
    i = encode(ref, "item_conv", items.tolist())[
        torch.as_tensor(pos.reshape(grid.shape), device=ref.device)]
    return score(ref, u[:, None, :].expand_as(i), i).cpu().numpy()
