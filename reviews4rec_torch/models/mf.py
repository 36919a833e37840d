"""Embedding-dot model family: bias_only, MF_dot, MF, GMF, MLP, NeuMF.
Counterpart of `reviews4rec_tpu/models/mf.py`.

Every model scores user_bias + item_bias + global_bias + interaction,
with bias tables initialized to 0.1 and the global bias to 4.0. Ids may
come with any leading shape (the rank evaluator feeds [B, C] candidate
grids), and the scores keep that shape. Embedding tables are
xavier-uniform on [rows, L], as flax's initializer draws them (the bound
is symmetric in the two fans). The user and the item embedding each
take their own dropout mask, drawn from the forward's `generator`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from .layers import FM, Dropout, MLPTower, _linear, take_rows


def _table(rows: int, width: int, generator: Optional[torch.Generator]
           ) -> nn.Parameter:
    return nn.Parameter(nn.init.xavier_uniform_(torch.empty(rows, width),
                                                generator=generator))


class BiasOnly(nn.Module):
    """b_u + b_i + mu."""

    # the record keys a forward reads (besides the label and weight)
    INPUTS = ("user", "item")

    def __init__(self, num_user_rows: int, num_item_rows: int):
        super().__init__()
        self.user_bias = nn.Parameter(torch.full((num_user_rows,), 0.1))
        self.item_bias = nn.Parameter(torch.full((num_item_rows,), 0.1))
        self.global_bias = nn.Parameter(torch.full((1,), 4.0))

    def _biases(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return (take_rows(self, self.user_bias, batch["user"])
                + take_rows(self, self.item_bias, batch["item"])
                + self.global_bias[0])

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._biases(batch)


class _Embedded(BiasOnly):
    """The bias tables plus one user and one item embedding table of
    width L under `prefix`, each row dropped out after its gather."""

    def __init__(self, num_user_rows: int, num_item_rows: int,
                 latent_size: int, dropout: float,
                 generator: Optional[torch.Generator],
                 prefixes: Tuple[str, ...] = ("",)):
        super().__init__(num_user_rows, num_item_rows)
        for p in prefixes:
            self.register_parameter(f"{p}user_embedding", _table(
                num_user_rows, latent_size, generator))
            self.register_parameter(f"{p}item_embedding", _table(
                num_item_rows, latent_size, generator))
        self.dropout = Dropout(dropout)

    def _pair(self, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator], prefix: str = ""
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        u = take_rows(self, getattr(self, f"{prefix}user_embedding"),
                      batch["user"], embedding=True)
        i = take_rows(self, getattr(self, f"{prefix}item_embedding"),
                      batch["item"], embedding=True)
        return self.dropout(u, generator), self.dropout(i, generator)


class MFDot(_Embedded):
    """Biases + dot(user_emb, item_emb)."""

    def __init__(self, num_user_rows: int, num_item_rows: int,
                 latent_size: int, dropout: float = 0.6,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_user_rows, num_item_rows, latent_size, dropout,
                         generator)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        u, i = self._pair(batch, generator)
        return self._biases(batch) + torch.sum(u * i, dim=-1)


class MF(_Embedded):
    """The reference's "MLP version" of MF: the hadamard product
    concatenated with an MLP projection of [u; i], scored by an FM head
    of L factors."""

    def __init__(self, num_user_rows: int, num_item_rows: int,
                 latent_size: int, dropout: float = 0.6,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_user_rows, num_item_rows, latent_size, dropout,
                         generator)
        L = latent_size
        self.projection = MLPTower(2 * L, (L, L), dropout, generator=generator)
        self.final = FM(2 * L, L, generator=generator)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        u, i = self._pair(batch, generator)
        mlp_vec = self.projection(torch.cat([u, i], dim=-1), generator)
        rating = self.final(torch.cat([mlp_vec, u * i], dim=-1))
        return self._biases(batch) + rating


class GMF(_Embedded):
    """Hadamard product -> linear."""

    def __init__(self, num_user_rows: int, num_item_rows: int,
                 latent_size: int, dropout: float = 0.6,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_user_rows, num_item_rows, latent_size, dropout,
                         generator)
        self.final = _linear(latent_size, 1, generator)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        u, i = self._pair(batch, generator)
        return self._biases(batch) + self.final(u * i)[..., 0]


class MLPModel(_Embedded):
    """concat -> 2-layer MLP -> linear."""

    def __init__(self, num_user_rows: int, num_item_rows: int,
                 latent_size: int, dropout: float = 0.6,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_user_rows, num_item_rows, latent_size, dropout,
                         generator)
        L = latent_size
        self.project = MLPTower(2 * L, (L, L), dropout, generator=generator)
        self.final = _linear(L, 1, generator)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        u, i = self._pair(batch, generator)
        joint = self.project(torch.cat([u, i], dim=-1), generator)
        return self._biases(batch) + self.final(joint)[..., 0]


class NeuMF(_Embedded):
    """GMF and MLP towers on tables of their own, fused by one linear
    layer over [gmf_joint; mlp_joint]."""

    def __init__(self, num_user_rows: int, num_item_rows: int,
                 latent_size: int, dropout: float = 0.6,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_user_rows, num_item_rows, latent_size, dropout,
                         generator, prefixes=("gmf_", "mlp_"))
        L = latent_size
        self.project = MLPTower(2 * L, (L, L), dropout, generator=generator)
        self.final = _linear(2 * L, 1, generator)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        gu, gi = self._pair(batch, generator, "gmf_")
        mu, mi = self._pair(batch, generator, "mlp_")
        mlp_joint = self.project(torch.cat([mu, mi], dim=-1), generator)
        rating = self.final(torch.cat([gu * gi, mlp_joint], dim=-1))[..., 0]
        return self._biases(batch) + rating


def neumf_warm_start(neumf: Mapping[str, torch.Tensor],
                     gmf: Mapping[str, torch.Tensor],
                     mlp: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """NeuMF's pretrain weight surgery on `state_dict`s: the GMF and MLP
    embeddings and the MLP projection copied in, the two final layers'
    weights concatenated (GMF first; `nn.Linear.weight` is [1, in], so
    along dim 1) and their biases averaged, the bias tables averaged.
    `global_bias` keeps NeuMF's own."""
    p = dict(neumf)
    for side in ("user", "item"):
        p[f"gmf_{side}_embedding"] = gmf[f"{side}_embedding"]
        p[f"mlp_{side}_embedding"] = mlp[f"{side}_embedding"]
        p[f"{side}_bias"] = 0.5 * (gmf[f"{side}_bias"] + mlp[f"{side}_bias"])
    p.update({k: v for k, v in mlp.items() if k.startswith("project.")})
    p["final.weight"] = torch.cat([gmf["final.weight"], mlp["final.weight"]],
                                  dim=1)
    p["final.bias"] = 0.5 * (gmf["final.bias"] + mlp["final.bias"])
    return p
