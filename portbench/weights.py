"""Random weights from the seed, made on the device in one draw, in the
program's state-dict layout (the names and shapes a configuration
implies). The program loads them, and the plain reference computes from
the same tensors.

Matrices take xavier-uniform bounds, sqrt(6 / (fan_in + fan_out));
biases are uniform within 0.05 around their init (0, or 0.1 for the
per-entity biases, 4.0 for the global bias), so that no bias starts at
an exact symmetry.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from . import models
from .corpus import torch_seed

ROW_MULTIPLE = 16


def entity_rows(n: int) -> int:
    """Rows of a per-entity table: the ids and a pad row, rounded up."""
    return -(-(n + 2) // ROW_MULTIPLE) * ROW_MULTIPLE


def tower_leaves(side: str, e: int, f: int, w: int, L: int):
    """A TextCNN tower's conv and FC to latent."""
    return [(f"{side}.conv_kernel", (w * e, f), "xavier"),
            (f"{side}.conv_bias", (f,), 0.0),
            (f"{side}.fc.weight", (L, f), "xavier"),
            (f"{side}.fc.bias", (L,), 0.0)]


def dense_leaves(name: str, n_in: int, n_out: int):
    return [(f"{name}.weight", (n_out, n_in), "xavier"),
            (f"{name}.bias", (n_out,), 0.0)]


def spec(cfg: Dict, num_users: int, num_items: int
         ) -> List[Tuple[str, tuple, object]]:
    """(name, shape, init) of every parameter: "xavier", or the centre
    of a bias; the model's file lists them (`portbench/models`)."""
    return models.load(cfg["model"]).params(cfg, num_users, num_items)


def make(cfg: Dict, num_users: int, num_items: int, seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """The parameters for `seed`, f32 on `device`."""
    leaves = spec(cfg, num_users, num_items)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    gen = torch.Generator(device=device).manual_seed(
        torch_seed(seed, "weights"))
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for (name, shape, init), n in zip(leaves, sizes):
        u = flat[at:at + n].reshape(shape)
        at += n
        if init == "xavier":
            out[name] = u * math.sqrt(6.0 / (shape[0] + shape[1]))
        else:
            out[name] = u * 0.05 + init
    return out
