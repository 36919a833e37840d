"""Checkpoints of the port: latest params, optimizer state, step and
epoch, and the best-validation params, in one file, so a run can resume
mid-training and a finished run can be restored for serving.

The JAX package writes flax msgpack (`reviews4rec_tpu/train/
checkpoint.py`); the port has no flax, so it keeps its own format: a
`torch.save` of plain dicts of tensors, ints and floats, read back with
`weights_only=True`. Its file is `hp.model_path() + ".pt"`, so a JAX
checkpoint of the same run tag is never read as a torch one.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Union

import torch

from ..parallel.mesh import local_params


def checkpoint_path(hp) -> str:
    return hp.model_path() + ".pt"


def save_checkpoint(path: str, params: Dict[str, torch.Tensor], *,
                    opt_state: Optional[Dict] = None, step: int = 0,
                    epoch: int = 0, extra: Optional[Dict] = None,
                    best_params: Optional[Dict[str, torch.Tensor]] = None
                    ) -> None:
    """`params` and `best_params` are `state_dict`s, `opt_state` an
    optimizer's `state_dict`. Written to `path + ".tmp"` and renamed, so
    an interrupted save leaves the previous file whole."""
    payload = {"params": params, "opt_state": opt_state or {},
               "step": int(step), "epoch": int(epoch),
               "extra": dict(extra or {}), "best_params": best_params or {}}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location=None) -> Dict:
    return torch.load(path, map_location=map_location, weights_only=True)


def restore_like(template: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                 state_dict: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """`state_dict` with the keys of `template` (a module or a
    `state_dict`), each tensor placed on its template tensor's device and
    cast to its dtype: a checkpoint read on another device comes back
    where the template lives. A module laid out on a mesh
    (`parallel.mesh.shard_model`) holds this rank's rows of each
    row-sharded table, so the whole tables of `state_dict` are cut to
    those rows first and the rank's shard shape is the one checked. A
    missing or unexpected key, or another shape, raises ValueError."""
    if isinstance(template, torch.nn.Module):
        state_dict = local_params(template, dict(state_dict))
        template = template.state_dict()
    missing = sorted(set(template) - set(state_dict))
    unexpected = sorted(set(state_dict) - set(template))
    if missing or unexpected:
        raise ValueError(f"state_dict does not match its template: missing "
                         f"{missing}, unexpected {unexpected}")
    out = {}
    for key, want in template.items():
        have = state_dict[key]
        if tuple(have.shape) != tuple(want.shape):
            raise ValueError(f"{key}: shape {tuple(have.shape)}, the "
                             f"template's {tuple(want.shape)}")
        out[key] = have.to(device=want.device, dtype=want.dtype)
    return out


def restore_params(path: str,
                   template: Union[torch.nn.Module, Mapping[str, torch.Tensor]]
                   ) -> Dict[str, torch.Tensor]:
    """The `params` of the checkpoint at `path`, restored like `template`
    (`restore_like`)."""
    return restore_like(template,
                        load_checkpoint(path, map_location="cpu")["params"])
