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
from typing import Dict, Optional

import torch


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
