"""Artifact IO: compressed .npz for arrays, no pickle."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def save_npz(path: str, **arrays) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}
