"""Artifact IO: compressed .npz for arrays and JSON for metadata, no
pickle."""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np


def save_npz(path: str, **arrays) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def save_json(path: str, obj: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)
