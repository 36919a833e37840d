"""Model registry: config -> torch module on a device."""

from __future__ import annotations

import torch

from ..config import ALL_MODELS, HyperParams
from ..utils.device import DeviceLike, resolve_device

# the models the port has: TextCNN towers over the frozen word table
_TEXTCNN_MODELS = ("deepconn", "deepconn++", "NARRE", "transnet",
                   "transnet++")
# where each model family still waits in ROADMAP.md
_QUEUE = {
    "MPCN": "Queue 1 item 11 (MPCN and the co-attention lib)",
    "bias_only": "Queue 1 item 9 (MF family)",
    "MF_dot": "Queue 1 item 9 (MF family)",
    "MF": "Queue 1 item 9 (MF family)",
    "GMF": "Queue 1 item 9 (MF family)",
    "MLP": "Queue 1 item 9 (MF family)",
    "NeuMF": "Queue 1 item 9 (MF family)",
}


def build_model(hp: HyperParams, word_vectors=None,
                device: DeviceLike = None) -> torch.nn.Module:
    """The module for `hp.model_type`, initialized from `hp.seed` and
    moved to `device` (None = the GPU)."""
    dev = resolve_device(device)
    mt = hp.model_type
    if mt in _TEXTCNN_MODELS:
        if word_vectors is None:
            raise ValueError(f"{mt} needs the corpus word vectors")
        gen = torch.Generator().manual_seed(hp.seed)
        rows = (hp.num_user_rows, hp.num_item_rows, hp.latent_size,
                word_vectors, hp.dropout)
        if mt == "NARRE":
            from .narre import NARRE
            model = NARRE(*rows, generator=gen)
        elif mt.startswith("transnet"):
            from .transnet import TransNet
            model = TransNet(*rows, plus=(mt == "transnet++"), generator=gen)
        else:
            from .deepconn import DeepCoNN
            model = DeepCoNN(*rows, use_fm=(mt == "deepconn"), generator=gen)
        return model.to(dev)
    if mt not in ALL_MODELS:
        raise ValueError(f"unknown model_type {mt!r}")
    raise NotImplementedError(
        f"{mt!r} is not ported to PyTorch yet: ROADMAP.md "
        f"{_QUEUE.get(mt, 'Queue 1 item 12 (non-SGD families)')}")
