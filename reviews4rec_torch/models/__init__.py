"""Model registry: config -> torch module on a device."""

from __future__ import annotations

import torch

from ..config import ALL_MODELS, HyperParams
from ..utils.device import DeviceLike, resolve_device

# where each model family still waits in ROADMAP.md
_QUEUE = {
    "NARRE": "Queue 1 item 8 (other TextCNN towers)",
    "transnet": "Queue 1 item 8 (other TextCNN towers)",
    "transnet++": "Queue 1 item 8 (other TextCNN towers)",
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
    if mt in ("deepconn", "deepconn++"):
        from .deepconn import DeepCoNN
        if word_vectors is None:
            raise ValueError(f"{mt} needs the corpus word vectors")
        gen = torch.Generator().manual_seed(hp.seed)
        model = DeepCoNN(hp.num_user_rows, hp.num_item_rows, hp.latent_size,
                         word_vectors, hp.dropout, use_fm=(mt == "deepconn"),
                         generator=gen)
        return model.to(dev)
    if mt not in ALL_MODELS:
        raise ValueError(f"unknown model_type {mt!r}")
    raise NotImplementedError(
        f"{mt!r} is not ported to PyTorch yet: ROADMAP.md "
        f"{_QUEUE.get(mt, 'Queue 1 item 12 (non-SGD families)')}")
