"""Model registry: config -> torch module on a device."""

from __future__ import annotations

import math

import torch

from ..config import ALL_MODELS, ID_MODELS, HyperParams
from ..utils.device import DeviceLike, resolve_device

# the models the port has: TextCNN towers over the frozen word table
_TEXTCNN_MODELS = ("deepconn", "deepconn++", "NARRE", "transnet",
                   "transnet++")


def _check_lookup(hp: HyperParams) -> None:
    """`hp.embedding_lookup`: "gspmd" is the plain row gather. The
    sharded lookups need a model axis of 2 or more, so without one the
    JAX package's `ValueError`; with one, a mesh, which the port does not
    have yet."""
    if hp.embedding_lookup == "gspmd":
        return
    axis = hp.mesh_axes[1]
    mesh = (dict(zip(hp.mesh_axes, hp.mesh_shape))
            if math.prod(hp.mesh_shape) > 1 else None)
    if mesh is None or mesh[axis] < 2:
        raise ValueError(
            f"embedding_lookup={hp.embedding_lookup!r} needs a mesh with "
            f"{axis!r} axis > 1; got {mesh}")
    raise NotImplementedError(
        f"embedding_lookup={hp.embedding_lookup!r} shards the tables over "
        f"a mesh: ROADMAP.md Queue 1 item 13")


def _id_model(hp: HyperParams, gen: torch.Generator) -> torch.nn.Module:
    from . import mf
    rows = (hp.num_user_rows, hp.num_item_rows)
    if hp.model_type == "bias_only":
        return mf.BiasOnly(*rows)
    _check_lookup(hp)
    cls = {"MF_dot": mf.MFDot, "MF": mf.MF, "GMF": mf.GMF,
           "MLP": mf.MLPModel, "NeuMF": mf.NeuMF}[hp.model_type]
    return cls(*rows, hp.latent_size, hp.dropout, generator=gen)


def build_model(hp: HyperParams, word_vectors=None,
                device: DeviceLike = None) -> torch.nn.Module:
    """The module for `hp.model_type`, initialized from `hp.seed` and
    moved to `device` (None = the GPU). The id models take no word
    vectors."""
    dev = resolve_device(device)
    mt = hp.model_type
    gen = torch.Generator().manual_seed(hp.seed)
    if mt in ID_MODELS:
        return _id_model(hp, gen).to(dev)
    if mt in _TEXTCNN_MODELS:
        if word_vectors is None:
            raise ValueError(f"{mt} needs the corpus word vectors")
        rows = (hp.num_user_rows, hp.num_item_rows, hp.latent_size,
                word_vectors, hp.dropout)
        # the fused word gather, as the JAX package sets it
        # (`models/__init__.py`: `fuse_gather` under `use_pallas`)
        kw = dict(generator=gen,
                  fuse_gather=bool(hp.use_pallas and hp.pallas_fuse_gather))
        if mt == "NARRE":
            from .narre import NARRE
            model = NARRE(*rows, **kw)
        elif mt.startswith("transnet"):
            from .transnet import TransNet
            model = TransNet(*rows, plus=(mt == "transnet++"), **kw)
        else:
            from .deepconn import DeepCoNN
            model = DeepCoNN(*rows, use_fm=(mt == "deepconn"), **kw)
        return model.to(dev)
    if mt not in ALL_MODELS:
        raise ValueError(f"unknown model_type {mt!r}")
    item = ("Queue 1 item 11 (MPCN and the co-attention lib)"
            if mt == "MPCN" else "Queue 1 item 12 (non-SGD families)")
    raise NotImplementedError(
        f"{mt!r} is not ported to PyTorch yet: ROADMAP.md {item}")
