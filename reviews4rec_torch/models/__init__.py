"""Model registry: config -> torch module on a device."""

from __future__ import annotations

import math
import warnings

import torch

from ..config import ID_MODELS, HyperParams
from ..utils.device import DeviceLike, resolve_device

# the TextCNN towers over the frozen word table
TEXTCNN_MODELS = ("deepconn", "deepconn++", "NARRE", "transnet",
                   "transnet++")


def _mesh(hp: HyperParams):
    """{axis: size} of `hp.mesh_shape`, or None for one device (the JAX
    package's `mesh_from_hp`)."""
    if math.prod(hp.mesh_shape) <= 1:
        return None
    return dict(zip(hp.mesh_axes, hp.mesh_shape))


def _check_lookup(hp: HyperParams) -> None:
    """`hp.embedding_lookup`: "gspmd" is the plain row gather (the
    owner-computes one on a model axis > 1). The sharded lookups need a
    model axis of 2 or more, so without one the JAX package's
    `ValueError`; with one, `parallel.mesh.shard_model` installs them
    when the trainer lays the model out on the mesh."""
    if hp.embedding_lookup == "gspmd":
        return
    axis = hp.mesh_axes[1]
    mesh = _mesh(hp)
    if mesh is None or mesh[axis] < 2:
        raise ValueError(
            f"embedding_lookup={hp.embedding_lookup!r} needs a mesh with "
            f"{axis!r} axis > 1; got {mesh}")
    if hp.embedding_lookup not in ("psum", "a2a"):
        raise ValueError(f"unknown embedding_lookup {hp.embedding_lookup!r} "
                         f"(expected gspmd | psum | a2a)")


def _check_seq_parallel(hp: HyperParams) -> None:
    """`hp.seq_parallel` shards the TextCNN's time axis over the mesh's
    model axis: the JAX package's two `ValueError`s word for word (a
    model without a TextCNN; no model axis > 1), and its warning when
    `use_pallas` is set too. With such a mesh, `parallel.mesh.shard_model`
    splits every TextCNN's time axis when the trainer lays the model out,
    and no TextCNN kernel runs (`parallel.sequence`)."""
    if not hp.seq_parallel:
        return
    mt = hp.model_type
    if mt not in TEXTCNN_MODELS:
        raise ValueError(
            f"seq_parallel=True shards the TextCNN time axis and is only "
            f"supported for {TEXTCNN_MODELS}; {mt!r} has no such axis")
    if hp.use_pallas:
        warnings.warn(
            "seq_parallel and use_pallas are both set; the two paths "
            "partition the same conv differently, seq_parallel takes "
            "precedence and the Pallas kernel will NOT run",
            stacklevel=3)
    mesh = _mesh(hp)
    if mesh is None or mesh[hp.mesh_axes[1]] < 2:
        raise ValueError(
            "seq_parallel=True needs a mesh with model axis > 1 "
            f"(mesh_shape={hp.mesh_shape})")


_CONV_DTYPES = ("float32", "bfloat16", "float16")


def _conv_dtype(hp: HyperParams) -> str:
    """The TextCNN's conv operand type. The JAX package's XLA TextCNN
    branch (no `use_pallas`) casts the conv operands to
    `hp.compute_dtype`, any dtype `jnp.dtype` takes; the port's TextCNN
    has kernels for float32, bfloat16 and float16 and refuses any other
    name. The Pallas branches choose their own dot dtype, and under
    `use_pallas` the port keeps f32."""
    if hp.use_pallas:
        return "float32"
    if hp.compute_dtype not in _CONV_DTYPES:
        raise ValueError(
            f"compute_dtype={hp.compute_dtype!r}: the TextCNN computes in "
            f"{', '.join(_CONV_DTYPES)} only")
    return hp.compute_dtype


def _id_model(hp: HyperParams, gen: torch.Generator) -> torch.nn.Module:
    from . import mf
    rows = (hp.num_user_rows, hp.num_item_rows)
    if hp.model_type == "bias_only":
        return mf.BiasOnly(*rows)
    _check_lookup(hp)
    cls = {"MF_dot": mf.MFDot, "MF": mf.MF, "GMF": mf.GMF,
           "MLP": mf.MLPModel, "NeuMF": mf.NeuMF}[hp.model_type]
    return cls(*rows, hp.latent_size, hp.dropout, generator=gen)


def _mpcn(hp: HyperParams, word_vectors, gen: torch.Generator
          ) -> torch.nn.Module:
    from .mpcn import MPCN
    if word_vectors is None:
        raise ValueError("MPCN needs the corpus word vectors (its table's "
                         "size and, under mpcn_pretrained, its init)")
    return MPCN(hp.num_user_rows, hp.num_item_rows, hp.latent_size,
                word_vectors, num_heads=hp.mpcn_heads,
                temperature=hp.mpcn_temperature, factors=hp.mpcn_factor,
                dropout_keep=hp.mpcn_dropout_keep,
                rating_min=hp.rating_min, rating_max=hp.rating_max,
                affinity=hp.mpcn_affinity, encoder=hp.mpcn_encoder,
                head=hp.mpcn_head, joint=hp.mpcn_joint,
                pretrained_words=hp.mpcn_pretrained,
                projection=hp.mpcn_projection, generator=gen)


def build_model(hp: HyperParams, word_vectors=None,
                device: DeviceLike = None) -> torch.nn.Module:
    """The module for `hp.model_type`, initialized from `hp.seed` and
    moved to `device` (None = the GPU). The id models take no word
    vectors; MPCN takes them for its trained table's size (and init,
    under `hp.mpcn_pretrained`)."""
    dev = resolve_device(device)
    mt = hp.model_type
    _check_seq_parallel(hp)
    gen = torch.Generator().manual_seed(hp.seed)
    if mt in ID_MODELS:
        return _id_model(hp, gen).to(dev)
    if mt == "MPCN":
        return _mpcn(hp, word_vectors, gen).to(dev)
    if mt in TEXTCNN_MODELS:
        dtype = _conv_dtype(hp)
        if word_vectors is None:
            raise ValueError(f"{mt} needs the corpus word vectors")
        rows = (hp.num_user_rows, hp.num_item_rows, hp.latent_size,
                word_vectors, hp.dropout)
        # the fused word gather, as the JAX package sets it
        # (`models/__init__.py`: `fuse_gather` under `use_pallas`)
        kw = dict(generator=gen,
                  fuse_gather=bool(hp.use_pallas and hp.pallas_fuse_gather),
                  compute_dtype=dtype)
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
    # the neighbor and topic families fit by their own runners
    # (`models.neighbors.run_neighbor`, `models.hft.run_hft`): the JAX
    # package's words
    raise ValueError(
        f"{mt!r} is not an SGD model; use hft.HFTTrainer or "
        f"neighbors.fit_predict for it")
