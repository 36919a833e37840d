"""Run configuration: one frozen dataclass for every model family.

The PyTorch package's own copy of the reference configuration
(`reviews4rec_tpu/config.py`): the same fields, defaults, derived sizes
and artifact names, so a run tag or a data directory means the same
thing in both packages. Fields that only the JAX runtime reads are kept
so that a configuration carries over unchanged; where one selects what
the port does not have (a conv dtype it has no kernel for), the port
raises.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Tuple

ID_MODELS = ("bias_only", "MF", "MF_dot", "GMF", "MLP", "NeuMF")
NEIGHBOR_MODELS = ("SVD", "kNN", "NMF", "SVD++", "baseline")
REVIEW_MODELS = ("deepconn", "deepconn++", "NARRE", "transnet", "transnet++",
                 "MPCN")
TOPIC_MODELS = ("HFT",)
ALL_MODELS = ID_MODELS + NEIGHBOR_MODELS + REVIEW_MODELS + TOPIC_MODELS


@dataclass(frozen=True)
class HyperParams:
    # ---- data ----
    dataset: str = "synthetic"
    k_core: int = 5
    percent_reviews_to_keep: int = 100
    data_root: str = "data"

    # ---- optimization ----
    weight_decay: float = 1e-6
    lr: float = 0.002
    epochs: int = 2
    batch_size: int = 128
    shuffle_data_every_epoch: bool = False
    seed: int = 0

    # ---- model geometry ----
    latent_size: int = 10
    word_embed_size: int = 64
    input_length: int = 1000
    dropout: float = 0.6
    model_type: str = "bias_only"

    # ---- data path ----
    out_of_core: bool = False
    materialize_chunk_rows: int = 8192

    # ---- training objective ----
    loss: str = "RAW_MSE"       # RAW_MSE | CE | BPR | HINGE
    hinge_margin: float = 0.2

    # ---- training control ----
    early_stop: int = 0
    save_model: bool = True
    resume: bool = False

    narre_num_reviews: int = 10
    narre_num_words: int = 100

    # ---- HFT ----
    lamda: float = 0.1
    latent_reg: float = 0.0
    hft_em_iters: int = 20
    hft_grad_iters: int = 20
    hft_vocab: int = 5000

    # ---- MPCN ----
    mpcn_dmax: int = 20
    mpcn_smax: int = 30
    mpcn_heads: int = 1
    mpcn_temperature: float = 0.5
    mpcn_factor: int = 10
    mpcn_l2: float = 1e-8
    mpcn_lr: float = 1e-3
    mpcn_clip_norm: float = 1.0
    mpcn_dropout_keep: float = 0.8
    mpcn_pretrained: bool = False
    mpcn_affinity: str = "SOFT"
    mpcn_encoder: str = "NBOW"
    mpcn_head: str = "FM"
    mpcn_joint: str = "MPCN"
    mpcn_projection: str = "FC"

    # ---- neighbor models ----
    surprise_epochs: int = 20
    surprise_lr: float = 0.005
    surprise_reg: float = 0.02
    knn_k: int = 10
    nmf_epochs: int = 50
    rating_min: float = 1.0
    rating_max: float = 5.0

    # ---- eval ----
    num_negs: int = 5           # candidates = 1 pos + num_negs
    eval_ks: Tuple[int, ...] = (1, 10)
    # > 0: the k > num_negs cutoffs are computed on wide 1+eval_num_negs
    # candidate sets sampled outside each user's interactions
    eval_num_negs: int = 0

    # ---- populated by data loading ----
    total_users: int = 0
    total_items: int = 0
    total_words: int = 0

    # ---- runtime switches of the JAX package ----
    # The port reads: mesh_shape / mesh_axes (a (data, model) mesh of
    # torch.distributed ranks, one process a device: `parallel.mesh`),
    # embedding_lookup (the row-sharded tables' lookup on a model axis
    # > 1, `parallel.embedding`), seq_parallel (the TextCNN's time axis
    # over the model axis, `parallel.sequence`), use_pallas with
    # pallas_fuse_gather (the fused word gather,
    # `ops.textcnn.textcnn_pool_embed`), scan_steps (S steps per dispatch,
    # a CUDA-graph replay on the card; eager steps on a mesh), the cache_*
    # switches and pallas_fuse_rows, and compute_dtype: without use_pallas
    # (the JAX package's XLA branch, which casts the conv operands) a
    # TextCNN model computes its conv on 16-bit operands at "bfloat16" or
    # "float16", its doc caches held at that type, and raises a
    # ValueError at any other dtype (JAX's branch takes any `jnp.dtype`;
    # the port has kernels for these three); under use_pallas, where the
    # JAX kernels choose their own dot dtype, it stays f32.
    mesh_shape: Tuple[int, ...] = (1, 1)
    mesh_axes: Tuple[str, ...] = ("data", "model")
    compute_dtype: str = "float32"
    use_pallas: bool = False
    pallas_fuse_gather: bool = False
    embedding_lookup: str = "gspmd"
    scan_steps: int = 1
    cache_doc_embeds: bool = False
    cache_sides: str = "both"
    cache_entity: bool = False
    pallas_fuse_rows: bool = False
    seq_parallel: bool = False
    log_dir: str = "saved_logs"
    model_dir: str = "saved_models"

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "HyperParams":
        return dataclasses.replace(self, **kw)

    @property
    def family(self) -> str:
        if self.model_type in ID_MODELS:
            return "id"
        if self.model_type in NEIGHBOR_MODELS:
            return "neighbor"
        if self.model_type in TOPIC_MODELS:
            return "topic"
        if self.model_type in REVIEW_MODELS:
            return "review"
        raise ValueError(f"unknown model_type {self.model_type!r}")

    @property
    def uses_reviews(self) -> bool:
        return self.family in ("review", "topic")

    @property
    def num_candidates(self) -> int:
        """Candidates of a ranking row: the positive and `num_negs`."""
        return 1 + self.num_negs

    # sentinel ids that pad the 10-slot neighbor lists
    @property
    def user_pad_id(self) -> int:
        return self.total_users + 1

    @property
    def item_pad_id(self) -> int:
        return self.total_items + 1

    # Embedding-table rows: the real ids plus a pad row, rounded up to
    # `row_multiple`. Extra rows are never indexed.
    row_multiple: int = 16

    @property
    def num_user_rows(self) -> int:
        return -(-(self.total_users + 2) // self.row_multiple) \
            * self.row_multiple

    @property
    def num_item_rows(self) -> int:
        return -(-(self.total_items + 2) // self.row_multiple) \
            * self.row_multiple

    @property
    def vocab_rows(self) -> int:
        """Word-table rows: the words and id 0 (unknown / padding)."""
        return self.total_words + 1

    # ------------------------------------------------------------------
    def data_dir(self) -> str:
        """Per-dataset artifact directory."""
        p = os.path.join(self.data_root, self.dataset, f"{self.k_core}_core")
        if self.percent_reviews_to_keep != 100:
            p = os.path.join(p, f"{self.percent_reviews_to_keep}_percent")
        return p

    def run_tag(self) -> str:
        """Config-derived artifact name: every hyper-parameter that
        affects the run is baked into log/checkpoint filenames."""
        parts = [
            self.model_type,
            self.dataset,
            f"{self.k_core}core",
            f"ls{self.latent_size}",
        ]
        if self.uses_reviews:
            parts += [f"we{self.word_embed_size}",
                      f"pct{self.percent_reviews_to_keep}"]
        if self.model_type == "NARRE":
            parts += [f"nr{self.narre_num_reviews}",
                      f"nw{self.narre_num_words}"]
        if self.model_type == "HFT":
            parts += [f"lam{self.lamda}", f"lreg{self.latent_reg}"]
        parts += [f"wd{self.weight_decay}", f"lr{self.lr}",
                  f"do{self.dropout}", f"il{self.input_length}"]
        return "_".join(str(p) for p in parts)

    def log_file(self) -> str:
        return os.path.join(self.log_dir, self.run_tag() + ".log")

    def model_path(self) -> str:
        return os.path.join(self.model_dir, self.run_tag() + ".ckpt")
