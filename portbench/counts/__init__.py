"""The yardstick's operation and byte counts, and the card's peaks.

Counts follow the work a call requires, from the shapes alone, whatever
kernels do it: a later change to a kernel cannot change them.

PEAK_FLOPS is 495 TFLOP/s, the H100 SXM's dense TF32 tensor-core rate
(NVIDIA's data sheet): the fastest rate at which the card computes any
product that can pass a float32 check (3xTF32, 1xTF32 or `wgmma`). The
67 TFLOP/s float32 rate outside the tensor cores is not a peak for a
tensor-core kernel, which could read above 100% against it. HBM_BYTES_S
is the card's 3.35 TB/s. Both assume the card's full 700 W; the run
prints its power limit beside them.
"""

from __future__ import annotations

from typing import Dict

from portbench import models

PEAK_FLOPS = 495e12
HBM_BYTES_S = 3.35e12
F32 = 4


def textcnn_fwd_flop(n: int, t: int, e: int, f: int, w: int) -> float:
    """The pooled conv over every window start of n docs of t words:
    t + w - 1 starts (w - 1 zero words pad each end), w*e multiply-adds
    per start and filter."""
    return 2.0 * n * (t + w - 1) * w * e * f


def textcnn_fwd_bytes(n: int, t: int, e: int, f: int, w: int) -> float:
    """Each input read once and each output written once: the docs, the
    kernel and bias, the pooled maxima and their int32 argmax."""
    return F32 * (n * t * e + w * e * f + f + 2 * n * f)


def textcnn_fwd_bound_s(n: int, t: int, e: int, f: int, w: int) -> float:
    """The least time the card could take for one forward's work."""
    return max(textcnn_fwd_flop(n, t, e, f, w) / PEAK_FLOPS,
               textcnn_fwd_bytes(n, t, e, f, w) / HBM_BYTES_S)


def dense_flop(n_in: int, n_out: int) -> float:
    """One example through a dense layer (multiply-adds and bias)."""
    return 2.0 * n_in * n_out + n_out


def _towers(cfg: Dict) -> Dict[str, int]:
    """(docs a side per example, words a doc, E, F, W, latent) of a
    configuration, from its model's file."""
    return models.load(cfg["model"]).towers(cfg)


def tower_flop(cfg: Dict) -> float:
    """Forward FLOP of one entity's tower: its docs' pooled convs and
    the FC to latent."""
    s = _towers(cfg)
    return s["docs"] * (textcnn_fwd_flop(1, s["t"], s["e"], s["f"], s["w"])
                        + dense_flop(s["f"], s["l"]))


def towers_fwd_bound_s(cfg: Dict, entities: int) -> float:
    """The least time the card could take for the pooled convs of
    `entities` towers, each its docs of its words."""
    s = _towers(cfg)
    return textcnn_fwd_bound_s(entities * s["docs"], s["t"], s["e"], s["f"],
                               s["w"])


def head_flop(cfg: Dict) -> float:
    """Forward FLOP of one pair's head from the two towers' outputs."""
    return models.load(cfg["model"]).head_flop(cfg)


def train_flop_per_example(cfg: Dict) -> float:
    """The training work an example requires: both towers' forward over
    every window start; dK over the winning windows only (2 F W E a
    doc); the FC layers and the head forward and backward (3x their
    forward). No dx: the word table is frozen. Every example masks its
    own review, so no tower output can be shared between examples."""
    s = _towers(cfg)
    conv = 2 * s["docs"] * textcnn_fwd_flop(1, s["t"], s["e"], s["f"],
                                            s["w"])
    dk = 2 * s["docs"] * 2.0 * s["f"] * s["w"] * s["e"]
    dense = 2 * s["docs"] * dense_flop(s["f"], s["l"]) + head_flop(cfg)
    return conv + dk + 3 * dense


def rank_flop(cfg: Dict, users: int, items: int, pairs: int) -> float:
    """A ranking call's required work: each distinct user's and item's
    tower once, and each pair's head. Nothing is masked at evaluation,
    so a call that factorizes its grid cannot read above 100%."""
    return (users + items) * tower_flop(cfg) + pairs * head_flop(cfg)
