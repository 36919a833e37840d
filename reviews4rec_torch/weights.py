"""Bridge from the JAX package's flax params to the port's modules.

A flax params tree (nested dicts of arrays) maps onto a torch
`state_dict` by joining the path with dots, with one change of layout:
a flax `Dense` kernel is `[in, out]` and becomes `nn.Linear.weight`
`[out, in]`. Every other leaf keeps its layout: TextCNN's `conv_kernel`
(`[W*E, F]`) and `conv_bias`, MPCN's trained `word_embedding` [V, E], its
FM's `fm_V`, TENSOR's `weights_T` [d, k, d], the `<prefix>_kernel` /
`<prefix>_bias` of D-ATT's convs (whose torch modules carry the flax
auto-names, `_Conv1D_0`, ...). `word_vectors` becomes the model's frozen
buffer.

The non-SGD families have no module: `neighbor_state` carries the JAX
package's neighbor state dicts (`bu`, `bi`, `p`, `q`, `y`; NMF's `p`,
`q`) and `hft_params` HFT's params (and background) across, as f32
tensors on a device.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def tree_from_flat(flat: Mapping[str, np.ndarray], sep: str = "/") -> Dict:
    """{'a/b/c': array} -> {'a': {'b': {'c': array}}}."""
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split(sep)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax params tree -> torch state_dict (CPU float32 tensors)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
                continue
            arr = np.asarray(value, np.float32)
            if key == "kernel":          # flax Dense: [in, out]
                out[f"{prefix}weight"] = torch.from_numpy(arr.T.copy())
            else:
                out[f"{prefix}{key}"] = torch.from_numpy(arr.copy())

    walk(tree, "")
    return out


def load_flax_params(model: torch.nn.Module, tree: Mapping) -> None:
    """Load a flax params tree into `model` in place. A `word_vectors`
    leaf, where the tree has one, must equal the model's frozen table
    (the dataset's); every parameter of the model must be in the tree."""
    state = params_from_flax(tree)
    own = model.state_dict()
    if "word_vectors" in own:
        wv = state.pop("word_vectors", None)
        if wv is not None and not torch.equal(wv, own["word_vectors"].cpu()):
            raise ValueError("the params' word_vectors differ from the "
                             "model's frozen table")
        state["word_vectors"] = own["word_vectors"]
    model.load_state_dict(state, strict=True)


def _tensors(tree: Mapping, keys, device, dtype) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(tree[k]), dtype=dtype, device=device)
            for k in keys}


def neighbor_state(state: Mapping, device=None,
                   dtype: torch.dtype = torch.float32
                   ) -> Dict[str, torch.Tensor]:
    """A JAX neighbor state dict (`_sgd_fit`'s `bu`, `bi`, `p`, `q`, `y`,
    or `_nmf_fit`'s `p`, `q`; numpy or JAX arrays) as tensors, every key
    it holds."""
    return _tensors(state, list(state), device, dtype)


def hft_params(params: Mapping, background=None, device=None,
               dtype: torch.dtype = torch.float32
               ) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """JAX HFT params (`alpha`, `kappa`, `beta_u`, `beta_i`, `gamma_u`,
    `gamma_i`, `topic_words`) and, if given, the background, as tensors."""
    keys = ("alpha", "kappa", "beta_u", "beta_i", "gamma_u", "gamma_i",
            "topic_words")
    bg = (None if background is None else torch.tensor(
        np.asarray(background), dtype=dtype, device=device))
    return _tensors(params, keys, device, dtype), bg
