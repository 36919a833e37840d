"""Device choice shared by every entry point of the package.

`device=None` means the GPU. Without CUDA an entry point raises unless
the caller asked for the CPU explicitly: nothing falls back silently.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def host_tensor(a: np.ndarray, pin: bool = False) -> torch.Tensor:
    """A CPU tensor of host array `a`: `a`'s own buffer where torch can
    share it, else one copy. A read-only array (the memory-mapped record
    store of `hp.out_of_core`) is copied, as torch tensors are writable;
    `pin=True` copies `a` into pinned memory for an asynchronous H2D."""
    a = np.ascontiguousarray(a)
    if pin:
        t = torch.empty(a.shape, pin_memory=True,
                        dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype)
        t.numpy()[...] = a
        return t
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """Host numpy batch -> tensors on `device`; on CUDA through pinned
    memory, so the copy is asynchronous and overlaps the device work
    before it (elsewhere a plain copy)."""
    pin = torch.device(device).type == "cuda"
    return {k: host_tensor(v, pin).to(device, non_blocking=pin)
            for k, v in batch.items()}


def module_device(module: torch.nn.Module,
                  device: Optional[DeviceLike]) -> torch.device:
    """The device a model's entry point runs on: the one asked for,
    which must be where the model's parameters already are."""
    dev = resolve_device(device)
    have = next(module.parameters()).device
    if have.type != dev.type or (dev.index is not None
                                 and have.index != dev.index):
        raise ValueError(f"the model lies on {have}, the call asks for {dev}"
                         f"; move it with model.to(device) first")
    return have
