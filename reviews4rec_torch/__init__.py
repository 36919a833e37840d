"""reviews4rec_torch: the PyTorch / CUDA port of reviews4rec_tpu for one
NVIDIA H100. It imports neither JAX nor the JAX package; the tests hold
it against the JAX package on the same inputs and weights."""

from .config import HyperParams

__all__ = ["HyperParams"]
