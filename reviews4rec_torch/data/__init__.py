from .batcher import Batcher
from .corpus import ReviewDataset, Split
from .synthetic import make_synthetic

__all__ = ["Batcher", "ReviewDataset", "Split", "make_synthetic"]
