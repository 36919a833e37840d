from .batcher import Batcher
from .corpus import ReviewDataset, Split

__all__ = ["Batcher", "ReviewDataset", "Split"]
