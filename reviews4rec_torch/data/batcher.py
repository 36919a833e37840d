"""Fixed-shape batching.

Every batch has exactly `batch_size` rows: the final partial batch is
zero-padded and a `weight` mask (1.0 real / 0.0 padding) is attached.
The shuffle draws the same permutation as the JAX package's Batcher for
the same seed and epoch, so both packages see the same batches.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class Batcher:
    """Iterate dict-of-arrays records in fixed-size batches.

    - all arrays are sliced on their leading dim;
    - unknown keys pass through untouched;
    - `shuffle=True` reshuffles every epoch with the seed
      `seed + epoch`.
    """

    def __init__(self, records: Dict[str, np.ndarray], batch_size: int,
                 shuffle: bool = False, seed: int = 0):
        self.records = {k: np.asarray(v) for k, v in records.items()}
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        first = next(iter(self.records.values()))
        self.n = int(first.shape[0])

    def __len__(self) -> int:
        return -(-self.n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Align the shuffle stream after a resume: the next iteration
        draws the permutation of epoch `epoch`."""
        self._epoch = int(epoch)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
            self._epoch += 1
        bs = self.batch_size
        for start in range(0, self.n, bs):
            sel = idx[start:start + bs]
            pad = bs - sel.shape[0]
            weight = np.zeros(bs, np.float32)
            weight[:sel.shape[0]] = 1.0
            batch: Dict[str, np.ndarray] = {}
            for k, v in self.records.items():
                arr = v[sel]
                if pad:
                    arr = np.concatenate(
                        [arr, np.zeros((pad,) + v.shape[1:], v.dtype)],
                        axis=0)
                batch[k] = arr
            batch["weight"] = weight
            yield batch
