"""Profiling and throughput, the port's counterpart of
`reviews4rec_tpu/train/profiler.py`:

- `trace(logdir)`: `torch.profiler.profile` over the block (CPU, and
  CUDA where there is a card), written to `logdir` as a Chrome /
  TensorBoard trace; yields the profiler, so a caller can read
  `key_averages()`. No logdir: no trace.
- `annotate(name)`: a named range (`record_function`, plus an NVTX range
  on CUDA) that shows up in both kinds of trace.
- `Throughput`: examples/s and ms per step for the epoch banner.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    if not logdir:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


@dataclass
class Throughput:
    examples: float = 0.0
    steps: int = 0
    _t0: float = field(default_factory=time.perf_counter)

    def add(self, n: float) -> None:
        self.examples += n
        self.steps += 1

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def examples_per_s(self) -> float:
        return self.examples / max(self.elapsed, 1e-9)

    @property
    def ms_per_step(self) -> float:
        return 1e3 * self.elapsed / max(self.steps, 1)

    def metrics(self) -> dict:
        return {
            "examples_per_s": round(self.examples_per_s, 1),
            "ms_per_step": round(self.ms_per_step, 2),
        }
