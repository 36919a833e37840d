"""Profiling and throughput, the port's counterpart of
`reviews4rec_tpu/train/profiler.py`:

- `trace(logdir)`: `torch.profiler.profile` over the block (CPU, and
  CUDA where there is a card), written to `logdir` as a Chrome /
  TensorBoard trace; yields the profiler, so a caller can read
  `key_averages()`. No logdir: no trace.
- `annotate(name)`: a named span, a `record_function` range entered
  only while a torch profiler records (`trace`, or any
  `torch.profiler.profile` around the call). It then lands in the
  profiler's timeline beside the device's events, on their clock, and
  nests under the span that encloses it. With no profiler recording it
  checks one flag and creates nothing: under a microsecond a span.
- `counters` and `count(name, n)`: the process's one store of named
  event counts since it started: each kernel launch under the kernel's
  name (`ops.textcnn.KERNELS`, `ops.neighbors.SGD`; a graph replay of
  `train.loop.ScanSteps` adds what its capture counted), `scan.captures`
  (graph captures), and the `score_grid.*` and `narre.*` counters of
  `train.evaluate` and `train.loop`. This module imports nothing of the
  package, so every layer, the kernels' included, counts here.
- `Throughput`: examples/s and ms per step for the epoch banner.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

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


_recording = torch._C._autograd._profiler_enabled
_UNRECORDED = contextlib.nullcontext()


def annotate(name: str):
    """`with annotate(name):` a span of the program: a `record_function`
    range while a torch profiler records, else one shared no-op context
    (a flag read, nothing created)."""
    if _recording():
        return torch.profiler.record_function(name)
    return _UNRECORDED


counters: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name`."""
    counters[name] = counters.get(name, 0) + n


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
