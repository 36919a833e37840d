"""The traced slice: `torch.profiler` over a bounded part of the window,
reduced in memory (no trace file is written) to what the per-layer
readers and the result's `breakdown` need.

- device intervals: every device event (kernels, copies, sets) whose
  name is no host event's, so the device-side copies of the host's
  named ranges are left out; their union is `busy_s`;
- `kernels`: device seconds by name; `host`: wall seconds of the host's
  named ranges and ops by name;
- `idle_gaps`: the device's idle time between the slice's first and
  last event, each gap charged to the innermost host event that spans
  its middle, summed by that event's name.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
from torch.autograd import DeviceType

TOP = 10
GAPS_READ = 5000


def _merge(iv: np.ndarray) -> np.ndarray:
    """The union of [start, end] intervals, as sorted disjoint ones."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    starts = iv[new, 0]
    last = np.concatenate([np.flatnonzero(new)[1:] - 1, [len(iv) - 1]])
    return np.stack([starts, ends[last]], axis=1)


def summarize(prof, window_s: float) -> Dict:
    events = list(prof.events())
    host = [e for e in events if e.device_type == DeviceType.CPU]
    host_names = {e.name for e in host}
    dev = [e for e in events if e.device_type != DeviceType.CPU
           and e.name not in host_names]
    kernels: Dict[str, float] = defaultdict(float)
    for e in dev:
        kernels[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    ranges: Dict[str, float] = defaultdict(float)
    for e in host:
        ranges[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    busy = _merge(np.asarray([[e.time_range.start, e.time_range.end]
                              for e in dev], float).reshape(-1, 2))
    return {"window_s": window_s,
            "busy_s": float(np.sum(busy[:, 1] - busy[:, 0])) * 1e-6,
            "kernels": dict(kernels), "host": dict(ranges),
            "idle_gaps": _idle_gaps(busy, host)}


def _idle_gaps(busy: np.ndarray, host) -> List[Tuple[str, float]]:
    if len(busy) == 0 or not host:
        return []
    hs = np.asarray([e.time_range.start for e in host], float)
    he = np.asarray([e.time_range.end for e in host], float)
    t0, t1 = min(hs.min(), busy[0, 0]), max(he.max(), busy[-1, 1])
    edges = np.concatenate([[t0], busy.reshape(-1), [t1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])[:GAPS_READ]]
    dur = he - hs
    by_name: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = np.flatnonzero((hs <= mid) & (he >= mid))
        name = (host[inside[np.argmin(dur[inside])]].name if inside.size
                else "(no host event)")
        by_name[name] += (b - a) * 1e-6
    return top(by_name)


def top(d: Dict[str, float]) -> List[Tuple[str, float]]:
    """The TOP largest entries, names cut to 200 characters."""
    return [[k[:200], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
            [:TOP]]
