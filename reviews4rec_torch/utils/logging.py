"""Run logging: append-only text logs keyed by the config tag plus an
epoch banner. The port's own copy of `reviews4rec_tpu/utils/logging.py`
(the reference's `file_write` / `log_end_epoch`). In a multi-process run
only the primary process prints and writes (`parallel.distributed`)."""

from __future__ import annotations

import os
import time
from typing import Dict, Optional


def file_write(log_file: Optional[str], s: str, quiet: bool = False) -> None:
    from ..parallel.distributed import is_primary
    if not is_primary():
        return
    if not quiet:
        print(s)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        with open(log_file, "a") as f:
            f.write(s + "\n")


def log_end_epoch(log_file: Optional[str], metrics: Dict, epoch,
                  elapsed_s: float, metrics_on: str = "(VAL)",
                  quiet: bool = False) -> None:
    body = " | ".join(f"{k} = {v}" for k, v in metrics.items())
    rule = "-" * 89
    file_write(
        log_file,
        f"{rule}\n| end of epoch {epoch} | time: {elapsed_s:5.2f}s | {body} {metrics_on}\n{rule}",
        quiet=quiet,
    )


class Timer:
    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self.t0
        return False
