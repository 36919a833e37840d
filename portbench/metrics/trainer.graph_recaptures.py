"""trainer.graph_recaptures.<entry>: the program's CUDA-graph captures
beyond the first in this process (`train.profiler.counters`,
"scan.captures", minus 1): a capture after the warm-up's means a
parameter or optimizer state tensor was replaced. Nothing where no
graph was captured (the CPU) or the program keeps no such counter."""

from reviews4rec_torch.train import profiler


def read(record):
    captures = getattr(profiler, "counters", {}).get("scan.captures", 0)
    return captures - 1 if captures else None
