"""trainer.replay_ms_per_step.<entry>: the host's wall milliseconds
inside the program's `scan.replay` spans (the launch of each group's
CUDA graph), per training step of the traced slice. Nothing where no
such span ran (no graph: the CPU)."""

from portbench.spans import ms_per


def read(record):
    return ms_per(record, "scan.replay", "steps")
