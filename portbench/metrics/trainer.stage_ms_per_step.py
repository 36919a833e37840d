"""trainer.stage_ms_per_step.<entry>: the host's wall milliseconds
inside the program's `scan.stage` spans (each group stacked into its
pinned slot and its copies enqueued), per training step of the traced
slice. Nothing where no such span ran."""

from portbench.spans import ms_per


def read(record):
    return ms_per(record, "scan.stage", "steps")
