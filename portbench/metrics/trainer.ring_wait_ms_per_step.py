"""trainer.ring_wait_ms_per_step.<entry>: the host's wall milliseconds
inside the program's `scan.ring_wait` spans (`ScanSteps._stage` waiting
for its pinned slot's last copy to the device), per training step of
the traced slice. Nothing where no such span ran (no graph: the CPU)."""

from portbench.spans import ms_per


def read(record):
    return ms_per(record, "scan.ring_wait", "steps")
