"""entry.fetch_ms_per_call.<entry>: the host's wall milliseconds inside
the program's `score_grid.fetch` span (the call's scores stacked and
copied to the host, waiting for the device), per ranking call of the
traced slice. Nothing where no such span ran."""

from portbench.spans import ms_per


def read(record):
    return ms_per(record, "score_grid.fetch", "units")
