"""entry.place_ms_per_call.<entry>: the host's wall milliseconds inside
the program's `score_grid.place` spans (each batch drawn, sliced and
copied to the device, with any stream wait the copies hold), per
ranking call of the traced slice. Nothing where no such span ran."""

from portbench.spans import ms_per


def read(record):
    return ms_per(record, "score_grid.place", "units")
