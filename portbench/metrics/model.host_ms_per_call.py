"""model.host_ms_per_call.<entry>: the host's wall milliseconds inside
the program's `score_grid.forward` spans (the model's forward
dispatched, a batch), per ranking call of the traced slice. Nothing
where no such span ran."""

from portbench.spans import ms_per


def read(record):
    return ms_per(record, "score_grid.forward", "units")
