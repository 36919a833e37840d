"""model.review_rows_live.<entry>: the share of the review rows that
NARRE's per-review towers encode holding a review that the step does
not mask, in percent: 100 x the counter "narre.review_rows_live" over
"narre.review_rows" (`train.profiler.counters`, every training step of
the process, graph replays included). The rest is padding: an entity's
empty rows past its last review, and the pair's own review row. Nothing
where the program keeps no such counters."""

from reviews4rec_torch.train import profiler


def read(record):
    counters = getattr(profiler, "counters", {})
    rows = counters.get("narre.review_rows", 0)
    if not rows or "narre.review_rows_live" not in counters:
        return None
    return 100.0 * counters["narre.review_rows_live"] / rows
