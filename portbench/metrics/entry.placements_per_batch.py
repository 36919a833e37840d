"""entry.placements_per_batch.<entry>: the host-to-device placements a
ranking call makes per grid batch: the counter
"score_grid.placements" over "score_grid.batches"
(`train.profiler.counters`, every `score_grid` call of the process).
1 where each batch is copied to the device on its own; 1 / batches where
a call places everything its device work reads once. Nothing where the
program keeps no such counters."""

from reviews4rec_torch.train import profiler


def read(record):
    counters = getattr(profiler, "counters", {})
    batches = counters.get("score_grid.batches", 0)
    if not batches or "score_grid.placements" not in counters:
        return None
    return counters["score_grid.placements"] / batches
