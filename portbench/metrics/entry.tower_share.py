"""entry.tower_share.<entry>: the share of the towers a ranking grid
names that the program's launches encode, in percent: 100 x the
counter "score_grid.towers" over "score_grid.tower_slots"
(`train.profiler.counters`, every `score_grid` call of the process).
100 where each grid row's user and each pair's item runs its own tower;
lower where a call encodes each distinct entity once. Nothing where the
program keeps no such counters."""

from reviews4rec_torch.train import profiler


def read(record):
    counters = getattr(profiler, "counters", {})
    slots = counters.get("score_grid.tower_slots", 0)
    if not slots or "score_grid.towers" not in counters:
        return None
    return 100.0 * counters["score_grid.towers"] / slots
