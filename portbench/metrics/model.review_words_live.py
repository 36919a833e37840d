"""model.review_words_live.<entry>: the share of the word slots that
NARRE's per-review towers encode holding a word, in percent: 100 x the
counter "narre.review_words_live" over "narre.review_words"
(`train.profiler.counters`, every training step of the process, graph
replays included). The rest is padding: the slots past a review's last
word (100 a row), in empty rows and in the pair's own masked row.
Nothing where the program keeps no such counters."""

from reviews4rec_torch.train import profiler


def read(record):
    counters = getattr(profiler, "counters", {})
    words = counters.get("narre.review_words", 0)
    if not words or "narre.review_words_live" not in counters:
        return None
    return 100.0 * counters["narre.review_words_live"] / words
