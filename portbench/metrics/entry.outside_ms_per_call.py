"""entry.outside_ms_per_call.<entry>: the traced slice's wall outside
the program's `eval_ranking` spans (the harness's own work between and
around the calls), in milliseconds per ranking call. Nothing where no
such span ran."""


def read(record):
    t = record["trace"]
    if "eval_ranking" not in t["host"]:
        return None
    outside = t["window_s"] - t["host"]["eval_ranking"]
    return 1e3 * outside / record["slice"]["units"]
