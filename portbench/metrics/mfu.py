"""mfu.<entry>: the model's required FLOP over the traced run's untraced
remainder of the window (`portbench.counts`: training a FLOP count an
example; ranking each distinct tower once a call and each pair's head),
over its seconds and the card's peak (`counts.PEAK_FLOPS`), in
percent."""

from portbench.counts import PEAK_FLOPS


def read(record):
    rest = record["rest"]
    if rest["seconds"] <= 0 or rest["flop"] <= 0:
        return None
    return 100.0 * rest["flop"] / rest["seconds"] / PEAK_FLOPS
