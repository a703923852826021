"""Host ms an iteration spent waiting for the card: the summed length of
the "stage:wait_*" ranges of the profiled iterations (the step's own,
inside its stages) over the iterations. Moves ``train_iters_per_s``."""

from portbench.yardstick import waits

UNIT = "ms"


def read(rec):
    if rec["kind"] != "train" or rec["trace"] is None:
        return None
    spans = waits.ranges(rec["trace"])
    if not spans:
        return None
    return sum(b - a for a, b in spans) / 1e3 / rec["items"]
