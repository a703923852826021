"""Calls that waited for the card, per iteration: the "stage:wait_*"
ranges of the profiled iterations over the iterations. Moves
``train_iters_per_s``."""

from portbench.yardstick import waits

UNIT = "syncs"


def read(rec):
    if rec["kind"] != "train" or rec["trace"] is None:
        return None
    n = len(waits.ranges(rec["trace"]))
    return n / rec["items"] if n else None
