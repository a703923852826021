"""Of the card's idle time over the profiled iterations, the share in gaps
that open while the host is inside a wait span: the card drained while
the host was blocked on it. Moves ``train_iters_per_s``."""

from portbench.yardstick import waits

UNIT = "%"


def read(rec):
    if rec["kind"] != "train" or rec["trace"] is None:
        return None
    return waits.drained_idle_pct(rec["trace"])
