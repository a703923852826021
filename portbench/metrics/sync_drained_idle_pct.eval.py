"""Of the card's idle time in the profiled stretch, the share in gaps that
open while the host is inside a wait span: the card drained while the
host was blocked on it. Moves ``images_per_s``."""

from portbench.yardstick import waits

UNIT = "%"


def read(rec):
    if rec["kind"] != "eval" or rec["trace"] is None:
        return None
    return waits.drained_idle_pct(rec["trace"])
