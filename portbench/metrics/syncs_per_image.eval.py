"""Calls that waited for the card, per image: the "stage:wait_*" ranges
of the profiled stretch over its images. Moves ``images_per_s``."""

from portbench.yardstick import waits

UNIT = "syncs"


def read(rec):
    if rec["kind"] != "eval" or rec["trace"] is None:
        return None
    n = len(waits.ranges(rec["trace"]))
    return n / rec["items"] if n else None
