"""The share of the profiled window in which no operation ran on the
card: 1 − the union of the device events' intervals over the window.
Moves ``images_per_s``."""

UNIT = "%"


def read(rec):
    if rec["kind"] != "eval" or rec["trace"] is None or not rec["window_s"]:
        return None
    return 100.0 * (1.0 - rec["trace"].busy_s() / rec["window_s"])
