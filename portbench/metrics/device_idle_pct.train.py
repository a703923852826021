"""The share of the profiled training window in which no operation ran on
the card. Moves ``train_iters_per_s``."""

UNIT = "%"


def read(rec):
    if rec["kind"] != "train" or rec["trace"] is None or not rec["window_s"]:
        return None
    return 100.0 * (1.0 - rec["trace"].busy_s() / rec["window_s"])
