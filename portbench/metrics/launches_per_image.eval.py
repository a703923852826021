"""Device operations (kernels, copies, fills) per image in the profiled
window. Moves ``images_per_s``."""

UNIT = "launches"


def read(rec):
    if rec["kind"] != "eval" or rec["trace"] is None:
        return None
    return len(rec["trace"].device) / rec["items"]
