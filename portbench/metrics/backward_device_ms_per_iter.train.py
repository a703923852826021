"""Device ms under ``grad_step``'s ``backward`` stage per iteration in the
profiled window. Moves ``train_iters_per_s``."""

UNIT = "ms"


def read(rec):
    if rec["kind"] != "train" or rec["trace"] is None:
        return None
    bwd = rec["trace"].stages().get("backward")
    if not bwd:
        return None
    return bwd["device_s"] * 1e3 / rec["items"]
