"""Device ms under the ``forward`` stage per image: every device event
launched while a "stage:forward" range was open, in the profiled window.
Moves ``images_per_s``."""

UNIT = "ms"


def read(rec):
    if rec["kind"] != "eval" or rec["trace"] is None:
        return None
    fwd = rec["trace"].stages().get("forward")
    if not fwd:
        return None
    return fwd["device_s"] * 1e3 / rec["items"]
