"""RetinaFace's FPN, SSH modules and heads: device ms an image of every
device event launched while its "fpn", "ssh1" to "ssh3" or "heads" scope
was open, in the profiled window. None where the trace has no such scope
(another detector). Moves ``images_per_s``."""

UNIT = "ms"
SCOPES = ("fpn", "ssh1", "ssh2", "ssh3", "heads")


def read(rec):
    if rec["kind"] != "eval" or rec["trace"] is None:
        return None
    groups = rec["trace"].group(lambda n: n in SCOPES)
    total = sum(g["device_s"] for k, g in groups.items() if k != "(outside)")
    return total * 1e3 / rec["items"] if total > 0 else None
