"""RetinaFace's ResNet-50 body: device ms an image of every device event
launched while one of the forward's "body.*" scopes was open ("body.conv1"
with the max pool, "body.layer1" to "body.layer4"), in the profiled
window. None where the trace has no such scope (another detector).
Moves ``images_per_s``."""

UNIT = "ms"


def read(rec):
    if rec["kind"] != "eval" or rec["trace"] is None:
        return None
    groups = rec["trace"].group(lambda n: n.startswith("body."))
    total = sum(g["device_s"] for k, g in groups.items() if k != "(outside)")
    return total * 1e3 / rec["items"] if total > 0 else None
