"""Host ms an image spent waiting for the card: the program's wait spans
("wait_<stage>" around each call that waits for the device, inside the
detector's stages) summed over the first half of the traced run (no
profiler), over the images issued there. ``issue_ms_per_image.eval``
includes the waits inside its stages. Moves ``images_per_s``."""

from portbench.yardstick import waits

UNIT = "ms"


def read(rec):
    if rec["kind"] != "eval" or not rec["host_items"]:
        return None
    s = waits.host_s(rec)
    return None if s is None else s * 1e3 / rec["host_items"]
