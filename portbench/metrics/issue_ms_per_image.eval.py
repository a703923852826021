"""Host ms of issuing one image: the detector's stages (prep, upload,
preproc, forward, decode, vote; the ``stages`` seam, ``time.perf_counter``
around each without a sync) summed over the first half of the traced run
(no profiler) and divided by the images issued. Moves ``images_per_s``."""

UNIT = "ms"
ISSUING_STAGES = ("prep", "upload", "preproc", "forward", "decode", "vote")


def read(rec):
    if rec["kind"] != "eval" or not rec["host_items"]:
        return None
    host = sum(rec["host_s"].get(k, 0.0) for k in ISSUING_STAGES)
    return host * 1e3 / rec["host_items"]
