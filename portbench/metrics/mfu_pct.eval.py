"""The whole pyramid's share of the card's peak: Σ over every layer of the
images in the profiled window of its operations over the peak of its
precision (the fp32 contract's 165 TFLOP/s, or int8's 1,979 TOP/s for Q1's
layers), over the window's length. Moves ``images_per_s``."""

UNIT = "%"


def read(rec):
    if rec["kind"] != "eval" or rec["trace"] is None or not rec["window_s"]:
        return None
    t = sum(r["ops"] / r["peak"] for r in rec["work"]["layers"])
    return 100.0 * t / rec["window_s"]
