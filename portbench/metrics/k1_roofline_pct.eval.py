"""K1's share of its roofline: Σ over K1's launches in the profiled window
of the least time its work needs (``yardstick/counts.stem`` at the fp32
contract's peak and the memory rate) over Σ K1's device time (its
``stem_kernel`` and ``split_w2_kernel`` events). Moves ``images_per_s``."""

from portbench.yardstick import peaks

UNIT = "%"


def read(rec):
    if rec["kind"] != "eval" or rec["trace"] is None or not rec["work"]["k1"]:
        return None
    t, n = rec["trace"].kernel_s(r"\b(stem_kernel|split_w2_kernel)\b")
    if n == 0 or t <= 0:
        return None
    bound = sum(peaks.bound_s(ops, b, peaks.PEAK_FP32_CONTRACT)
                for ops, b in rec["work"]["k1"])
    return 100.0 * bound / t
