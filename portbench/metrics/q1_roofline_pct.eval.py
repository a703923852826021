"""Q1's share of its roofline: Σ over Q1's launches in the profiled window
of the least time each needs (int8 operations at the int8 peak, its int8
or fp32 bytes at the memory rate, ``yardstick/counts.forward``) over Σ
the device time of its ``conv3x3_int8_kernel`` events. Moves
``images_per_s``."""

from portbench.yardstick import peaks

UNIT = "%"


def read(rec):
    if rec["kind"] != "eval" or rec["trace"] is None or not rec["work"]["q1"]:
        return None
    t, n = rec["trace"].kernel_s(r"\bconv3x3_int8_kernel\b")
    if n == 0 or t <= 0:
        return None
    bound = sum(peaks.bound_s(ops, b, peaks.PEAK_INT8)
                for ops, b in rec["work"]["q1"])
    return 100.0 * bound / t
