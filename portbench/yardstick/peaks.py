"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W).

From ``smallhardface_tpu_torch/tools/measure.py`` :43-49, changed: work
that keeps the fp32 contract is priced once at the 3xTF32 rate, 495 / 3 =
165 TFLOP/s (the route the stem kernel K1 takes; no route that stays
correct in fp32 is faster, so no share can pass 100 %), not three times
at 495.
"""

PEAK_BYTES = 3.35e12
PEAK_FP32_CONTRACT = 495e12 / 3
PEAK_INT8 = 1979e12


def bound_s(ops, nbytes, peak):
    """The least time for the work: the larger of operations over ``peak``
    and bytes over the memory rate."""
    return max(ops / peak, nbytes / PEAK_BYTES)
