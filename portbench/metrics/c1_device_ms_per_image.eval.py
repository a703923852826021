"""C1's device ms an image: the summed device time of the fp32 3×3
convolution kernel C1 (``conv3x3_fp32_kernel``) and the weight split it
launches before it (``split_weights_kernel``, both in
``smallhardface_tpu_torch/csrc/conv_fp32.cu``) over the profiled window,
per image. None where no C1 event ran (a port without C1, or a cell whose
convolutions do not reach it). Moves ``images_per_s``."""

UNIT = "ms"


def read(rec):
    if rec["kind"] != "eval" or rec["trace"] is None:
        return None
    t, n = rec["trace"].kernel_s(
        r"\b(conv3x3_fp32_kernel|split_weights_kernel)\b")
    if n == 0 or t <= 0:
        return None
    return t * 1e3 / rec["items"]
