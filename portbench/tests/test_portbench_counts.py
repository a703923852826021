"""The operation and byte counts against hand counts at one small shape."""

from portbench.reference import arch
from portbench.yardstick import counts, peaks


def test_stem_by_hand():
    ops, nbytes = counts.stem(32, 48, 2)
    assert ops == 2 * 2 * 32 * 48 * (27 * 64 + 576 * 64)
    assert nbytes == (2 * (32 * 48 * 3 + 16 * 24 * 64) * 4
                      + 4 * (64 * 27 + 64 + 64 * 576 + 64))


def test_forward_by_hand():
    rows = {r["name"]: r for r in counts.forward(32, 48, 2)}
    # conv2_1 at stride 2: 16 x 24 pixels, 64 -> 128, 3x3
    assert rows["conv2_1"]["ops"] == 2 * 2 * 16 * 24 * 64 * 128 * 9
    assert rows["conv2_1"]["bytes"] == (2 * (16 * 24 * 64 + 16 * 24 * 128)
                                        * 4 + 4 * 128 * 64 * 9 + 4 * 128)
    # the depthwise deconvolution on the stride-16 map, 256 channels
    assert rows["conv5_256_up"]["ops"] == 2 * 2 * 2 * 3 * 256 * 16
    assert rows["head@4"]["ops"] == 2 * 2 * 4 * 6 * 128 * 128 * 9
    total = sum(r["ops"] for r in rows.values())
    assert total == sum(r["ops"] for r in counts.forward(32, 48, 1)) * 2


def test_int8_layers_priced_at_int8():
    rows = {r["name"]: r for r in counts.forward(32, 48, 2, "int8")}
    assert rows["conv3_1"]["peak"] == peaks.PEAK_INT8 and rows["conv3_1"]["q1"]
    assert rows["conv1_1"]["peak"] == peaks.PEAK_FP32_CONTRACT
    # a chain link writes int8; the chain's end (conv5_3, the head) fp32
    assert rows["conv3_1"]["bytes"] == (2 * (8 * 12 * 128 + 8 * 12 * 256)
                                        + 256 * 128 * 9 + 4 * 256)
    assert rows["conv5_3"]["bytes"] == (2 * (2 * 3 * 512 + 2 * 3 * 512 * 4)
                                        + 512 * 512 * 9 + 4 * 512)
    assert sum(r["q1"] for r in rows.values()) == 16


def test_train_counts_backward_once():
    fwd = sum(r["ops"] for r in counts.forward(64, 64, 1))
    ops, _ = counts.train_step(64, 64)
    frozen = sum(r["ops"] for r in counts.forward(64, 64, 1)
                 if r["name"].startswith(("conv1", "conv2")))
    conv3_1 = [r for r in counts.forward(64, 64, 1)
               if r["name"] == "conv3_1"][0]["ops"]
    deconv = [r for r in counts.forward(64, 64, 1)
              if r["name"] == "conv5_256_up"][0]["ops"]
    # every layer above the frozen stages: a weight gradient (not the
    # fixed deconv) and a data gradient (not conv3_1's input)
    assert ops == fwd + 2 * (fwd - frozen) - conv3_1 - deconv
    assert arch.multipliers()[0]["conv3_1"]["w"] > 0


def test_bound_is_the_larger_term():
    assert peaks.bound_s(165e12, 0, peaks.PEAK_FP32_CONTRACT) == 1.0
    assert peaks.bound_s(0, 3.35e12, peaks.PEAK_INT8) == 1.0
