"""The training step's share of the card's peak: Σ over the profiled
iterations' micro-batches of the forward's, the data gradients' and the
weight gradients' operations (``yardstick/counts.train_step``) at the fp32
contract's 165 TFLOP/s, over the window's length. Moves
``train_iters_per_s``."""

UNIT = "%"


def read(rec):
    if rec["kind"] != "train" or rec["trace"] is None or not rec["window_s"]:
        return None
    t = sum(r["ops"] / r["peak"] for r in rec["work"]["layers"])
    return 100.0 * t / rec["window_s"]
