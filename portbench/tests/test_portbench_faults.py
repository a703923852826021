"""The timed path broken underneath, the rest of a run as it is: each
fault that a cell can have makes ``correct`` false."""

import numpy as np
import pytest

import tiny


@pytest.fixture
def folder(tmp_path):
    return tiny.write(str(tmp_path))


def _alter_answers(monkeypatch):
    """An answer altered where it is produced: every returned box moved by
    half its width."""
    from smallhardface_tpu_torch import detect
    orig = detect.TorchDetector.finalize_async

    def altered(self, handle, thresh=0.05):
        out = orig(self, handle, thresh)
        moved = []
        for d in out:
            d = np.array(d, np.float32)
            half = (d[:, 2] - d[:, 0]) / 2
            d[:, 0] += half
            d[:, 2] += half
            moved.append(d)
        return moved
    monkeypatch.setattr(detect.TorchDetector, "finalize_async", altered)


@pytest.mark.parametrize("cell", ["tiny-eval", "tiny-b4"])
def test_altered_answer_is_not_correct(folder, cell, monkeypatch):
    _alter_answers(monkeypatch)
    res, _ = tiny.run(folder, cell, monkeypatch)
    assert not res["correct"], res["checks"]


def test_one_image_of_each_batch_altered(folder, monkeypatch):
    """detect_many answering the last image of each group with its boxes
    moved: the mean over the compared images may hide it, the count of
    images past half unmatched does not."""
    from smallhardface_tpu_torch import detect
    orig = detect.TorchDetector.detect_many

    def one_wrong(self, ims, *a, **k):
        out = orig(self, ims, *a, **k)
        d = np.array(out[-1][0], np.float32)
        width = d[:, 2] - d[:, 0] + 1
        d[:, 0] += 2 * width
        d[:, 2] += 2 * width
        return out[:-1] + [[d, *out[-1][1:]]]
    monkeypatch.setattr(detect.TorchDetector, "detect_many", one_wrong)
    res, _ = tiny.run(folder, "tiny-b4", monkeypatch)
    assert not res["correct"], res["checks"]
    past = res["checks"]["det_images_past_half.loose"]
    assert past["value"] > past["limit"], res["checks"]


def test_half_the_batch_left_out_detection(folder, monkeypatch):
    """detect_many leaving out the second half of its images: their
    answers never come."""
    from smallhardface_tpu_torch import detect
    orig = detect.TorchDetector.detect_many

    def half(self, ims, *a, **k):
        return orig(self, ims[:len(ims) // 2], *a, **k)
    monkeypatch.setattr(detect.TorchDetector, "detect_many", half)
    res, _ = tiny.run(folder, "tiny-b4", monkeypatch)
    assert not res["correct"] and res["failed"] > 0, res


def test_half_the_batch_left_out_training(folder, monkeypatch):
    """grad_step over the first micro-batch only, its mean over that one."""
    from smallhardface_tpu_torch.train import train_loop as tl
    orig = tl.grad_step

    def half(model, loss_fn, batch, out_shape, iter_size, *a, **k):
        keep = max(1, iter_size // 2)
        part = {key: v[:keep] for key, v in batch.items()}
        m = orig(model, loss_fn, part, out_shape, keep, *a, **k)
        return m.repeat(1, iter_size // keep)
    monkeypatch.setattr(tl, "grad_step", half)
    res, _ = tiny.run(folder, "tiny-train", monkeypatch)
    assert not res["correct"], res["checks"]


def test_step_that_leaves_the_state_unchanged(folder, monkeypatch):
    from smallhardface_tpu_torch.train import solver
    monkeypatch.setattr(solver, "apply_update",
                        lambda params, grads, state, **k: (params, state))
    res, _ = tiny.run(folder, "tiny-train", monkeypatch)
    assert not res["correct"], res["checks"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)
