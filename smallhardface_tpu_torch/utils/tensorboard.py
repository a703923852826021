"""Metrics sink: tensorboardX writer behind the reference's null-object API.
The port's copy of ``smallhardface_tpu/utils/tensorboard.py``.

The reference talked to a Crayon tensorboard REST server and fell back to a
`Fake` null object when disabled or timing out
(lib/utils/tensorboard.py:74-85,88-393). Here the same
``tb.sess.add_scalar_value(...)`` call surface is kept, backed by
tensorboardX event files when enabled and a no-op otherwise.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


class Fake:
    """Null object: absorbs any call chain (reference tensorboard.py:74-85)."""

    def __getattr__(self, name):
        return self

    def __call__(self, *args, **kwargs):
        return self


class TBSink:
    """Scalar/text/image sink with the Crayon-client method names."""

    def __init__(self, logdir, name):
        from tensorboardX import SummaryWriter
        self._writer = SummaryWriter(logdir=logdir, comment=name)

    def add_scalar_value(self, tag, value, step=0, wall_time=None):
        self._writer.add_scalar(tag, value, global_step=step)

    def add_text(self, tag, text, step=0):
        self._writer.add_text(tag, text, global_step=step)

    def add_image(self, tag, image_path, wall_time=0, step=0):
        try:
            import numpy as np
            from PIL import Image
            arr = np.asarray(Image.open(image_path))
            self._writer.add_image(tag, arr, global_step=step,
                                   dataformats="HWC")
        except Exception:
            logger.warning("Failed to log image %s", image_path)

    def add_histogram_value(self, tag, values, step=0):
        self._writer.add_histogram(tag, values, global_step=step)


class Tensorboard:
    """Factory matching the reference client's create_experiment API."""

    def __init__(self, hostname=None, port=None, logdir=None):
        self._logdir = logdir

    def create_experiment(self, name):
        logdir = self._logdir or f"runs/{name}"
        return TBSink(logdir, name)


class _TB:
    """Module-level holder; defaults to the Fake null object."""

    def __init__(self):
        self.client = Fake()
        self.sess = Fake()


tb = _TB()
