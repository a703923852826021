"""Debugger usable from forked / threaded workers.
The port's copy of ``smallhardface_tpu/utils/forked_pdb.py``.

Role parity with the reference's debug helper
(lib/utils/ipdb.py:4-17): a plain ``pdb`` session started
inside a forked data-loader or prefetch worker reads EOF because the child
inherits a closed/duplicated stdin. This subclass reopens the controlling
terminal for the duration of the interaction, so debug stops work from
any worker: call ``set_trace()`` there in place of ``pdb.set_trace()``.
"""

from __future__ import annotations

import pdb
import sys


class ForkedPdb(pdb.Pdb):
    """Pdb that temporarily rebinds stdin to the controlling terminal."""

    def interaction(self, *args, **kwargs):
        saved_stdin = sys.stdin
        try:
            sys.stdin = open("/dev/stdin")
            super().interaction(*args, **kwargs)
        finally:
            try:
                sys.stdin.close()
            except Exception:
                pass
            sys.stdin = saved_stdin


def set_trace():
    """Drop into a ForkedPdb at the caller's frame."""
    ForkedPdb().set_trace(sys._getframe().f_back)
