"""First-use build of the port's CUDA kernels, shared by every kernel.

Each kernel source in ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, under
``csrc/build/<name>_<sha256[:16]>.so``, keyed by a hash of the source and
the flags, and loaded with ctypes (the idiom the repo-root ``csrc/`` host
library uses). Only the sources in the checkout are compiled; nothing is
downloaded. ``build_all`` starts one ``nvcc`` per source at once and waits
for all of them, so the build costs the slowest source, not the sum.

Every entry point of a kernel library returns a ``cudaError_t`` (0 on a
successful launch); ``CudaLibrary.check`` turns anything else into an
exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import tempfile
import threading

CSRC = osp.abspath(osp.join(osp.dirname(__file__), "..", "csrc"))
BUILD_DIR = osp.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

VP, CI = ctypes.c_void_p, ctypes.c_int
# what ``CudaLibrary.check`` puts before cudaGetErrorString's text
LAUNCH_FAILED = "kernel launch failed: "


def nvcc():
    for cand in (shutil.which("nvcc"),
                 osp.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")):
        if cand and osp.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "port's CUDA kernels are compiled from csrc/ at first "
                       "use")


class CudaLibrary:
    """One kernel source and its ctypes interface.

    ``signatures`` maps each exported C function to its ctypes argument
    types; every one returns an int error code. ``log`` holds nvcc's output
    (``-Xptxas -v``: registers, shared memory, spills) of a build this
    process ran, else "".
    """

    def __init__(self, name, source, signatures, extra_flags=()):
        self.name = name
        self.source = osp.join(CSRC, source)
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self.signatures = dict(signatures)
        self.log = ""
        self._lib = None
        self._lock = threading.Lock()

    def path(self):
        """The .so for the current source and flags."""
        with open(self.source, "rb") as f:
            h = hashlib.sha256(f.read() + " ".join(self.flags).encode())
        return osp.join(BUILD_DIR, f"{self.name}_{h.hexdigest()[:16]}.so")

    def _start(self):
        """Start nvcc on a temporary output; returns (process, tmp path)."""
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc(), *self.flags, "-o", tmp, self.source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def _finish(self, proc, tmp):
        try:
            self.log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source} "
                                   f"({proc.returncode}):\n{self.log}")
            os.replace(tmp, self.path())
        finally:
            if osp.exists(tmp):
                os.unlink(tmp)

    def load(self):
        """Build (if this source was not built yet) and load the library.
        Safe to call repeatedly and from several processes: each builds to
        a temporary name and renames it."""
        with self._lock:
            if self._lib is None:
                if not osp.exists(self.path()):
                    self._finish(*self._start())
                self._bind(ctypes.CDLL(self.path()))
            return self._lib

    def _bind(self, lib):
        for fn, argtypes in self.signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = CI
        lib.shf_cuda_error_string.argtypes = [CI]
        lib.shf_cuda_error_string.restype = ctypes.c_char_p
        self._lib = lib

    def check(self, err, what):
        if err:
            raise RuntimeError(
                f"{what}: {LAUNCH_FAILED}"
                + self._lib.shf_cuda_error_string(err).decode())


def build_all(libraries):
    """Build every library not built yet with one nvcc each, all started
    together, then load them all."""
    started = [(lib, *lib._start()) for lib in libraries
               if lib._lib is None and not osp.exists(lib.path())]
    errors = []
    for lib, proc, tmp in started:      # wait for every nvcc, even on error
        try:
            lib._finish(proc, tmp)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    for lib in libraries:
        lib.load()
