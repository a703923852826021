"""smallhardface_tpu_torch: the smallhardface face detector in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

Counterpart of ``smallhardface_tpu`` (JAX/XLA/Pallas), which stays the
reference it is tested against. This package imports torch and never jax;
it shares the JAX package's jax-free modules (config, anchors, host NMS and
vote, the ``.npz`` checkpoint reader). Like its counterpart, importing it
imports nothing.
"""

__version__ = "0.1.0"
