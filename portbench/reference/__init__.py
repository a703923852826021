"""The plain reference that decides ``correct``: PyTorch and NumPy only.

Nothing here imports ``jax``, the JAX package or the PyTorch port. The
formulas are frozen copies of the port's plain versions (each file names
its source); the reference re-derives everything the program derives
(pyramid levels, int8 calibration, decode, vote, training targets) from
the benchmark's own inputs.
"""
