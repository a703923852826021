"""Give each pytest-xdist worker its share of the machine's cores for
torch's intra-op threads.

Each worker process would otherwise run torch with one OpenMP thread per
core of the machine, so that six workers on eight cores run 48 spinning
threads against each other: a test that takes 17 s alone then takes
minutes beside its neighbours. Imported under an xdist worker (the
``PYTEST_XDIST_WORKER_COUNT`` variable that xdist sets in each worker),
this module sets ``torch.set_num_threads`` to the cores this process may
run on divided by the number of workers, and to no fewer than two: with
one thread PyTorch's CPU convolutions sum some fp32 products in another
order, and ``test_torch_port_int8``'s comparison of the int8 chain with
JAX's holds at two threads and more but not at one. Outside xdist it does
nothing, so a file run alone keeps every core.

Every port test file (``tests/test_torch_port_*.py``) imports it first,
as ``import torch_threads`` (pytest puts ``tests/`` on the path, as for
``retinaface_ref``; a ``tests`` package installed elsewhere may shadow
``tests.torch_threads``). Every xdist worker collects every test file
before it runs its first test, so the cap holds in every worker,
including for the torch oracles of the JAX package's own test files that
the worker runs.
"""

import os

import torch

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(2, len(os.sched_getaffinity(0))
                              // int(_WORKERS)))
