"""The threads of the port's CPU test modules.

Every ``tests/test_torch_*.py`` that runs on the CPU imports this module
before anything else, and with it, as its first import,
:func:`one_intra_op_thread`, an autouse fixture of module scope:

    from torch_threads import one_intra_op_thread  # noqa: F401,I001 (autouse; first: see its module)

The suite runs in six worker processes on eight cores, and by default
each worker's PyTorch keeps an OpenMP pool of one thread per core whose
threads spin after every parallel region.  The pools then take the cores
from each other: on an 8-core x86 CPU, the large-grid strip's first
solve took 291 s in a six-worker run (~20 s alone), the 256x256 two-pass
comparison 233 s, and runs of the whole suite ended anywhere from 735 s
to past its 1,470 s limit.  Two remedies, both here:

* ``OMP_WAIT_POLICY=PASSIVE`` (unless already set), which makes idle
  OpenMP threads sleep instead of spinning.  The OpenMP runtime reads it
  once, when PyTorch loads it, so this module must be imported before
  ``torch`` is, which is why the test modules import it first; no module
  that a worker imports before them loads PyTorch.  It changes no result.
* one intra-op thread per test module (the fixture; the count in force
  before the module is put back after it).  Besides the time, one thread
  keeps the bitwise comparisons of two solves to what they test: with the
  default threads, the first solve after the JAX package's computations in
  a process now and then took other bits (two pairs off by ~6e-7
  relative, the solve's tolerance) than the same solve later, whichever
  route ran first.

tests/test_torch_flow_large.py and its companion import
:func:`eight_intra_op_threads` instead: their tolerances at the default
refinement exit were set on eight threads' summation order, which the
strip's distance to the JAX package and to the float64 solve depends on
(that file gives the distances at 1 to 8 threads).  Eight is pinned, not
the machine's default, so that a machine with another core count runs
the same reductions.
"""

import os

os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")

import pytest  # noqa: E402
import torch  # noqa: E402


def _intra_op_threads(n):
    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    yield from _intra_op_threads(1)


@pytest.fixture(scope="module", autouse=True)
def eight_intra_op_threads():
    yield from _intra_op_threads(8)
