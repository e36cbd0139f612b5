"""One intra-op thread in every process that the port's CPU tests run.

The tier-1 command runs the suite in six xdist workers (``-n 6 --dist
loadfile``) on an 8-core box.  Left alone, torch starts one OpenMP thread
a core in every process, so 6 workers x 8 spinning threads share 8 cores
and a test that takes a second alone takes minutes.  Every
``tests/test_torch_*.py`` imports this module before its other imports:

- ``torch.set_num_threads(1)`` caps the importing process.  Under
  ``--dist loadfile`` every worker imports every test module at
  collection, so the cap holds from the first test of each worker;
- ``OMP_NUM_THREADS=1`` (where it is unset) reaches the processes the
  tests start: the ranks ``parallel.spawn`` starts, the driver's
  subprocesses, ``subprocess`` children."""

import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import torch  # noqa: E402

torch.set_num_threads(1)
