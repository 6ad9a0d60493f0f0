"""Each pytest-xdist worker takes its share of the CPU for torch.

Under ``pytest -n W`` every worker's torch would keep one OpenMP / MKL
thread per core, W times as many threads as cores, all spinning.  The
port's plain versions of the tensor-core kernels, loops of thousands of
small products that each open an OpenMP region, then run tens of times
slower than alone.  Every ``test_torch_*.py`` imports this module first,
and it gives each worker ``cores // W`` threads (at least one).  The share
goes into ``OMP_NUM_THREADS`` / ``MKL_NUM_THREADS`` before torch loads
OpenMP, so that every thread of the worker starts with it, as do the
subprocesses the tests start.  (After ``torch.set_num_threads`` alone, a
server's handler threads kept OpenMP's default of a thread a core in part
of their work and summed a call in another order than the test's thread.)  Where the
caller set ``OMP_NUM_THREADS`` itself, that count stands, in the worker
and its subprocesses.  Without xdist it does nothing.
"""

import os

_share = None
if (os.environ.get("PYTEST_XDIST_WORKER_COUNT")
        and "OMP_NUM_THREADS" not in os.environ):
    _share = max(1, len(os.sched_getaffinity(0))
                 // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
    os.environ["OMP_NUM_THREADS"] = str(_share)
    os.environ.setdefault("MKL_NUM_THREADS", str(_share))

import torch  # noqa: E402  (after the environment is set)

if _share:  # in case torch was loaded before this module
    torch.set_num_threads(_share)
