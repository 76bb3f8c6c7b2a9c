"""Test configuration for every pytest run from the repo's root, loaded
before tests/conftest.py: each pytest-xdist worker's share of the CPUs, and
the order in which xdist hands out the test files."""

import os

import pytest

# Six xdist workers on an 8-CPU host, each running torch's and OpenBLAS's
# thread pools as wide as the whole host, oversubscribe the CPUs about
# sixfold: six test files took 185-200 s at the libraries' defaults and
# 47-61 s with these pools at one thread per worker.  So each worker gets its
# share of the CPUs in those pools; a plain pytest run keeps the defaults.
# XLA:CPU's pool stays as it is: it keeps a thread for each of the 8 devices
# tests/conftest.py forces, whatever PJRT_NPROC says, and no XLA_FLAGS entry
# narrows it.
_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _workers:
    share = max(1, len(os.sched_getaffinity(0)) // _workers)
    # The variables reach the subprocesses tests start; torch reads
    # OMP_NUM_THREADS there.
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, str(share))

    import threadpoolctl
    import torch

    torch.set_num_threads(share)
    # numpy's OpenBLAS is loaded already (the plugins import jax first) and
    # has read its environment: set its width in place.
    threadpoolctl.threadpool_limits(share)

# The two sharded tests of tests/test_parallel.py take 360-630 s each: the
# JAX package runs its sharded step outside jit, so JAX compiles each
# primitive on the 8-device mesh by itself.  Each alone is longer than all
# the other files on six workers.  Under --dist loadfile xdist handed that
# file out late (it has few tests), ran the two one after the other, and
# queued another file behind them: the suite ended at 1325-1470 s.  So under
# loadfile each of LONG_TESTS is a work unit of its own, handed out first,
# and its worker stops after it.  A worker runs an item only once it holds
# the next item or a shutdown, so the shutdown goes out with the test; the
# last worker left running takes whatever is left as usual.
LONG_TESTS = ("tests/test_parallel.py::test_sharded_matches_batched",
              "tests/test_parallel.py::test_sharded_output_sharding")


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class LongTestsFirst(LoadFileScheduling):
        def _split_scope(self, nodeid):
            return nodeid if nodeid in LONG_TESTS else super()._split_scope(nodeid)

        def _assign_work_unit(self, node):
            long = next((scope for scope in self.workqueue if scope in LONG_TESTS), None)
            others = [n for n in self.nodes if n is not node and not n.shutting_down]
            if long is None or not others:
                return super()._assign_work_unit(node)
            self.workqueue.move_to_end(long, last=False)
            super()._assign_work_unit(node)
            node.shutdown()

    return LongTestsFirst(config, log)
