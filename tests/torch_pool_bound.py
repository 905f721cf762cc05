"""A time bound for a test that runs ``run_study``'s ``fork`` pool in the
test's own process (a pool's wait for its workers has none of its own).

Past POOL_BOUND_S seconds the process prints every thread's stack and
exits: the test fails (pytest-xdist reports its worker crashed and starts
another) instead of holding the whole run.

``test_torch_study._bounded_run`` bounds code run in a fresh interpreter.
The tests that use this bound fork this process instead: they hand the
pool what they already hold here (fixtures, closures defined in the test)
or check this process's module state after it (``study._FORK_STATE``)."""

import contextlib
import faulthandler
import sys

POOL_BOUND_S = 120


@contextlib.contextmanager
def pool_bound():
    faulthandler.dump_traceback_later(POOL_BOUND_S, exit=True,
                                      file=sys.stderr)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
