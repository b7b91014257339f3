"""How the tests are queued onto xdist's workers.

Tier-1 runs with ``-m 'not slow'``, which replaces the ``-m 'not heavy'`` of
the addopts, so the few files of ``heavy`` tests run too; each of their tests
compiles for minutes, and under ``--dist loadfile`` one file sits on one
worker and would alone set the length of the whole run. For ``--dist
loadfile`` only, the scheduler below therefore makes each test of a heavy
file a work unit of its own and queues those units first; every other file
stays one unit, in xdist's order. No test is selected, skipped or marked here.

This file imports neither JAX nor xdist at module level: xdist is imported in
the hook, which only xdist calls, and ``tests/conftest.py`` configures JAX.
"""

from collections import OrderedDict
from pathlib import PurePosixPath

import pytest

# the test files whose source carries ``pytest.mark.heavy``
# (tests/test_torch_repairs.py holds this list to the sources)
HEAVY_FILES = ("test_adjoint.py", "test_assim.py", "test_ensemble.py", "test_world_io.py")


def _is_heavy(scope: str) -> bool:
    """Whether a nodeid or a work unit's scope lies in a heavy file."""
    return PurePosixPath(scope.split("::", 1)[0]).name in HEAVY_FILES


def heavy_first(workqueue: OrderedDict) -> None:
    """Move the heavy files' work units to the front of ``workqueue`` (an
    OrderedDict keyed by scope), keeping their order among themselves and the
    others' order among themselves."""
    heavy = [s for s in workqueue if _is_heavy(s)]
    for scope in reversed(heavy):
        workqueue.move_to_end(scope, last=False)


@pytest.hookimpl(tryfirst=True, optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class HeavyFirstScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            # a heavy file's test is a unit of its own; other files stay whole
            return nodeid if _is_heavy(nodeid) else super()._split_scope(nodeid)

        def _assign_work_unit(self, node):
            heavy_first(self.workqueue)
            super()._assign_work_unit(node)

    return HeavyFirstScheduling(config, log)
