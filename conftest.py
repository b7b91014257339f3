"""How the test files are queued onto xdist's workers.

``--dist loadfile`` queues the files largest first by collected test count,
so the few files of ``heavy`` tests, which hold few tests but run for many
minutes each, start late and set the length of the whole run. For
``--dist loadfile`` only, the scheduler below queues those files first; the
rest keep xdist's order. No test is selected, skipped or marked here.

This file imports neither JAX nor xdist at module level: xdist is imported in
the hook, which only xdist calls, and ``tests/conftest.py`` configures JAX.
"""

from collections import OrderedDict
from pathlib import PurePosixPath

import pytest

# the test files whose source carries ``pytest.mark.heavy``
# (tests/test_torch_repairs.py holds this list to the sources)
HEAVY_FILES = ("test_adjoint.py", "test_assim.py", "test_ensemble.py", "test_world_io.py")


def heavy_first(workqueue: OrderedDict) -> None:
    """Move the heavy files' work units to the front of ``workqueue`` (an
    OrderedDict keyed by file), keeping their order among themselves and the
    others' order among themselves."""
    heavy = [s for s in workqueue if PurePosixPath(s.split("::", 1)[0]).name in HEAVY_FILES]
    for scope in reversed(heavy):
        workqueue.move_to_end(scope, last=False)


@pytest.hookimpl(tryfirst=True, optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class HeavyFirstScheduling(LoadFileScheduling):
        def _assign_work_unit(self, node):
            heavy_first(self.workqueue)
            super()._assign_work_unit(node)

    return HeavyFirstScheduling(config, log)
