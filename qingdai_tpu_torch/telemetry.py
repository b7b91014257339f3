"""Spans of the step on the profiler's clock.

While a ``torch.profiler`` session is active, ``with span(name):`` keeps one
record ``(name, start_ns, end_ns, parent)``: host times from
``time.time_ns()``, the clock that the profiler's (kineto's) events carry,
and ``parent``, the index in ``records()`` of the span that was open around
it (-1 for none). The spans of one step form a tree under its root
(``ensemble.step`` for the member-batched step, ``step`` for one planet), so
a reader of a trace can put each device operation, by the host time of the
call that launched it, in the innermost span open then. Names are
``<layer>.<stage>``; the layer is the part before the first dot.

A span launches no device work and touches no tensor: no
``record_function``, NVTX range or CUDA event, so a device trace holds the
same operations with the spans as without them, and the numbers are the
same bit for bit. With no profiler session active ``span`` returns one
shared no-op context and records nothing. With one, a span opens when
``span`` is called and closes when its block ends; it keeps its record in
flat arrays of integers and leaves behind no object that Python's garbage
collector tracks, so tracing neither brings collections on nor lengthens them.

The records live in this module: one buffer a process, filled by one
thread, as the step loop runs in one. The buffer holds at most ``CAPACITY``
records; once it is full, further spans are not recorded until ``clear()``.
"""

from __future__ import annotations

import contextlib
import time
from array import array
from typing import NamedTuple

from torch.autograd import profiler as _profiler

CAPACITY = 1 << 18

_OFF = contextlib.nullcontext()
_names: list = []            # the records' names, in the order they opened
_times = array("q")          # start_ns, end_ns of each record (end 0 while open)
_parents = array("q")        # the index of each record's parent, -1 for none
_open = array("q")           # the indices of the spans open now, outermost first


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int


class _Close:
    """The context of every recorded span: its exit closes the innermost
    open span."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):
        _times[2 * _open.pop() + 1] = time.time_ns()
        return False


_CLOSE = _Close()


def span(name: str):
    """A context that records the block as the span ``name`` while a
    profiler session is active, and does nothing otherwise. Use it only as
    ``with span(name):``."""
    if not _profiler._is_profiler_enabled or len(_names) >= CAPACITY:
        return _OFF
    _parents.append(_open[-1] if _open else -1)
    _open.append(len(_names))
    _names.append(name)
    _times.append(time.time_ns())
    _times.append(0)
    return _CLOSE


def records() -> list:
    """The records kept so far, in the order the spans opened (a parent
    before its children)."""
    return [Record(n, _times[2 * i], _times[2 * i + 1], _parents[i])
            for i, n in enumerate(_names)]


def clear() -> None:
    """Drop every record. Call it between steps, with no span open."""
    del _names[:], _times[:], _parents[:], _open[:]
