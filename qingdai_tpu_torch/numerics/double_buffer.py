"""Read/write double buffers for host-side NumPy pipelines (the port's copy
of ``qingdai_tpu/numerics/double_buffer.py``, which imports no JAX; held
equal to it by ``tests/test_torch_repairs.py``).

The reference enforces read/write separation inside a mutating step with
``DoubleBufferingArray``. The port's step needs none: it maps a state to a
new state, and ``world.QingdaiWorld`` hands its IO worker a state that the
step never writes again. These classes are standalone utilities, not part of the
coupled model's path: ``DoubleBufferingArray`` keeps the reference's API
contract (read/write/swap/self-alias protection) for NumPy pipelines, and
``HostDoubleBuffer`` is a two-slot snapshot holder for host pipelines that
mutate their buffers in place.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np


class DoubleBufferingArray:
    """Read/write buffer pair with O(1) swap (reference API parity).

    __getitem__ reads the read buffer; __setitem__ writes the write buffer;
    ``swap()`` exchanges them. Using the instance in arithmetic reads the read
    buffer; ufunc ``out=`` targeting the instance writes the write buffer.
    Writing an expression that reads the same instance's write buffer raises,
    mirroring the reference's self-alias protection (double_buffer.py:115-127).
    """

    def __init__(self, shape_or_array, dtype=None):
        if isinstance(shape_or_array, np.ndarray):
            a = shape_or_array.astype(dtype) if dtype else shape_or_array.copy()
            b = a.copy()
        else:
            a = np.zeros(shape_or_array, dtype=dtype or float)
            b = np.zeros(shape_or_array, dtype=dtype or float)
        self._read = a
        self._write = b

    @property
    def read(self) -> np.ndarray:
        return self._read

    @property
    def write(self) -> np.ndarray:
        return self._write

    @property
    def shape(self):
        return self._read.shape

    @property
    def dtype(self):
        return self._read.dtype

    def swap(self) -> None:
        self._read, self._write = self._write, self._read

    def sync(self) -> None:
        """Copy read → write (copy-on-write style synchronization)."""
        np.copyto(self._write, self._read)

    def __getitem__(self, key):
        return self._read[key]

    def __setitem__(self, key, value):
        if isinstance(value, np.ndarray) and (value is self._write
                                              or value.base is self._write):
            raise ValueError("self-aliasing write: value reads this buffer's write side")
        self._write[key] = value

    def __array__(self, dtype=None):
        return np.asarray(self._read, dtype=dtype)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        out = kwargs.get("out")
        proc_in = tuple(i._read if isinstance(i, DoubleBufferingArray) else i
                        for i in inputs)
        if out is not None:
            proc_out = tuple(o._write if isinstance(o, DoubleBufferingArray) else o
                             for o in out)
            for o in proc_out:
                for i in proc_in:
                    if isinstance(i, np.ndarray) and i is o:
                        raise ValueError("self-aliasing ufunc: input is the write buffer")
            kwargs["out"] = proc_out
        result = getattr(ufunc, method)(*proc_in, **kwargs)
        if out is not None:
            return out[0] if len(out) == 1 else out
        return result


class HostDoubleBuffer:
    """Two host slots for device-snapshot pipelining.

    ``publish(pytree)`` fills the back slot and flips; ``latest()`` returns
    the most recently completed snapshot. Thread-safe: the renderer/writer
    thread never sees a half-written snapshot.
    """

    def __init__(self):
        self._slots: list[Optional[Any]] = [None, None]
        self._front = 0
        self._lock = threading.Lock()

    def publish(self, pytree) -> None:
        back = 1 - self._front
        self._slots[back] = pytree
        with self._lock:
            self._front = back

    def latest(self):
        with self._lock:
            return self._slots[self._front]
