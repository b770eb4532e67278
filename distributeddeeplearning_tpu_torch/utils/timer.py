"""Wall-clock timing utilities: the JAX package's ``utils/timer.py``,
copied as it is (it imports no JAX).

Capability parity with the reference's ``common/timer.py``: a ``Timer``
context manager (reference ``common/timer.py:7-71``, ``elapsed`` at
``:62-71``) and a ``timer`` decorator (``common/timer.py:74-105``) with a
callable output sink. Re-designed, not translated: uses
``time.perf_counter`` and supports nesting + accumulation, which the
training loop uses for step/epoch/run-level throughput.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Optional


class Timer:
    """Context-manager wall-clock timer.

    Example::

        with Timer() as t:
            work()
        print(t.elapsed)

    ``output`` is an optional callable sink (e.g. ``logger.info``) invoked
    on exit with ``fmt.format(elapsed)`` — mirroring the reference Timer's
    callable-output behavior (``common/timer.py:30-46``).
    """

    def __init__(
        self,
        output: Optional[Callable[[str], None]] = None,
        fmt: str = "elapsed time: {:.3f} s",
        prefix: str = "",
    ):
        self._output = output
        self._fmt = fmt
        self._prefix = prefix
        self._start: Optional[float] = None
        self._end: Optional[float] = None
        self._accumulated = 0.0

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        self._end = None
        return self

    def stop(self) -> float:
        if self._start is None:
            raise RuntimeError("Timer.stop() called before start()")
        if self._end is None:  # idempotent: a second stop() is a no-op
            self._end = time.perf_counter()
            self._accumulated += self._end - self._start
        return self.elapsed

    @property
    def elapsed(self) -> float:
        """Seconds elapsed: running total if stopped, live value if running."""
        if self._start is None:
            return self._accumulated
        if self._end is None:
            return self._accumulated + (time.perf_counter() - self._start)
        return self._accumulated

    def reset(self) -> None:
        self._start = None
        self._end = None
        self._accumulated = 0.0

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
        if self._output is not None:
            self._output(self._prefix + self._fmt.format(self.elapsed))


def timer(
    output: Optional[Callable[[str], None]] = None,
    fmt: str = "{name} elapsed time: {elapsed:.3f} s",
):
    """Decorator timing each call of the wrapped function.

    Parity with the reference ``timer`` decorator (``common/timer.py:74-105``,
    which exists there but is unused — here it is exercised by tests).
    """

    def deco(fn: Callable):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t = Timer()
            t.start()
            try:
                return fn(*args, **kwargs)
            finally:
                t.stop()
                if output is not None:
                    output(fmt.format(name=fn.__name__, elapsed=t.elapsed))

        wrapped.__timer__ = True
        return wrapped

    return deco
