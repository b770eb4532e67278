"""Event-bus-triggered ``torch.profiler`` capture: the port of the JAX
package's ``obs/trace.py``.

Capture is wired into the training loop as a *triggered* action:

* ``TRACE_EVERY_N_EPOCHS=k`` — capture every k-th epoch (epoch 0, k,
  2k, …) into ``<OBS_DIR>/traces/trace-epochNNNN`` (``TRACE_DIR``
  overrides the base);
* on demand — ``kill -USR1 <pid>`` (``TRACE_ON_SIGNAL``, or
  :meth:`TraceController.request`) marks the *next* epoch for capture,
  so a live job can be profiled when it misbehaves without a restart.

A capture is a ``torch.profiler.profile`` of CPU activity, and of CUDA
activity when the card is there, started at one epoch boundary and
stopped at the next; the stop writes a Chrome trace,
``<dir>/trace-epochNNNN/rank<R>.pt.trace.json``. Start and stop are
epoch-boundary actions (the loop calls ``maybe_start``/``maybe_stop``
outside the dispatch clock). Stopping waits for the device to drain,
one host sync booked as ``trace_stop`` (``utils/hostsync``). Each
transition emits a ``point`` on the bus (``trace_start``/``trace_stop``),
which is how a report correlates "epoch 7 was slow" with "epoch 7 was
being traced".
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Optional

import torch

from distributeddeeplearning_tpu_torch.obs import bus as _bus


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class TraceController:
    """Decides, per epoch, whether a profiler capture starts/stops."""

    def __init__(self, directory: str, every_n: int = 0) -> None:
        self.directory = directory
        self.every_n = max(int(every_n), 0)
        self._requested = False
        self._active_dir: Optional[str] = None
        self._profile = None
        # Whether captures record CUDA activity: the loop sets it from its
        # device; None means "when CUDA is available".
        self.cuda: Optional[bool] = None

    @property
    def active(self) -> bool:
        return self._active_dir is not None

    def request(self) -> None:
        """Capture the next epoch (signal handler / user code)."""
        self._requested = True

    def install_signal(self, signum: Optional[int] = None) -> bool:
        """SIGUSR1 → :meth:`request`. Main thread only; returns False
        when signals are unavailable (e.g. called from a worker)."""
        signum = signum or getattr(signal, "SIGUSR1", None)
        if signum is None:
            return False
        if threading.current_thread() is not threading.main_thread():
            return False
        try:
            signal.signal(signum, lambda *_: self.request())
        except (ValueError, OSError):
            return False
        return True

    def maybe_start(self, epoch: int) -> bool:
        """Start a capture for ``epoch`` if due (periodic or requested)."""
        if self._active_dir is not None:
            return False
        due = self._requested or (self.every_n > 0 and epoch % self.every_n == 0)
        if not due:
            return False
        self._requested = False
        out = os.path.join(self.directory, f"trace-epoch{epoch:04d}")
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda if self.cuda is not None else torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._profile = profile(activities=acts)
        self._profile.start()
        self._active_dir = out
        _bus.point("trace_start", epoch=epoch, dir=out)
        return True

    def maybe_stop(self, epoch: int) -> bool:
        """Stop the active capture (epoch boundary) and write its trace."""
        if self._active_dir is None:
            return False
        from torch.profiler import ProfilerActivity

        from distributeddeeplearning_tpu_torch.utils import hostsync

        if ProfilerActivity.CUDA in self._profile.activities:
            # The trace is whole only once the device has drained: the
            # capture's one sync, booked under its own label.
            torch.cuda.synchronize()
            hostsync.accountant().record("trace_stop")
        self._profile.stop()
        os.makedirs(self._active_dir, exist_ok=True)
        self._profile.export_chrome_trace(
            os.path.join(self._active_dir, f"rank{_rank()}.pt.trace.json"))
        _bus.point("trace_stop", epoch=epoch, dir=self._active_dir)
        self._active_dir = None
        self._profile = None
        return True


def from_env(env=None, directory: Optional[str] = None) -> Optional[TraceController]:
    """Build the controller the env asks for, or None when tracing is
    entirely off (``TRACE_EVERY_N_EPOCHS`` unset/0 and no
    ``TRACE_ON_SIGNAL``). The trace directory defaults to
    ``<OBS_DIR>/traces`` next to the event files."""
    e = os.environ if env is None else env
    every_n = int(e.get("TRACE_EVERY_N_EPOCHS", "0") or 0)
    on_signal = e.get("TRACE_ON_SIGNAL", "").strip().lower() in {
        "1", "true", "t", "yes", "y", "on"
    }
    if every_n <= 0 and not on_signal:
        return None
    if directory is None:
        base = e.get("TRACE_DIR")
        if not base:
            bus_dir = _bus.get_bus().directory
            base = os.path.join(bus_dir or os.getcwd(), "traces")
        directory = base
    ctrl = TraceController(directory, every_n=every_n)
    ctrl.install_signal()
    return ctrl
