"""Host↔device materialisation accounting: the port of the JAX package's
``utils/hostsync.py`` (the sync-free-loop ledger).

A training step is only as fast as its launches stay asynchronous: one
stray ``.item()`` (or ``float(t)``, ``bool(t)`` in an ``if``, a
``.cpu()`` in a callback) in the hot loop makes the host wait for the
device and serialises the two. Here that class of regression is counted:

* :class:`SyncAccountant`: a process-global counter of device→host
  materialisations, labelled by call site and mirrored onto the port's
  event bus (``host_sync`` counter). The training loop routes its one
  materialisation an epoch through :func:`device_get`, so the CPU tests
  can assert "≤ 1 host sync an epoch".
* :func:`track`: additionally patches the ways torch materialises a
  tensor (``Tensor.item``, ``.cpu``, ``.tolist``, ``.numpy``,
  ``__float__``, ``__int__``, ``__bool__``) while active, so a
  materialisation in code that does not use this module (callbacks,
  user code, a kernel wrapper) is booked too. The host copies
  :func:`device_get` hands out are already booked and are not counted
  again when read.
* :class:`StepClock`: per-step host time and per-epoch wait time;
  ``summary()`` reports p50/p99 and the total wait.

Everything here is host-side bookkeeping and adds no device work.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Any, Dict, Iterator, List

import torch

# The tensor methods that copy a value to the host (and, for a CUDA
# tensor, wait for the device): what track() patches.
MATERIALISERS = ("item", "cpu", "tolist", "numpy", "__float__", "__int__", "__bool__")

# The host copies device_get handed out (id -> weak reference): reading
# them is not a sync. Keyed by id, as a tensor's == is elementwise.
_HOST_COPIES: Dict[int, "weakref.ref"] = {}


def _remember(t: torch.Tensor) -> None:
    key = id(t)
    _HOST_COPIES[key] = weakref.ref(t, lambda _, key=key: _HOST_COPIES.pop(key, None))


def _is_host_copy(t: torch.Tensor) -> bool:
    ref = _HOST_COPIES.get(id(t))
    return ref is not None and ref() is t


class SyncAccountant:
    """Counts device→host materialisations, by label."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0
        self.by_label: Dict[str, int] = {}

    def record(self, label: str = "device_get", n: int = 1) -> None:
        with self._lock:
            self.count += n
            self.by_label[label] = self.by_label.get(label, 0) + n
        # Mirror onto the event bus with the call-site label; imported
        # here so this module stays importable on its own.
        from distributeddeeplearning_tpu_torch import obs

        obs.counter("host_sync", n, label=label)

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.by_label = {}


_GLOBAL = SyncAccountant()


def accountant() -> SyncAccountant:
    """The process-global accountant (tests reset it between runs)."""
    return _GLOBAL


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def device_get(tree: Any, label: str = "device_get") -> Any:
    """Copy every tensor of ``tree`` (dicts, lists and tuples of tensors
    and host values) to the host, booked as ONE materialisation.

    Returns the same tree with each tensor replaced by a detached CPU
    copy (a copy even of a CPU tensor, so a later in-place update of the
    original cannot reach it). On a CUDA device the copies are issued
    non-blocking into pinned memory and the host then waits once for
    the current stream. All of the port's deliberate host syncs go
    through here; a raw ``.item()`` in a hot path is a review flag."""
    _GLOBAL.record(label)
    cuda = []

    def copy(x):
        if not torch.is_tensor(x):
            return x
        out = x.detach().to("cpu", non_blocking=x.is_cuda, copy=True)
        if x.is_cuda:
            cuda.append(x.device)
        _remember(out)
        return out

    out = _tree_map(copy, tree)
    for dev in dict.fromkeys(cuda):
        torch.cuda.current_stream(dev).synchronize()
    return out


@contextlib.contextmanager
def track(label: str = "tensor") -> Iterator[SyncAccountant]:
    """Count every materialisation of a tensor in the process while
    active: each call of a :data:`MATERIALISERS` method on a tensor
    that is not a host copy from :func:`device_get` is booked as
    ``"<label>.<method>"``. Calls through :func:`device_get` are booked
    once, by it. Not re-entrant; restores the methods on exit."""
    originals = {name: getattr(torch.Tensor, name) for name in MATERIALISERS}

    def counted(name, original):
        def method(self, *args, **kwargs):
            if not _is_host_copy(self):
                _GLOBAL.record(f"{label}.{name}")
            return original(self, *args, **kwargs)

        method.__name__ = name
        return method

    for name, original in originals.items():
        setattr(torch.Tensor, name, counted(name, original))
    try:
        yield _GLOBAL
    finally:
        for name, original in originals.items():
            setattr(torch.Tensor, name, original)


class StepClock:
    """Host-time-vs-wait decomposition of the training hot loop.

    ``note_dispatch`` records the host time of one step. In JAX that is
    the enqueue of one compiled program; in eager torch it is the
    step's whole host time (every launch of the forward, backward and
    update), which the device overlaps while it keeps up and which the
    host's wait on a full launch queue lengthens when it does not.
    ``waiting()`` wraps the deliberate blocking points (the one epoch
    materialisation). A host sync inside the loop shows as a p99 spike
    the size of a device step."""

    def __init__(self) -> None:
        self.dispatch_s: List[float] = []
        self.wait_s: List[float] = []

    def note_dispatch(self, seconds: float) -> None:
        self.dispatch_s.append(seconds)

    @contextlib.contextmanager
    def waiting(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.wait_s.append(time.perf_counter() - t0)

    @staticmethod
    def _percentile(sorted_vals: List[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
        return sorted_vals[idx]

    def summary(self) -> Dict[str, float]:
        d = sorted(self.dispatch_s)
        return {
            "steps": float(len(d)),
            "dispatch_p50_ms": self._percentile(d, 0.50) * 1e3,
            "dispatch_p99_ms": self._percentile(d, 0.99) * 1e3,
            "dispatch_total_s": sum(d),
            "wait_total_s": sum(self.wait_s),
        }
