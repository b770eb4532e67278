"""On-device metric accumulation: true epoch means with one host sync.
The port of the JAX package's ``training/metrics.py``.

The train step threads a small accumulator through the epoch: the f32
sums of :data:`METRIC_KEYS`, a step count and the non-finite-loss
counter, all on the device, so the loop materialises ONE tensor an
epoch. Contract (``training/train_step.make_train_step`` returns a
:class:`StepFn`)::

    step(state, batch)          -> (state, metrics)
    step(state, batch, acc)     -> (state, metrics, acc)

In JAX the update is fused into the compiled step. Eager torch pays a
launch per op and the fused ResNet step is host-bound, so the update is
kept to four launches: the accumulator is ONE f32 vector ``[Σloss,
Σaccuracy, Σgrad_norm, count, nonfinite]``, updated in place with one
``torch.stack`` of the step's values and one add. The adds are f32 in
step order, so the finalized mean equals, bit for bit, a host-side f32
running mean of the same per-step values.

With in-step accumulation (``ACCUM_STEPS``) a dispatch still emits ONE
metric sample (the f32 mean over its microbatches, ``grad_norm`` of the
final mean gradient), so the accumulator counts optimizer steps.

:class:`StepFn` also has JAX's ahead-of-time slots (JAX
``metrics.py:100-164``): :meth:`StepFn.aot_compile` captures the step's
device part as CUDA graphs, keyed by the call's signature (accumulator
or not, the optimizer's phase, the batch's shapes, dtypes and device),
and a matching call replays its graph instead of dispatching the step
op by op; a call of another signature (a padded tail batch) runs eager,
as JAX's falls back to ``jit``, and is counted in ``eager_calls``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

# Every train step emits exactly these (cross-rank-reduced, f32 scalar)
# metrics; the accumulator is sized from this tuple.
METRIC_KEYS: Tuple[str, ...] = ("loss", "accuracy", "grad_norm")


def init_accumulator(device=None, keys: Tuple[str, ...] = METRIC_KEYS) -> torch.Tensor:
    """A fresh zeroed accumulator on ``device``: ``len(keys)`` sums, the
    step count, then the count of steps whose loss was NaN or Inf (the
    non-finite guard, materialised with the rest at the epoch
    boundary, so detection costs no extra host sync)."""
    return torch.zeros(len(keys) + 2, dtype=torch.float32, device=device)


def accumulate_metrics(acc: torch.Tensor, metrics: Dict[str, torch.Tensor],
                       keys: Tuple[str, ...] = METRIC_KEYS) -> torch.Tensor:
    """One update, in place: ``sums += metrics``, ``count += 1``,
    ``nonfinite += [loss is NaN/Inf]``. Returns ``acc``."""
    loss = metrics["loss"].float()
    one = torch.ones((), dtype=torch.float32, device=acc.device)
    step = torch.stack([metrics[k].float() for k in keys]
                       + [one, (~torch.isfinite(loss)).float()])
    return acc.add_(step)


def finalize_accumulator(acc: torch.Tensor) -> torch.Tensor:
    """Epoch means on the device (the caller owns the one host sync):
    ``[mean_k for k in keys] + [nonfinite_steps]``, the non-finite step
    COUNT last (a count, not a mean: one poisoned step must trip the
    guard even in a long epoch). :func:`accumulator_logs` names them."""
    n = acc.shape[0] - 2
    means = acc[:n] / torch.clamp(acc[n:n + 1], min=1.0)
    return torch.cat([means, acc[n + 1:]])


def accumulator_logs(host_values, keys: Tuple[str, ...] = METRIC_KEYS) -> Dict[str, float]:
    """Name the host copy of :func:`finalize_accumulator`'s tensor."""
    vals = [float(v) for v in host_values.tolist()]
    out = dict(zip(keys, vals))
    out["nonfinite_steps"] = vals[len(keys)]
    return out


@dataclasses.dataclass
class StepParts:
    """A train step split at the host/device boundary
    (``train_step.make_train_step``): ``stage(batch)`` puts a batch on
    the device; ``prepare(state)`` is the host part before the device
    work (the dropout generators seeded, the optimizer's host part) and
    returns the token ``run`` needs; ``run(state, tensors, token)`` is
    the device part, which reads no host state but the token and syncs
    nothing, so it can be captured; ``finish(state)`` the host part
    after (``state.step``). ``phase(state)`` names the device program
    the next call runs, one of ``phases`` (the micro-steps of
    ``GRAD_ACCUM_STEPS``); ``generators`` are the step's own, which a
    graph registers so that its replay draws from their seeds."""

    prepare: Callable[[Any], Any]
    run: Callable[[Any, Tuple[torch.Tensor, ...], Any], Dict[str, torch.Tensor]]
    finish: Callable[[Any], None]
    phase: Callable[[Any], int]
    phases: int
    generators: Sequence[torch.Generator]
    stage: Callable[[Any], Tuple[torch.Tensor, ...]]
    device: torch.device
    model: Any


@dataclasses.dataclass
class Captured:
    """What ``aot_compile`` made: the number of CUDA graphs (0 on the
    CPU, where there are none), the FLOPs of the eager warm-up step
    (``torch.utils.flop_counter``; None where a hand-written kernel did
    part of the work, which the counter cannot see) and the seconds of
    the eager warm-up steps (the first one counted), the rest of the
    call's seconds being the capture."""

    graphs: int
    flops: Optional[float]
    warmup_sec: float = 0.0

    def cost_analysis(self) -> Dict[str, float]:
        """JAX's ``compiled.cost_analysis()`` shape."""
        return {"flops": self.flops or 0.0}


def kernel_launches() -> int:
    """Launches of the port's hand-written kernels so far (every
    wrapper's counter, summed)."""
    from distributeddeeplearning_tpu_torch.ops import (
        depthwise,
        flash,
        flash_packed,
        fused_block,
        fused_grads,
        paged_decode,
    )

    return sum(m.launches for m in (depthwise, flash, flash_packed, fused_block, fused_grads,
                                    paged_decode))


def _clone_tree(x):
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone_tree(v) for v in x)
    return x


def _restore_tree(dst, src) -> None:
    items = src.items() if isinstance(src, dict) else enumerate(src)
    for k, v in items:
        if torch.is_tensor(v):
            dst[k].copy_(v)
        elif isinstance(v, (dict, list, tuple)):
            _restore_tree(dst[k], v)
        else:
            dst[k] = v


def _tensors(x, out: List[torch.Tensor]) -> List[torch.Tensor]:
    if torch.is_tensor(x):
        out.append(x)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    return out


def _addresses(state) -> Tuple[int, ...]:
    """Where the optimizer state's tensors live: a captured step is
    valid only while they stay where they were (a restore copies into
    them; a new optimizer state does not)."""
    return tuple(t.data_ptr() for t in _tensors(state.opt_state, []))


@contextlib.contextmanager
def _preserved(state, model):
    """Run the warm-up steps, then put the state back as it was: the
    model's parameters and buffers, the optimizer state (tensors and
    host counters) and ``state.step``, so that warming up trains
    nothing."""
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt, step = _clone_tree(state.opt_state), state.step
    try:
        yield
    finally:
        live = model.state_dict()
        with torch.no_grad():
            for k, v in weights.items():
                live[k].copy_(v)
            _restore_tree(state.opt_state, opt)
        state.step = step


def _signature(tensors, *extra) -> tuple:
    return extra + tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


def _capture_stream(device: torch.device):
    """A fresh side stream that has waited for the current one, and the
    context that makes it current."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    return stream, torch.cuda.stream(stream)


def _warmup_iters(phases: int) -> int:
    """Eager steps before a capture: every phase at least once, whole
    cycles, at least three steps (torch's advice for capture)."""
    return phases * max(1, math.ceil(3 / phases))


class _Graph:
    """One captured program: the graph, its static inputs, accumulator
    and outputs."""

    def __init__(self, graph, static_in, static_acc, outputs):
        self.graph, self.static_in, self.static_acc, self.outputs = (
            graph, static_in, static_acc, outputs)

    def load(self, tensors, acc=None) -> None:
        """Copy the call's batch (and accumulator) into the static
        buffers, one device-to-device copy each, unless they are them."""
        for dst, src in zip(self.static_in, tensors):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        if acc is not None and acc.data_ptr() != self.static_acc.data_ptr():
            self.static_acc.copy_(acc)


class StepFn:
    """The step contract: arity dispatch over the :class:`StepParts` of a
    split step, ``step(state, batch) -> (state, metrics)``; with ``acc``
    the metrics are also added to the accumulator after the step.
    ``accum_steps`` (the in-step microbatch count) and
    ``accumulates_metrics`` are probed by the loop.

    A captured call (:meth:`aot_compile`) returns the graph's static
    outputs: the metrics and the accumulator are overwritten by the next
    replay of the same graph, as the eager step's accumulator is
    updated in place."""

    accumulates_metrics = True

    def __init__(self, parts: StepParts, accum_steps: int = 1):
        self._parts = parts
        self.accum_steps = accum_steps
        self._aot: Dict[tuple, Tuple[_Graph, Tuple[int, ...]]] = {}
        # Calls that found graphs installed but none for their signature.
        self.eager_calls = 0

    @property
    def graphs(self) -> int:
        """CUDA graphs installed."""
        return len(self._aot)

    def discard(self) -> None:
        """Drop the installed graphs (their memory pool goes with them):
        every call runs eager again."""
        self._aot.clear()

    def _eager(self, state, batch):
        p = self._parts
        tensors = p.stage(batch)
        token = p.prepare(state)
        metrics = p.run(state, tensors, token)
        p.finish(state)
        return state, metrics

    def __call__(self, state, batch, acc: Optional[torch.Tensor] = None):
        if self._aot:
            p = self._parts
            tensors = p.stage(batch)
            found = self._aot.get(_signature(tensors, acc is not None, p.phase(state)))
            if found is not None and found[1] == _addresses(state):
                graph = found[0]
                graph.load(tensors, acc)
                p.prepare(state)
                graph.graph.replay()
                p.finish(state)
                if acc is None:
                    return state, graph.outputs
                return state, graph.outputs, graph.static_acc
            self.eager_calls += 1
            batch = tensors
        state, metrics = self._eager(state, batch)
        if acc is None:
            return state, metrics
        return state, metrics, accumulate_metrics(acc, metrics)

    def aot_compile(self, state, batch, acc: Optional[torch.Tensor] = None, *,
                    count_flops: bool = False) -> Tuple[Captured, float]:
        """Capture the step ahead of time against ``batch``'s signature
        (``acc`` non-None: the accumulating variant, the one ``fit``
        runs); returns ``(captured, seconds)``, kernel builds included.

        Warm-up steps run eager first (:func:`_warmup_iters`: every
        phase, on the capture stream on the card, so that lazy state such
        as the kernels' plans, libraries and counter buffers exists on
        that stream before capture); with ``count_flops`` (the warm-up's
        report, JAX's cost analysis) the FLOP counter watches the second
        on the card (the first on the CPU) unless an earlier one launched
        a hand-written kernel, which the counter cannot see (its first use
        in a process costs seconds); then one graph is captured for each phase of the optimizer,
        all in one memory pool, with the step's generators registered.
        The state comes back as it was: warming up trains nothing. On the
        CPU there is no graph: the warm-up step runs alone. On the card a
        failed capture raises."""
        from torch.utils.flop_counter import FlopCounterMode

        p = self._parts
        t0 = time.perf_counter()
        tensors = p.stage(batch)
        on_card = tensors[0].device.type == "cuda"
        iters = _warmup_iters(p.phases) if on_card else 1
        scratch = torch.zeros_like(acc) if acc is not None else None
        stream, ctx = (_capture_stream(p.device) if on_card
                       else (None, contextlib.nullcontext()))
        counted_step = 1 if on_card else 0
        flops, kernels_ran = None, False
        with _preserved(state, p.model):
            with ctx:
                for i in range(iters):
                    counter = (FlopCounterMode(display=False)
                               if count_flops and i == counted_step and not kernels_ran
                               else None)
                    k0 = kernel_launches()
                    with counter or contextlib.nullcontext():
                        _, metrics = self._eager(state, tensors)
                        if scratch is not None:
                            accumulate_metrics(scratch, metrics)
                    kernels_ran = kernels_ran or kernel_launches() > k0
                    if counter is not None and not kernels_ran:
                        flops = float(counter.get_total_flops()) or None
                if on_card:
                    torch.cuda.synchronize(p.device)
            warmup_sec = time.perf_counter() - t0
            if on_card:
                torch.cuda.current_stream(p.device).wait_stream(stream)
                try:
                    self._capture(state, tensors, acc, stream)
                except BaseException:
                    self.discard()  # no half-captured set of graphs stays installed
                    raise
        if on_card:
            torch.cuda.synchronize(p.device)
        return (Captured(graphs=self.graphs, flops=flops, warmup_sec=warmup_sec),
                time.perf_counter() - t0)

    def _capture(self, state, tensors, acc, stream) -> None:
        p = self._parts
        static_in = tuple(t.clone() for t in tensors)
        static_acc = torch.zeros_like(acc) if acc is not None else None
        pool = torch.cuda.graph_pool_handle()
        addresses = _addresses(state)
        for _ in range(p.phases):
            phase = p.phase(state)
            token = p.prepare(state)  # host part, outside the capture
            graph = torch.cuda.CUDAGraph()
            for gen in p.generators:
                graph.register_generator_state(gen)
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                outputs = p.run(state, static_in, token)
                if static_acc is not None:
                    accumulate_metrics(static_acc, outputs)
            self._aot[_signature(static_in, acc is not None, phase)] = (
                _Graph(graph, static_in, static_acc, outputs), addresses)


class EvalStepFn:
    """The eval step (``train_step.make_eval_step``): ``step(state,
    batch) -> {loss, top1, top5, count}``, with the same ahead-of-time
    slot as :class:`StepFn` (no accumulator, no phases; the outputs of a
    replay are the graph's static ones)."""

    def __init__(self, run: Callable, stage: Callable, device: torch.device, model):
        self._run, self._stage, self._device, self._model = run, stage, device, model
        self._aot: Dict[tuple, _Graph] = {}
        self.eager_calls = 0

    @property
    def graphs(self) -> int:
        return len(self._aot)

    def __call__(self, state, batch) -> Dict[str, torch.Tensor]:
        tensors = self._stage(batch)
        if self._aot:
            graph = self._aot.get(_signature(tensors))
            if graph is not None:
                graph.load(tensors)
                self._model.eval()
                graph.graph.replay()
                return graph.outputs
            self.eager_calls += 1
        return self._run(state, tensors)

    def aot_compile(self, state, batch) -> Tuple[Captured, float]:
        """Capture the eval step against ``batch``'s signature after
        warm-up steps on the capture stream; ``(captured, seconds)``.
        The CPU runs the warm-up step only."""
        t0 = time.perf_counter()
        tensors = self._stage(batch)
        on_card = tensors[0].device.type == "cuda"
        if not on_card:
            self._run(state, tensors)
            secs = time.perf_counter() - t0
            return Captured(graphs=0, flops=None, warmup_sec=secs), secs
        stream, ctx = _capture_stream(self._device)
        with ctx:
            for _ in range(_warmup_iters(1)):
                self._run(state, tensors)
            torch.cuda.synchronize(self._device)
        warmup_sec = time.perf_counter() - t0
        torch.cuda.current_stream(self._device).wait_stream(stream)
        static_in = tuple(t.clone() for t in tensors)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            outputs = self._run(state, static_in)
        self._aot[_signature(static_in)] = _Graph(graph, static_in, None, outputs)
        torch.cuda.synchronize(self._device)
        return (Captured(graphs=self.graphs, flops=None, warmup_sec=warmup_sec),
                time.perf_counter() - t0)
