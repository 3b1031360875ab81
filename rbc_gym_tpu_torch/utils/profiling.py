"""Tracing and profiling hooks on the port.

Twin of ``rbc_gym_tpu.utils.profiling``:

  * :func:`trace` -- context manager around ``torch.profiler`` (CPU and, on a
    CUDA machine, CUDA activity) that writes a Chrome trace of the block
    into ``logdir``; view it in Perfetto or ``chrome://tracing``.
  * :class:`annotate` -- named region: a ``record_function`` range in the
    trace, and an NVTX range on CUDA.
  * :class:`StepTimer` -- synchronising wall-clock timer for env or train
    steps with summary percentiles.
  * :func:`device_memory_stats` -- live device memory per CUDA device.
  * :func:`kernel_time_split` and :func:`trace_events` -- device time by
    kernel name, and the device's idle share, from a written trace.
  * :func:`device_ms` -- CUDA-event time of a call on the card (host clock
    for CPU tensors, which the caller labels as such).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import time
from typing import Any, Dict, List, Optional

import torch


class annotate(contextlib.ContextDecorator):
    """Named trace region: ``with annotate("env_step"): ...``."""

    def __init__(self, name: str):
        self.name = name
        self._stack: Optional[contextlib.ExitStack] = None

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(torch.profiler.record_function(self.name))
        if torch.cuda.is_available():
            self._stack.enter_context(torch.cuda.nvtx.range(self.name))
        return self

    def __exit__(self, exc_type, exc, tb):
        self._stack.close()
        return False

    def _recreate_cm(self):
        # a fresh region for each call of a decorated function, so that
        # nested or recursive calls do not share one exit stack
        return annotate(self.name)


def _sync() -> None:
    """Wait until every CUDA device has finished its queued work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


@dataclasses.dataclass
class Trace:
    """What :func:`trace` yields: the running profiler, and after the block
    the path of the Chrome trace it wrote."""

    profiler: Any
    path: Optional[str] = None


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block with ``torch.profiler`` and write its
    Chrome trace into ``logdir`` (``trace.<pid>.<ns>.json``).

    Synchronises before starting and before stopping, so that queued device
    work neither leaks into the trace nor out of it."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _sync()
    prof = profile(activities=activities)
    out = Trace(profiler=prof)
    prof.start()
    try:
        yield out
        _sync()
    finally:
        prof.stop()
        out.path = os.path.join(logdir, f"trace.{os.getpid()}.{time.time_ns()}.json")
        prof.export_chrome_trace(out.path)


def trace_events(path: str) -> List[dict]:
    """The events of a Chrome trace written by :func:`trace`."""
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def kernel_time_split(events: list, top: int = 12) -> dict:
    """Device time by kernel name from a Chrome trace's events (``cat``
    "kernel", ``ts`` and ``dur`` in us): the ``top`` largest names, the
    busy sum and the device's idle share of the span from the first
    kernel's start to the last one's end."""
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        return {"not_measured": "the profiler recorded no kernel"}
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (t + e["dur"], n + 1)
    busy = sum(e["dur"] for e in kernels)
    span = max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "idle_share": 1.0 - busy / span if span > 0 else 0.0,
            "kernels": [{"name": name[:120], "ms": t / 1e3, "count": n}
                        for name, (t, n) in ranked]}


def _cuda_devices(value: Any) -> set:
    """The CUDA devices of the tensors in ``value`` (nested tuples, lists,
    dicts and NamedTuples)."""
    if isinstance(value, torch.Tensor):
        return {value.device} if value.device.type == "cuda" else set()
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        return set().union(*map(_cuda_devices, value)) if value else set()
    return set()


class StepTimer:
    """Wall-clock step timer with device synchronisation.

    >>> timer = StepTimer()
    >>> for _ in range(100):
    ...     with timer:
    ...         state, ts = env.step(state, actions)
    ...         timer.sink(ts.reward)   # wait for a result before stopping
    >>> timer.summary()["p50_ms"]

    ``sink`` is optional but recommended: CUDA work is queued
    asynchronously, so timing without waiting on an output measures only
    the host's enqueue. The timer synchronises the devices of the sunk
    tensors."""

    def __init__(self, skip_first: int = 1):
        self.times: List[float] = []
        self._skip = skip_first  # discard warm-up iterations
        self._t0: Optional[float] = None
        self._sunk = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def sink(self, value: Any):
        self._sunk = value

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            if self._sunk is not None:
                for d in _cuda_devices(self._sunk):
                    torch.cuda.synchronize(d)
                self._sunk = None
            dt = time.perf_counter() - self._t0
            if self._skip > 0:
                self._skip -= 1
            else:
                self.times.append(dt)
        return False

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)

        def pct(p):
            return ts[min(len(ts) - 1, int(p * len(ts)))]

        return {
            "n": len(ts),
            "mean_ms": 1e3 * statistics.fmean(ts),
            "p50_ms": 1e3 * pct(0.50),
            "p95_ms": 1e3 * pct(0.95),
            "max_ms": 1e3 * ts[-1],
            "steps_per_sec": 1.0 / statistics.fmean(ts),
        }


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Live device memory per CUDA device: ``bytes_in_use`` and
    ``peak_bytes_in_use`` from the caching allocator, ``bytes_limit`` the
    device's total memory. Without a CUDA device, one empty entry for the
    CPU, as the JAX package gives where a device has no stats."""
    if not torch.cuda.is_available():
        return {"cpu": {}}
    out: Dict[str, Dict[str, int]] = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[str(torch.device("cuda", i))] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
        }
    return out


def device_ms(fn, reps: int, device, warmup: int = 1) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls after ``warmup``: CUDA events
    on a CUDA ``device``, the host clock on the CPU."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - start) / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps
