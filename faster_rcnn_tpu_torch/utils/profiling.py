"""Profiling utilities.

Counterpart of faster_rcnn_tpu/utils/profiling.py, the rebuild of the
reference's ``custom_decorators.profile`` (custom_decorators.py:8-33): a
nested wall-clock scope tracker printing an indented call tree when the
outermost scope exits, in call order, per thread; ``StepTimer`` for
training loops; and ``device_trace``, a ``torch.profiler`` trace of the CPU
and the CUDA device written as a Chrome trace.

Host-side timers measure the time to *enqueue* CUDA work; ``block=True``
waits for the device before the scope's clock stops.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import Callable, List, Optional, Tuple

import torch

_state = threading.local()


def _frames() -> List[Tuple[int, str, float]]:
    if not hasattr(_state, "frames"):
        _state.frames = []
        _state.depth = 0
    return _state.frames


def _sync() -> None:
    """Wait for the current CUDA device's work; nothing when CUDA has not
    been initialised (the CPU)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def scope(name: str, block: bool = False):
    """Timed scope; prints the accumulated tree when the outermost exits."""
    frames = _frames()
    _state.depth += 1
    depth = _state.depth
    idx = len(frames)
    frames.append((depth, name, 0.0))
    start = time.perf_counter()
    try:
        yield
    finally:
        if block:
            _sync()
        elapsed = time.perf_counter() - start
        frames[idx] = (depth, name, elapsed)
        _state.depth -= 1
        if _state.depth == 0:
            for d, n, t in frames:
                print(f"{'  ' * (d - 1)}{n}: {t * 1000:.2f} ms")
            frames.clear()


def profile(fn: Optional[Callable] = None, *, block: bool = False):
    """Decorator form of :func:`scope` (reference: @profile)."""

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            with scope(f.__qualname__, block=block):
                return f(*args, **kwargs)

        return wrapper

    return deco(fn) if fn is not None else deco


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the CPU and, where CUDA is available, the CUDA device with
    ``torch.profiler``; on exit the device work is waited for and the trace
    written to ``logdir/trace_<pid>_<n>.json`` (Chrome / Perfetto). Yields
    the ``torch.profiler.profile``, whose events can also be read in the
    process."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield prof
        _sync()
    n = len([f for f in os.listdir(logdir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


class StepTimer:
    """Rolling images/sec + ms/step tracker for training loops."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def ms_per_step(self) -> float:
        return 1000.0 * sum(self._times) / max(len(self._times), 1)

    def img_per_sec(self, batch_size: int) -> float:
        if not self._times:
            return 0.0
        return batch_size * len(self._times) / sum(self._times)
