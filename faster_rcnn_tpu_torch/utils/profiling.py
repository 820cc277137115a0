"""Spans: the port's layers, named and nested, and what a trace reads of them.

Counterpart of faster_rcnn_tpu/utils/profiling.py, the rebuild of the
reference's ``custom_decorators.profile`` (custom_decorators.py:8-33).
``scope(name)`` marks a layer of the program and :func:`profile` is its
decorator form. Spans nest per thread.

Recording is off by default. A span then costs one flag test: it opens no
profiler range, records no CUDA event, keeps nothing and prints nothing.
Recording is on inside :func:`recording` and while a ``torch.profiler``
trace runs. Each span then opens a profiler range of its name, so the trace
shows it on the clock of the device's kernels and copies, and an idle gap
of the device can be put down to the innermost span open at the time; and
it keeps a :class:`Span`: its
name, id, parent's id, the id of the call it belongs to (its outermost
span), the host clock at each edge and, in a call on a CUDA device, a CUDA
event at each edge. A span never synchronises the device: device times are
read when the recording closes (:meth:`Recording.resolve`). Spans recorded
under a profiler with no recording open go to :data:`PROFILED`, which keeps
the last few hundred calls'.

:func:`format_spans` prints recorded spans as the reference's indented
tree. :func:`runtime_calls` puts a profile's CUDA runtime calls in the
outermost span that made them: the host's waits on the device and the
kernel launches of each call. :func:`device_trace` writes a Chrome trace of
the CPU and the CUDA device with the spans in it, and the spans beside it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import json
import os
import re
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_state = threading.local()
_ids = itertools.count(1)
_open: List["Recording"] = []  # the recordings open, innermost last
# timing CUDA events whose spans were resolved, for reuse: a CUDA event
# costs some tens of us to destroy
_free_events: List[torch.cuda.Event] = []


@dataclasses.dataclass
class Span:
    """One recorded span. ``call`` is the id of the outermost span it sits
    in (its own for an outermost span); ``parent`` is None there.
    ``device_ms`` is None until the recording resolves it, and stays None
    in a call that ran on no CUDA device."""

    name: str
    id: int
    parent: Optional[int]
    call: int
    host_start_ns: int = 0
    host_end_ns: int = 0
    device_ms: Optional[float] = None
    device: Optional[torch.device] = None
    events: Optional[tuple] = None

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) / 1e6


class Recording:
    """The spans recorded while it was open, in the order they opened; the
    last ``keep`` of them where ``keep`` is given."""

    def __init__(self, keep: Optional[int] = None):
        self.spans = collections.deque(maxlen=keep)

    def resolve(self) -> "Recording":
        """Read the device time of every closed span whose CUDA events are
        still held (waiting for each end event), and drop the events."""
        for s in list(self.spans):
            if s.events is not None and s.host_end_ns:
                start, end = s.events
                end.synchronize()
                s.device_ms, s.events = start.elapsed_time(end), None
                _free_events.extend((start, end))
        return self

    def calls(self, name: Optional[str] = None) -> List[List[Span]]:
        """The spans of each call whose outermost span is kept (and named
        ``name``, where given), outermost first, in the order the calls
        began."""
        by_call: Dict[int, List[Span]] = {}
        for s in self.spans:
            by_call.setdefault(s.call, []).append(s)
        return [c for c in by_call.values()
                if c[0].parent is None and (name is None or c[0].name == name)]


# spans recorded under a torch.profiler trace with no recording open
PROFILED = Recording(keep=4096)

# A span's range in a profile: an operator's range (the profile's category
# ``cpu_op``), not a user annotation, which the profiler would mirror on the
# device's timeline as a range over all the span's kernels and the gaps
# between them.
_range = torch._C._profiler._RecordFunctionFast


def _event() -> torch.cuda.Event:
    try:
        return _free_events.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def _stack() -> list:
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    return stack


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Mark:
    """An unrecorded span that calls ``mark(name)`` as it ends."""

    __slots__ = ("name", "mark")

    def __init__(self, name: str, mark: Callable[[str], None]):
        self.name, self.mark = name, mark

    def __enter__(self):
        return None

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.mark(self.name)
        return False


class _Recorded:
    __slots__ = ("name", "mark", "device", "span", "rf")

    def __init__(self, name, mark, device):
        self.name, self.mark, self.device = name, mark, device

    def __enter__(self):
        stack = _stack()
        up = stack[-1].span if stack else None
        device = torch.device(self.device) if self.device is not None else (
            up.device if up else None)
        sid = next(_ids)
        span = self.span = Span(self.name, sid, up.id if up else None, up.call if up else sid,
                                device=device)
        self.rf = _range(self.name)
        self.rf.__enter__()
        if span.device is not None and span.device.type == "cuda":
            span.events = (_event(), _event())
            span.events[0].record(torch.cuda.current_stream(span.device))
        (_open[-1] if _open else PROFILED).spans.append(span)
        stack.append(self)
        span.host_start_ns = time.perf_counter_ns()
        return span

    def __exit__(self, exc_type, *exc):
        span = self.span
        span.host_end_ns = time.perf_counter_ns()
        if span.events is not None:
            span.events[1].record(torch.cuda.current_stream(span.device))
        _stack().pop()
        self.rf.__exit__(None, None, None)
        if exc_type is None and self.mark is not None:
            self.mark(self.name)
        return False


def scope(name: str, mark: Optional[Callable[[str], None]] = None, device=None):
    """A span named ``name``: ``with scope(name): ...``. ``mark``, where
    given, is called with ``name`` as the span ends (a stage boundary),
    whether or not recording is on. ``device`` is the device the call's
    work runs on, given at the outermost span; inner spans take their
    parent's."""
    if not (_open or _autograd_profiler._is_profiler_enabled):
        return _NULL if mark is None else _Mark(name, mark)
    return _Recorded(name, mark, device)


def profile(fn: Optional[Callable] = None):
    """Decorator form of :func:`scope`, named by the function's qualified
    name (reference: @profile)."""

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            with scope(f.__qualname__):
                return f(*args, **kwargs)

        return wrapper

    return deco(fn) if fn is not None else deco


@contextlib.contextmanager
def recording():
    """Record every span opened while this is open, in any thread; yields
    the :class:`Recording`, resolved as it closes."""
    rec = Recording()
    _open.append(rec)
    try:
        yield rec
    finally:
        _open.remove(rec)
        rec.resolve()


def format_spans(spans: Iterable[Span]) -> str:
    """The indented tree of recorded spans, a call after another in the
    order they began: ``name: <ms> ms`` a line, the device time where the
    span has one, else the host time."""
    spans = list(spans)
    order = {c: i for i, c in enumerate(dict.fromkeys(s.call for s in spans))}
    depth: Dict[int, int] = {}
    lines = []
    for s in sorted(spans, key=lambda s: order[s.call]):
        d = depth[s.id] = depth.get(s.parent, -1) + 1
        ms = s.device_ms if s.device_ms is not None else s.host_ms
        lines.append(f"{'  ' * d}{s.name}: {ms:.2f} ms\n")
    return "".join(lines)


# ---------------------------------------------------------------------------
# the CUDA runtime calls of a profile, by call
# ---------------------------------------------------------------------------

# runtime calls in which the host waits for the device: the stream and
# device syncs that PyTorch's blocking copies and reads end in, and the
# synchronous memcpy
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
_VERSION = re.compile(r"_v\d+$")


def _runtime_name(name: str) -> str:
    return _VERSION.sub("", name)


def is_sync(name: str) -> bool:
    return _runtime_name(name) in SYNC_CALLS


def is_launch(name: str) -> bool:
    n = _runtime_name(name)
    return n.startswith(("cudaLaunch", "cuLaunch")) or n in ("cudaGraphLaunch", "cuGraphLaunch")


def _is_runtime(name: str) -> bool:
    return name.startswith(("cuda", "cu")) and not name.startswith("cudnn")


def runtime_calls(events, spans: Iterable[Span]) -> dict:
    """Each recorded call's CUDA runtime calls, from a profile's events
    (``prof.profiler.kineto_results.events()``) and the spans recorded
    while it ran. A call is the range of an outermost span in the profile;
    a runtime call is its if it started inside that range.

    ``calls`` holds each call, in order: ``name``, ``start_ns`` and
    ``end_ns`` on the profile's clock; ``spans``: each of its spans with
    its ids, its range on the profile's clock and its ``device_ms``;
    ``runtime``: each runtime call's ``name``, ``start_ns``, ``end_ns`` and
    ``correlation``; ``syncs`` and ``sync_wait_ms``, the count of the
    calls in which the host waited on the device (:data:`SYNC_CALLS`) and
    the host ms spent in them; ``sync_sites``, each such call with its
    innermost span and the innermost aten operation around it;
    ``launches``, the kernel launches; and ``device_ms``, the device time
    of the work it launched. ``device_ms`` is the whole trace's device
    time and ``outside_ms`` the part of it launched outside every call."""
    spans = list(spans)
    names = {s.name for s in spans}
    cuda = torch.autograd.DeviceType.CUDA
    host, device = [], []
    for e in events:
        (device if e.device_type() == cuda else host).append(e)
    ranges: Dict[str, list] = {}
    for e in sorted(host, key=lambda e: e.start_ns()):
        if e.name() in names:
            ranges.setdefault(e.name(), []).append(e)
    # the k-th range of a name in the profile is the k-th span of that name
    seen: Dict[str, int] = {}
    placed = []
    for s in spans:
        k = seen.get(s.name, 0)
        seen[s.name] = k + 1
        got = ranges.get(s.name, [])
        if k < len(got):
            e = got[k]
            placed.append((s, e.start_ns(), e.start_ns() + e.duration_ns()))
    runtime = sorted((e for e in host if _is_runtime(e.name())), key=lambda e: e.start_ns())
    aten = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in host
            if e.name().startswith("aten::")]
    # the device's work by the runtime call that launched it; a range the
    # profiler mirrors from a user annotation has no such call and is left out
    launched = {e.correlation_id() for e in runtime}
    dev_by_corr: Dict[int, float] = collections.defaultdict(float)
    for e in device:
        if e.correlation_id() in launched:
            dev_by_corr[e.correlation_id()] += e.duration_ns() / 1e6
    calls, inside = [], set()
    for root, lo, hi in (p for p in placed if p[0].parent is None):
        mine = [p for p in placed if p[0].call == root.id]
        rt = [e for e in runtime if lo <= e.start_ns() < hi]
        sites, wait = [], 0.0
        for e in rt:
            if not is_sync(e.name()):
                continue
            s, t = e.start_ns(), e.start_ns() + e.duration_ns()
            wait += (t - s) / 1e6
            # the innermost span around it: of nested spans, the last opened
            span = max((i, p) for i, p in enumerate(mine) if p[1] <= s < p[2])[1][0]
            ops = [a for a in aten if a[0] <= s < a[1]]
            sites.append({"call": _runtime_name(e.name()), "span": span.name,
                          "op": max(ops)[2] if ops else None, "wait_ms": (t - s) / 1e6})
        inside.update(e.correlation_id() for e in rt)
        calls.append({
            "name": root.name, "call": root.id, "start_ns": lo, "end_ns": hi,
            "spans": [{"name": s.name, "id": s.id, "parent": s.parent, "start_ns": a,
                       "end_ns": b, "device_ms": s.device_ms} for s, a, b in mine],
            "runtime": [{"name": e.name(), "start_ns": e.start_ns(),
                         "end_ns": e.start_ns() + e.duration_ns(),
                         "correlation": e.correlation_id()} for e in rt],
            "syncs": len(sites), "sync_wait_ms": wait, "sync_sites": sites,
            "launches": sum(is_launch(e.name()) for e in rt),
            "device_ms": sum(dev_by_corr.get(e.correlation_id(), 0.0) for e in rt)})
    return {"calls": calls, "device_ms": sum(dev_by_corr.values()),
            "outside_ms": sum(v for c, v in dev_by_corr.items() if c not in inside)}


def _sync() -> None:
    """Wait for the current CUDA device's work; nothing when CUDA has not
    been initialised (the CPU)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the CPU and, where CUDA is available, the CUDA device with
    ``torch.profiler``, recording the program's spans. On exit the device's
    work is waited for, the trace written to ``logdir/trace_<pid>_<n>.json``
    (Chrome / Perfetto) with each span a range in it, and the calls'
    spans and runtime calls (:func:`runtime_calls`) beside it in
    ``logdir/spans_<pid>_<n>.json``. Yields the ``torch.profiler.profile``,
    whose events can also be read in the process."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with recording() as rec:
        with prof:
            yield prof
            _sync()
    n = len([f for f in os.listdir(logdir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))
    calls = runtime_calls(prof.profiler.kineto_results.events(), rec.spans)
    with open(os.path.join(logdir, f"spans_{os.getpid()}_{n}.json"), "w") as f:
        json.dump(calls, f)
