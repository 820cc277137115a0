"""What the readers of the port's own spans share: the spans the port
recorded while the traced calls ran under the profiler
(``faster_rcnn_tpu_torch.utils.profiling.PROFILED``), and the device time
between the CUDA events at each span's edges. A port that records no such
spans, or a run on no CUDA device, reads None."""

from __future__ import annotations


def traced_calls(t: dict, root: str) -> list:
    """The spans of each of the traced calls whose outermost span is
    ``root``: the last ``traced_steps`` such calls the port recorded under
    the profiler, or [] where it recorded fewer."""
    try:
        from faster_rcnn_tpu_torch.utils import profiling
    except ImportError:
        return []
    rec = getattr(profiling, "PROFILED", None)
    n = t.get("traced_steps") or 0
    if rec is None or not n:
        return []
    calls = rec.resolve().calls(root)
    return calls[-n:] if len(calls) >= n else []


def stage_ms(t: dict, root: str, stage: str):
    """Device ms of the stage ``stage`` (a span just inside ``root``), the
    mean over the traced calls; None where a call has no device time for
    it."""
    vals = []
    for call in traced_calls(t, root):
        ms = [s.device_ms for s in call if s.name == stage and s.parent == call[0].id]
        if len(ms) != 1 or ms[0] is None:
            return None
        vals.append(ms[0])
    return sum(vals) / len(vals) if vals else None
