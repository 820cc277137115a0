"""The port's spans (utils/profiling) on the CPU: the span tree of a detect
call and of the train steps at tiny shapes, the stage marks they fire, the
path with recording off against on, the spans as ranges of a
torch.profiler trace, the runtime-call counters on made-up profile events,
and the benchmark's readers of the detect stages on made-up spans."""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from faster_rcnn_tpu_torch import inference as tinf
from faster_rcnn_tpu_torch.models.detector import init_model
from faster_rcnn_tpu_torch.parallel import freeze as tfreeze
from faster_rcnn_tpu_torch.train import pipeline as tpipe
from faster_rcnn_tpu_torch.utils import profiling
from portbench import harness
from tests.test_torch_models import port_config
from tests.test_train_step import tiny_batch, tiny_config

DETECT = ["ingest", "backbone", "rpn_proposals", "roi_align_head", "decode"]
# the stage marks each step fired before it had spans, in this order
STEPS = {
    "joint": ("frcnn.train.joint", ["frozen_prefix", "backbone_rpn", "rpn_targets_losses",
                                    "proposals", "det_targets", "roi_align_head", "backward",
                                    "optimizer"]),
    "rpn": ("frcnn.train.rpn", ["frozen_prefix", "backbone_rpn", "rpn_targets_losses",
                                "backward", "optimizer"]),
    "det": ("frcnn.train.det", ["rpn_proposals", "det_targets", "frozen_prefix", "backbone",
                                "roi_align_head", "backward", "optimizer"]),
    "det_heads_only": ("frcnn.train.det", ["rpn_proposals", "det_targets", "roi_align_head",
                                           "backward", "optimizer"]),
}


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(1)
    jcfg = tiny_config("resnet50")
    tc = port_config(jcfg)
    tc = tc.replace(model=dataclasses.replace(tc.model, compute_dtype="float32"))
    batch = {k: np.array(v) for k, v in tiny_batch(jcfg, b=2, seed=3).items()}
    batch["image"] = np.random.RandomState(3).randint(0, 256, batch["image"].shape,
                                                      ).astype(np.uint8)
    return tc, batch


def _detect(tc):
    return tinf.make_detect_fn(tc, init_model(0, tc, "cpu"), device="cpu")


def _step(tc, kind):
    model = init_model(0, tc, "cpu")
    opt = tfreeze.make_optimizer(model, "resnet50", tc.model.freeze_blocks, 1e-3)
    if kind == "joint":
        return tpipe.make_joint_train_step(tc, model, opt, device="cpu")
    if kind == "rpn":
        return tpipe.make_rpn_train_step(tc, model, opt, device="cpu")
    return tpipe.make_det_train_step(tc, model, opt, init_model(1, tc, "cpu"),
                                     heads_only=kind == "det_heads_only", device="cpu")


def _tree(spans):
    """[(name, parent's name)] of spans in the order they opened."""
    by_id = {s.id: s.name for s in spans}
    return [(s.name, by_id.get(s.parent)) for s in spans]


def test_detect_span_tree(tiny):
    tc, batch = tiny
    detect = _detect(tc)
    with profiling.recording() as rec:
        for _ in range(2):
            detect(batch["image"], batch["img_hw"])
    calls = rec.calls()
    assert len(calls) == 2 and calls[0][0].call != calls[1][0].call
    for call in calls:
        root = call[0]
        assert root.parent is None and root.call == root.id
        assert {s.call for s in call} == {root.id}
        assert _tree(call) == [("frcnn.detect", None)] + [(n, "frcnn.detect") for n in DETECT]
        assert all(s.device_ms is None and s.events is None for s in call)  # no CUDA
        assert all(root.host_start_ns <= s.host_start_ns <= s.host_end_ns <= root.host_end_ns
                   for s in call)


@pytest.mark.parametrize("kind", ["joint", "det"])
def test_step_span_tree(tiny, kind):
    tc, batch = tiny
    root, stages = STEPS[kind]
    step = _step(tc, kind)
    with profiling.recording() as rec:
        step(batch, torch.Generator().manual_seed(0))
    (call,) = rec.calls()
    assert _tree(call) == [(root, None)] + [(n, root) for n in stages]
    assert len({s.id for s in call}) == len(call)


@pytest.mark.parametrize("kind", list(STEPS))
def test_steps_fire_todays_marks(tiny, kind):
    tc, batch = tiny
    marks = []
    _step(tc, kind)(batch, torch.Generator().manual_seed(0), marks.append)
    assert marks == STEPS[kind][1]


def test_detect_fires_its_five_marks(tiny):
    tc, batch = tiny
    marks = []
    _detect(tc)(batch["image"], batch["img_hw"], marks.append)
    assert marks == DETECT


def test_recording_off_enters_nothing_and_changes_nothing(tiny, monkeypatch):
    """Off, a span opens no profiler range, makes no CUDA event and keeps no
    span; the detections are bit for bit those of a recorded call."""
    tc, batch = tiny
    detect = _detect(tc)
    ranges, events = [], []
    real_range, real_event = profiling._range, torch.cuda.Event
    monkeypatch.setattr(profiling, "_range", lambda n: ranges.append(n) or real_range(n))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: events.append(1) or
                        real_event(*a, **k))
    kept = len(profiling.PROFILED.spans)
    off = detect(batch["image"], batch["img_hw"])
    assert ranges == [] and events == [] and len(profiling.PROFILED.spans) == kept
    with profiling.recording() as rec:
        on = detect(batch["image"], batch["img_hw"])
    assert ranges == ["frcnn.detect"] + DETECT and len(rec.spans) == 6
    assert events == []  # the call ran on the CPU
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_scope_off_is_a_flag_test():
    assert not profiling._open
    assert profiling.scope("a") is profiling.scope("b")
    marks = []
    with profiling.scope("stage", marks.append):
        pass
    with pytest.raises(KeyError):
        with profiling.scope("failed", marks.append):
            raise KeyError
    assert marks == ["stage"]  # a stage that raised is not marked


def test_spans_are_ranges_of_a_profile(tiny):
    """Under a torch.profiler trace with no recording open, a detect call's
    spans are ranges of the profile, nested as the spans, with the
    backbone's convolutions inside ``backbone``; the spans are kept in
    ``PROFILED``."""
    tc, batch = tiny
    detect = _detect(tc)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        detect(batch["image"], batch["img_hw"])
    events = list(prof.profiler.kineto_results.events())
    rng = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
           if e.name() in ["frcnn.detect"] + DETECT}
    assert set(rng) == {"frcnn.detect", *DETECT}
    lo, hi = rng["frcnn.detect"]
    assert all(lo <= a <= b <= hi for a, b in rng.values())
    starts = [rng[n][0] for n in DETECT]
    assert starts == sorted(starts)
    convs = [e.start_ns() for e in events if e.name() == "aten::convolution"]
    b0, b1 = rng["backbone"]
    assert convs and any(b0 <= s < b1 for s in convs)
    assert all(rng["ingest"][1] <= s for s in convs)
    (call,) = profiling.PROFILED.calls()[-1:]
    assert _tree(call) == [("frcnn.detect", None)] + [(n, "frcnn.detect") for n in DETECT]


def test_format_spans_nests_and_prefers_device_time():
    spans = [profiling.Span("step", 1, None, 1, 0, 5_000_000),
             profiling.Span("a", 2, 1, 1, 0, 2_000_000, device_ms=1.25),
             profiling.Span("b", 3, 2, 1, 0, 1_000_000),
             profiling.Span("other", 4, None, 4, 0, 3_000_000)]
    assert profiling.format_spans(spans) == (
        "step: 5.00 ms\n  a: 1.25 ms\n    b: 1.00 ms\nother: 3.00 ms\n")


class _Ev:
    """A made-up CUDA event at device time ``t`` ms."""

    def __init__(self, t):
        self.t, self.waited = t, False

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, end):
        return end.t - self.t


def test_resolve_reads_closed_spans_and_reuses_their_events(monkeypatch):
    monkeypatch.setattr(profiling, "_free_events", [])
    a, b = _Ev(1.0), _Ev(3.5)
    rec = profiling.Recording()
    rec.spans.append(profiling.Span("closed", 1, None, 1, 0, 10, events=(a, b)))
    rec.spans.append(profiling.Span("open", 2, None, 2, 5, 0, events=(_Ev(0), _Ev(0))))
    closed, still_open = rec.resolve().spans
    assert closed.device_ms == 2.5 and closed.events is None and b.waited
    assert still_open.device_ms is None and still_open.events is not None
    assert {profiling._event(), profiling._event()} == {a, b}


# ---------------------------------------------------------------------------
# the runtime calls of a profile, on made-up events
# ---------------------------------------------------------------------------

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, dev, start, dur, corr=0):
        self._n, self._d, self._s, self._u, self._c = name, dev, start, dur, corr

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def correlation_id(self):
        return self._c


def _made_up():
    """Two calls of ``frcnn.detect`` [0, 1000) and [2000, 3000), each with
    ``backbone`` over its first half and ``decode`` over its second; the
    first call launches three kernels (correlation 1-3), copies pageable
    frames in, waits 300 ns in a stream sync inside ``aten::to`` and 50 in a
    synchronous cudaMemcpy; the second launches one kernel and waits 100 ns
    in a device sync; a readback (correlation 9) runs between the calls.
    The device's timeline also holds a range mirrored from a user
    annotation, which no runtime call launched."""
    spans = [profiling.Span("frcnn.detect", 1, None, 1), profiling.Span("backbone", 2, 1, 1),
             profiling.Span("decode", 3, 1, 1, device_ms=0.5),
             profiling.Span("frcnn.detect", 4, None, 4), profiling.Span("backbone", 5, 4, 4),
             profiling.Span("decode", 6, 4, 4)]
    ev = [Event("frcnn.detect", CPU, 0, 1000), Event("backbone", CPU, 0, 500),
          Event("decode", CPU, 500, 500),
          Event("cudaLaunchKernel", CPU, 10, 5, 1), Event("cuLaunchKernelEx", CPU, 20, 5, 2),
          Event("cudaMemcpyAsync", CPU, 100, 50, 4),
          Event("aten::to", CPU, 90, 400), Event("aten::copy_", CPU, 95, 390),
          Event("cudaStreamSynchronize", CPU, 160, 300, 5),
          Event("cudaLaunchKernelExC_v11060", CPU, 600, 5, 3),
          Event("cudaMemcpy", CPU, 700, 50, 6),
          Event("cudaMemcpyAsync", CPU, 1500, 20, 9),
          Event("frcnn.detect", CPU, 2000, 1000), Event("backbone", CPU, 2000, 500),
          Event("decode", CPU, 2500, 500),
          Event("cudaLaunchKernel", CPU, 2010, 5, 10),
          Event("cudaDeviceSynchronize", CPU, 2600, 100, 11),
          Event("k1", CUDA, 30, 200, 1), Event("k2", CUDA, 230, 100, 2),
          Event("Memcpy HtoD (Pageable -> Device)", CUDA, 160, 40, 4),
          Event("k3", CUDA, 610, 60, 3), Event("Memcpy DtoH", CUDA, 1520, 100, 9),
          Event("k4", CUDA, 2020, 500, 10),
          Event("frcnn.detect", CUDA, 30, 2500, 0)]  # the profiler's mirror of a range
    return ev, spans


def test_runtime_calls_count_syncs_waits_and_launches():
    ev, spans = _made_up()
    got = profiling.runtime_calls(ev, spans)
    first, second = got["calls"]
    assert (first["name"], first["start_ns"], first["end_ns"]) == ("frcnn.detect", 0, 1000)
    assert first["syncs"] == 2 and first["sync_wait_ms"] == pytest.approx(350e-6)
    assert first["launches"] == 3
    assert first["sync_sites"] == [
        {"call": "cudaStreamSynchronize", "span": "backbone", "op": "aten::copy_",
         "wait_ms": pytest.approx(300e-6)},
        {"call": "cudaMemcpy", "span": "decode", "op": None, "wait_ms": pytest.approx(50e-6)}]
    assert first["device_ms"] == pytest.approx(400e-6)
    assert [r["correlation"] for r in first["runtime"]] == [1, 2, 4, 5, 3, 6]
    assert second["syncs"] == 1 and second["launches"] == 1
    assert second["sync_sites"][0]["span"] == "decode"
    assert second["sync_wait_ms"] == pytest.approx(100e-6)
    assert [(s["name"], s["start_ns"], s["end_ns"], s["device_ms"])
            for s in first["spans"]] == [("frcnn.detect", 0, 1000, None),
                                         ("backbone", 0, 500, None), ("decode", 500, 1000, 0.5)]
    assert got["outside_ms"] == pytest.approx(100e-6)
    assert got["device_ms"] == pytest.approx(1000e-6)


def test_runtime_calls_without_a_device():
    ev, spans = _made_up()
    ev = [e for e in ev if e.device_type() == CPU and not e.name().startswith("cu")]
    got = profiling.runtime_calls(ev, spans)
    assert [(c["syncs"], c["launches"], c["device_ms"]) for c in got["calls"]] == [(0, 0, 0)] * 2
    assert got["device_ms"] == 0 and got["outside_ms"] == 0


@pytest.mark.parametrize("name,sync,launch", [
    ("cudaStreamSynchronize", True, False), ("cudaMemcpy", True, False),
    ("cudaMemcpyAsync", False, False), ("cudaEventSynchronize_v3020", True, False),
    ("cudaLaunchKernel", False, True), ("cuLaunchKernel", False, True),
    ("cudaGraphLaunch", False, True), ("cudaEventRecord", False, False)])
def test_runtime_call_kinds(name, sync, launch):
    assert profiling.is_sync(name) == sync and profiling.is_launch(name) == launch


# ---------------------------------------------------------------------------
# the benchmark's readers of the detect stages
# ---------------------------------------------------------------------------


def _recorded(device_ms):
    """A recording of one warm-up call and two traced calls of
    ``frcnn.detect``, each of the five stages at ``device_ms`` + its call's
    index."""
    rec = profiling.Recording()
    sid = 100
    for i in range(3):
        root = sid
        rec.spans.append(profiling.Span("frcnn.detect", root, None, root, device_ms=50.0))
        for name in DETECT:
            sid += 1
            ms = None if device_ms is None else device_ms + i
            rec.spans.append(profiling.Span(name, sid, root, root, device_ms=ms))
        sid += 1
    return rec


@pytest.mark.parametrize("stage", DETECT)
def test_stage_readers_mean_the_traced_calls(stage, monkeypatch):
    monkeypatch.setattr(profiling, "PROFILED", _recorded(2.0))
    t = {"traced_steps": 2}
    assert harness.reader(f"{stage}_ms.detect").read(t) == pytest.approx(3.5)


def test_stage_readers_read_none_without_device_or_spans(monkeypatch):
    read = harness.reader("backbone_ms.detect").read
    monkeypatch.setattr(profiling, "PROFILED", _recorded(None))
    assert read({"traced_steps": 2}) is None  # a CPU run: no device time
    monkeypatch.setattr(profiling, "PROFILED", _recorded(2.0))
    assert read({"traced_steps": 4}) is None  # fewer calls recorded than traced
    monkeypatch.delattr(profiling, "PROFILED")
    assert read({"traced_steps": 2}) is None  # a port without spans


def test_spans_nest_per_thread_under_one_recording():
    """A span opened in another thread while one is open here is the
    outermost span of its own call."""
    def other():
        with profiling.scope("other"):
            with profiling.scope("inner"):
                pass

    with profiling.recording() as rec:
        with profiling.scope("main"):
            t = threading.Thread(target=other)
            t.start()
            t.join()
    main, inner_thread = rec.calls("main"), rec.calls("other")
    assert [s.name for s in main[0]] == ["main"]
    assert _tree(inner_thread[0]) == [("other", None), ("inner", "other")]


def test_spans_of_many_threads_keep_their_own_calls():
    """Threads more than cores, switching often, open nested spans under
    one recording: every call holds its own outer and inner span, once."""
    n_threads, n_calls = 16, 200

    def work(k):
        for _ in range(n_calls):
            with profiling.scope(f"outer{k}"):
                with profiling.scope(f"inner{k}"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    calls = rec.calls()
    assert len(calls) == n_threads * n_calls and len(rec.spans) == 2 * len(calls)
    for outer, inner in calls:
        k = outer.name[len("outer"):]
        assert inner.name == f"inner{k}" and inner.parent == outer.id == inner.call
