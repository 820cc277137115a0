"""The port's h5 export, annotate and gt_stats CLIs and its profiling
utilities against faster_rcnn_tpu's, on the CPU.

Both packages' CLIs run on the same tree, frames and weights: the port's
read a checkpoint the port wrote; on the JAX side the weights come in
through its ``_load_step_params`` and ``init_model``, which the test
replaces (a Flax init traces the whole model), as
tests/test_torch_trainer_jax.py does. The JAX package's files are
untouched.
"""

import argparse
import dataclasses
import io
import json
import os
import re
import shutil
import threading
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from PIL import Image as PilImage

from faster_rcnn_tpu.cli import annotate as jannotate
from faster_rcnn_tpu.cli import export_h5 as jexport
from faster_rcnn_tpu.cli import gt_stats as jgt_stats
from faster_rcnn_tpu.models.detector import FasterRCNN as JaxFasterRCNN
from faster_rcnn_tpu.utils import profiling as jprofiling
from faster_rcnn_tpu_torch.cli import annotate as tannotate
from faster_rcnn_tpu_torch.cli import export_h5 as texport
from faster_rcnn_tpu_torch.cli import gt_stats as tgt_stats
from faster_rcnn_tpu_torch.models.detector import init_model
from faster_rcnn_tpu_torch.utils import checkpoint as ckpt_lib
from faster_rcnn_tpu_torch.utils import profiling as tprofiling
from faster_rcnn_tpu_torch.utils.convert import from_flax_numpy
from tests.test_data import make_voc_tree
from tests.test_torch_keras_import import drawn_state, h5_contents
from tests.test_torch_models import port_config
from tests.test_torch_train import to_flax_numpy
from tests.test_torch_vgg_r101 import f32_config, redraw
from tests.test_train_step import tiny_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def workdir(tmp_path):
    path = tmp_path / "work"
    yield str(path)
    shutil.rmtree(path, ignore_errors=True)


def _save_port_checkpoint(workdir, step, state):
    ckpt_lib.save(os.path.join(workdir, f"step{step}"), 1, {"model": state, "count": 1})


def _stdout(fn, *args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


# ---------------------------------------------------------------------------
# gt_stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--obj_class", "dog"], ["--obj_class", "bird"],
                                   ["--resize_dims", "45,60"]])
def test_gt_stats_prints_what_jax_prints(tmp_path, flags):
    root = str(tmp_path / "VOC")
    make_voc_tree(root, [
        ("000001", 120, 90, [("dog", False, 21, 21, 61, 51), ("cat", False, 11, 11, 31, 91)]),
        ("000002", 120, 90, [("dog", False, 1, 1, 101, 41)]),
        ("000003", 90, 120, [("person", True, 5, 7, 80, 110), ("dog", False, 3, 4, 9, 30)]),
    ])
    argv = ["--voc_paths", root, "--img_set", "trainval", "--resize_dims", "90,120", *flags]
    _, want = _stdout(jgt_stats.main, argv)
    _, got = _stdout(tgt_stats.main, argv)
    assert got == want
    assert ("(no boxes)" in got) == (flags == ["--obj_class", "bird"])


# ---------------------------------------------------------------------------
# export_h5
# ---------------------------------------------------------------------------


def test_export_h5_matches_jax_dataset_by_dataset(tmp_path, workdir, monkeypatch):
    """A ResNet-50 step-4 checkpoint (every entry drawn, batch-norm
    statistics included) exported by both CLIs: the same layers, weight
    names and arrays."""
    tc = port_config(f32_config("resnet50"))
    state = drawn_state(tc, 3)
    vnp = to_flax_numpy(state)
    _save_port_checkpoint(workdir, 4, state)
    monkeypatch.setattr(jexport, "init_model", lambda key, cfg: (None, vnp))
    monkeypatch.setattr(jexport, "_load_step_params", lambda w, s, t: vnp["params"])
    argv = ["--voc_paths", "unused", "--network", "resnet50", "--workdir", workdir,
            "--from_step", "4"]
    jpath, tpath = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    _, jout = _stdout(jexport.main, argv + ["--out", jpath])
    written, tout = _stdout(texport.main, argv + ["--out", tpath, "--device", "cpu"])
    assert tout.replace(tpath, jpath) == jout
    layers, names, arrays = h5_contents(tpath)
    jlayers, jnames, jarrays = h5_contents(jpath)
    assert sorted(layers) == sorted(jlayers) == sorted(written)
    assert names == jnames and set(arrays) == set(jarrays)
    assert any("moving_variance" in k for k in arrays)
    for k, a in jarrays.items():
        assert arrays[k].dtype == a.dtype and np.array_equal(arrays[k], a), k
    os.remove(jpath)
    os.remove(tpath)


# ---------------------------------------------------------------------------
# annotate
# ---------------------------------------------------------------------------


def _frames(root, n=3):
    """n 60x96 frames with a red rectangle each (the JAX package's test's
    frames), two PNGs and a JPEG."""
    os.makedirs(root)
    rng = np.random.RandomState(0)
    for i in range(n):
        arr = (rng.rand(60, 96, 3) * 255).astype(np.uint8)
        arr[15:40, 20 + 20 * i:55 + 20 * i] = (210, 60, 50)
        PilImage.fromarray(arr).save(os.path.join(root, f"f{i}.{'jpg' if i == 2 else 'png'}"))
    return root


def test_annotate_matches_jax(tmp_path, workdir, monkeypatch):
    """VGG16 at tiny_config shapes in f32, the same weights in both (the
    port's seeded init, redrawn): the same summary of boxes drawn per
    frame and the same output pixels. Both CLIs get the f32 config; the JAX
    side's RoI align takes its plain einsum form (tiny_config's)."""
    cfg = tiny_config("vgg16")
    jcfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    tc = port_config(jcfg)
    vnp = redraw(to_flax_numpy(init_model(1, tc, "cpu").state_dict()), 1)
    _save_port_checkpoint(workdir, 4, from_flax_numpy(vnp))
    monkeypatch.setattr(jannotate, "init_model", lambda key, cfg: (JaxFasterRCNN(jcfg), vnp))
    monkeypatch.setattr(jannotate, "_load_step_params", lambda w, s, t: vnp["params"])
    monkeypatch.setattr(jannotate, "config_from_args", lambda args: jcfg)
    monkeypatch.setattr(tannotate, "config_from_args", lambda args: tc)
    frames = _frames(str(tmp_path / "frames"))
    argv = ["--voc_paths", "unused", "--network", "vgg16", "--input_dir", frames,
            "--workdir", workdir, "--from_step", "4", "--det_threshold", "0.02"]
    want = jannotate.main(argv + ["--output_dir", str(tmp_path / "jax")])
    got = tannotate.main(argv + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert [os.path.basename(p) for p, _ in got] == ["f0.png", "f1.png", "f2.jpg"]
    assert got == want
    assert sum(n for _, n in got) > 0
    for path, n in got:
        name = os.path.basename(path)
        with PilImage.open(tmp_path / "port" / name) as a, \
                PilImage.open(tmp_path / "jax" / name) as b:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
        if n:
            with PilImage.open(path) as orig, PilImage.open(tmp_path / "port" / name) as a:
                assert np.any(np.asarray(orig.convert("RGB")) != np.asarray(a)), name


def test_annotate_runs_on_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tannotate.main(["--voc_paths", "unused", "--input_dir", str(tmp_path),
                        "--output_dir", str(tmp_path / "out")])


@pytest.mark.parametrize("module", [tannotate, texport, tgt_stats])
def test_cli_flags_are_the_jax_clis_plus_device(module, monkeypatch):
    """Each CLI's parser has its JAX counterpart's options and defaults, and
    --device."""
    jmod = {tannotate: jannotate, texport: jexport, tgt_stats: jgt_stats}[module]

    def options(mod):
        seen = {}

        def capture(parser, argv=None, namespace=None):
            seen.update({a.dest: a.default for a in parser._actions})
            raise SystemExit(0)

        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(SystemExit):
            mod.main([])
        monkeypatch.undo()
        return seen

    want, got = options(jmod), options(module)
    assert got.pop("device") == "cuda"
    assert got == want


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def _tree(pkg, **block):
    """Nested scopes and decorated functions; ``block`` as the JAX package's
    scopes take it."""
    @pkg.profile
    def leaf():
        return 3

    @pkg.profile(**block)
    def blocked():
        return 4

    with pkg.scope("outer"):
        with pkg.scope("first"):
            assert leaf() == 3
        with pkg.scope("second", **block):
            with pkg.scope("inner"):
                pass
        assert blocked() == 4
    with pkg.scope("alone"):
        pass


def _untimed(text):
    return re.sub(r"\d+\.\d\d ms", "T ms", text)


def test_profiling_tree_is_jax_s():
    """The port's spans, recorded and formatted, are the tree the JAX
    package prints as its outermost scopes exit."""
    _, want = _stdout(lambda: _tree(jprofiling, block=True))
    with tprofiling.recording() as rec:
        _, printed = _stdout(_tree, tprofiling)
    assert printed == ""
    got = _untimed(tprofiling.format_spans(rec.spans))
    assert got == _untimed(want)
    assert got.splitlines() == [
        "outer: T ms", "  first: T ms", "    _tree.<locals>.leaf: T ms", "  second: T ms",
        "    inner: T ms", "  _tree.<locals>.blocked: T ms", "alone: T ms"]
    assert not torch.cuda.is_initialized()


def test_profiling_scopes_are_per_thread():
    """A scope opened in another thread while one is open here is the
    outermost span of its own call, formatted as its own tree."""
    def other():
        with tprofiling.scope("other"):
            pass

    with tprofiling.recording() as rec:
        with tprofiling.scope("main"):
            t = threading.Thread(target=other)
            t.start()
            t.join()
    main, oth = rec.spans
    assert (main.name, oth.name) == ("main", "other")
    assert main.parent is None and oth.parent is None and oth.call != main.call
    assert re.fullmatch(r"main: \d+\.\d\d ms\nother: \d+\.\d\d ms\n",
                        tprofiling.format_spans(rec.spans))


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """Each trace is a Chrome trace with the program's spans as ranges, and
    beside it the recorded calls (utils/profiling.runtime_calls)."""
    logdir = str(tmp_path / "trace")
    for _ in range(2):
        with tprofiling.device_trace(logdir) as prof:
            with tprofiling.scope("frcnn.call"):
                with tprofiling.scope("stage"):
                    torch.ones(8, 8).matmul(torch.ones(8, 8))
        assert any("mm" in e.name for e in prof.events())
    files = sorted(os.listdir(logdir))
    traces = [f for f in files if f.startswith("trace_")]
    spans = [f for f in files if f.startswith("spans_")]
    assert len(traces) == 2 and len(spans) == 2 and all(f.endswith(".json") for f in files)
    with open(os.path.join(logdir, traces[0])) as f:
        text = f.read()
    assert '"traceEvents"' in text and '"frcnn.call"' in text and '"stage"' in text
    with open(os.path.join(logdir, spans[0])) as f:
        got = json.load(f)
    (call,) = got["calls"]
    assert call["name"] == "frcnn.call" and [s["name"] for s in call["spans"]] == [
        "frcnn.call", "stage"]
    assert call["syncs"] == 0 and got["outside_ms"] == 0
