"""The port's data path and evaluator against faster_rcnn_tpu, on the CPU.

The same files on disk (a tiny VOC tree with a portrait image, and the
KITTI-synthetic generator's output) go through both packages: records,
prepared examples (native decoder and PIL, float and uint8), the loader's
batch sequence with one worker, the synthetic renderers and the VOC
evaluator, each held bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from faster_rcnn_tpu import evaluate as jeval
from faster_rcnn_tpu.config import DataConfig, FasterRcnnConfig
from faster_rcnn_tpu.data import kitti_synth as jkitti
from faster_rcnn_tpu.data import native_loader as jnative
from faster_rcnn_tpu.data import pipeline as jdata
from faster_rcnn_tpu.data import synth_render as jrender
from faster_rcnn_tpu.data import voc as jvoc
from faster_rcnn_tpu_torch import evaluate as teval
from faster_rcnn_tpu_torch.data import kitti_synth as tkitti
from faster_rcnn_tpu_torch.data import native_loader as tnative
from faster_rcnn_tpu_torch.data import pipeline as tdata
from faster_rcnn_tpu_torch.data import synth_render as trender
from faster_rcnn_tpu_torch.data import voc as tvoc
from tests.test_data import make_voc_tree
from tests.test_torch_models import port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_data") / "VOC")
    make_voc_tree(root, [
        ("000001", 200, 150, [("dog", False, 49, 41, 62, 95), ("person", True, 11, 21, 111, 121)]),
        ("000002", 120, 160, [("car", False, 11, 31, 101, 141)]),  # portrait
        ("000003", 180, 120, [("cat", False, 5, 5, 170, 110), ("dog", False, 30, 40, 60, 90)]),
    ])
    return root


def small_config():
    """Canvases of 96x160 (landscape) and 160x96 (portrait)."""
    return FasterRcnnConfig(data=DataConfig(canvas_h=96, canvas_w=160, resize_min=96,
                                            resize_max=160))


def records(voc_root, flip=True):
    cfg = small_config()
    kw = dict(flip=flip, resize_min=cfg.data.resize_min, resize_max=cfg.data.resize_max)
    return (jvoc.load_dataset([voc_root], "trainval", **kw),
            tvoc.load_dataset([voc_root], "trainval", **kw))


@pytest.mark.parametrize("flip", [False, True])
def test_load_dataset_records_match(voc_root, flip):
    (jrecs, jratios), (trecs, tratios) = records(voc_root, flip)
    assert len(trecs) == (6 if flip else 3)
    assert tratios == jratios
    for j, t in zip(jrecs, trecs):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.cache_key == j.cache_key
    assert {(r.width, r.height) for r in trecs} == {(128, 96), (96, 128), (144, 96)}


def test_annotation_less_image_is_a_record_in_memory(voc_root, tmp_path):
    root = str(tmp_path / "VOC")
    make_voc_tree(root, [("000001", 60, 40, [])])
    os.remove(os.path.join(root, tvoc.ANNOTATIONS_DIR, "000001.xml"))
    got, want = tvoc.parse_annotation(root, "000001"), jvoc.parse_annotation(root, "000001")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.width, got.height, got.gt_boxes) == (60, 40, [])


@pytest.fixture
def pil_only(monkeypatch):
    """Both packages' prepare_example on the PIL path."""
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "load_canvas_native", lambda *a, **k: None)
        monkeypatch.setattr(mod, "load_canvas_native_u8", lambda *a, **k: None)


@pytest.mark.parametrize("uint8", [False, True])
@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_prepare_example_matches_bit_for_bit(voc_root, request, uint8, decoder):
    if decoder == "pil":
        request.getfixturevalue("pil_only")
    else:
        assert tnative.available() and jnative.available()
    jcfg = small_config()
    tcfg = port_config(jcfg)
    (jrecs, _), (trecs, _) = records(voc_root)
    for j, t in zip(jrecs, trecs):  # flipped and portrait records among them
        want = jdata.prepare_example(j, jvoc.VOC_CLASS_MAPPING, jcfg, uint8=uint8)
        got = tdata.prepare_example(t, tvoc.VOC_CLASS_MAPPING, tcfg, uint8=uint8)
        assert tdata.canvas_for(t, tcfg) == jdata.canvas_for(j, jcfg)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if uint8 and decoder == "pil":  # padding is the mean pixel
            h, w = got["img_hw"]
            assert (got["image"][h:, :] == [124, 117, 104]).all()


def test_loader_sequence_matches_over_epochs(voc_root):
    """One worker, the same seed: the same (canvas, batch) sequence over
    three epochs (6 records, 4 landscape and 2 portrait, batches of 2)."""
    jcfg = small_config()
    tcfg = port_config(jcfg)
    (jrecs, _), (trecs, _) = records(voc_root)
    jit = iter(jdata.TrainLoader(jrecs, jvoc.VOC_CLASS_MAPPING, jcfg, 2, seed=3, num_workers=1,
                                 uint8=True))
    loader = tdata.TrainLoader(trecs, tvoc.VOC_CLASS_MAPPING, tcfg, 2, seed=3, num_workers=1,
                               uint8=True)
    assert loader.num_workers == 1
    tit = iter(loader)
    try:
        canvases = []
        for _ in range(9):
            (jc, jb), (tc, tb) = next(jit), next(tit)
            assert tc == jc
            canvases.append(tc)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert set(canvases) == {(96, 160), (160, 96)}
    finally:
        jit.close()
        tit.close()


def test_native_library_is_built_under_the_port(voc_root):
    assert tnative.available()
    so = tnative.build_info["library"]
    assert so == str(tnative.library_path()) and os.path.isfile(so)
    assert os.path.dirname(so) == os.path.join(REPO, "faster_rcnn_tpu_torch", "_build")
    assert os.path.realpath(so) != os.path.realpath(jnative._SO)


def test_native_library_of_another_cpu_is_never_loaded(monkeypatch):
    """The library is built with -march=native, so its name is keyed by the
    host's CPU: a build copied from a host with other instruction-set flags
    has another name, and this host builds its own."""
    here = tnative.library_path()
    assert any(w in tnative._host_cpu() for w in ("flags", "Features"))
    monkeypatch.setattr(tnative, "_host_cpu", lambda: "x86_64 x86_64 flags : fpu sse2")
    other = tnative.library_path()
    assert other != here and other.parent == here.parent


@pytest.mark.parametrize("name,h,w,seed", [("a", 40, 60, 0), ("000123", 375, 500, 1),
                                           ("kt000001", 375, 1242, 0)])
def test_render_image_matches(name, h, w, seed):
    boxes = [(3, 4, 30, 35), (10, 2, 58, 20), (0, 0, 59, 39), (20, 20, 21, 21)]
    cls = [0, 5, 11, 3]
    np.testing.assert_array_equal(trender.render_image(name, h, w, boxes, cls, seed=seed),
                                  jrender.render_image(name, h, w, boxes, cls, seed=seed))
    for c in range(12):
        for k, v in jrender.class_style(c).items():
            np.testing.assert_array_equal(trender.class_style(c)[k], v)


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = path
    return out


@pytest.fixture(scope="module")
def kitti_trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("kitti")
    kw = dict(n_train=3, n_val=4, seed=5)
    names = (tkitti.build_kitti_synth_dataset(str(base / "port"), tvoc.KITTI_CLASS_MAPPING, **kw),
             jkitti.build_kitti_synth_dataset(str(base / "jax"), jvoc.KITTI_CLASS_MAPPING, **kw))
    return str(base / "port"), str(base / "jax"), names


def test_kitti_synth_writes_the_same_dataset(kitti_trees):
    from PIL import Image as PilImage

    port, jax_root, (tnames, jnames) = kitti_trees
    assert tnames == jnames and len(tnames) == 7
    tfiles, jfiles = _tree(port), _tree(jax_root)
    assert set(tfiles) == set(jfiles)
    for rel, path in jfiles.items():
        if rel.endswith(".jpg"):
            got = np.asarray(PilImage.open(tfiles[rel]))
            assert got.shape == (375, 1242, 3)
            np.testing.assert_array_equal(got, np.asarray(PilImage.open(path)))
        else:  # annotations and imagesets
            with open(tfiles[rel]) as a, open(path) as b:
                assert a.read() == b.read(), rel
    recs, _ = tvoc.load_dataset([port], "train", flip=False, resize_min=600, resize_max=1500)
    assert {(r.height, r.width) for r in recs} == {(453, 1500)}


def _write_dets(out, gt, rng, classes):
    """comp3 files: most ground-truth boxes found with jitter (some twice),
    and false positives, with random scores."""
    os.makedirs(out, exist_ok=True)
    for cls in classes:
        lines = []
        for name, boxes in gt.items():
            for b in boxes:
                if b.obj_cls != cls:
                    continue
                for _ in range(rng.randint(0, 3)):
                    c = b.corners + rng.uniform(-6, 6, 4)
                    lines.append(f"{name} {rng.uniform():.6f} " + " ".join(
                        f"{v + 1:.1f}" for v in c))
            if rng.uniform() < 0.5:
                x, y = rng.uniform(0, 300, 2)
                lines.append(f"{name} {rng.uniform():.6f} {x:.1f} {y:.1f} {x + 40:.1f} {y + 30:.1f}")
        with open(os.path.join(out, f"comp3_det_test_{cls}.txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))


@pytest.mark.parametrize("tree", ["kitti", "voc"])
def test_eval_all_gives_the_same_aps(kitti_trees, voc_root, tmp_path, tree):
    if tree == "kitti":
        root, img_set, mapping = kitti_trees[0], "val", tvoc.KITTI_CLASS_MAPPING
    else:  # one 'difficult' box
        root, img_set, mapping = voc_root, "trainval", tvoc.VOC_CLASS_MAPPING
    gt = teval.load_ground_truth(root, img_set)
    classes = sorted({b.obj_cls for boxes in gt.values() for b in boxes})
    _write_dets(str(tmp_path), gt, np.random.RandomState(0), classes)
    got = teval.eval_all(str(tmp_path), root, mapping, img_set=img_set, verbose=False)
    want = jeval.eval_all(str(tmp_path), root, mapping, img_set=img_set, verbose=False)
    assert got == want
    assert 0 < got["mAP"] < 1 and set(got) == set(mapping) - {"bg"} | {"mAP"}
    rec, prec = np.linspace(0, 1, 7), np.linspace(1, 0.2, 7)
    for use_07 in (True, False):
        assert teval.voc_ap(rec, prec, use_07) == jeval.voc_ap(rec, prec, use_07)


def test_loader_raises_a_workers_error(voc_root, tmp_path):
    """A batch that fails (here an image missing on disk) is raised to the
    consumer, which would otherwise wait for it forever."""
    import threading

    cfg = port_config(small_config())
    (_, _), (trecs, _) = records(voc_root, flip=False)
    gone = dataclasses.replace(trecs[0], image_path=str(tmp_path / "missing.jpg"))
    it = iter(tdata.TrainLoader([gone] * 2, tvoc.VOC_CLASS_MAPPING, cfg, 2, num_workers=2))
    raised = []

    def consume():
        try:
            next(it)
        except FileNotFoundError as e:
            raised.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and len(raised) == 1


def test_native_library_that_does_not_load_falls_back_to_pil(voc_root, monkeypatch, tmp_path,
                                                             capsys):
    """A library built where libjpeg's shared library was, loaded where it
    is not (or any file that dlopen refuses): the native loader reports why
    and PIL decodes."""
    bad = tmp_path / "_image_loader_bad.so"
    bad.write_bytes(b"not a shared object")
    monkeypatch.setattr(tnative, "library_path", lambda: bad)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "build_info", {})
    assert not tnative.available()
    assert "loading _image_loader_bad.so failed" in tnative.build_info["error"]
    assert "using PIL fallback" in capsys.readouterr().out
    (_, _), (trecs, _) = records(voc_root, flip=False)
    cfg = port_config(small_config())
    ex = tdata.prepare_example(trecs[0], tvoc.VOC_CLASS_MAPPING, cfg, uint8=True)
    h, w = ex["img_hw"]
    assert (ex["image"][h:, :] == [124, 117, 104]).all()  # the PIL path's padding
