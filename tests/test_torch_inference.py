"""The PyTorch port's detection path against faster_rcnn_tpu.inference.

Both packages run ResNet-50 at tiny_config shapes in float32 on the same
weights (see tests/test_torch_models.py) and the same uint8 canvases; the JAX
side runs its Pallas stem and RoI-align kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_tpu import inference as jinf
from faster_rcnn_tpu.train import pipeline as jpipe
from faster_rcnn_tpu_torch import inference as tinf
from faster_rcnn_tpu_torch.models.detector import init_model
from faster_rcnn_tpu_torch.train import pipeline as tpipe
from tests.test_torch_models import build_pair, port_config
from tests.test_train_step import tiny_config


@pytest.fixture(scope="module")
def detect_pair():
    torch.set_num_threads(1)
    jcfg, tc, model, vnp, tmodel = build_pair(seed=1)
    rng = np.random.RandomState(7)
    img = rng.randint(0, 256, (3, 64, 96, 3)).astype(np.uint8)
    hw = np.array([[64, 96], [48, 80], [33, 50]], np.int32)  # per-image extents
    want = jinf.make_detect_fn(jcfg, model, vnp, uint8_input=True)(img, hw)
    got = tinf.make_detect_fn(tc, tmodel, device="cpu")(img, hw)
    return jcfg, tc, want, got


class TestDetect:
    def test_matches_jax_detect(self, detect_pair):
        _, tc, want, got = detect_pair
        d = tc.rpn.infer_post_nms
        assert tuple(got.boxes.shape) == (3, d, 4) and got.classes.dtype == torch.int32
        wv = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid.numpy(), wv)
        assert wv.sum() > 0
        np.testing.assert_array_equal(got.classes.numpy()[wv], np.asarray(want.classes)[wv])
        np.testing.assert_allclose(got.boxes.numpy()[wv], np.asarray(want.boxes)[wv],
                                   rtol=0, atol=1e-2)
        np.testing.assert_allclose(got.scores.numpy()[wv], np.asarray(want.scores)[wv],
                                   rtol=1e-4)

    def test_records_match_jax(self, detect_pair):
        _, tc, want, got = detect_pair
        names = [f"c{i}" for i in range(tc.model.num_classes)]
        ratios = [1.0, 0.8, 0.55]
        jr = jinf.detections_to_records(want, ratios, names)
        tr = tinf.detections_to_records(got, ratios, names)
        assert [len(r) for r in tr] == [len(r) for r in jr]
        for a, b in zip(tr, jr):
            for x, y in zip(a, b):
                assert x["cls_name"] == y["cls_name"]
                assert np.abs(x["bbox"] - y["bbox"]).max() <= 1
                np.testing.assert_allclose(x["prob"], y["prob"], rtol=1e-4)

    def test_write_dets_same_files(self, tmp_path):
        recs = {"car": {"img1": [{"bbox": np.array([1, 2, 30, 40]), "prob": 0.5}]},
                "van": {"img2": [{"bbox": np.array([0, 0, 5, 6]), "prob": 0.25}]}}
        jinf.write_dets(recs, str(tmp_path / "j"))
        tinf.write_dets(recs, str(tmp_path / "t"))
        for cls in recs:
            name = f"comp3_det_test_{cls}.txt"
            assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()


class TestDecode:
    def test_decode_one_image_batched(self, rng):
        jcfg = tiny_config("resnet50")
        tc = port_config(jcfg)
        c, r = jcfg.model.num_classes, 40
        rois = np.stack([rng.randint(0, 3, (2, r)), rng.randint(0, 3, (2, r)),
                         rng.randint(3, 6, (2, r)), rng.randint(3, 6, (2, r))], -1)
        rois = rois.astype(np.float32)
        prob = rng.dirichlet(np.ones(c), size=(2, r)).astype(np.float32)
        prob[1, :10] = 1.0 / c  # ties: argmax takes the first maximum
        reg = (rng.standard_normal((2, r, 4 * (c - 1))) * 0.1).astype(np.float32)
        valid = rng.uniform(size=(2, r)) > 0.2
        want = jax.vmap(lambda *a: jinf._decode_one_image(jcfg, *a))(
            jnp.asarray(rois), jnp.asarray(valid), jnp.asarray(prob), jnp.asarray(reg))
        got = tinf._decode_one_image(tc, torch.tensor(rois), torch.tensor(valid),
                                     torch.tensor(prob), torch.tensor(reg))
        wv = np.asarray(want[3])
        np.testing.assert_array_equal(got[3].numpy(), wv)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-4)

    def test_ingest_images(self, rng):
        img = rng.randint(0, 256, (2, 8, 12, 3)).astype(np.uint8)
        np.testing.assert_array_equal(tpipe.ingest_images(torch.tensor(img)).numpy(),
                                      np.asarray(jpipe.ingest_images(jnp.asarray(img))))
        f = torch.zeros(1, 4, 4, 3)
        assert tpipe.ingest_images(f) is f


class TestDevice:
    def test_entry_points_raise_without_cuda_unless_cpu(self, monkeypatch):
        tc = port_config(tiny_config("resnet50"))
        model = init_model(0, tc, device="cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tinf.make_detect_fn(tc, model)
        with pytest.raises(RuntimeError):
            tinf.make_detect_fn(tc, model, device="cuda")
        with pytest.raises(RuntimeError):
            init_model(0, tc)
        tinf.make_detect_fn(tc, model, device="cpu")  # the tests' way

    def test_cpu_detect_counts_no_kernel_launch(self):
        from faster_rcnn_tpu_torch import _build

        tc = port_config(tiny_config("resnet50"))
        model = init_model(0, tc, device="cpu")
        before = dict(_build.LAUNCHES)
        img = np.zeros((1, 64, 96, 3), np.uint8)
        dets = tinf.make_detect_fn(tc, model, device="cpu")(img, np.array([[64, 96]]))
        assert _build.LAUNCHES == before
        assert tuple(dets.valid.shape) == (1, tc.rpn.infer_post_nms)
