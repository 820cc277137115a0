"""The PyTorch port's ops (faster_rcnn_tpu_torch.ops) against the JAX package.

Inputs come from numpy seeds and go through both packages on the CPU. Where
the JAX function reaches a Pallas kernel it runs in interpret mode. On the
CPU each kernel wrapper runs its plain PyTorch version, so these tests hold
the plain versions (and the arithmetic the CUDA kernels repeat) against the
JAX reference; tests/test_torch_gpu.py holds the kernels against the plain
versions on a card.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_tpu.ops import boxes as jboxes
from faster_rcnn_tpu.ops import nms as jnms
from faster_rcnn_tpu.ops import proposals as jprops
from faster_rcnn_tpu.ops import roi_align as jroi
from faster_rcnn_tpu.ops.conv1_pallas import conv1_pallas_v2, conv1_xla
from faster_rcnn_tpu.ops.nms_pallas import nms_keep_mask_pallas
from faster_rcnn_tpu.ops.roi_align_pallas import roi_align_pallas
from faster_rcnn_tpu_torch import _build
from faster_rcnn_tpu_torch.ops import boxes as tboxes
from faster_rcnn_tpu_torch.ops import conv1_cuda
from faster_rcnn_tpu_torch.ops import nms as tnms
from faster_rcnn_tpu_torch.ops import nms_cuda
from faster_rcnn_tpu_torch.ops import proposals as tprops
from faster_rcnn_tpu_torch.ops import roi_align as troi
from faster_rcnn_tpu_torch.ops import roi_align_cuda

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.tensor(np.asarray(x))


def _boxes(rng, n, lo=0, hi=100, max_wh=40):
    x1 = rng.uniform(lo, hi, n)
    y1 = rng.uniform(lo, hi, n)
    return np.stack([x1, y1, x1 + rng.uniform(1, max_wh, n), y1 + rng.uniform(1, max_wh, n)],
                    1).astype(np.float32)


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------


class TestBoxes:
    @pytest.mark.parametrize("fn", ["area", "area_plus_one", "valid_mask"])
    def test_unary_exact(self, rng, fn):
        b = _boxes(rng, 200)
        b[::7, 2] = b[::7, 0]  # some zero-width boxes
        np.testing.assert_array_equal(
            np.asarray(getattr(jboxes, fn)(jnp.asarray(b))), getattr(tboxes, fn)(_t(b)).numpy())

    def test_iou_matrix_exact(self, rng):
        a, b = _boxes(rng, 50), _boxes(rng, 70)
        b[3] = [5, 5, 5, 9]  # zero area
        np.testing.assert_array_equal(np.asarray(jboxes.iou_matrix(jnp.asarray(a), jnp.asarray(b))),
                                      tboxes.iou_matrix(_t(a), _t(b)).numpy())

    def test_decode_rounded_exact_and_float_to_ulp(self, rng):
        a = np.round(_boxes(rng, 4000))
        d = (rng.standard_normal((4000, 4)) * 0.5).astype(np.float32)
        np.testing.assert_array_equal(
            np.asarray(jboxes.decode(jnp.asarray(a), jnp.asarray(d), True)),
            tboxes.decode(_t(a), _t(d), True).numpy())
        # the float decode goes through exp, whose last bit differs between
        # XLA's and PyTorch's implementations
        np.testing.assert_allclose(
            np.asarray(jboxes.decode(jnp.asarray(a), jnp.asarray(d), False)),
            tboxes.decode(_t(a), _t(d), False).numpy(), rtol=1e-6, atol=1e-5)

    def test_encode_to_ulp(self, rng):
        a, g = _boxes(rng, 500), _boxes(rng, 500)
        g[::9, 3] = g[::9, 1]  # degenerate rows give zeros
        want = np.asarray(jboxes.encode(jnp.asarray(a), jnp.asarray(g)))
        got = tboxes.encode(_t(a), _t(g)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)  # log's last bit
        np.testing.assert_array_equal(got[::9], 0.0)

    def test_clip_to_grid_exact_with_per_image_extent(self, rng):
        b = np.round(rng.uniform(-10, 60, (3, 40, 4))).astype(np.float32)
        rows, cols = np.array([30, 20, 38]), np.array([50, 94, 10])
        want = np.stack([np.asarray(jboxes.clip_to_grid(jnp.asarray(b[i]), rows[i], cols[i]))
                         for i in range(3)])
        got = tboxes.clip_to_grid(_t(b), _t(rows)[:, None], _t(cols)[:, None]).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# NMS: the plain keep mask against _blocked_keep_mask and the Pallas kernel
# ---------------------------------------------------------------------------


def _sorted_case(rng, n, n_valid, clustered):
    if clustered:  # heavy overlap, long suppression chains
        centers = rng.uniform(0, 150, (12, 2))
        c = centers[rng.randint(0, 12, n)] + rng.normal(0, 6, (n, 2))
        wh = rng.uniform(20, 60, (n, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    else:
        boxes = _boxes(rng, n, 0, 180, 100)
    scores = rng.uniform(size=n).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[:n_valid] = True
    bs, ss, vs = jnms.sort_by_score(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    return boxes, scores, valid, np.asarray(bs), np.asarray(vs)


NMS_CASES = [  # n, valid, tile, iou, enough, clustered
    (256, 240, 64, 0.6, 0, False),
    (256, 256, 64, 0.5, 5, False),
    (512, 500, 128, 0.7, 40, True),
    (384, 300, 128, 0.5, 300, True),
    (256, 200, 256, 0.3, 0, True),
]


class TestNmsKeepMask:
    @pytest.mark.parametrize("n,n_valid,tile,iou,enough,clustered", NMS_CASES)
    def test_matches_blocked_and_pallas_exactly(self, rng, n, n_valid, tile, iou, enough,
                                                clustered):
        _, _, _, bs, vs = _sorted_case(rng, n, n_valid, clustered)
        want = np.asarray(jnms.nms_sorted_mask_blocked(jnp.asarray(bs), jnp.asarray(vs), iou,
                                                       tile=tile, enough=enough))
        pallas = np.asarray(nms_keep_mask_pallas(jnp.asarray(bs), jnp.asarray(vs), iou,
                                                 tile=tile, enough=enough, interpret=True))
        got = nms_cuda.nms_keep_mask(_t(bs)[None], _t(vs)[None], iou, tile=tile,
                                     enough=enough)[0].numpy()
        # the whole mask, the tail after an early exit included
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pallas)

    def test_greedy_oracle(self, rng):
        from tests import reference_impl as ref

        boxes, scores, valid, bs, vs = _sorted_case(rng, 256, 256, True)
        keep = nms_cuda.nms_keep_mask(_t(bs)[None], _t(vs)[None], 0.5, tile=64)[0].numpy()
        order = np.argsort(-scores, kind="stable")
        pick = ref.np_greedy_nms(boxes, scores, 0.5, 1000)
        np.testing.assert_array_equal(np.sort(order[keep]), np.sort(pick))

    def test_batched_rows_are_independent(self, rng):
        cases = [_sorted_case(rng, 256, nv, True) for nv in (256, 100, 0)]
        bs = np.stack([c[3] for c in cases])
        vs = np.stack([c[4] for c in cases])
        got = nms_cuda.nms_keep_mask(_t(bs), _t(vs), 0.6, tile=64, enough=30).numpy()
        for i in range(3):
            want = np.asarray(jnms.nms_sorted_mask_blocked(
                jnp.asarray(bs[i]), jnp.asarray(vs[i]), 0.6, tile=64, enough=30))
            np.testing.assert_array_equal(got[i], want)

    def test_wrapper_checks_shapes_and_counts_nothing_on_cpu(self, rng):
        _, _, _, bs, vs = _sorted_case(rng, 128, 128, False)
        before = dict(_build.LAUNCHES)
        nms_cuda.nms_keep_mask(_t(bs)[None], _t(vs)[None], 0.5, tile=64)
        assert _build.LAUNCHES == before
        with pytest.raises(ValueError):
            nms_cuda.nms_keep_mask(_t(bs)[None], _t(vs)[None], 0.5, tile=96)
        with pytest.raises(ValueError):
            nms_cuda.nms_keep_mask(_t(bs), _t(vs), 0.5, tile=64)


class TestNmsTopk:
    @pytest.mark.parametrize("presorted", [False, True])
    def test_nms_topk_exact(self, rng, presorted):
        outs = []
        for _ in range(2):
            boxes, scores, valid, bs, vs = _sorted_case(rng, 300, 280, True)
            if presorted:
                ss = np.sort(np.where(valid, scores, -1e30).astype(np.float32))[::-1].copy()
                boxes, scores, valid = bs, ss, vs
            jw = jnms.nms_topk(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                               40, 0.5, tile=128, presorted=presorted)
            outs.append((boxes, scores, valid, [np.asarray(x) for x in jw]))
        got = tnms.nms_topk(_t(np.stack([o[0] for o in outs])),
                            _t(np.stack([o[1] for o in outs])),
                            _t(np.stack([o[2] for o in outs])), 40, 0.5, tile=128,
                            presorted=presorted)
        for i, o in enumerate(outs):
            for w, g in zip(o[3], got):
                np.testing.assert_array_equal(g[i].numpy(), w)

    def test_nms_topk_fewer_candidates_than_outputs(self, rng):
        boxes, scores, valid, _, _ = _sorted_case(rng, 20, 15, False)
        jw = jnms.nms_topk(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 32, 0.5,
                           tile=16)
        got = tnms.nms_topk(_t(boxes)[None], _t(scores)[None], _t(valid)[None], 32, 0.5, tile=16)
        for w, g in zip(jw, got):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))

    def test_nms_topk_indices_exact_with_score_ties(self, rng):
        boxes, scores, valid, _, _ = _sorted_case(rng, 300, 260, True)
        scores[rng.randint(0, 300, 120)] = 0.5  # tie plateau: order by index
        boxes = boxes + (rng.randint(0, 4, (300, 1)) * 16384.0).astype(np.float32)
        ji, jv = jnms.nms_topk_indices(jnp.asarray(boxes), jnp.asarray(scores),
                                       jnp.asarray(valid), 300, 0.5, tile=128)
        ti, tv = tnms.nms_topk_indices(_t(boxes)[None], _t(scores)[None], _t(valid)[None], 300,
                                       0.5, tile=128)
        np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))

    def test_sort_by_score_stable(self, rng):
        s = rng.randint(0, 4, 64).astype(np.float32)
        valid = rng.uniform(size=64) > 0.2
        b = _boxes(rng, 64)
        jb, js, jv = jnms.sort_by_score(jnp.asarray(b), jnp.asarray(s), jnp.asarray(valid))
        tb, ts, tv, _ = tnms.sort_by_score(_t(b)[None], _t(s)[None], _t(valid)[None])
        for w, g in ((jb, tb), (js, ts), (jv, tv)):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# proposals
# ---------------------------------------------------------------------------


class TestProposals:
    @pytest.mark.parametrize("ties", [False, True])
    def test_generate_proposals_exact(self, rng, ties):
        from faster_rcnn_tpu.config import AnchorConfig
        from faster_rcnn_tpu.ops.anchors import anchor_grid_conv_space as j_anchors
        from faster_rcnn_tpu_torch.ops.anchors import anchor_grid_conv_space as t_anchors

        h, w, stride = 6, 9, 16
        dims = AnchorConfig(scales=(16, 32, 64), ratios=((1, 1), (2, 1))).dims
        a = len(dims)
        anchors = j_anchors(h, w, dims, stride)
        np.testing.assert_array_equal(anchors, t_anchors(h, w, dims, stride))
        b = 3
        probs = rng.uniform(size=(b, h, w, a)).astype(np.float32)
        if ties:  # plateaus: lax.top_k and the stable sort order ties by index
            probs[rng.uniform(size=probs.shape) < 0.4] = 0.5
            probs[0, :2] = 0.25
        reg = (rng.standard_normal((b, h, w, 4 * a)) * 2).astype(np.float32)
        rows, cols = np.array([6, 4, 5]), np.array([9, 9, 6])
        jposv = jprops.position_validity(h, w, a)
        want = [jprops.generate_proposals(jnp.asarray(probs[i]), jnp.asarray(reg[i]),
                                          jnp.asarray(anchors), jposv(rows[i], cols[i]),
                                          rows[i], cols[i], pre_nms=80, post_nms=24,
                                          iou_thresh=0.7, nms_tile=32) for i in range(b)]
        tposv = tprops.position_validity(h, w, a)
        got = tprops.generate_proposals(_t(probs), _t(reg), _t(anchors),
                                        tposv(_t(rows), _t(cols)), _t(rows), _t(cols),
                                        pre_nms=80, post_nms=24, iou_thresh=0.7, nms_tile=32)
        for i in range(b):
            for wv, gv in zip(want[i], got):
                np.testing.assert_array_equal(gv[i].numpy(), np.asarray(wv))
        assert got.valid.sum() > 0


# ---------------------------------------------------------------------------
# RoI align and the stem conv against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def _rois(rng, n, h, w):
    x1 = rng.randint(0, w - 2, n)
    y1 = rng.randint(0, h - 2, n)
    x2 = np.maximum(np.minimum(x1 + rng.randint(1, 12, n), w - 1), x1 + 1)
    y2 = np.maximum(np.minimum(y1 + rng.randint(1, 8, n), h - 1), y1 + 1)
    return np.stack([x1, y1, x2, y2], 1).astype(np.float32)


class TestRoiAlign:
    def test_matches_pallas_interpret_and_gather(self, rng):
        feat = rng.standard_normal((2, 20, 28, 16)).astype(np.float32)
        rois = np.stack([_rois(rng, 12, 20, 28) for _ in range(2)])
        rois[0, 0] = [5, 5, 6, 6]    # single pixel
        rois[1, 1] = [0, 0, 27, 19]  # the whole map
        got = roi_align_cuda.roi_align(_t(feat), _t(rois), 7).numpy()
        for i in range(2):
            pallas = np.asarray(roi_align_pallas(jnp.asarray(feat[i]), jnp.asarray(rois[i]), 7,
                                                 True))
            gather = np.asarray(jroi.roi_align(jnp.asarray(feat[i]), jnp.asarray(rois[i]), 7))
            np.testing.assert_allclose(got[i], pallas, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(got[i], gather, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[0, 0], np.broadcast_to(feat[0, 5, 5], (7, 7, 16)))

    def test_einsum_oracle_and_tap_weights(self, rng):
        feat = rng.standard_normal((12, 15, 8)).astype(np.float32)
        rois = _rois(rng, 9, 12, 15)
        np.testing.assert_allclose(troi.roi_align_einsum(_t(feat), _t(rois), 7).numpy(),
                                   troi.roi_align(_t(feat), _t(rois), 7).numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(
            troi._tap_weights(_t(rois[:, 1]), _t(rois[:, 3] - rois[:, 1]), 12, 7).numpy(),
            np.asarray(jroi._tap_weights(jnp.asarray(rois[:, 1]),
                                         jnp.asarray(rois[:, 3] - rois[:, 1]), 12, 7)))

    def test_bf16_plain_version_rounds_once(self, rng):
        feat = rng.standard_normal((1, 10, 12, 8)).astype(np.float32)
        rois = _rois(rng, 5, 10, 12)[None]
        f16 = _t(feat).to(torch.bfloat16)
        got = roi_align_cuda.roi_align(f16, _t(rois), 7)
        want = troi.roi_align_batched(f16.float(), _t(rois), 7).to(torch.bfloat16)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


class TestConv1:
    @pytest.mark.parametrize("b,h,w", [(2, 16, 24), (1, 32, 64), (2, 64, 96)])
    def test_plain_matches_pallas_v2_interpret(self, rng, b, h, w):
        x = rng.standard_normal((b, h, w, 3)).astype(np.float32)
        k = rng.standard_normal((7, 7, 3, 64)).astype(np.float32)
        got = conv1_cuda.conv1(_t(x), _t(k)).numpy()
        want = np.asarray(conv1_pallas_v2(jnp.asarray(x), jnp.asarray(k), True))
        assert got.shape == (b, h // 2, w // 2, 64)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
        np.testing.assert_allclose(got, np.asarray(conv1_xla(jnp.asarray(x), jnp.asarray(k))),
                                   rtol=1e-4, atol=1e-4 * scale)

    def test_rejects_odd_canvas(self, rng):
        with pytest.raises(ValueError):
            conv1_cuda.conv1(torch.zeros(1, 15, 16, 3), torch.zeros(7, 7, 3, 64))


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "faster_rcnn_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _calls_an_entry_point(node):
    """A call of a kernel library entry point: ``lib.frcnn_x(...)``,
    ``lib().frcnn_x(...)`` or ``getattr(<library>, name)(...)``."""
    f = node.func
    return (isinstance(f, ast.Attribute) and f.attr.startswith("frcnn_")) or (
        isinstance(f, ast.Call) and isinstance(f.func, ast.Name) and f.func.id == "getattr")


def test_kernels_launch_only_through_the_device_guarded_helper():
    """The wrappers (ops/*_cuda.py) never touch the kernel library: each
    kernel launches through _build.launch, which calls its entry point with
    the tensor's device current and that device's stream, checks the result
    and counts the launch; sizes and occupancy come through _build.query.
    In _build.py only those two (and check's error string) call an entry."""
    launched = []
    for path in sorted((REPO / "faster_rcnn_tpu_torch" / "ops").glob("*_cuda.py")):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            where = (path.name, getattr(node, "lineno", None))
            if isinstance(node, ast.Attribute):
                assert node.attr != "lib" and not node.attr.startswith("frcnn_"), where
            if isinstance(node, ast.Call):
                assert not (isinstance(node.func, ast.Name) and node.func.id == "getattr"), where
                if isinstance(node.func, ast.Attribute) and node.func.attr == "launch":
                    launched.append(node.args[0].value)
    assert sorted(launched) == sorted(_build.LAUNCHES)  # one launch site per kernel
    tree = ast.parse((REPO / "faster_rcnn_tpu_torch" / "_build.py").read_text())
    callers = {fn.name for fn in tree.body if isinstance(fn, ast.FunctionDef)
               for node in ast.walk(fn)
               if isinstance(node, ast.Call) and _calls_an_entry_point(node)}
    assert callers == {"launch", "query", "check"}


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = (sorted((REPO / "faster_rcnn_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "scripts").glob("*_torch.py"))
             + sorted((REPO / "scripts").glob("*_cuda.py")))
    assert len(files) > 15 and REPO / "scripts" / "bench_multi_gpu_torch.py" in files
    bad = {str(f.relative_to(REPO)): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
           for f in files}
    assert not {k: v for k, v in bad.items() if v}, bad
