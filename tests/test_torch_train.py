"""The PyTorch port's training path against faster_rcnn_tpu, on the CPU.

Inputs come from numpy seeds; the samplers' random numbers are drawn with
jax.random from the JAX step's own keys and handed to both packages, since
the two frameworks' streams differ. Where a test is about a kernel the JAX
side runs its Pallas kernel in interpret mode; on the CPU each kernel
wrapper of the port runs its plain version. The whole joint step runs
ResNet-50 at tiny_config shapes in float32 on the same weights
(utils/convert.from_flax_numpy), two steps, so momentum counts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from faster_rcnn_tpu.models import layers as jlayers
from faster_rcnn_tpu.models.detector import FasterRCNN as JaxFasterRCNN
from faster_rcnn_tpu.ops import losses as jlosses
from faster_rcnn_tpu.ops import sampling as jsampling
from faster_rcnn_tpu.ops import targets as jtargets
from faster_rcnn_tpu.ops.conv1_pallas import conv1_pallas_v2
from faster_rcnn_tpu.ops.roi_align_pallas import roi_align_pallas
from faster_rcnn_tpu.ops.sort_pallas import topk_sorted_pallas
from faster_rcnn_tpu.parallel import freeze as jfreeze
from faster_rcnn_tpu.train import pipeline as jpipe
from faster_rcnn_tpu.train import schedule as jschedule
from faster_rcnn_tpu_torch import _build
from faster_rcnn_tpu_torch.models import layers as tlayers
from faster_rcnn_tpu_torch.models.detector import FasterRCNN, init_model
from faster_rcnn_tpu_torch.ops import conv1_cuda, roi_align_cuda, sort_cuda
from faster_rcnn_tpu_torch.ops import losses as tlosses
from faster_rcnn_tpu_torch.ops import sampling as tsampling
from faster_rcnn_tpu_torch.ops import targets as ttargets
from faster_rcnn_tpu_torch.parallel import freeze as tfreeze
from faster_rcnn_tpu_torch.train import pipeline as tpipe
from faster_rcnn_tpu_torch.train import schedule as tschedule
from faster_rcnn_tpu_torch.utils.convert import from_flax_numpy
from tests.test_torch_models import port_config, redraw_norm_layers
from tests.test_train_step import tiny_batch, tiny_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.tensor(np.asarray(x))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got,
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# K4 top-k: the plain version against lax.top_k and the Pallas kernel
# ---------------------------------------------------------------------------


class TestTopk:
    @pytest.mark.parametrize("n,k", [(1000, 300), (1024, 1024), (3000, 1200), (5000, 10)])
    def test_matches_lax_top_k_and_pallas_with_ties(self, rng, n, k):
        x = rng.uniform(size=n).astype(np.float32)
        x[rng.randint(0, n, 50)] = 0.5  # tie plateau
        v, i = sort_cuda.topk_sorted(_t(x)[None], k)
        tv, ti = jax.lax.top_k(jnp.asarray(x), k)
        pv, pi = topk_sorted_pallas(jnp.asarray(x), k, interpret=True)
        for want_v, want_i in ((tv, ti), (pv, pi)):
            _eq(v[0], want_v)
            _eq(i[0], want_i)
        assert i.dtype == torch.int64

    def test_batch_with_masks_and_signed_zeros(self, rng):
        b, n, k = 4, 2000, 700
        x = rng.uniform(size=(b, n)).astype(np.float32)
        x[rng.uniform(size=(b, n)) < 0.3] = -1e30   # masked, as the port masks
        x[3] = -1e30                                 # an all-masked row
        x[1, :40] = 0.0
        x[1, 40:80] = -0.0                           # -0.0 ties +0.0, by index
        x[2, rng.randint(0, n, 200)] = 0.25
        v, i = sort_cuda.topk_sorted(_t(x), k)
        for r in range(b):
            tv, ti = jax.lax.top_k(jnp.asarray(x[r]), k)
            _eq(i[r], ti)
            np.testing.assert_array_equal(v[r].numpy().view(np.uint32),
                                          np.asarray(tv).view(np.uint32))
        assert np.all(i[3].numpy() == np.arange(k))

    def test_all_masked_indices_in_bounds(self):
        x = np.full((2, 2000), -1e30, np.float32)
        _, i = sort_cuda.topk_sorted(_t(x), 300)
        _, pi = topk_sorted_pallas(jnp.asarray(x[0]), 300, interpret=True)
        _eq(i[0], pi)
        assert int(i.max()) < 2000

    def test_wrapper_checks_and_counts_nothing_on_cpu(self):
        before = dict(_build.LAUNCHES)
        sort_cuda.topk_sorted(torch.zeros(2, 10), 3)
        assert _build.LAUNCHES == before
        with pytest.raises(ValueError):
            sort_cuda.topk_sorted(torch.zeros(2, 10), 11)
        with pytest.raises(ValueError):
            sort_cuda.topk_sorted(torch.zeros(10), 3)


# ---------------------------------------------------------------------------
# samplers, with the JAX keys' draws injected
# ---------------------------------------------------------------------------


def _uniform(key, n):
    return np.asarray(jax.random.uniform(key, (n,)))


def _bits(key, n):
    """The two 32-bit words ``jax.random.randint`` draws from ``key``."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.bits(k1, (n,), jnp.uint32)).astype(np.int64),
            np.asarray(jax.random.bits(k2, (n,), jnp.uint32)).astype(np.int64))


class TestSampling:
    def test_randint_from_bits_is_jax_randint(self):
        key = jax.random.PRNGKey(3)
        hi, lo = _bits(key, 64)
        for m in (1, 2, 3, 7, 100, 1999, 2000, 65536):
            want = jax.random.randint(key, (64,), 0, m)
            _eq(tsampling.randint_from_bits(_t(hi), _t(lo), torch.tensor(m)), want)

    @pytest.mark.parametrize("n,k,max_k", [(300, 17, None), (3000, 40, 128), (3000, 200, 256)])
    def test_random_subset_mask(self, rng, n, k, max_k):
        key = jax.random.PRNGKey(n + k)
        mask = rng.uniform(size=n) < 0.1
        want = jsampling.random_subset_mask(key, jnp.asarray(mask), k, max_k=max_k)
        u = _uniform(key, n)
        got = tsampling.random_subset_mask(_t(u)[None], _t(mask)[None], k, max_k=max_k)
        _eq(got[0], want)
        assert int(got.sum()) == min(k, int(mask.sum()))

    def test_subsample_rpn_anchors(self, rng):
        n, b = 4000, 3
        keys = jax.random.split(jax.random.PRNGKey(5), b)
        is_pos = rng.uniform(size=(b, n)) < np.array([[0.01], [0.1], [0.0]])
        can_use = rng.uniform(size=(b, n)) < 0.8
        us = []
        for i in range(b):
            kp, kn = jax.random.split(keys[i])  # sampling.py:60
            us.append((_uniform(kp, n), _uniform(kn, n)))
        got = tsampling.subsample_rpn_anchors(
            _t(np.stack([u[0] for u in us])), _t(np.stack([u[1] for u in us])),
            _t(is_pos), _t(can_use), 256, 128)
        for i in range(b):
            want = jsampling.subsample_rpn_anchors(keys[i], jnp.asarray(is_pos[i]),
                                                   jnp.asarray(can_use[i]), 256, 128)
            _eq(got[i], want)
        assert got.sum(1).tolist() == [256, 256, 256]

    def test_sample_det_rois_every_branch(self, rng):
        k, r = 200, 64
        # many of both; few negatives (with replacement); no negatives; none at all
        cases = [(0.3, 0.5), (0.02, 0.04), (0.2, 0.2), (0.0, 0.0)]
        keys = jax.random.split(jax.random.PRNGKey(9), len(cases))
        elig, pos, draws = [], [], []
        for (pe, pp), key in zip(cases, keys):
            e = rng.uniform(size=k) < pe + (pp if pp > pe else 0)
            p = e & (rng.uniform(size=k) < (1.0 if pe == pp else pp / max(pe + pp, 1e-9)))
            elig.append(e)
            pos.append(p)
            kp, kn, kr = jax.random.split(key, 3)  # sampling.py:99
            draws.append((_uniform(kp, k), _uniform(kn, k)) + _bits(kr, r))
        d = [_t(np.stack([x[j] for x in draws])) for j in range(4)]
        idx, ok = tsampling.sample_det_rois(*d, _t(np.stack(elig)), _t(np.stack(pos)), r, 0.25)
        for i, key in enumerate(keys):
            wi, wok = jsampling.sample_det_rois(key, jnp.asarray(elig[i]), jnp.asarray(pos[i]),
                                                r, 0.25)
            _eq(idx[i], wi)
            assert bool(ok[i]) == bool(wok)
        assert not bool(ok[3])


# ---------------------------------------------------------------------------
# targets and losses
# ---------------------------------------------------------------------------


def _gt(rng, b, g, h, w):
    x1 = rng.uniform(0, w - 40, (b, g))
    y1 = rng.uniform(0, h - 40, (b, g))
    boxes = np.stack([x1, y1, x1 + rng.uniform(8, 40, (b, g)), y1 + rng.uniform(8, 40, (b, g))],
                     -1).astype(np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        valid[i, :rng.randint(1, g)] = True
    return boxes, rng.randint(0, 5, (b, g)).astype(np.int32), valid


class TestTargets:
    def test_rpn_targets(self, rng):
        from faster_rcnn_tpu.ops.anchors import anchor_grid_image_space

        cfg = tiny_config("resnet50")
        anchors = anchor_grid_image_space(8, 12, cfg.anchors.dims, 16).astype(np.float32)
        n, b = anchors.shape[0], 3
        boxes, _, valid = _gt(rng, b, 6, 128, 192)
        img_hw = np.array([[128, 192], [100, 150], [64, 192]])
        keys = jax.random.split(jax.random.PRNGKey(1), b)
        us = [tuple(_uniform(kk, n) for kk in jax.random.split(keys[i])) for i in range(b)]
        got = ttargets.rpn_targets(_t(np.stack([u[0] for u in us])),
                                   _t(np.stack([u[1] for u in us])), _t(anchors), _t(boxes),
                                   _t(valid), _t(img_hw[:, 1]), _t(img_hw[:, 0]),
                                   sample_size=64, max_pos=16)
        for i in range(b):
            want = jtargets.rpn_targets(keys[i], jnp.asarray(anchors), jnp.asarray(boxes[i]),
                                        jnp.asarray(valid[i]), img_hw[i, 1], img_hw[i, 0],
                                        sample_size=64, max_pos=16)
            for f in ("cls_mask", "cls_target", "reg_mask"):
                _eq(getattr(got, f)[i], getattr(want, f))
            np.testing.assert_allclose(got.reg_target[i].numpy(), np.asarray(want.reg_target),
                                       rtol=1e-6, atol=1e-6)
        assert got.cls_target.any() and got.cls_mask.sum() > 0

    def test_det_targets(self, rng):
        b, k = 3, 150
        boxes, cls, valid = _gt(rng, b, 5, 128, 192)
        x1 = np.round(rng.uniform(0, 10, (b, k)))
        y1 = np.round(rng.uniform(0, 6, (b, k)))
        rois = np.stack([x1, y1, x1 + np.round(rng.uniform(1, 4, (b, k))),
                         y1 + np.round(rng.uniform(1, 4, (b, k)))], -1).astype(np.float32)
        roi_valid = rng.uniform(size=(b, k)) < 0.9
        got = ttargets.det_targets(_t(rois), _t(roi_valid), _t(boxes), _t(cls), _t(valid), 6)
        for i in range(b):
            want = jtargets.det_targets(jnp.asarray(rois[i]), jnp.asarray(roi_valid[i]),
                                        jnp.asarray(boxes[i]), jnp.asarray(cls[i]),
                                        jnp.asarray(valid[i]), 6)
            for f in ("eligible", "is_pos", "cls_target"):
                _eq(getattr(got, f)[i], getattr(want, f))
            np.testing.assert_allclose(got.reg_target[i].numpy(), np.asarray(want.reg_target),
                                       rtol=1e-6, atol=1e-6)
        assert got.is_pos.any() and (got.eligible & ~got.is_pos).any()


class TestLosses:
    def test_all_four_losses(self, rng):
        b, n, r, c = 3, 500, 16, 6
        logits = (rng.standard_normal((b, n)) * 3).astype(np.float32)
        tpos = rng.uniform(size=(b, n)) < 0.2
        mask = rng.uniform(size=(b, n)) < 0.5
        pred = rng.standard_normal((b, n, 4)).astype(np.float32)
        tgt = (rng.standard_normal((b, n, 4)) * 2).astype(np.float32)
        dl = (rng.standard_normal((b, r, c)) * 2).astype(np.float32)
        dcls = rng.randint(0, c, (b, r))
        dpos = (dcls != c - 1) & (rng.uniform(size=(b, r)) < 0.7)
        dreg = rng.standard_normal((b, r, 4 * (c - 1))).astype(np.float32)
        dtgt = (rng.standard_normal((b, r, 4)) * 2).astype(np.float32)
        got = [tlosses.rpn_cls_loss(_t(logits), _t(tpos), _t(mask)),
               tlosses.rpn_reg_loss(_t(pred), _t(tgt), _t(mask)),
               tlosses.det_cls_loss(_t(dl), _t(dcls)),
               tlosses.det_reg_loss(_t(dreg), _t(dtgt), _t(dcls), _t(dpos), c)]
        for i in range(b):
            want = [jlosses.rpn_cls_loss(logits[i], tpos[i], mask[i]),
                    jlosses.rpn_reg_loss(pred[i], tgt[i], mask[i]),
                    jlosses.det_cls_loss(dl[i], dcls[i]),
                    jlosses.det_reg_loss(dreg[i], dtgt[i], dcls[i], dpos[i], c)]
            for g, w in zip(got, want):
                np.testing.assert_allclose(g[i].item(), float(w), rtol=1e-6)
        np.testing.assert_allclose(tlosses.smooth_l1(_t(tgt)).numpy(),
                                   np.asarray(jlosses.smooth_l1(tgt)), rtol=1e-7)


# ---------------------------------------------------------------------------
# backward contracts: frozen affine, RoI align, stem
# ---------------------------------------------------------------------------


class TestBackward:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("zero_mean", [False, True])
    def test_frozen_affine_vjp_bit_for_bit(self, rng, dtype, zero_mean):
        c = 16
        x = (rng.standard_normal((2, 5, 7, c)) * 3).astype(np.float32)
        cot = rng.standard_normal(x.shape).astype(np.float32)
        mean = np.zeros(c, np.float32) if zero_mean else rng.normal(size=c).astype(np.float32)
        inv = rng.uniform(0.3, 2, c).astype(np.float32)
        bias = rng.normal(size=c).astype(np.float32)
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        jx, jcot = jnp.asarray(x).astype(jdt), jnp.asarray(cot).astype(jdt)
        y, vjp = jax.vjp(jlayers._frozen_affine, jx, jnp.asarray(mean), jnp.asarray(inv),
                         jnp.asarray(bias))
        jdx = vjp(jcot)[0]
        tdt = getattr(torch, dtype)
        tx = _t(np.asarray(jx.astype(jnp.float32))).to(tdt).requires_grad_(True)
        tinv = _t(inv).requires_grad_(True)
        tbias = _t(bias).requires_grad_(True)
        ty = tlayers.FrozenAffine.apply(tx, None if zero_mean else _t(mean), tinv, tbias)
        ty.backward(_t(np.asarray(jcot.astype(jnp.float32))).to(tdt))
        assert ty.dtype == tdt and tx.grad.dtype == tdt
        # the forward is the port's own arithmetic bit for bit (XLA may
        # contract it into an FMA, so against JAX it holds to the last bit)
        centred = tx.detach().float() if zero_mean else tx.detach() - _t(mean)
        _eq(ty.detach().float(), torch.addcmul(_t(bias), centred, _t(inv)).to(tdt).float())
        np.testing.assert_allclose(ty.detach().float().numpy(), np.asarray(y.astype(jnp.float32)),
                                   rtol=1e-6, atol=1e-6)
        _eq(tx.grad.float(), np.asarray(jdx.astype(jnp.float32)))
        assert tinv.grad is None and tbias.grad is None

    def test_roi_align_backward_matches_pallas_vjp(self, rng):
        from tests.test_torch_ops import _rois

        feat = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
        rois = np.stack([_rois(rng, 6, 16, 16) for _ in range(2)])
        rois[1, 0] = rois[1, 1]  # a repeated ROI, as the sampler draws
        g = rng.standard_normal((2, 6, 7, 7, 8)).astype(np.float32)
        tf = _t(feat).requires_grad_(True)
        roi_align_cuda.roi_align(tf, _t(rois), 7).backward(_t(g))
        plain = roi_align_cuda.roi_align_backward(_t(g), _t(rois), feat.shape, 7)
        for i in range(2):
            want = jax.grad(lambda f: jnp.sum(roi_align_pallas(f, jnp.asarray(rois[i]), 7, True)
                                              * g[i]))(jnp.asarray(feat[i]))
            np.testing.assert_allclose(tf.grad[i].numpy(), np.asarray(want), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(plain[i].numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        g16 = _t(g).bfloat16()
        bf = roi_align_cuda.roi_align_backward(g16, _t(rois), feat.shape, 7)
        f32 = roi_align_cuda.roi_align_backward(g16.float(), _t(rois), feat.shape, 7)
        assert bf.dtype == torch.bfloat16
        _eq(bf.float(), f32.bfloat16().float())  # summed in f32, rounded once

    def test_stem_gradient_matches_pallas_vjp(self, rng):
        x = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
        w = (rng.standard_normal((7, 7, 3, 64)) * 0.1).astype(np.float32)
        g = rng.standard_normal((2, 16, 24, 64)).astype(np.float32)
        _, vjp = jax.vjp(lambda a, b: conv1_pallas_v2(a, b, True), jnp.asarray(x), jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(g))
        tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
        conv1_cuda.conv1(tx, tw).backward(_t(g))
        for got, want in ((tx.grad, jdx), (tw.grad, jdw)):
            scale = np.abs(np.asarray(want)).max()
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# freezing, the optimizer, the schedule
# ---------------------------------------------------------------------------


def _flax_names(tree):
    """{port parameter name: flax path} over a Flax params tree, by the
    mapping of utils/convert.from_flax_numpy."""
    out = {}
    for path, _ in jax.tree_util.tree_leaves_with_path(tree):
        keys = [p.key for p in path]
        leaf = "weight" if keys[-1] == "kernel" else keys[-1]
        out[".".join(keys[:-1] + [leaf])] = tuple(keys)
    return out


def _flat(tree):
    return {tuple(p.key for p in path): v for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def tiny_train_config(freeze=(1, 2, 3)):
    cfg = tiny_config("resnet50")
    return cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32",
                                                 conv1_impl="xla", freeze_blocks=freeze))


def to_flax_numpy(state_dict) -> dict:
    """The inverse of utils/convert.from_flax_numpy: a port state dict as a
    Flax variable tree of numpy arrays."""
    tree: dict = {}
    for name, t in state_dict.items():
        *path, leaf = name.split(".")
        arr = t.detach().numpy().copy()
        if leaf == "weight":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            leaf = "kernel"
        node = tree.setdefault("batch_stats" if leaf in ("mean", "var") else "params", {})
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


@pytest.fixture(scope="module")
def r50():
    """(jax cfg, port cfg, flax model, numpy variables) at tiny shapes. The
    weights are the port's seeded init carried to the Flax tree (Flax's own
    init traces the whole model and costs some 20 s here), with redrawn
    batch-norm statistics and affines."""
    jcfg = tiny_train_config()
    tc = port_config(jcfg)
    vnp = redraw_norm_layers(to_flax_numpy(init_model(0, tc, "cpu").state_dict()), 0)
    return jcfg, tc, JaxFasterRCNN(jcfg), vnp


def _port_model(tc, vnp):
    m = FasterRCNN(tc)
    m.load_state_dict(from_flax_numpy(vnp), strict=True)
    return m


class TestFreeze:
    @pytest.mark.parametrize("freeze,modules", [((1, 2, 3), ()), ((2, 3), ("rpn_head",)),
                                                ((), ("backbone",))])
    def test_param_labels_name_by_name(self, r50, freeze, modules):
        _, tc, _, vnp = r50
        want = _flat(jfreeze.param_labels(vnp["params"], "resnet50", freeze, modules))
        names = _flax_names(vnp["params"])
        got = tfreeze.param_labels(_port_model(tc, vnp), "resnet50", freeze, modules)
        assert set(got) == set(names)
        assert {n: got[n] for n in got} == {n: want[names[n]] for n in got}
        assert "train" in got.values() and "frozen" in got.values()

    def test_frozen_prefix_stage_and_decay_mask(self, r50):
        for args in [((1, 2, 3),), ((2, 3),), ((1, 3),), ((),), ((), ("backbone",))]:
            assert tfreeze.frozen_prefix_stage("resnet50", *args) == \
                jfreeze.frozen_prefix_stage("resnet50", *args)
        _, tc, _, vnp = r50
        want = _flat(jfreeze.decay_mask(vnp["params"]))
        names = _flax_names(vnp["params"])
        got = tfreeze.decay_mask(_port_model(tc, vnp))
        assert got == {n: want[names[n]] for n in got}

    @pytest.mark.parametrize("kind", ["sgd", "adam"])
    def test_optimizer_state_is_created_at_the_first_step(self, kind):
        """No state until the first step; then one entry per trainable
        tensor, made like the parameter as it is then: a model converted
        after the optimizer was built (here to f64; to the card in
        make_joint_train_step) keeps working."""
        model = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.Linear(4, 2))
        opt = tfreeze.make_optimizer(model, "resnet50", (), 0.1, optimizer=kind)
        assert opt.state == {}
        model.double()
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        assert set(opt.state) == {n for n, _ in model.named_parameters()}
        assert all(t.dtype == torch.float64 for st in opt.state.values() for t in st.values())

    @pytest.mark.parametrize("kind", ["sgd", "adam"])
    def test_optimizer_matches_optax(self, r50, rng, kind):
        """Weight decay before the clip, both over the trainable leaves only,
        then SGD (optax's trace starts at zero, so its first step is
        trace = g, which is torch's first momentum buffer) or Adam; two
        steps, so the momentum and the moments count."""
        _, tc, _, vnp = r50
        params = vnp["params"]
        lr = tschedule.schedule_from_phases([(1, 0.5), (5, 0.2)])
        jlr = jschedule.schedule_from_phases([(1, 0.5), (5, 0.2)])
        tx = jfreeze.make_optimizer(params, "resnet50", (1, 2, 3), jlr, optimizer=kind,
                                    weight_decay=1e-4, clip_grad_norm=1.0)
        state = tx.init(params)
        update = jax.jit(tx.update)
        model = _port_model(tc, vnp)
        opt = tfreeze.make_optimizer(model, "resnet50", (1, 2, 3), lr, optimizer=kind,
                                     weight_decay=1e-4, clip_grad_norm=1.0)
        names = _flax_names(params)
        named = dict(model.named_parameters())
        jp = params
        for _ in range(2):
            grads = jax.tree_util.tree_map(
                lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.1, jp)
            upd, state = update(grads, state, jp)
            jp = optax.apply_updates(jp, upd)
            fg = _flat(grads)
            for n, p in named.items():
                g = fg[names[n]]
                p.grad = _t(g.transpose(3, 2, 0, 1) if g.ndim == 4 else g.T if g.ndim == 2
                            else g) if p.requires_grad else None
            opt.step()
        want = from_flax_numpy({"params": jax.tree_util.tree_map(np.asarray, jp)})
        before = from_flax_numpy({"params": params})
        for n, p in named.items():
            if opt.labels[n] == "frozen":
                assert not p.requires_grad and torch.equal(p.detach(), before[n]), n
            else:
                delta = (want[n] - before[n]).abs().max().item()
                assert delta > 0, n
                np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0,
                                           atol=1e-4 * delta, err_msg=n)

    def test_schedule_matches_optax(self):
        phases = tschedule.phases_from_str("3:1e-3,2:1e-4,4:5e-5")
        assert phases == jschedule.phases_from_str("3:1e-3,2:1e-4,4:5e-5")
        assert tschedule.total_iterations(phases) == jschedule.total_iterations(phases) == 9
        t, j = tschedule.schedule_from_phases(phases), jschedule.schedule_from_phases(phases)
        _eq(np.float32([t(s) for s in range(12)]), [j(s) for s in range(12)])
        assert tschedule.schedule_from_phases([(10, 0.1)])(100) == 0.1


# ---------------------------------------------------------------------------
# the whole joint step
# ---------------------------------------------------------------------------


def jax_draws(keys, cfg, fold: bool = True) -> tpipe.Draws:
    """The draws of a JAX train step's samplers, from its own keys. The
    joint step folds each image's key: fold_in(k, 0) for the RPN sampler
    (split at sampling.py:60), fold_in(k, 1) for the ROI sampler (split at
    sampling.py:99). The RPN and detector steps of the 4-step scheme hand
    the key to the sampler as it is (``fold=False``)."""
    n = cfg.conv_h * cfg.conv_w * cfg.anchors.num_anchors
    k, r = cfg.rpn.train_post_nms, cfg.det.num_rois
    cols = [[] for _ in range(6)]
    for key in keys:
        rpn_key, det_key = ((jax.random.fold_in(key, 0), jax.random.fold_in(key, 1)) if fold
                            else (key, key))
        kp, kn = jax.random.split(rpn_key)
        dp, dn, dr = jax.random.split(det_key, 3)
        for col, x in zip(cols, (_uniform(kp, n), _uniform(kn, n), _uniform(dp, k),
                                 _uniform(dn, k)) + _bits(dr, r)):
            col.append(x)
    return tpipe.Draws(*(_t(np.stack(c)) for c in cols))


STEPS = 2


def bias_only_rpn(vnp, num_anchors):
    """The RPN's 1x1 outputs made of their biases at the start (weights
    zero). The RPN's 3x3 conv runs in bf16 in both packages whatever the
    compute dtype (detector.py:62), and each framework rounds its bf16
    backward differently; with random 1x1 weights that rounding enters
    stage 4's gradient, so the parameters could be held only to bf16
    precision. From these weights step 1's backbone gradient comes from the
    f32 detector branch alone, and step 2's RPN share is small."""
    rpn = vnp["params"]["rpn_head"]
    for name, width, span in (("rpn_out_cls", num_anchors, 1.0),
                              ("rpn_out_bbreg", 4 * num_anchors, 0.3)):
        rpn[name]["kernel"] = np.zeros_like(rpn[name]["kernel"])
        rpn[name]["bias"] = np.linspace(-span, span, width).astype(np.float32)
    return vnp


@pytest.fixture(scope="module")
def joint(r50):
    """Both packages' joint steps, two steps each from the same weights,
    batch and draws, from two sets of weights: the seeded init ("random")
    and the same with bias-only RPN outputs (:func:`bias_only_rpn`).
    Returns {set: (optimizer, params before, JAX metrics, port metrics,
    [(JAX params, port params) after each step], [names with a .grad])}."""
    jcfg, tc, model, vnp = r50
    kw = dict(weight_decay=1e-4, clip_grad_norm=10.0)
    tx = jfreeze.make_optimizer(vnp["params"], "resnet50", jcfg.model.freeze_blocks, 0.02, **kw)
    step = jax.jit(jpipe.make_joint_train_step(jcfg, model, tx, vnp["batch_stats"]))
    batch = tiny_batch(jcfg, b=2, seed=4)
    batch["image"] = jnp.asarray(np.random.RandomState(4).randint(
        0, 256, batch["image"].shape).astype(np.uint8))
    tbatch = {k: np.array(v) for k, v in batch.items()}
    out = {}
    sets = {"random": vnp,
            "bias_rpn": bias_only_rpn(jax.tree_util.tree_map(np.copy, vnp),
                                      tc.anchors.num_anchors)}
    for label, weights in sets.items():
        params = weights["params"]
        state = jpipe.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
        tmodel = _port_model(tc, weights)
        opt = tfreeze.make_optimizer(tmodel, "resnet50", tc.model.freeze_blocks, 0.02, **kw)
        tstep = tpipe.make_joint_train_step(tc, tmodel, opt, device="cpu")
        before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
        want, got, after, grads_seen = [], [], [], []
        for i in range(STEPS):
            keys = jax.random.split(jax.random.PRNGKey(10 + i), 2)
            state, m = step(state, batch, keys)
            want.append({k: np.asarray(v) for k, v in m.items()})
            got.append({k: v.numpy() for k, v in tstep(tbatch, jax_draws(keys, tc)).items()})
            grads_seen.append({n for n, p in tmodel.named_parameters() if p.grad is not None})
            after.append((from_flax_numpy({"params": jax.tree_util.tree_map(
                np.asarray, state.params)}),
                {n: p.detach().clone() for n, p in tmodel.named_parameters()}))
        out[label] = (opt, before, want, got, after, grads_seen)
    return out


class TestJointStep:
    @pytest.mark.parametrize("weights", ["random", "bias_rpn"])
    def test_metrics_match_jax(self, joint, weights):
        _, _, want, got, _, _ = joint[weights]
        for w, g in zip(want, got):
            assert int(g["num_valid_images"]) == int(w["num_valid_images"]) == 2
            for k in ("rpn_cls", "rpn_reg", "det_cls", "det_reg", "loss"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
        assert got[0]["det_reg"] > 0 and got[0]["rpn_reg"] > 0

    def test_trainable_params_match_jax_after_each_step(self, joint):
        """Within a share of each parameter's largest change max|delta|,
        from the bias-only RPN weights (:func:`bias_only_rpn`): 1e-3 (8.4e-4
        measured), for f32 sums in other orders, ReLUs that flip at that
        noise and the rounding of p + delta; 2e-2 for the RPN's bf16 3x3
        conv (1.2e-2 measured), whose output and gradient take one bf16
        rounding that flips with the order of the f32 sums beneath it."""
        opt, before, _, _, after, _ = joint["bias_rpn"]
        for jparams, port in after:
            for n, lab in opt.labels.items():
                if lab != "train":
                    continue
                delta = (jparams[n] - before[n]).abs().max().item()
                tol = 2e-2 if n.startswith("rpn_head.rpn_conv1.") else 1e-3
                np.testing.assert_allclose(port[n].numpy(), jparams[n].numpy(), rtol=0,
                                           atol=tol * delta, err_msg=n)
        moved = [n for n, lab in opt.labels.items()
                 if lab == "train" and not torch.equal(after[-1][1][n], before[n])]
        assert len(moved) == sum(lab == "train" for lab in opt.labels.values())

    @pytest.mark.parametrize("weights", ["random", "bias_rpn"])
    def test_frozen_params_bit_identical_and_without_grad(self, joint, weights):
        opt, before, _, _, after, grads_seen = joint[weights]
        frozen = [n for n, lab in opt.labels.items() if lab == "frozen"]
        assert any(n.startswith("backbone.res3") for n in frozen)
        for n in frozen:
            assert torch.equal(after[-1][1][n], before[n]), n
        for seen in grads_seen:
            assert not any(n.startswith(("backbone.conv1", "backbone.res2", "backbone.res3"))
                           for n in seen)
            assert not any(".bn" in n or n.startswith("backbone.bn") for n in seen)
            assert "backbone.res4a.res4a_branch2a.weight" in seen

    def test_stem_trains_when_not_frozen(self, r50):
        """freeze_blocks=() leaves the stem trainable: its gradient goes
        through the stem kernel's autograd wrapper and the optimizer moves
        it (on the CPU, the wrapper's plain version)."""
        _, tc, _, vnp = r50
        tc0 = tc.replace(model=dataclasses.replace(tc.model, freeze_blocks=()))
        model = _port_model(tc0, vnp)
        opt = tfreeze.make_optimizer(model, "resnet50", (), 1e-2)
        step = tpipe.make_joint_train_step(tc0, model, opt, device="cpu")
        w0 = model.backbone.conv1.weight.detach().clone()
        batch = {k: np.array(v) for k, v in tiny_batch(tiny_train_config(), b=1).items()}
        step(batch, torch.Generator().manual_seed(0))
        assert model.backbone.conv1.weight.grad is not None
        assert not torch.equal(model.backbone.conv1.weight.detach(), w0)


def test_train_step_runs_on_cuda_unless_asked_for_the_cpu(r50, monkeypatch):
    _, tc, _, vnp = r50
    model = _port_model(tc, vnp)
    opt = tfreeze.make_optimizer(model, "resnet50", tc.model.freeze_blocks, 1e-3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.make_joint_train_step(tc, model, opt)
    tpipe.make_joint_train_step(tc, model, opt, device="cpu")  # the tests' way
