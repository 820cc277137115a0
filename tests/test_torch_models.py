"""The PyTorch port's ResNet-50 detector against the Flax model.

One Flax ResNet-50 at tiny_config shapes in float32 (built once per module)
is carried into the port through faster_rcnn_tpu_torch.utils.convert; both
then run on the same numpy inputs on the CPU. Batch-norm statistics and
affines are redrawn from a numpy seed first, so the conversion of every
buffer is exercised and activations stay in a range where the comparison
means something. Tolerances are relative to the largest |value| of the
reference: the two frameworks sum the convolutions in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_tpu.models import layers as jlayers
from faster_rcnn_tpu.models.detector import FasterRCNN as JaxFasterRCNN
from faster_rcnn_tpu.models.detector import init_model as jax_init_model
from faster_rcnn_tpu_torch import config as tcfg
from faster_rcnn_tpu_torch.models import layers as tlayers
from faster_rcnn_tpu_torch.models.detector import FasterRCNN, init_model
from faster_rcnn_tpu_torch.utils.convert import from_flax_numpy
from tests.test_train_step import tiny_config

REL_TOL = 1e-4  # of max|reference|, float32 on both sides


def port_config(cfg):
    """The same configuration built from the port's copy of config.py."""
    return tcfg.FasterRcnnConfig(**{
        f.name: getattr(tcfg, type(getattr(cfg, f.name)).__name__)(
            **dataclasses.asdict(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)})


def tiny_r50_config():
    """tiny_config('resnet50') in float32, with the JAX side's Pallas stem
    and RoI-align kernels run by the interpreter."""
    cfg = tiny_config("resnet50")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype="float32",
                                  conv1_impl="pallas_v2_interpret"),
        det=dataclasses.replace(cfg.det, roi_align_impl="pallas_interpret"))


def redraw_norm_layers(variables_np, seed=0):
    """Seeded non-trivial BN statistics and affines (Flax inits them to the
    identity)."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        keys = [getattr(p, "key", "") for p in path]
        if not keys[-2].startswith("bn"):
            return x
        lo_hi = {"scale": (0.3, 0.8), "var": (0.5, 2.0)}
        if keys[-1] in lo_hi:
            return rng.uniform(*lo_hi[keys[-1]], x.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, x.shape).astype(np.float32)  # mean, bias

    return jax.tree_util.tree_map_with_path(draw, variables_np)


def build_pair(seed=0):
    """(jax cfg, port cfg, flax model, numpy variables, port model)."""
    jcfg = tiny_r50_config()
    model, variables = jax_init_model(jax.random.PRNGKey(seed), jcfg)
    vnp = redraw_norm_layers(jax.tree_util.tree_map(np.asarray, variables), seed)
    tcfg_ = port_config(jcfg)
    tmodel = FasterRCNN(tcfg_)
    tmodel.load_state_dict(from_flax_numpy(vnp), strict=True)
    return jcfg, tcfg_, model, vnp, tmodel.eval()


@pytest.fixture(scope="module")
def pair():
    torch.set_num_threads(1)
    return build_pair()


def _close(got, want, rel_tol=REL_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel_tol * scale)


class TestConvert:
    def test_every_leaf_maps_by_name_with_layouts(self, pair):
        _, tc, _, vnp, tmodel = pair
        sd = from_flax_numpy(vnp)
        assert set(sd) == set(tmodel.state_dict())
        k = vnp["params"]["backbone"]["res2a"]["res2a_branch2b"]["kernel"]  # HWIO
        np.testing.assert_array_equal(sd["backbone.res2a.res2a_branch2b.weight"].numpy(),
                                      k.transpose(3, 2, 0, 1))
        d = vnp["params"]["det_head"]["dense_reg_6"]["kernel"]              # (in, out)
        np.testing.assert_array_equal(sd["det_head.dense_reg_6.weight"].numpy(), d.T)
        m = vnp["batch_stats"]["backbone"]["bn_conv1"]["mean"]
        np.testing.assert_array_equal(sd["backbone.bn_conv1.mean"].numpy(), m)

    def test_unknown_leaf_raises(self, pair):
        _, tc, _, _, _ = pair
        with pytest.raises(ValueError):
            from_flax_numpy({"params": {"backbone": {"x": {"gamma": np.ones(3)}}}})

    def test_init_model_seeded_and_named_like_flax(self, pair):
        _, tc, _, vnp, _ = pair
        a = init_model(3, tc, device="cpu").state_dict()
        b = init_model(3, tc, device="cpu").state_dict()
        c = init_model(4, tc, device="cpu").state_dict()
        sd = from_flax_numpy(vnp)
        assert set(a) == set(sd)
        for k in a:
            assert a[k].shape == sd[k].shape, k
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        assert not torch.equal(a["backbone.conv1.weight"], c["backbone.conv1.weight"])
        std = a["backbone.conv1.weight"].std().item()   # lecun normal, fan_in 147
        assert abs(std - (1 / 147) ** 0.5) < 0.1 * (1 / 147) ** 0.5
        assert a["rpn_head.rpn_conv1.weight"].abs().max() <= 0.02  # truncated at 2 sigma


class TestLayers:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_frozen_batchnorm(self, rng, dtype):
        c = 16
        x = (rng.standard_normal((2, 5, 7, c)) * 3).astype(np.float32)
        p = {"scale": rng.uniform(0.5, 2, c), "bias": rng.normal(size=c)}
        s = {"mean": rng.normal(size=c), "var": rng.uniform(0.2, 3, c)}
        p = {k: v.astype(np.float32) for k, v in p.items()}
        s = {k: v.astype(np.float32) for k, v in s.items()}
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        want = jlayers.FrozenBatchNorm(dtype=jdt).apply({"params": p, "batch_stats": s},
                                                        jnp.asarray(x).astype(jdt))
        tdt = getattr(torch, dtype)
        bn = tlayers.FrozenBatchNorm(c, dtype=tdt)
        bn.load_state_dict({k: torch.tensor(v) for k, v in {**p, **s}.items()})
        with torch.no_grad():
            got = bn(torch.tensor(x).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=1e-6, atol=1e-6)

    def test_channel_scale(self, rng):
        c = 8
        x = rng.standard_normal((3, 4, c)).astype(np.float32)
        p = {"scale": rng.uniform(0.5, 2, c).astype(np.float32),
             "bias": rng.normal(size=c).astype(np.float32)}
        want = jlayers.ChannelScale().apply({"params": p}, jnp.asarray(x))
        cs = tlayers.ChannelScale(c)
        cs.load_state_dict({k: torch.tensor(v) for k, v in p.items()})
        with torch.no_grad():
            got = cs(torch.tensor(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


class TestModel:
    def test_backbone_through_the_pallas_stem(self, pair, rng):
        _, _, model, vnp, tmodel = pair
        x = (rng.standard_normal((2, 64, 96, 3)) * 50).astype(np.float32)
        want = model.apply(vnp, jnp.asarray(x), method=JaxFasterRCNN.backbone)
        with torch.no_grad():
            got = tmodel.backbone(torch.tensor(x))
        assert tuple(got.shape) == (2, 4, 6, 1024)
        _close(got.numpy(), want)

    def test_backbone_extent_at_kitti_canvas_arithmetic(self):
        # 608x1504 -> stem 304x752 -> VALID pool 151x375 -> 76x188 -> 38x94
        import torch.nn.functional as F

        x = torch.zeros(1, 1, 304, 752)
        p = F.max_pool2d(x, 3, 2)
        assert tuple(p.shape[2:]) == (151, 375)
        s3 = F.conv2d(p, torch.zeros(1, 1, 1, 1), stride=2)
        s4 = F.conv2d(s3, torch.zeros(1, 1, 1, 1), stride=2)
        assert tuple(s3.shape[2:]) == (76, 188) and tuple(s4.shape[2:]) == (38, 94)

    def test_rpn_head(self, pair, rng):
        """The RPN's 3x3 conv runs in bf16 on both sides whatever the compute
        dtype, so single bf16 roundings of its output (2^-8 relative) reach
        the f32 1x1 outputs: 1e-2 of max|reference|."""
        _, _, model, vnp, tmodel = pair
        feat = np.abs(rng.standard_normal((2, 4, 6, 1024))).astype(np.float32)
        want = model.apply(vnp, jnp.asarray(feat), method=JaxFasterRCNN.rpn)
        with torch.no_grad():
            got = tmodel.rpn(torch.tensor(feat))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            _close(g.numpy(), w, rel_tol=1e-2)

    def test_det_head(self, pair, rng):
        _, _, model, vnp, tmodel = pair
        pooled = np.abs(rng.standard_normal((2, 3, 7, 7, 1024))).astype(np.float32)
        want = model.apply(vnp, jnp.asarray(pooled), method=JaxFasterRCNN.det_head)
        with torch.no_grad():
            got = tmodel.det_head(torch.tensor(pooled))
        for g, w in zip(got, want):
            assert tuple(g.shape) == np.asarray(w).shape
            _close(g.numpy(), w)
