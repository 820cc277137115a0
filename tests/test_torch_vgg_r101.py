"""The port's VGG16 and ResNet-101 models against the Flax models, on the CPU.

Each Flax model at tiny_config shapes in float32 (JAX's init, with every
bias, batch norm and channel scale redrawn from a numpy seed so that each
leaf's conversion shows) is carried into the port through
utils/convert.from_flax_numpy; both then run on the same numpy inputs.
ResNet-101's stem runs the JAX package's Pallas kernel in interpret mode.
Tolerances are relative to the largest |value| of the reference
(tests/test_torch_models.REL_TOL). Detection is in
tests/test_torch_vgg_r101_detect.py.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faster_rcnn_tpu.models.detector import FasterRCNN as JaxFasterRCNN
from faster_rcnn_tpu.models.detector import init_model as jax_init_model
from faster_rcnn_tpu.parallel import freeze as jfreeze
from faster_rcnn_tpu_torch.models import layers as tlayers
from faster_rcnn_tpu_torch.models.detector import FasterRCNN, init_model
from faster_rcnn_tpu_torch.models.heads import VggDetHead
from faster_rcnn_tpu_torch.models.vgg import VGG16Backbone, vgg_param_block
from faster_rcnn_tpu_torch.parallel import freeze as tfreeze
from faster_rcnn_tpu_torch.utils.convert import from_flax_numpy
from tests.test_torch_models import REL_TOL, _close, port_config, redraw_norm_layers
from tests.test_torch_train import _flat, _flax_names
from tests.test_train_step import tiny_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def f32_config(network: str):
    """tiny_config(network) in float32; the JAX side's stem and RoI align
    through their Pallas kernels in interpret mode."""
    cfg = tiny_config(network)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype="float32",
                                  conv1_impl="pallas_v2_interpret"),
        det=dataclasses.replace(cfg.det, roi_align_impl="pallas_interpret"))


def redraw(variables_np, seed: int = 0):
    """redraw_norm_layers, then seeded channel scales (scale 0.5-1.5, bias
    normal 0.1) and every conv and dense bias (normal 0.05), which Flax
    inits to 1 and 0."""
    rng = np.random.RandomState(seed + 1)

    def draw(path, x):
        keys = [getattr(p, "key", "") for p in path]
        if keys[0] != "params" or keys[-2].startswith("bn"):
            return x
        if keys[-2].startswith("scale"):
            return (rng.uniform(0.5, 1.5, x.shape) if keys[-1] == "scale"
                    else rng.normal(0.0, 0.1, x.shape)).astype(np.float32)
        if keys[-1] == "bias":
            return rng.normal(0.0, 0.05, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(draw, redraw_norm_layers(variables_np, seed))


def build(network: str, seed: int = 0):
    """(jax cfg, port cfg, flax model, numpy variables, port model)."""
    jcfg = f32_config(network)
    model, variables = jax_init_model(jax.random.PRNGKey(seed), jcfg)
    vnp = redraw(jax.tree_util.tree_map(np.asarray, variables), seed)
    tc = port_config(jcfg)
    tmodel = FasterRCNN(tc)
    tmodel.load_state_dict(from_flax_numpy(vnp), strict=True)
    return jcfg, tc, model, vnp, tmodel.eval()


@pytest.fixture(scope="module")
def vgg():
    return build("vgg16")


@pytest.fixture(scope="module")
def r101():
    return build("resnet101")


def _pooled(rng, c):
    return np.abs(rng.standard_normal((2, 3, 7, 7, c))).astype(np.float32)


def _compare_det_head(pair, pooled):
    _, _, model, vnp, tmodel = pair
    want = model.apply(vnp, jnp.asarray(pooled), method=JaxFasterRCNN.det_head)
    with torch.no_grad():
        got = tmodel.det_head(torch.tensor(pooled))
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape and g.dtype == torch.float32
        _close(g.numpy(), w)


class TestVGG16:
    def test_backbone(self, vgg, rng):
        _, _, model, vnp, tmodel = vgg
        x = (rng.standard_normal((2, 64, 96, 3)) * 50).astype(np.float32)
        want = model.apply(vnp, jnp.asarray(x), method=JaxFasterRCNN.backbone)
        with torch.no_grad():
            got = tmodel.backbone(torch.tensor(x))
        assert tuple(got.shape) == (2, 4, 6, 512)
        _close(got.numpy(), want)

    def test_run_stages_keeps_the_frozen_prefix_out_of_autograd(self, vgg, rng):
        """Blocks 1..k without autograd then k+1..5: the forward's output,
        and a backward that reaches block k+1 and nothing below it."""
        _, _, _, _, tmodel = vgg
        bb = tmodel.backbone
        x = torch.tensor((rng.standard_normal((1, 32, 48, 3)) * 50).astype(np.float32))
        for k in (0, 2, 5):
            bb.zero_grad(set_to_none=True)
            mid = bb.run_stages(x, 1, k, k)
            assert mid.requires_grad == (k == 0 and x.requires_grad)
            out = bb.run_stages(mid, k + 1, bb.last_stage, k)
            with torch.no_grad():
                torch.testing.assert_close(out, bb(x), rtol=0, atol=0)
            if k == 5:
                assert not out.requires_grad
                continue
            out.sum().backward()
            blocks = {vgg_param_block(n.split(".")) for n, p in bb.named_parameters()
                      if p.grad is not None}
            assert blocks == set(range(k + 1, 6))

    def test_det_head(self, vgg, rng):
        _compare_det_head(vgg, _pooled(rng, 512))

    def test_det_head_flattens_each_roi_in_nhwc_order(self, rng):
        """fc1 reads a pooled ROI as Flax's ``reshape(n, -1)`` does: row
        (i * 7 + j) * 512 + c of its kernel weighs cell (i, j), channel c."""
        head = VggDetHead(6, dtype=torch.float32)
        seen = []
        head.fc1.register_forward_hook(lambda m, a, out: seen.append(a[0]))
        pooled = torch.tensor(rng.standard_normal((2, 3, 7, 7, 512)).astype(np.float32))
        head(pooled)
        torch.testing.assert_close(seen[0], pooled.reshape(6, 25088), rtol=0, atol=0)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_dense_matches_flax_dense(self, rng, dtype):
        """The product and the bias add each in the compute dtype (bf16:
        within one rounding of the result, 1e-2 of max|ref|)."""
        x = rng.standard_normal((5, 300)).astype(np.float32)
        p = {"kernel": (rng.standard_normal((300, 40)) * 0.05).astype(np.float32),
             "bias": rng.standard_normal(40).astype(np.float32)}
        jdt = getattr(jnp, dtype)
        want = fnn.Dense(40, dtype=jdt, param_dtype=jnp.float32).apply({"params": p},
                                                                        jnp.asarray(x))
        dense = tlayers.Dense(300, 40, dtype=getattr(torch, dtype))
        dense.load_state_dict({"weight": torch.tensor(p["kernel"].T),
                               "bias": torch.tensor(p["bias"])})
        with torch.no_grad():
            got = dense(torch.tensor(x))
        assert got.dtype == getattr(torch, dtype)
        _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
               REL_TOL if dtype == "float32" else 1e-2)


class TestResNet101:
    def test_backbone_through_the_pallas_stem(self, r101, rng):
        _, _, model, vnp, tmodel = r101
        x = (rng.standard_normal((2, 64, 96, 3)) * 50).astype(np.float32)
        want = model.apply(vnp, jnp.asarray(x), method=JaxFasterRCNN.backbone)
        with torch.no_grad():
            got = tmodel.backbone(torch.tensor(x))
        assert tuple(got.shape) == (2, 4, 6, 1024)
        _close(got.numpy(), want)

    def test_stage5_head(self, r101, rng):
        _compare_det_head(r101, _pooled(rng, 1024))

    def test_caffe_layout(self, r101):
        """Bias-free convs, a channel scale after every batch norm, and
        blocks a, b1..b3 in stage 3 and a, b1..b22 in stage 4."""
        _, _, _, _, tmodel = r101
        names = set(tmodel.state_dict())
        assert "backbone.conv1.bias" not in names and "backbone.scale_conv1.scale" in names
        assert not any(n.endswith(".bias") and n.split(".")[-2].startswith(("res", "conv1"))
                       for n in names)
        bns = {n.replace(".bn", ".scale") for n in names if ".bn" in n and n.endswith(".scale")}
        assert bns <= names and len(bns) == 104  # conv1 + 33 blocks x 3 + 4 shortcuts + stage 5
        blocks = {n.split(".")[1] for n in names if n.startswith("backbone.res")}
        assert {f"res3b{i}" for i in range(1, 4)} | {"res4b22", "res4a"} <= blocks
        assert len(blocks) == 3 + 4 + 23 and "res4f" not in blocks


class TestFreezeRules:
    @pytest.mark.parametrize("network", ["vgg16", "resnet101"])
    @pytest.mark.parametrize("freeze,modules", [((1, 2), ()), ((1, 2, 3), ("det_head",)),
                                                ((), ("rpn_head",)),
                                                ((1, 2, 3, 4, 5), ("det_head", "backbone"))])
    def test_param_labels_name_by_name(self, vgg, r101, network, freeze, modules):
        _, _, _, vnp, tmodel = vgg if network == "vgg16" else r101
        want = _flat(jfreeze.param_labels(vnp["params"], network, freeze, modules))
        names = _flax_names(vnp["params"])
        got = tfreeze.param_labels(tmodel, network, freeze, modules)
        assert set(got) == set(names)
        assert got == {n: want[names[n]] for n in got}

    def test_vgg_blocks_and_frozen_prefix(self):
        assert vgg_param_block(["backbone", "block4_conv2", "weight"]) == 4
        assert vgg_param_block(["rpn_head", "rpn_conv1", "weight"]) is None
        for args in [((1, 2),), ((1, 2, 3, 4, 5),), ((2, 3),), ((),), ((), ("backbone",))]:
            assert tfreeze.frozen_prefix_stage("vgg16", *args) == \
                jfreeze.frozen_prefix_stage("vgg16", *args)
        assert tfreeze.frozen_prefix_stage("vgg16", (), ("backbone",)) == VGG16Backbone.last_stage


class TestConvert:
    @pytest.mark.parametrize("network", ["vgg16", "resnet50", "resnet101"])
    def test_every_leaf_maps_by_name(self, vgg, r101, network):
        """Every leaf of the Flax tree lands on the port's parameter or
        buffer of the same path: the state dicts have the same names and
        shapes, and the layouts turn (conv HWIO -> OIHW, dense (in, out) ->
        (out, in))."""
        if network == "resnet50":
            jcfg = tiny_config("resnet50")
            _, variables = jax_init_model(jax.random.PRNGKey(0), jcfg)
            vnp = jax.tree_util.tree_map(np.asarray, variables)
            tmodel = FasterRCNN(port_config(jcfg))
        else:
            _, _, _, vnp, tmodel = vgg if network == "vgg16" else r101
        sd = from_flax_numpy(vnp)
        ref = tmodel.state_dict()
        assert set(sd) == set(ref)
        assert all(sd[n].shape == ref[n].shape for n in sd)
        p = vnp["params"]
        if network == "vgg16":
            kernel = p["backbone"]["block3_conv2"]["kernel"]  # HWIO
            np.testing.assert_array_equal(sd["backbone.block3_conv2.weight"].numpy(),
                                          kernel.transpose(3, 2, 0, 1))
            np.testing.assert_array_equal(sd["det_head.fc1.weight"].numpy(),
                                          p["det_head"]["fc1"]["kernel"].T)
            np.testing.assert_array_equal(sd["det_head.fc2.bias"].numpy(),
                                          p["det_head"]["fc2"]["bias"])
            assert sd["det_head.fc1.weight"].shape == (4096, 25088)
        if network == "resnet101":
            leaf = p["backbone"]["res4b22"]["scale4b22_branch2b"]
            np.testing.assert_array_equal(sd["backbone.res4b22.scale4b22_branch2b.scale"].numpy(),
                                          leaf["scale"])
            np.testing.assert_array_equal(sd["backbone.res4b22.scale4b22_branch2b.bias"].numpy(),
                                          leaf["bias"])
            assert "bias" not in p["backbone"]["res4b22"]["res4b22_branch2b"]
            np.testing.assert_array_equal(sd["backbone.scale_conv1.scale"].numpy(),
                                          p["backbone"]["scale_conv1"]["scale"])


class TestInit:
    @pytest.mark.parametrize("network", ["vgg16", "resnet101"])
    def test_init_model_seeded_and_named_like_flax(self, vgg, r101, network):
        _, tc, _, vnp, _ = vgg if network == "vgg16" else r101
        a = init_model(3, tc, device="cpu").state_dict()
        b = init_model(3, tc, device="cpu").state_dict()
        sd = from_flax_numpy(vnp)
        assert set(a) == set(sd)
        for k in a:
            assert a[k].shape == sd[k].shape, k
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        del b, sd
        first = "backbone.block1_conv1.weight" if network == "vgg16" else "backbone.conv1.weight"
        c = init_model(4, tc, device="cpu").state_dict()
        assert not torch.equal(a[first], c[first])
        # lecun normal (Flax's default) for the convs and VGG's fc layers
        name, fan_in = (("det_head.fc1.weight", 25088) if network == "vgg16"
                        else ("backbone.res4b22.res4b22_branch2b.weight", 9 * 256))
        std = a[name].std().item()
        assert abs(std - fan_in ** -0.5) < 0.05 * fan_in ** -0.5
        assert a[name].abs().max() <= 2 * fan_in ** -0.5 / 0.8796
