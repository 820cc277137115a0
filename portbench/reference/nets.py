"""ResNet-50 (C4: stages 1-4 to stride 16, stage 5 on the pooled ROIs, frozen
batch norm) and VGG16 (13 convs to conv5_3, fc6 and fc7 on the ROIs), the
RPN head and the detector's outputs, as plain functions of a dict of
weights in float32.

He et al., arXiv:1512.03385 Table 1 (ResNet-50, the stride on the first
1x1 of a stage, as the Keras model puts it); Simonyan & Zisserman,
arXiv:1409.1556 config D; Ren et al., arXiv:1506.01497 (RPN: a 3x3 conv
of 512, 1x1 objectness and box outputs). Weights are keyed by the Keras
layer names: ``backbone.res4a.res4a_branch2a.weight``. Activations are
NCHW inside a network and NHWC where a map leaves it.

``prec`` is the arithmetic of every convolution and matrix product:
``"f32"`` (TF32 off) or ``"fp8"``, both operands rounded to float8 e4m3
with one scale per tensor, as an fp8 GEMM takes them, and the product
accumulated in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

RESNET50_STAGES = ((2, "abc", (64, 64, 256), 1), (3, "abcd", (128, 128, 512), 2),
                   (4, "abcdef", (256, 256, 1024), 2))
VGG16_BLOCKS = ((1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512))
E4M3_MAX = 448.0


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 at one scale per tensor; the gradient passes as
    it is (the rounding's straight-through estimate)."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp_min(1e-30)
        s = amax / E4M3_MAX
        return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s

    @staticmethod
    def backward(ctx, g):
        return g


def _q(x, prec: str):
    return _Fp8.apply(x) if prec == "fp8" else x


def conv(x, w, b, stride: int, pad, prec: str):
    """NCHW x OIHW; ``pad`` is (left, right, top, bottom)."""
    if any(pad):
        x = F.pad(x, pad)
    return F.conv2d(_q(x, prec), _q(w, prec), b, stride)


def linear(x, w, b, prec: str):
    return F.linear(_q(x, prec), _q(w, prec), b)


def _same(k: int):
    p = (k - 1) // 2
    return (p, p, p, p)


def frozen_bn(x, W, name: str, eps: float = 1e-5):
    inv = W[name + ".scale"] / torch.sqrt(W[name + ".var"] + eps)
    mean, bias = W[name + ".mean"][:, None, None], W[name + ".bias"][:, None, None]
    return (x - mean) * inv[:, None, None] + bias


def _bottleneck(x, W, pre: str, stage: int, blk: str, stride: int, project: bool, prec: str):
    def branch(y, s, k, st):
        c = f"{pre}res{stage}{blk}.res{stage}{blk}_branch{s}"
        y = conv(y, W[c + ".weight"], W[c + ".bias"], st, _same(k), prec)
        return frozen_bn(y, W, f"{pre}res{stage}{blk}.bn{stage}{blk}_branch{s}")

    y = F.relu(branch(x, "2a", 1, stride))
    y = F.relu(branch(y, "2b", 3, 1))
    y = branch(y, "2c", 1, 1)
    return F.relu(y + (branch(x, "1", 1, stride) if project else x))


def resnet50_stages(x, W, first: int, last: int, prec: str):
    """Stages ``first``..``last`` of the backbone on NCHW ``x``. Stage 1:
    the 7x7/2 stem (SAME: 2 before, 3 after), its batch norm, ReLU and a
    3x3/2 VALID max-pool."""
    if first <= 1 <= last:
        x = conv(x, W["backbone.conv1.weight"], W["backbone.conv1.bias"], 2, (2, 3, 2, 3), prec)
        x = F.max_pool2d(F.relu(frozen_bn(x, W, "backbone.bn_conv1")), 3, 2)
    for stage, blocks, _, stride in RESNET50_STAGES:
        if first <= stage <= last:
            for i, blk in enumerate(blocks):
                x = _bottleneck(x, W, "backbone.", stage, blk, stride if i == 0 else 1, i == 0,
                                prec)
    return x


def resnet50_head(pooled, W, num_classes: int, prec: str):
    """(N, P, P, 1024) pooled ROIs -> (class logits (N, C), boxes (N, 4(C-1))):
    stage 5 (three stride-1 bottlenecks to 2048), the P x P mean, then the
    two dense outputs."""
    x = pooled.permute(0, 3, 1, 2)
    for i, blk in enumerate("abc"):
        x = _bottleneck(x, W, "det_head.stage5.", 5, blk, 1, i == 0, prec)
    return _outputs(x.mean((2, 3)), W, num_classes, prec)


def vgg16_stages(x, W, first: int, last: int, prec: str):
    """Blocks ``first``..``last``: 3x3 SAME convs with ReLU, a 2x2/2 max-pool
    after blocks 1-4."""
    for blk, n, _ in VGG16_BLOCKS:
        if first <= blk <= last:
            for j in range(1, n + 1):
                c = f"backbone.block{blk}_conv{j}"
                x = F.relu(conv(x, W[c + ".weight"], W[c + ".bias"], 1, (1, 1, 1, 1), prec))
            if blk < 5:
                x = F.max_pool2d(x, 2, 2)
    return x


def vgg16_head(pooled, W, num_classes: int, prec: str):
    """(N, P, P, 512) pooled ROIs flattened in (y, x, c) order -> fc6, fc7
    (4096, ReLU) -> the two dense outputs."""
    x = pooled.reshape(pooled.shape[0], -1)
    x = F.relu(linear(x, W["det_head.fc1.weight"], W["det_head.fc1.bias"], prec))
    x = F.relu(linear(x, W["det_head.fc2.weight"], W["det_head.fc2.bias"], prec))
    return _outputs(x, W, num_classes, prec)


def _outputs(x, W, c: int, prec: str):
    cls = linear(x, W[f"det_head.dense_class_{c}.weight"], W[f"det_head.dense_class_{c}.bias"],
                 prec)
    reg = linear(x, W[f"det_head.dense_reg_{c}.weight"], W[f"det_head.dense_reg_{c}.bias"], prec)
    return cls, reg


def rpn_head(feat, W, prec: str):
    """NCHW map -> (objectness logits (B, h, w, A), boxes (B, h, w, 4A))."""
    x = F.relu(conv(feat, W["rpn_head.rpn_conv1.weight"], W["rpn_head.rpn_conv1.bias"], 1,
                    (1, 1, 1, 1), prec))
    cls = conv(x, W["rpn_head.rpn_out_cls.weight"], W["rpn_head.rpn_out_cls.bias"], 1,
               (0, 0, 0, 0), prec)
    reg = conv(x, W["rpn_head.rpn_out_bbreg.weight"], W["rpn_head.rpn_out_bbreg.bias"], 1,
               (0, 0, 0, 0), prec)
    return cls.permute(0, 2, 3, 1), reg.permute(0, 2, 3, 1)


class Network:
    """The backbone's stages and the detector head of one network."""

    def __init__(self, name: str):
        if name not in ("resnet50", "vgg16"):
            raise ValueError(f"no reference for network {name}")
        self.name = name
        self.last_stage = 4 if name == "resnet50" else 5
        self._stages = resnet50_stages if name == "resnet50" else vgg16_stages
        self._head = resnet50_head if name == "resnet50" else vgg16_head

    def stages(self, x, W, first: int, last: int, prec: str):
        return self._stages(x, W, first, last, prec)

    def head(self, pooled, W, num_classes: int, prec: str):
        return self._head(pooled, W, num_classes, prec)

    def block_of(self, name: str):
        """The backbone stage (ResNet) or block (VGG16) a weight lies in,
        for the freeze rule; None outside the backbone's stages."""
        parts = name.split(".")
        if parts[0] != "backbone":
            return None
        p = parts[1]
        if self.name == "vgg16":
            return int(p[5])
        if p in ("conv1", "bn_conv1"):
            return 1
        return int(p[3])


def is_norm(name: str) -> bool:
    return any(p.startswith("bn") for p in name.split("."))


def weight_shapes(network: str, num_classes: int, num_anchors: int) -> dict:
    """Every weight of the detector by name, in a fixed order: conv weights
    OIHW, dense weights (out, in), batch norms' scale, bias, mean, var."""
    out = {}

    def conv_(name, cin, cout, k, bias=True):
        out[name + ".weight"] = (cout, cin, k, k)
        if bias:
            out[name + ".bias"] = (cout,)

    def bn_(name, c):
        for p in ("scale", "bias", "mean", "var"):
            out[f"{name}.{p}"] = (c,)

    def bottlenecks(pre, stage, blocks, filters, cin):
        f1, f2, f3 = filters
        for i, blk in enumerate(blocks):
            ci = cin if i == 0 else f3
            branches = [("2a", ci, f1, 1), ("2b", f1, f2, 3), ("2c", f2, f3, 1)]
            if i == 0:
                branches.append(("1", ci, f3, 1))
            for s, a, b, k in branches:
                conv_(f"{pre}res{stage}{blk}.res{stage}{blk}_branch{s}", a, b, k)
                bn_(f"{pre}res{stage}{blk}.bn{stage}{blk}_branch{s}", b)

    if network == "resnet50":
        conv_("backbone.conv1", 3, 64, 7)
        bn_("backbone.bn_conv1", 64)
        cin = 64
        for stage, blocks, filters, _ in RESNET50_STAGES:
            bottlenecks("backbone.", stage, blocks, filters, cin)
            cin = filters[2]
        feat, head_in = 1024, 2048
    elif network == "vgg16":
        cin = 3
        for blk, n, f in VGG16_BLOCKS:
            for j in range(1, n + 1):
                conv_(f"backbone.block{blk}_conv{j}", cin, f, 3)
                cin = f
        feat, head_in = 512, 4096
    else:
        raise ValueError(f"no reference for network {network}")
    conv_("rpn_head.rpn_conv1", feat, 512, 3)
    conv_("rpn_head.rpn_out_cls", 512, num_anchors, 1)
    conv_("rpn_head.rpn_out_bbreg", 512, 4 * num_anchors, 1)
    if network == "resnet50":
        bottlenecks("det_head.stage5.", 5, "abc", (512, 512, 2048), 1024)
    else:
        out["det_head.fc1.weight"], out["det_head.fc1.bias"] = (4096, 7 * 7 * 512), (4096,)
        out["det_head.fc2.weight"], out["det_head.fc2.bias"] = (4096, 4096), (4096,)
    c = num_classes
    out[f"det_head.dense_class_{c}.weight"], out[f"det_head.dense_class_{c}.bias"] = \
        (c, head_in), (c,)
    out[f"det_head.dense_reg_{c}.weight"], out[f"det_head.dense_reg_{c}.bias"] = \
        (4 * (c - 1), head_in), (4 * (c - 1),)
    return out
