"""The port's Keras h5 import and export (utils/keras_import.py) against
faster_rcnn_tpu's, on the CPU.

For VGG16, ResNet-50 and ResNet-101 (tiny_config shapes; the networks' own
widths): an h5 written by JAX's ``save_keras_h5`` and read by the port's
``load_keras_h5`` gives ``utils/convert.from_flax_numpy`` of the same tree,
and an h5 written by the port and read by JAX's ``load_keras_h5`` gives the
Flax tree; the two writers' files hold the same datasets. Then the layout
facts: the ``model_weights/`` nesting with str names, the unmatched
report, and the raises on ambiguous names.
"""

import os

import h5py
import jax
import numpy as np
import pytest
import torch

from faster_rcnn_tpu.utils import keras_import as jkeras
from faster_rcnn_tpu_torch.models.detector import FasterRCNN, init_model
from faster_rcnn_tpu_torch.utils import keras_import as tkeras
from faster_rcnn_tpu_torch.utils.convert import from_flax_numpy
from tests.test_torch_models import port_config
from tests.test_torch_train import to_flax_numpy
from tests.test_train_step import tiny_config

NETWORKS = ("vgg16", "resnet50", "resnet101")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def drawn_state(tc, seed):
    """A state dict of the network's names and shapes (built on the meta
    device: no init) with every entry drawn from ``seed``, so that no two
    entries share values."""
    with torch.device("meta"):
        shapes = {k: t.shape for k, t in FasterRCNN(tc).state_dict().items()}
    gen = torch.Generator().manual_seed(seed)
    return {k: 0.05 * torch.randn(s, generator=gen) for k, s in shapes.items()}


@pytest.fixture(scope="module", params=NETWORKS)
def net(request):
    """(network, port config, Flax numpy tree with every leaf drawn)."""
    tc = port_config(tiny_config(request.param))
    return request.param, tc, to_flax_numpy(drawn_state(tc, 1))


@pytest.fixture
def h5dir(tmp_path):
    """A directory for the test's h5 files, removed as the test ends (a
    VGG16 file is 0.55 GB)."""
    yield tmp_path
    for f in tmp_path.glob("*.h5"):
        f.unlink()


def _str(name):
    return name.decode() if isinstance(name, bytes) else name


def h5_contents(path):
    """(layer names, {layer: weight names}, {dataset path: array})."""
    out, names = {}, {}
    with h5py.File(path, "r") as f:
        layers = [_str(n) for n in f.attrs["layer_names"]]
        for lname in layers:
            names[lname] = [_str(n) for n in f[lname].attrs["weight_names"]]
            for wn in names[lname]:
                out[f"{lname}/{wn}"] = np.asarray(f[lname][wn])
    return layers, names, out


def test_jax_h5_read_by_the_port_is_from_flax_numpy(net, h5dir):
    _, tc, vnp = net
    path = str(h5dir / "jax.h5")
    written = jkeras.save_keras_h5(vnp["params"], vnp.get("batch_stats", {}), path)
    want = from_flax_numpy(vnp)
    fresh = {k: torch.zeros_like(t) for k, t in want.items()}
    got, loaded, unmatched = tkeras.load_keras_h5(path, fresh)
    assert sorted(loaded) == sorted(written) and unmatched == []
    assert list(got) == list(fresh)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    assert not fresh[k].any()  # the copy, not the argument, changed


def test_port_h5_read_by_jax_is_the_flax_tree(net, h5dir):
    """And the port's file holds JAX's file's layers, weight names and
    arrays."""
    _, _, vnp = net
    port_path, jax_path = str(h5dir / "port.h5"), str(h5dir / "jax.h5")
    written = tkeras.save_keras_h5(from_flax_numpy(vnp), port_path)
    jwritten = jkeras.save_keras_h5(vnp["params"], vnp.get("batch_stats", {}), jax_path)
    assert sorted(written) == sorted(jwritten)
    zeros = jax.tree_util.tree_map(np.zeros_like, vnp)
    params, stats, loaded = jkeras.load_keras_h5(port_path, zeros["params"],
                                                 zeros.get("batch_stats", {}))
    assert sorted(loaded) == sorted(written)
    got = {"params": params, **({"batch_stats": stats} if "batch_stats" in vnp else {})}
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(vnp))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_array_equal(leaf, flat_want[path], err_msg=str(path))
    layers, names, arrays = h5_contents(port_path)
    jlayers, jnames, jarrays = h5_contents(jax_path)
    assert sorted(layers) == sorted(jlayers) and names == jnames
    assert set(arrays) == set(jarrays)
    for k, a in jarrays.items():
        assert arrays[k].dtype == a.dtype and np.array_equal(arrays[k], a), k


def _write_nested(path, layers, as_bytes):
    """A full-model save: weights under ``model_weights/``, names as bytes
    or str."""
    enc = (lambda s: s.encode()) if as_bytes else (lambda s: s)
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")
        for lname, weights in layers.items():
            g = root.create_group(lname)
            g.attrs["weight_names"] = [enc(f"{lname}/{k}:0") for k in weights]
            for k, a in weights.items():
                g.create_dataset(f"{lname}/{k}:0", data=a)
        root.attrs["layer_names"] = [enc(n) for n in layers]


@pytest.mark.parametrize("as_bytes", [True, False])
def test_nested_file_and_the_unmatched_report(h5dir, capsys, as_bytes):
    tc = port_config(tiny_config("resnet50"))
    state = init_model(0, tc, "cpu").state_dict()
    rng = np.random.RandomState(0)
    kernel = rng.normal(size=(1, 1, 256, 64)).astype(np.float32)  # HWIO
    gamma = rng.normal(size=(64,)).astype(np.float32)
    layers = {"res2b_branch2a": {"kernel": kernel, "bias": gamma},
              "bn2b_branch2a": {"gamma": gamma, "beta": gamma + 1, "moving_mean": gamma + 2,
                                "moving_variance": gamma + 3},
              "not_a_layer": {"kernel": kernel},
              "res2c_branch2a": {"kernel": kernel[..., :3]}}  # the shape matches nothing
    path = str(h5dir / "nested.h5")
    _write_nested(path, layers, as_bytes)
    got, loaded, unmatched = tkeras.load_keras_h5(path, state, verbose=True)
    assert loaded == ["res2b_branch2a", "bn2b_branch2a"]
    assert unmatched == ["not_a_layer", "res2c_branch2a"]
    assert "no match for layer not_a_layer" in capsys.readouterr().out
    pre = "backbone.res2b."
    assert torch.equal(got[pre + "res2b_branch2a.weight"],
                       torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
    assert torch.equal(got[pre + "res2b_branch2a.bias"], torch.from_numpy(gamma))
    for leaf, add in (("scale", 0), ("bias", 1), ("mean", 2), ("var", 3)):
        assert torch.equal(got[pre + "bn2b_branch2a." + leaf], torch.from_numpy(gamma + add))
    changed = {k for k in state if not torch.equal(got[k], state[k])}
    assert changed == {pre + "res2b_branch2a." + leaf for leaf in ("weight", "bias")} | {
        pre + "bn2b_branch2a." + leaf for leaf in ("scale", "bias", "mean", "var")}
    # JAX reads the same file into the same layers
    _, _, jloaded = jkeras.load_keras_h5(path, to_flax_numpy(state)["params"],
                                         to_flax_numpy(state)["batch_stats"])
    assert jloaded == loaded


def test_dense_kernels_transpose(h5dir):
    """A dense layer's (in, out) kernel is the port's (out, in) weight, and
    back."""
    state = {"head.fc.weight": torch.zeros(3, 5), "head.fc.bias": torch.zeros(3)}
    kernel = np.arange(15, dtype=np.float32).reshape(5, 3)
    path = str(h5dir / "dense.h5")
    _write_nested(path, {"fc": {"kernel": kernel, "bias": np.ones(3, np.float32)}}, True)
    got, loaded, _ = tkeras.load_keras_h5(path, state)
    assert loaded == ["fc"] and torch.equal(got["head.fc.weight"], torch.from_numpy(kernel.T))
    out = str(h5dir / "back.h5")
    assert tkeras.save_keras_h5(got, out) == ["fc"]
    _, names, arrays = h5_contents(out)
    assert names == {"fc": ["fc/kernel:0", "fc/bias:0"]}
    np.testing.assert_array_equal(arrays["fc/fc/kernel:0"], kernel)


def test_two_modules_claiming_one_layer_raise(h5dir):
    state = {"a.conv.weight": torch.zeros(4, 2, 3, 3), "b.conv.weight": torch.zeros(4, 2, 3, 3)}
    path = str(h5dir / "two.h5")
    _write_nested(path, {"conv": {"kernel": np.ones((3, 3, 2, 4), np.float32)}}, True)
    with pytest.raises(ValueError, match="matches multiple entries"):
        tkeras.load_keras_h5(path, state)
    with pytest.raises(ValueError, match="duplicate module name 'conv'"):
        tkeras.save_keras_h5(state, str(h5dir / "out.h5"))
    assert not os.path.exists(h5dir / "out.h5")
