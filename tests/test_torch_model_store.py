"""Port parity: the model zoo's offline weight store
(``gluon.model_zoo.model_store``), as ``tests/test_model_store.py`` holds
the JAX package's: the ``{name}-{hash}.params`` layout, the sha1 check,
the index that outlives the process, ``purge``; and
``get_model(..., pretrained=True, root=...)`` of the port on a store
filled from a JAX-saved parameter file gives the JAX network's output.
Nothing is downloaded.
"""
from __future__ import annotations

import os

import numpy as onp
import pytest

from gluon_parity import CONV_TOL, jax_mx, port_mx

from mxnet_tpu_torch.gluon.model_zoo import model_store
from mxnet_tpu_torch.gluon.model_zoo.vision import get_model

DATA = os.path.join(os.path.dirname(__file__), "data",
                    "squeezenet1.1_tiny.params")


def _probe():
    return onp.linspace(-1, 1, 1 * 3 * 64 * 64,
                        dtype="float32").reshape(1, 3, 64, 64)


def test_publish_and_resolve(tmp_path):
    root = str(tmp_path / "models")
    dst = model_store.publish("squeezenet1.1", DATA, root=root)
    sha = model_store._sha1_of(DATA)
    assert dst.endswith("squeezenet1.1-%s.params" % sha[:8])
    assert os.path.exists(dst)
    assert model_store.get_model_file("squeezenet1.1", root=root) == dst
    assert model_store.short_hash("squeezenet1.1", root=root) == sha[:8]


def test_hash_check_detects_corruption(tmp_path):
    root = str(tmp_path / "models")
    dst = model_store.publish("squeezenet1.1", DATA, root=root)
    with open(dst, "r+b") as f:
        f.seek(100)
        f.write(b"\x00corrupt\x00")
    with pytest.raises(ValueError, match="checksum mismatch"):
        model_store.get_model_file("squeezenet1.1", root=root)
    with port_mx().Context("cpu"), pytest.raises(ValueError,
                                                 match="checksum"):
        get_model("squeezenet1.1", classes=8, pretrained=True, root=root)


def test_missing_model_raises_with_publish_hint(tmp_path):
    model_store._model_sha1.pop("no_such_model", None)
    with pytest.raises(ValueError, match="publish"):
        model_store.get_model_file("no_such_model", root=str(tmp_path))
    root = str(tmp_path / "models")
    model_store.publish("squeezenet1.1", DATA, root=root)
    os.remove(model_store.get_model_file("squeezenet1.1", root=root))
    with pytest.raises(ValueError, match="missing"):
        model_store.get_model_file("squeezenet1.1", root=root)


def test_index_survives_fresh_process_state(tmp_path):
    root = str(tmp_path / "models")
    model_store.publish("squeezenet1.1", DATA, root=root)
    model_store._model_sha1.clear()
    path = model_store.get_model_file("squeezenet1.1", root=root)
    assert os.path.exists(path)


def test_purge(tmp_path):
    root = str(tmp_path / "models")
    model_store.publish("squeezenet1.1", DATA, root=root)
    model_store.purge(root)
    assert not [f for f in os.listdir(root) if f.endswith(".params")]


def test_store_format_is_the_jax_packages(tmp_path):
    from mxnet_tpu.gluon.model_zoo import model_store as jstore
    root = str(tmp_path / "models")
    jstore.publish("squeezenet1.1", DATA, root=root)
    model_store._model_sha1.clear()
    assert model_store.get_model_file("squeezenet1.1", root=root) == \
        jstore.get_model_file("squeezenet1.1", root=root)


@pytest.mark.parametrize("name,shape", [
    ("squeezenet1.1", (1, 3, 64, 64)),
    ("resnet18_v1", (2, 3, 32, 32)),
])
def test_pretrained_loads_a_jax_saved_file(name, shape, tmp_path):
    jmx, tmx = jax_mx(), port_mx()
    x = (onp.random.default_rng(5).standard_normal(shape)
         .astype("float32"))
    if name == "squeezenet1.1":
        params = DATA                    # the JAX package's committed file
    else:
        jnet = jmx.gluon.model_zoo.vision.get_model(name, classes=8)
        jnet.initialize(jmx.init.Xavier())
        jnet(jmx.np.array(x))
        params = str(tmp_path / "jax.params")
        jnet.save_parameters(params)
        params = params if os.path.exists(params) else params + ".npz"
    root = str(tmp_path / "models")
    model_store.publish(name, params, root=root)
    jnet = jmx.gluon.model_zoo.vision.get_model(
        name, classes=8, pretrained=True, root=root)
    with tmx.Context("cpu"):
        tnet = tmx.gluon.model_zoo.vision.get_model(
            name, classes=8, pretrained=True, root=root)
        got = tnet(tmx.np.array(x)).asnumpy()
    want = jnet(jmx.np.array(x)).asnumpy()
    # CONV_TOL: the same weights, fp32 on both sides; each convolution
    # sums hundreds of products an element, in another order in XLA
    onp.testing.assert_allclose(got, want, **CONV_TOL)
