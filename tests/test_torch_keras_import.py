"""Keras HDF5 weights in the port (``flypylib_tpu_torch/io/keras_import.py``):
the six cases of ``tests/test_metrics_and_import.py`` on the port's
modules, and files that cross packages — written by the JAX package's
``save_keras_weights`` and loaded into the port, and the other way round.

Tolerances: a round trip inside one package is exact (the same f32
values); logits across packages, f32, within 1e-4 of max |logit| (convs
summed in other orders), as the port's other f32 model tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from flypylib_tpu.io import keras_import as jk  # noqa: E402
from flypylib_tpu.models import zoo as jzoo  # noqa: E402
from flypylib_tpu_torch.io import keras_import as tk  # noqa: E402
from flypylib_tpu_torch.models import zoo as tzoo  # noqa: E402
from tests.test_torch_bn import _modules  # noqa: E402

torch.set_num_threads(1)


def _states_equal(a: torch.nn.Module, b: torch.nn.Module) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _baseline(features=(4, 6), seed=0):
    return tzoo.baseline_model(features=features, dilations=(1,) * len(features),
                               head_features=8, dtype=torch.float32,
                               seed=seed).module


def test_keras_weight_roundtrip(tmp_path):
    src = _baseline(seed=0)
    path = str(tmp_path / "weights.h5")
    tk.save_keras_weights(path, src)
    dst = _baseline(seed=1)
    assert tk.load_keras_weights(path, dst) is dst
    _states_equal(src, dst)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (1, 12, 12, 12, 1)).astype(np.float32))
    assert torch.equal(src(x), dst(x))
    # the reference's params-tree form of the same call
    tree = tzoo.flax_from_params(_baseline(seed=2).state_dict())["params"]
    loaded = tk.load_keras_weights(path, tree)
    want = tzoo.flax_from_params(src.state_dict())["params"]
    for name in want:
        for leaf in want[name]:
            np.testing.assert_array_equal(loaded[name][leaf], want[name][leaf])


def test_keras_import_shape_mismatch(tmp_path):
    path = str(tmp_path / "w.h5")
    tk.save_keras_weights(path, _baseline(features=(4,)))
    dst = _baseline(features=(6,))
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    with pytest.raises(ValueError, match="shape"):
        tk.load_keras_weights(path, dst)
    for k, v in dst.state_dict().items():  # nothing half-loaded
        assert torch.equal(v, before[k]), k


def test_keras_unet_roundtrip(tmp_path):
    """U-Net (Conv + ConvTranspose interleaving) round-trips by name."""
    src = tzoo.unet(base_features=4, levels=2, convs_per_stage=1, seed=3).module
    path = str(tmp_path / "unet.h5")
    tk.save_keras_weights(path, src)
    dst = tzoo.unet(base_features=4, levels=2, convs_per_stage=1, seed=9).module
    tk.load_keras_weights(path, dst)
    _states_equal(src, dst)


def test_keras_batchnorm_roundtrip(tmp_path):
    _, _, src = _modules(seed=0)
    path = str(tmp_path / "bn.h5")
    tk.save_keras_weights(path, src)
    _, _, dst = _modules(seed=4)
    tk.load_keras_weights(path, dst)
    _states_equal(src, dst)  # scale/bias and the running mean/var
    assert dst.norms[0].var.min() > 0
    # a BatchNorm file refuses the params-only back-compat form
    with pytest.raises(ValueError, match="BatchNorm"):
        tk.load_keras_weights(path, tzoo.flax_from_params(
            dst.state_dict())["params"])


def test_keras_import_unmatched_layer_errors(tmp_path):
    """Strict contract: missing model layers error, never skip."""
    path = str(tmp_path / "small.h5")
    tk.save_keras_weights(path, _baseline(features=(4,)))
    with pytest.raises(ValueError,
                       match="count mismatch|not present|shape"):
        tk.load_keras_weights(path, _baseline(features=(4, 6)))


def test_keras_order_import_rejects_unet(tmp_path):
    """Anonymous (non-Flax-named) files cannot target U-Nets."""
    path = str(tmp_path / "anon.h5")
    with h5py.File(path, "w") as f:
        for i in range(3):
            grp = f.create_group(f"conv3d_{i}").create_group(f"conv3d_{i}")
            grp.create_dataset(
                "kernel:0", data=np.zeros((3, 3, 3, 1, 4), np.float32))
            grp.create_dataset("bias:0", data=np.zeros(4, np.float32))
    dst = tzoo.unet(base_features=4, levels=1, convs_per_stage=1).module
    with pytest.raises(ValueError, match="ConvTranspose"):
        tk.load_keras_weights(path, dst)


def _cross_models(model):
    """(Flax module, its f32 variables as numpy, port module, input)."""
    if model == "bn":
        jm, v, tm = _modules(seed=5)
        s = 20
    elif model == "baseline":
        jm = jzoo.ConvStack(features=(4, 6), dilations=(1, 2),
                            head_features=8, dtype=jnp.float32)
        tm = tzoo.ConvStack(features=(4, 6), dilations=(1, 2),
                            head_features=8, dtype=torch.float32)
        s = 14
    else:
        jm = jzoo.UNetValid(base_features=4, levels=2, convs_per_stage=1,
                            dtype=jnp.float32)
        tm = tzoo.UNetValid(base_features=4, levels=2, convs_per_stage=1,
                            dtype=torch.float32)
        s = 22
    if model != "bn":
        v = jax.tree_util.tree_map(np.asarray, jm.init(
            jax.random.PRNGKey(6), jnp.zeros((1, s, s, s, 1)), train=False))
    x = np.random.default_rng(8).normal(0, 1, (1, s, s, s, 1)).astype(np.float32)
    return jm, v, tm, x


def _logits_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("model", ["baseline", "bn", "unet"])
def test_jax_written_file_loads_into_the_port(tmp_path, model):
    jm, v, tm, x = _cross_models(model)
    path = str(tmp_path / "jax.h5")
    jk.save_keras_weights(path, v)
    tk.load_keras_weights(path, tm)
    for k, t in tzoo.params_from_flax(v).items():
        assert torch.equal(tm.state_dict()[k], t), k
    _logits_close(tm(torch.from_numpy(x)).detach(),
                  jm.apply(v, jnp.asarray(x), train=False))


@pytest.mark.parametrize("model", ["baseline", "bn", "unet"])
def test_port_written_file_loads_into_jax(tmp_path, model):
    jm, v, tm, x = _cross_models(model)
    if model != "bn":  # weights the JAX side does not hold yet
        tm.load_state_dict(tzoo.params_from_flax(jax.tree_util.tree_map(
            lambda a: a + np.float32(0.05), v)))
    path = str(tmp_path / "port.h5")
    tk.save_keras_weights(path, tm)
    target = jax.tree_util.tree_map(np.zeros_like, v)
    loaded = jk.load_keras_variables(path, target)
    want = tzoo.flax_from_params(tm.state_dict())
    for coll in loaded:
        for name, layer in loaded[coll].items():
            for leaf, a in layer.items():
                np.testing.assert_array_equal(a, want[coll][name][leaf])
    _logits_close(jm.apply(loaded, jnp.asarray(x), train=False),
                  tm(torch.from_numpy(x)).detach())
