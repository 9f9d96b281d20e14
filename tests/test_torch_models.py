"""The port's model zoo (``flypylib_tpu_torch.models.zoo``) against the JAX
package's Flax modules: the same params (converted by ``params_from_flax``)
give the same logits, and the geometry facts are the reference's.

Tolerance: rtol = atol = 1e-4 on f32 logits (both accumulate in f32, in
different orders, through up to three layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flypylib_tpu.models import zoo as jzoo
from flypylib_tpu.ops.packed_unet import packed_unet_spec as j_packed_unet_spec
from flypylib_tpu_torch.models import zoo as tzoo
from flypylib_tpu_torch.ops.packed_unet import (
    packed_unet_spec as t_packed_unet_spec,
)

torch.set_num_threads(1)

SMALL = {
    "baseline": dict(features=(4, 6), dilations=(1, 2), head_features=8),
    "vgg_like": dict(features=(4, 4, 6), dilations=(1, 2, 4),
                     head_features=8),
}


def _flax_params(name, rng):
    """Small f32 Flax model with random (non-zero) biases, its params as
    numpy, and the port's model holding the same params."""
    kw = SMALL[name]
    jspec = jzoo.MODEL_ZOO[name](dtype=jnp.float32, **kw)
    params = jax.tree_util.tree_map(
        np.array, jspec.init(jax.random.PRNGKey(0), 16))["params"]
    for layer in params.values():
        layer["bias"] = rng.normal(0, 0.1, layer["bias"].shape).astype(
            np.float32)
    tspec = tzoo.MODEL_ZOO[name](dtype=torch.float32, **kw)
    tspec.module.load_state_dict(tzoo.params_from_flax({"params": params}))
    return jspec, params, tspec


@pytest.mark.parametrize("name", ["baseline", "vgg_like"])
def test_logits_match_flax(rng, name):
    jspec, params, tspec = _flax_params(name, rng)
    x = rng.normal(0, 1, (2, 16, 16, 16, 1)).astype(np.float32)
    want = np.asarray(jspec.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tspec.module(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, *(16 - 2 * tspec.context,) * 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_uint8_input_is_its_raw_values(rng, dtype):
    spec = tzoo.baseline_model(dtype=dtype, seed=3, **SMALL["baseline"])
    u8 = rng.integers(0, 256, (1, 12, 12, 12, 1), dtype=np.uint8)
    with torch.no_grad():
        a = spec.module(torch.from_numpy(u8))
        b = spec.module(torch.from_numpy(u8.astype(np.float32)))
    assert a.dtype == b.dtype == torch.float32
    assert torch.equal(a, b)


GEOMETRY = {
    "baseline": ("baseline", {}),
    "vgg_like": ("vgg_like", {}),
    # unet() itself (24, 2, 2) is held in test_torch_detect.py's tiling test
    "unet-4-2-2": ("unet", dict(base_features=4)),
    "unet-4-1-1": ("unet", dict(base_features=4, levels=1, convs_per_stage=1)),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_geometry_matches_reference(name):
    """The geometry facts equal the reference's; for the U-Net, whose JAX
    geometry comes from ``jax.eval_shape`` at every candidate size (~15 s
    a spec on a CPU), for the plain and the packed spec."""
    zoo_name, kw = GEOMETRY[name]
    pairs = [(tzoo.MODEL_ZOO[zoo_name](**kw), jzoo.MODEL_ZOO[zoo_name](**kw))]
    if zoo_name == "unet":
        pairs.append((t_packed_unet_spec(pairs[0][0]),
                      j_packed_unet_spec(pairs[0][1])))
    for tspec, jspec in pairs:
        for attr in ("name", "context", "size_multiple", "size_offset",
                     "min_size", "metadata"):
            assert getattr(tspec, attr) == getattr(jspec, attr), attr
        for s in range(0, 80):
            assert tspec.valid_size(s) == jspec.valid_size(s)
            assert tspec.is_valid_size(s) == jspec.is_valid_size(s)


@pytest.mark.parametrize("name", ["baseline", "vgg_like"])
def test_full_width_params_have_flax_shapes(name):
    jspec = jzoo.MODEL_ZOO[name]()
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(lambda: jspec.init(jax.random.PRNGKey(0),
                                          jspec.min_size)))
    converted = tzoo.params_from_flax(zeros)
    module = tzoo.MODEL_ZOO[name]().module
    state = module.state_dict()
    assert converted.keys() == state.keys()
    for k, v in state.items():
        assert converted[k].shape == v.shape, k
    assert module.dtype == torch.bfloat16  # the reference's default


def test_init_is_seeded_lecun_normal():
    a = tzoo.baseline_model(seed=0).module.state_dict()
    b = tzoo.baseline_model(seed=0).module.state_dict()
    c = tzoo.baseline_model(seed=1).module.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["convs.3.weight"], c["convs.3.weight"])
    for k, v in a.items():
        if k.endswith("bias"):
            assert not v.any(), k
            continue
        fan_in = v[..., 0].numel()  # 27 * Ci, or Ci for the 1x1x1 convs
        std = (1.0 / fan_in) ** 0.5
        assert float(v.abs().max()) <= 2 * std / tzoo._TRUNC_STD + 1e-6, k
        if v.numel() > 10_000:
            assert abs(float(v.std()) / std - 1) < 0.05, k


def test_params_from_flax_rejects_a_non_convstack_tree():
    with pytest.raises(ValueError, match="Conv_0"):
        tzoo.params_from_flax({"params": {"Dense_0": {}, "Conv_0": {}}})
