"""The port's default dtype, bf16, against the JAX package: the logits of
``baseline``, ``vgg_like`` and ``unet``, each on its plain module and on its
packed engine, against the JAX ``apply`` in bf16 on the same seeded numpy
input and the same weights (``params_from_flax``), at small sizes.

The two packages round at different points.  The port's plain convs (K1's
plain version) add the bias to the f32 sum and round once; Flax's ``nn.Conv``
rounds the conv to bf16 and then adds the bias.  So a value differs by a
bf16 ulp here and there and the difference is carried through the layers:
the comparison holds rounding noise, not equality.

The packed engines round where the JAX engines do (the conv to bf16, then
the bias), so they agree to f32 noise; the plain modules differ by about
1% of the largest logit.

Tolerances: ``TOL[case]`` on max |logit difference|, each 4x the largest gap
read over input/weight seeds 0-4 (``GAP`` below, read with
``python -m tests.test_torch_bf16_parity``), the logits' magnitude beside
it, and at least ``TOL_FLOOR``.  A wrong result (a dropped tap, a transposed
weight) moves the logits by their own magnitude, far past 4x the rounding
gap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flypylib_tpu.models import zoo as jzoo
from flypylib_tpu.ops import packed_conv as jpc
from flypylib_tpu.ops import packed_unet as jpu
from flypylib_tpu_torch.models import zoo as tzoo
from flypylib_tpu_torch.ops import packed_conv as tpc
from flypylib_tpu_torch.ops import packed_unet as tpu

torch.set_num_threads(1)

SMALL = {
    "baseline": dict(features=(6, 8), dilations=(1, 2), head_features=12),
    "vgg_like": dict(features=(4, 6, 6, 8), dilations=(1, 1, 2, 4),
                     head_features=8),
    "unet": dict(base_features=4),
}
UNET_SIZE = 44  # min_size of the (base, 2, 2) U-Net, plain and packed

CASES = [(name, engine) for name in SMALL for engine in ("plain", "packed")]
# largest max |logit difference| over seeds 0-4, and the largest max |logit|
# (the gap does not follow the logits' size: seed 0's vgg_like logits reach
# only 0.04 with a gap of 1.1e-3)
GAP = {
    ("baseline", "plain"): (7.15e-3, 0.69),
    ("baseline", "packed"): (2.44e-6, 0.69),
    ("vgg_like", "plain"): (2.28e-3, 0.256),
    ("vgg_like", "packed"): (3.58e-7, 0.256),
    ("unet", "plain"): (1.91e-3, 0.287),
    ("unet", "packed"): (0.0, 0.287),
}
TOL_FLOOR = 1e-5  # f32 summation order in the f32 logits conv
TOL = {case: max(4 * gap, TOL_FLOOR) for case, (gap, _) in GAP.items()}


def _variables(name, seed):
    """f32 Flax params of the small ``name`` model: lecun-scaled kernels,
    non-zero biases, from numpy."""
    rng = np.random.default_rng(seed)
    if name == "unet":
        jm = jzoo.UNetValid(dtype=jnp.float32, **SMALL[name])
        x0 = jnp.zeros((1, UNET_SIZE, UNET_SIZE, UNET_SIZE, 1))
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x0)["params"]
    else:
        jspec = jzoo.MODEL_ZOO[name](dtype=jnp.float32, **SMALL[name])
        shapes = jax.eval_shape(
            lambda: jspec.init(jax.random.PRNGKey(0), jspec.min_size))["params"]
    params = {}
    for layer, leaves in shapes.items():
        k = leaves["kernel"].shape
        params[layer] = {
            "kernel": rng.normal(0, np.prod(k[:-1]) ** -0.5, k).astype(np.float32),
            "bias": rng.normal(0, 0.1, leaves["bias"].shape).astype(np.float32),
        }
    return {"params": params}, rng


def logit_gap(name, engine, seed):
    """(max |port - JAX|, max |JAX|) of the bf16 logits of one case."""
    variables, rng = _variables(name, seed)
    state = tzoo.params_from_flax(variables)
    if name == "unet":
        jm = jzoo.UNetValid(**SMALL[name])  # bf16, the default
        tm = tzoo.UNetValid(dtype=torch.bfloat16, **SMALL[name])
        tm.load_state_dict(state)
        s = UNET_SIZE
        if engine == "packed":
            jm, tm = jpu.PackedUNet(jm), tpu.PackedUNet(tm.eval())
    else:
        jspec = jzoo.MODEL_ZOO[name](**SMALL[name])
        tspec = tzoo.MODEL_ZOO[name](dtype=torch.bfloat16, **SMALL[name])
        tspec.module.load_state_dict(state)
        jm, tm = jspec.module, tspec.module
        s = tspec.min_size + 7
        if engine == "packed":
            pspec = tpc.packed_spec(tspec)
            jm, tm, s = jpc.PackedConvStack(jm), pspec.module, pspec.valid_size(s)
    assert jm.dtype == jnp.bfloat16 and tm.dtype == torch.bfloat16
    x = rng.random((1, s, s, s, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.shape == want.shape
    return float(np.abs(got.numpy() - want).max()), float(np.abs(want).max())


@pytest.mark.parametrize("name,engine", CASES,
                         ids=[f"{n}-{e}" for n, e in CASES])
def test_bf16_logits_match_jax(name, engine):
    gap, scale = logit_gap(name, engine, seed=3)
    assert scale > 5 * TOL[name, engine], ("the logits are no signal", scale)
    assert gap <= TOL[name, engine], (gap, scale)


if __name__ == "__main__":  # the readings behind GAP
    jax.config.update("jax_platforms", "cpu")
    for case in CASES:
        reads = [logit_gap(*case, seed) for seed in range(5)]
        print(case, "gap/max|logit| %.3g" % max(g / s for g, s in reads),
              ["%.3g / %.3g" % r for r in reads])
