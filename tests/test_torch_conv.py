"""The port's K1 (``flypylib_tpu_torch.ops.conv``) against the JAX package's
Pallas kernel (interpret mode) and its lax reference, on the same inputs.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is checked on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.

Tolerances: f32 rtol = atol = 1e-5 (both accumulate in f32, in different
orders); bf16 one bf16 ulp (``chip_smoke.conv_check``), since both round
once after an f32 bias add.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from flypylib_tpu.ops import pallas_conv as jconv
from flypylib_tpu_torch.ops import _build
from flypylib_tpu_torch.ops.conv import conv3d_bias_relu

torch.set_num_threads(1)


def _inputs(rng, shape, ci, co, batch=None):
    lead = (batch,) if batch else ()
    x = rng.normal(0, 1, (*lead, *shape, ci)).astype(np.float32)
    w = rng.normal(0, 0.2, (3, 3, 3, ci, co)).astype(np.float32)
    b = rng.normal(0, 0.1, co).astype(np.float32)
    return x, w, b


def _jax_pair(x, w, b, d, dtype):
    """(Pallas kernel in interpret mode, lax reference) for one volume."""
    xj = jnp.asarray(x).astype(dtype)
    kern = jconv.conv3d_bias_relu(xj, jnp.asarray(w), jnp.asarray(b),
                                  dilation=d, block=(4, 4), interpret=True)
    ref = jconv.conv3d_reference(xj, jnp.asarray(w).astype(dtype),
                                 jnp.asarray(b).astype(dtype), d)
    return (np.asarray(kern.astype(jnp.float32)),
            np.asarray(ref.astype(jnp.float32)))


def _assert_close(got: torch.Tensor, want: np.ndarray, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        err, ok = chip_smoke.conv_check(got, torch.from_numpy(np.array(want)))
        assert ok, f"more than one bf16 ulp apart (max |err| {err})"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape,ci,co,d",
    [
        ((10, 11, 13), 1, 8, 1),   # Ci = 1: layer 0's case
        ((12, 9, 14), 5, 8, 1),
        ((11, 13, 10), 1, 8, 2),
        ((13, 12, 9), 5, 8, 2),
    ],
)
def test_matches_pallas_kernel(rng, shape, ci, co, d, dtype):
    x, w, b = _inputs(rng, shape, ci, co)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    kern, ref = _jax_pair(x, w, b, d, jdt)
    got = conv3d_bias_relu(torch.from_numpy(x).to(dtype)[None],
                           torch.from_numpy(w), torch.from_numpy(b), d)
    assert got.dtype == dtype
    assert got.shape == (1, *kern.shape)
    _assert_close(got[0], kern, dtype)
    _assert_close(got[0], ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,ci,co,d", [
    ((9, 10, 11), 4, 8, 3),     # a dilation outside {1, 2, 4}
    ((5, 6, 7), 8, 192, 1),     # Co past 128: the 3-level U-Net's bottleneck
    ((9, 8, 10), 1, 136, 3),    # both, on Ci = 1
])
def test_any_dilation_and_any_co_match_the_reference(rng, shape, ci, co, d,
                                                     dtype):
    """The wrapper takes what the reference's plain path takes (Flax
    ``nn.Conv``: any dilation, any Co) and equals the JAX package's lax
    reference of K1 there."""
    x, w, b = _inputs(rng, shape, ci, co)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    ref = np.asarray(jconv.conv3d_reference(
        xj, jnp.asarray(w).astype(jdt), jnp.asarray(b).astype(jdt), d
    ).astype(jnp.float32))
    got = conv3d_bias_relu(torch.from_numpy(x).to(dtype)[None],
                           torch.from_numpy(w), torch.from_numpy(b), d)
    assert got.dtype == dtype and got.shape == (1, *ref.shape)
    assert got.shape[-1] == co and got.shape[1] == shape[0] - 2 * d
    _assert_close(got[0], ref, dtype)


def test_batch_of_two_is_two_volumes(rng):
    x, w, b = _inputs(rng, (9, 10, 11), 5, 8, batch=2)
    got = conv3d_bias_relu(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), 1)
    assert got.shape == (2, 7, 8, 9, 8)
    for i in range(2):
        kern, _ = _jax_pair(x[i], w, b, 1, jnp.float32)
        _assert_close(got[i], kern, torch.float32)


def test_rounds_once_after_f32_bias():
    # conv sum 1 + 2^-9, bias 2^-8: the f32 total 1 + 3 * 2^-9 rounds to
    # 1 + 2^-7 in bf16, while rounding the sum first (to 1) and then the
    # biased value (1 + 2^-8, a tie, to even) gives 1
    x = torch.zeros((1, 3, 3, 3, 1), dtype=torch.bfloat16)
    x[0, 0, 0, :2, 0] = 1.0
    w = torch.zeros((3, 3, 3, 1, 1))
    w[0, 0, 0, 0, 0] = 1.0
    w[0, 0, 1, 0, 0] = 2.0**-9
    got = conv3d_bias_relu(x, w, torch.tensor([2.0**-8]))
    assert got.dtype == torch.bfloat16
    assert got.item() == 1.0 + 2.0**-7


def test_relu_and_bias_applied(rng):
    x = torch.from_numpy(rng.normal(0, 1, (1, 8, 8, 12, 4)).astype(np.float32))
    b = torch.arange(-4, 4, dtype=torch.float32)
    got = conv3d_bias_relu(x, torch.zeros((3, 3, 3, 4, 8)), b)
    assert torch.equal(got[0, 0, 0, 0], torch.relu(b))


@pytest.mark.parametrize(
    "x_shape,w_shape,b_shape,d",
    [
        ((1, 4, 4, 4, 2), (3, 3, 3, 2, 8), (8,), 2),   # smaller than the field
        ((4, 4, 4, 2), (3, 3, 3, 2, 8), (8,), 1),      # no batch axis
        ((1, 6, 6, 6, 2), (3, 3, 3, 3, 8), (8,), 1),   # Ci mismatch
        ((1, 6, 6, 6, 2), (3, 3, 3, 2, 8), (7,), 1),   # bias mismatch
    ],
)
def test_bad_shapes_raise(x_shape, w_shape, b_shape, d):
    with pytest.raises(ValueError):
        conv3d_bias_relu(torch.zeros(x_shape), torch.zeros(w_shape),
                         torch.zeros(b_shape), d)


def test_no_plain_fallback_off_the_cpu():
    # a tensor that is not on the CPU never takes the plain version
    x = torch.zeros((1, 5, 5, 5, 2), device="meta")
    with pytest.raises(ValueError, match="no conv3d_bias_relu for device"):
        conv3d_bias_relu(x, torch.zeros((3, 3, 3, 2, 4), device="meta"),
                         torch.zeros(4, device="meta"))


def test_cpu_path_never_builds_or_counts(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path must not build the kernels")

    monkeypatch.setattr(_build, "load_library", refuse)
    before = conv3d_bias_relu.launches
    conv3d_bias_relu(torch.zeros((1, 5, 5, 5, 1)), torch.zeros((3, 3, 3, 1, 4)),
                     torch.zeros(4))
    assert conv3d_bias_relu.launches == before


def test_library_name_tracks_sources_and_flags(monkeypatch):
    first = _build.library_path()
    assert first.parent == _build.BUILD_DIR
    assert first == _build.library_path()
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-DX=1"])
    assert _build.library_path() != first
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "kernels").exists()


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "CUDA is not available" in proc.stderr


def test_bf16_tolerance_is_one_ulp():
    ref = torch.tensor([1.0, 3.0, 0.5, 0.0], dtype=torch.bfloat16)
    one_ulp = torch.tensor([1.0 + 2.0**-7, 3.0 - 2.0**-6, 0.5, 0.0],
                           dtype=torch.bfloat16)
    two_ulp = torch.tensor([1.0 + 2.0**-6, 3.0, 0.5, 0.0],
                           dtype=torch.bfloat16)
    assert chip_smoke.conv_check(one_ulp, ref)[1]
    assert not chip_smoke.conv_check(two_ulp, ref)[1]
    f32 = torch.tensor([1.0, 2.0])
    assert chip_smoke.conv_check(f32 + 1e-4, f32)[1]
    assert not chip_smoke.conv_check(f32 + 1e-3, f32)[1]
