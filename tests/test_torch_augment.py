"""The port's flip/rotation augmentation (``flypylib_tpu_torch.ops.augment``)
and its copy of the host batch generator (``train/batches.py``) against the
JAX package's, on the same numpy patches.  Augmentation is a copy of
values, so every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flypylib_tpu.ops.augment import augment_patch as j_augment_patch
from flypylib_tpu.train import batches as jbatches
from flypylib_tpu_torch.ops.augment import (AUGMENT_GROUP_SIZE, augment_batch,
                                            augment_patch)
from flypylib_tpu_torch.train import batches as tbatches

_j_augment = jax.jit(j_augment_patch)  # one compile per shape, code traced


@pytest.mark.parametrize("code", range(AUGMENT_GROUP_SIZE))
def test_each_code_equals_jax(code):
    rng = np.random.default_rng(code)
    for shape in ((5, 7, 7), (4, 6, 6, 3)):  # with and without channels
        x = rng.random(shape).astype(np.float32)
        want = np.asarray(_j_augment(jnp.asarray(x), jnp.int32(code)))
        got = augment_patch(torch.from_numpy(x), code)
        np.testing.assert_array_equal(got.numpy(), want)
        # the host generator's _apply_code is the same map
        np.testing.assert_array_equal(tbatches._apply_code(x, code), want)


def test_batch_applies_each_patch_its_code():
    rng = np.random.default_rng(1)
    x = rng.random((16, 6, 9, 9, 2)).astype(np.float32)
    codes = rng.permutation(16)
    got = augment_batch(torch.from_numpy(x), torch.from_numpy(codes)).numpy()
    want = jax.vmap(j_augment_patch)(jnp.asarray(x), jnp.asarray(codes))
    np.testing.assert_array_equal(got, np.asarray(want))
    u8 = (x[..., 0] * 255).astype(np.uint8)  # dtypes pass through
    got8 = augment_batch(torch.from_numpy(u8), codes.tolist())
    assert got8.dtype == torch.uint8
    np.testing.assert_array_equal(got8.numpy(), (got[..., 0] * 255).astype(
        np.uint8))


def test_group_is_closed_and_distinct():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((4, 5, 5)).astype(np.float32))
    images = [augment_patch(x, c) for c in range(AUGMENT_GROUP_SIZE)]
    keys = [im.numpy().tobytes() for im in images]
    assert len(set(keys)) == AUGMENT_GROUP_SIZE  # 16 distinct elements
    for a in range(AUGMENT_GROUP_SIZE):  # composing two stays in the group
        for b in (3, 8, 13):
            assert augment_patch(images[a], b).numpy().tobytes() in keys


def test_non_square_patch_is_rejected():
    x = torch.zeros((2, 4, 5, 6))
    with pytest.raises(ValueError, match="square"):
        augment_batch(x, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="square"):
        j_augment_patch(jnp.zeros((4, 5, 6)), jnp.int32(0))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["f32", "u8"])
def test_gen_batches_copy_equals_jax(dtype):
    rng = np.random.default_rng(4)
    image = (rng.random((24, 22, 26)) * 255).astype(dtype)
    labels = (rng.random(image.shape) > 0.97).astype(np.float32)
    mask = (rng.random(image.shape) > 0.1).astype(np.float32)
    kw = dict(patch_size=9, batch_size=5, context=2, seed=3)
    got = tbatches.gen_batches(image, labels, mask, **kw)
    want = jbatches.gen_batches(image, labels, mask, **kw)
    for _ in range(3):
        for a, b in zip(next(got), next(want)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
