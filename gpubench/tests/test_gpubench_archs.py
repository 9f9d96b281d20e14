"""The architecture modules (``gpubench/archs/``): the baseline's shapes,
counts, patches and forward as they were before they moved into
``archs/conv_stack.py``, and a second architecture found from a file added
beside the others, with no edit to any file that is there."""

import shutil
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from gpubench import archs, counts, inputs, reference
from gpubench.harness import Catalog

CAT = Catalog()
HERE = Path(__file__).resolve().parent
TOY = {"name": "toy", "arch": "toy_unet", "base_features": 4,
       "assumed": {"bias_std": 0.05}}


# -- the baseline, pinned to the values of the code before the move -------

def test_baseline_shapes_context_and_patches():
    cfg = CAT.config("baseline")
    assert reference.param_shapes(cfg) == [
        ("Conv_0", (3, 3, 3, 1, 24), 27), ("Conv_1", (3, 3, 3, 24, 32), 648),
        ("Conv_2", (3, 3, 3, 32, 48), 864), ("Conv_3", (3, 3, 3, 48, 64), 1296),
        ("Conv_4", (1, 1, 1, 64, 96), 64), ("Conv_5", (1, 1, 1, 96, 1), 96)]
    assert reference.context(cfg) == 6
    assert reference.train_patch(cfg, 33, "packed") == 34
    assert reference.train_patch(cfg, 33, "plain") == 33
    assert archs.of(cfg).logits_layer(cfg) == "Conv_5"


def test_baseline_counts_bit_for_bit():
    cfg = CAT.config("baseline")
    assert counts.forward_flops(cfg, 1024) == 328644193142400.0
    assert counts.train_flops(cfg, 33) == 11955198240.0
    assert counts.forward_bytes(cfg, 1024) == 5407511172.0
    assert counts.forward_bound_s(cfg, 1024) == (0.3322994875049545,
                                                 "operations")


def _parent_forward(params, x, dilations):
    """The conv stack's reference forward as it read before the move."""
    def conv(x, p, d):
        w = p["kernel"].permute(4, 3, 0, 1, 2)
        return F.conv3d(x, w, dilation=d) + p["bias"].view(1, -1, 1, 1, 1)

    def pw(x, p):
        k = p["kernel"]
        w = k.reshape(k.shape[-2], k.shape[-1]).t().reshape(
            k.shape[-1], k.shape[-2], 1, 1, 1)
        return F.conv3d(x, w) + p["bias"].view(1, -1, 1, 1, 1)

    names = sorted(params, key=lambda k: int(k.split("_")[1]))
    n = len(dilations)
    for name, d in zip(names[:n], dilations):
        x = F.relu(conv(x, params[name], d))
    x = F.relu(pw(x, params[names[n]]))
    return pw(x, params[names[n + 1]])


def test_baseline_forward_bit_for_bit():
    cfg = CAT.config("baseline")
    params = inputs.make_params(cfg, 7, "cpu")
    x = torch.rand((1, 1, 24, 24, 24), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = reference.forward(cfg, params, x)
        want = _parent_forward(params, x, cfg["dilations"])
    assert got.shape == (1, 1, 12, 12, 12)
    assert torch.equal(got, want)
    # the seeded weights and input are those the values were pinned from
    assert float(got.double().sum()) == pytest.approx(-374.54026966914535,
                                                      rel=1e-6)


# -- a second architecture, found by its name ---------------------------------

@pytest.fixture
def toy(tmp_path, monkeypatch):
    """``archs/toy_unet.py`` in a directory of its own, on the package's
    search path."""
    shutil.copy(HERE / "toy_arch.py", tmp_path / "toy_unet.py")
    monkeypatch.setattr(archs, "__path__", [*archs.__path__, str(tmp_path)])
    yield dict(TOY)
    sys.modules.pop("gpubench.archs.toy_unet", None)


def test_toy_is_found_by_its_arch(toy, tmp_path):
    mod = archs.of(toy)
    assert Path(mod.__file__).parent == tmp_path
    names = [n for n, _, _ in reference.param_shapes(toy)]
    assert "ConvTranspose_0" in names and reference.context(toy) == 4
    assert reference.train_patch(toy, 20, "plain") == 20
    params = inputs.make_params(toy, 5, "cpu")
    assert {n: p["kernel"].shape for n, p in params.items()} == {
        n: s for n, s, _ in reference.param_shapes(toy)}
    inputs.prior_bias(toy, params, 0.002)
    assert torch.all(params["Conv_3"]["bias"] < -6)


def test_toy_forward_and_slabs(toy):
    params = inputs.make_params(toy, 5, "cpu")
    x = torch.rand((2, 1, 14, 16, 18), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y = reference.forward(toy, params, x)
        feats = reference.forward(toy, params, x, logits=False)
    assert y.shape == (2, 1, 6, 8, 10) and feats.shape == (2, 4, 6, 8, 10)
    vol = inputs.blob_volume(14, 2, torch.Generator().manual_seed(2), "cpu")
    whole = reference.volume_logits(toy, params, vol, None, slab=14)
    for slab in (2, 4, 5):  # 5 rounds down to the grid's 4
        got = reference.volume_logits(toy, params, vol, None, slab=slab)
        assert torch.equal(got, whole), slab
    # the grid matters: a slab that starts on it reads what the whole
    # forward reads; one that starts a plane off reads other pooling blocks
    idx = reference.reflect_index(14, 4, 4, "cpu")
    xp = vol[idx][:, idx][:, :, idx].float()[None, None]
    with torch.no_grad():
        on = reference.forward(toy, params, xp[:, :, 2:14])[0, 0]
        off = reference.forward(toy, params, xp[:, :, 1:13])[0, 0]
    assert torch.equal(on, whole[2:6])
    assert not torch.allclose(off, whole[1:5], rtol=0, atol=1e-2)
    with pytest.raises(ValueError, match="off the grid"):
        reference.volume_logits(toy, params, vol[:13], None)


def test_toy_counts_by_hand(toy):
    # output 4^3: conv 0 at 10^3, conv 1 at 3^3 (half of 6), the
    # ConvTranspose at 6^3 (one tap of 8 a voxel), conv 2 and logits at 4^3
    want = (27 * 1 * 4 * 10**3 + 27 * 4 * 8 * 3**3 + 8 * 4 * 6**3
            + 27 * 8 * 4 * 4**3 + 4 * 1 * 4**3)
    assert counts.forward_flops(toy, 4) == 2.0 * want
    first = 2.0 * 27 * 4 * 10**3
    assert counts.train_flops(toy, 12) == 3.0 * 2.0 * want - first
    assert counts.forward_bound_s(toy, 4)[1] == "bytes"
